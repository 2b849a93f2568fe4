"""The harness over DLRM-style heads, by whole runs on the CPU at the tiny
size (``tiny.py``'s tables): a DLRM dot head with a bottom tower, a
low-rank DCNv2 cross head on the raw dense tail, the tower over uniform
bags (the port's ``bag_L`` path) and a configuration that states its
towers bias-free each read ``correct``; each planted fault and the control
in the cross layers read not correct; ragged bags fail loudly.  The
reference's heads against direct computations besides."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import control, inputs, reference, serve, tables
from portbench.tests import faults, tiny

SEED = 4_000_000_001

def _bf16(make):
    return lambda: dict(make(), dtype="bfloat16", table_dtype="bfloat16")


SOUND = {
    "dot_bottom": tiny.dot_model,
    "cross_low_rank": tiny.cross_model,
    "bags4": tiny.bag_model,
    "bias_off": lambda: dict(tiny.model(), bias=False),
    "cross_full_rank": lambda: tiny.cross_model(0),
    "dot_bottom_bf16": _bf16(tiny.dot_model),
    "cross_low_rank_bf16": _bf16(tiny.cross_model),
    "bags4_bf16": _bf16(tiny.bag_model),
}


def _run(m, patch=None):
    return serve.run_single(tiny.cell_of(m), SEED, 0.5, False, time.monotonic_ns(),
                            device="cpu", patch=patch)


@pytest.mark.parametrize("case", sorted(SOUND))
def test_sound_head_run_is_correct(case):
    out = _run(SOUND[case]())
    assert serve.correct(out), out.checks
    assert out.checks["max_err"]["value"] < 1e-5
    assert len(out.window()) > 0


def _faults():
    from fleetrec_tpu_torch.models import FleetRecModel, fleetrec

    return {
        "cross_without_residual": (tiny.cross_model, faults.cross_without_residual,
                                   (fleetrec, "cross_network")),
        "tf32_cross": (tiny.cross_model, faults.tf32_cross, (fleetrec, "cross_network")),
        "bottom_tower_skipped": (tiny.dot_model, faults.bottom_tower_skipped,
                                 (fleetrec, "interaction_head")),
        "bag_last_dropped": (tiny.bag_model, faults.bag_last_dropped,
                             (FleetRecModel, "forward_pooled")),
    }


@pytest.mark.parametrize("fault", ["cross_without_residual", "tf32_cross",
                                   "bottom_tower_skipped", "bag_last_dropped"])
def test_planted_fault_is_not_correct(fault):
    make, patch, (target, name) = _faults()[fault]
    saved = getattr(target, name)
    try:
        out = _run(make(), patch=patch)
    finally:
        setattr(target, name, saved)
    assert out.checks["unanswered"]["value"] == 0 and out.checks["wire_errors"]["value"] == 0
    assert not serve.correct(out)
    assert out.checks["max_err"]["value"] > out.checks["max_err"]["limit"]


@pytest.mark.parametrize("case", sorted(SOUND))
def test_control_fails_the_tiny_limit(case):
    """The control (every product of the head one precision below) fails
    the tiny cell's limit on three seeds."""
    c = tiny.cell_of(SOUND[case]())
    for seed in (101, 2_200_000_003, 7):
        assert control.reading(c, seed, torch.device("cpu")) > c.check["max_err"]


def test_ragged_bags_fail_loudly():
    with pytest.raises(ValueError, match="ragged bags"):
        _run(tiny.bag_model([1, 2, 3, 1, 2, 4]))


def _pool(m, batch=16, pool=2):
    ids, dense = inputs.pools(SEED, m, batch, pool)
    return ids, dense, tables.head_weights(SEED, m, "cpu")


def test_last_activation_changes_the_dot_scores():
    m0, m1 = tiny.dot_model(False), tiny.dot_model(True)
    ids, dense, w = _pool(m0)
    key = tables.seed_key(SEED)
    s0 = reference.pool_scores(m0, key, ids, dense, w)
    s1 = reference.pool_scores(m1, key, ids, dense, w)
    assert reference.max_err(s1, s0) > 1e-2


def test_bias_changes_the_scores():
    m0, m1 = tiny.dot_model(), dict(tiny.dot_model(), bias=True)
    ids, dense, _ = _pool(m0)
    w = tables.head_weights(SEED, m1, "cpu")
    assert len(w["mlp_bias"]) == 2 and len(w["bottom_bias"]) == 2
    key = tables.seed_key(SEED)
    s1 = reference.pool_scores(m1, key, ids, dense, w)
    s0 = reference.pool_scores(m0, key, ids, dense, dict(w, mlp_bias=[], bottom_bias=[]))
    assert reference.max_err(s1, s0) > 1e-2


def test_dot_head_against_direct_computation():
    """The dot head by loops in numpy: the bottom tower, every pair's dot
    in row-major strict-triangle order, the top tower."""
    m = tiny.dot_model()
    ids, dense, w = _pool(m, batch=4, pool=1)
    key = tables.seed_key(SEED)
    x = reference.features(m, key, torch.from_numpy(ids[0].astype(np.int64)),
                           torch.from_numpy(dense[0])).numpy()
    got = reference.head(m, torch.from_numpy(x), torch.from_numpy(dense[0]), w).numpy()
    relu = lambda h: np.maximum(h, 0)  # noqa: E731
    W = [t.double().numpy() for t in w["bottom"]]
    bot = relu(dense[0].astype(np.float64) @ W[0]) @ W[1]
    vecs = [bot] + [x[:, 8 * t:8 * t + 8] for t in range(6)]
    z = [np.sum(vecs[i] * vecs[j], axis=1) for i in range(7) for j in range(i)]
    top = np.concatenate([bot, np.stack(z, axis=1)], axis=1)
    T = [t.double().numpy() for t in w["mlp"]]
    want = (relu(top @ T[0]) @ T[1])[:, 0]
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cross_head_against_direct_computation():
    """The cross layers by their formula in numpy, full and low rank."""
    for rank in (0, 8):
        m = tiny.cross_model(rank)
        ids, dense, w = _pool(m, batch=4, pool=1)
        x0 = reference.features(m, tables.seed_key(SEED), torch.from_numpy(ids[0].astype(np.int64)),
                                torch.from_numpy(dense[0])).numpy()
        got = reference.head(m, torch.from_numpy(x0), torch.from_numpy(dense[0]), w).numpy()
        x = x0
        for layer in w["cross"]:
            *mats, b = [t.double().numpy() for t in layer]
            xw = x
            for mat in mats:
                xw = xw @ mat
            x = x0 * (xw + b) + x
        T = [t.double().numpy() for t in w["mlp"]]
        want = (np.maximum(np.maximum(x @ T[0], 0) @ T[1], 0) @ T[2])[:, 0]
        assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_bag_features_sum_their_members():
    """A bag's features are the sum of its members' single-id features."""
    m1, m4 = tiny.model(), tiny.bag_model(4)
    ids = inputs.pools(SEED, m4, 8, 1)[0][0].astype(np.int64)
    dense = torch.zeros((8, m1["dense_dim"]))
    key = tables.seed_key(SEED)
    got = reference.features(m4, key, torch.from_numpy(ids), dense)
    want = sum(reference.features(m1, key, torch.from_numpy(ids[:, k::4]), dense)
               for k in range(4))
    assert torch.equal(got, want)
