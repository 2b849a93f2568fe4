"""The host-side launch shape of the lookup's backward kernel
(``ops/lookup.py::backward_plan``), which the CUDA kernel
(``ops/csrc/lookup_fused.cu``, ``fr_lookup_fused_backward``) follows, for
every config of the registry, whole and on model shards; and a numpy
interpreter of the kernel's walk over the batch's (row, 4 output columns)
units, which adds a unit whose first column carries the descriptors'
``VEC4`` bit as 4 consecutive elements of the first column's row (and of
its QR remainder row), in float64 on integer cotangents, so every sum is
exact: it must give ``lookup_fused_backward_plain``'s gradients bit for bit
on every layout case, which holds the descriptors to what the 16-byte
reductions assume."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import draw_ids, ids_with_bad
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.embedding import lookup_tensors
from fleetrec_tpu_torch.models.fleetrec import ModelPlan
from fleetrec_tpu_torch.ops import lookup as tlk
from fleetrec_tpu_torch.parallel import shard_operands
from torch_variants import CPU, LAYOUT_CASES, variant

SM = 132  # an H100's SMs
FIELD = {name: i for i, name in enumerate(tlk.LOOKUP_COL_FIELDS)}


def _check_plan(plan, cols, pos, B):
    """A block a 256 (row, 4 columns) units, at most BACKWARD_BLOCKS_PER_SM
    an SM, at least one; a block's shared memory within the card's."""
    n_plan, F = cols.shape[0], pos.shape[0]
    units = B * (F // 4 if F % 4 == 0 else F)
    cap = tlk.BACKWARD_BLOCKS_PER_SM * SM
    assert 1 <= plan.grid <= cap
    assert plan.grid == max(1, min(cap, -(-units // 256)))
    assert plan.vec and tlk.smem_bytes(F, n_plan, 0) <= tlk.SMEM_BYTES


def _descriptors(name, shard=None):
    cfg = TC.get_config(name)
    plan = ModelPlan.create(cfg)
    d = lookup_tensors(plan.layout, plan.index_perm, plan.qr_positions, CPU, shard=shard)
    return d["cols"], d["pos"]


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 4)])
@pytest.mark.parametrize("name", sorted(TC.CONFIGS))
def test_backward_plan_of_every_config(name, shard):
    """backward_plan for each registry config at B = 4096, 1024, 24 and 1,
    whole and as model shards' descriptors."""
    cols, pos = _descriptors(name, shard)
    for B in (4096, 1024, 24, 1):
        _check_plan(tlk.backward_plan(cols, pos, B, SM), cols, pos, B)


def test_backward_plan_model1_dlrm_and_model3_shapes():
    """At B = 4096 model1 (352 columns), model3 (3968) and dlrm_terabyte
    (3328) have far more units than 3 blocks an SM take at once: 396
    blocks each, whose threads walk the units grid-stride; ``vec=False``
    keeps the grid, ``blocks_per_sm`` sets it."""
    for name in ("fleetrec_model1", "fleetrec_model3", "dlrm_terabyte"):
        cols, pos = _descriptors(name)
        assert tlk.backward_plan(cols, pos, 4096, SM) == tlk.BackwardPlan(3 * SM, True)
        assert tlk.backward_plan(cols, pos, 4096, SM, vec=False) == tlk.BackwardPlan(3 * SM,
                                                                                   False)
        assert tlk.backward_plan(cols, pos, 4096, SM, blocks_per_sm=8).grid == 8 * SM


def test_backward_plan_refuses_descriptors_over_shared_memory():
    """A block stages every output and plan column's descriptor; more than
    fit its shared memory raise."""
    cols = np.zeros((100, len(tlk.LOOKUP_COL_FIELDS)), np.int64)
    F = (tlk.SMEM_BYTES - 40 * 100) // 8
    assert tlk.backward_plan(cols, np.zeros((F, 2), np.int32), 4096, SM).grid >= 1
    with pytest.raises(ValueError, match="shared memory"):
        tlk.backward_plan(cols, np.zeros((F + 1, 2), np.int32), 4096, SM)


def _emulate(vec, ct, ids, bufs, cols, pos, stripes, stripe_height, window):
    """The kernel's arithmetic in float64: with ``vec`` (F a multiple of 4)
    each (row, 4 output columns) unit whose first column has the VEC4 bit
    adds its 4 cotangents into 4 consecutive elements from the first
    column's element (and its QR remainder column's), read from that
    column's descriptor alone; every other column adds element by element
    at lookup_offsets_plain's offsets (-1: no row, nothing added)."""
    col, add, o = (t.numpy() for t in tlk._decode_pos(pos))
    flag = pos[:, 1].numpy() & tlk.VEC4
    offs, _ = tlk.lookup_offsets_plain(ids, cols, stripes, stripe_height, window)
    offs = offs.numpy()
    buf_of = cols[:, FIELD["buf"]].numpy()
    g = ct.double().numpy()
    sums = [np.zeros(b.numel()) for b in bufs]
    F = g.shape[1]
    vec = vec and F % 4 == 0
    p = 0
    while p < F:
        n = 4 if vec and p % 4 == 0 and flag[p] else 1
        for k in (col[p], add[p]):
            if k < 0:
                continue
            live = offs[:, k] >= 0
            at = offs[live, k][:, None] + o[p] + np.arange(n)
            np.add.at(sums[buf_of[k]], at, g[live, p:p + n])
        p += n
    return sums


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo", "narrow"])
def test_backward_units_interpreted_match_plain(name, vec):
    """The kernel's unit walk interpreted in float64 (``_emulate``) against
    lookup_fused_backward_plain, integer cotangents and ids with bad ones,
    at B = 2500 and the config's B, whole and on shard 1 of 2: bit-equal,
    with 16-byte units (``vec``) and one column at a time."""
    cfg = dataclasses.replace(variant(name, TC), table_dtype="float32")
    model = init_model(cfg, device=CPU)
    rng = np.random.default_rng(40)
    F = model.layout.feature_dim
    for B in (2500, cfg.batch_size):
        ids = torch.from_numpy(ids_with_bad(cfg, B, rng))
        ct = torch.from_numpy(rng.integers(-3, 4, (B, F)).astype(np.float32))
        for shard in (None, (1, 2)):
            ops = model.lookup_operands() if shard is None else shard_operands(model, *shard, CPU)
            window = ops.get("window") if shard else None
            _check_plan(tlk.backward_plan(ops["cols"], ops["pos"], B, SM), ops["cols"],
                        ops["pos"], B)
            got = _emulate(vec, ct, ids, ops["bufs"], ops["cols"], ops["pos"], ops["stripes"],
                           ops["stripe_height"], window)
            want = tlk.lookup_fused_backward_plain(ct, ids, ops["bufs"], ops["cols"], ops["pos"],
                                                   ops["stripes"], ops["stripe_height"],
                                                   window=window)
            for i, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(a.astype(np.float32), b.reshape(-1).numpy(),
                                              err_msg=f"{name} B={B} shard {shard} buffer {i}")


@pytest.mark.parametrize("draw", ["ids0", "skew"])
def test_backward_units_interpreted_on_contention_draws(draw):
    """The same on the tiers variant (one-hot, factored and take tables)
    with every id 0 and with skewed ids: every row a batch reads is one of a
    few, and the 16-byte units cover most of its columns."""
    cfg = dataclasses.replace(variant("tiers", TC), table_dtype="float32")
    model = init_model(cfg, device=CPU)
    rng = np.random.default_rng(41)
    B, F = 2100, model.layout.feature_dim
    ids = torch.from_numpy(draw_ids(cfg, B, rng, draw))
    ct = torch.from_numpy(rng.integers(-3, 4, (B, F)).astype(np.float32))
    ops = model.lookup_operands()
    args = (ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
    assert (ops["pos"][:, 1] & tlk.VEC4).count_nonzero() * 8 >= F  # half in 16-byte units
    got = _emulate(True, ct, ids, ops["bufs"], *args, None)
    want = tlk.lookup_fused_backward_plain(ct, ids, ops["bufs"], *args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.astype(np.float32), b.reshape(-1).numpy())
