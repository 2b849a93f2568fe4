"""The serving engine's forward replayed from CUDA graphs
(``serving/engine.py``: ``GraphSlots``) on the card: a ``from_model``
engine's dispatched batches of the served shape are scored by replays, bit-
equal to the same engine's eager scores (``score_fn``) of the same batches,
for every in-flight window and both drain modes, with distinct batches
submitted back to back so that a slot overwritten before its readback shows
as a wrong score; a bad take id still poisons its row through a replay; a
batch of another shape or with int64 ids runs eagerly.  Every test here is
marked ``cuda`` and skips without a CUDA device.  The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_engine_graph.py
"""

import functools

import numpy as np
import pytest
import torch

from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.ops.lookup import lookup_fused, lookup_fused_bags
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp
from fleetrec_tpu_torch.serving import ServingEngine
from torch_variants import cap

B, NB = 256, 8
KERNELS = (lookup_fused, lookup_fused_bags, fused_mlp)
# (config, engine options) a case
CASES = {
    "criteo_int8": ("criteo_int8", {}),
    "model1_fp32": ("model1", {}),
    "dlrm_bf16": ("dlrm_bf16", {}),
    "model1_fuse2": ("model1", {"fuse": 2}),
    "model1_bags4": ("model1", {"bag_L": 4}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine captures CUDA graphs only there")
    return torch.device("cuda:0")


def _config(name):
    if name == "criteo_int8":
        # criteo's geometry, int8 tables and the float32 tower of the benchmark's cell
        return cap(C.criteo_terabyte(batch_size=B, dtype="float32", table_dtype="int8"), 40000)
    if name == "model1":
        return cap(C.fleetrec_model1(batch_size=B), 20000)
    return cap(C.dlrm_terabyte(batch_size=B, dtype="bfloat16"), 2000)


@functools.cache
def _model(name):
    cfg = _config(name)
    return cfg, init_model(cfg, mlp_scheme="uniform", device="cuda")


def _batches(cfg, n, rng, fuse=1, bag_L=0, rows=B):
    lead = (fuse, rows) if fuse > 1 else (rows,)
    out = []
    for _ in range(n):
        tail = (bag_L,) if bag_L else ()
        ids = np.stack([rng.integers(0, t.rows, lead + tail) for t in cfg.tables],
                       len(lead)).astype(np.int32)
        if bag_L:
            ids[rng.random(ids.shape) < 0.3] = -1  # padding
        dense = (rng.uniform(-1, 1, lead + (cfg.dense_dim,)).astype(np.float32)
                 if cfg.dense_dim else None)
        out.append((ids, dense))
    return out


def _launches():
    return [k.launches for k in KERNELS]


def _served(eng, batches):
    """Submit ``batches`` back to back; their replied scores in order."""
    got = {}
    for ids, dense in batches:
        eng.submit(ids, dense, on_done=lambda k, s: got.__setitem__(k, s))
    eng.drain()
    eng.close()
    return [got[k] for k in range(len(batches))]


@pytest.mark.cuda
@pytest.mark.parametrize("bg", [False, True], ids=["inline_drain", "background_drain"])
@pytest.mark.parametrize("max_in_flight", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_scores_equal_eager_scores(cuda, case, max_in_flight, bg):
    name, kw = CASES[case]
    cfg, model = _model(name)
    eng = ServingEngine.from_model(model, batch_size=B, max_in_flight=max_in_flight,
                                   background_drain=bg, **kw)
    batches = _batches(cfg, NB, np.random.default_rng(max_in_flight), **kw)
    per = _launches()
    eng.score_fn(*batches[0])
    per = [a - b for a, b in zip(_launches(), per)]  # one forward's launches
    before = _launches()
    eng.warmup()
    got = _served(eng, batches)
    assert eng.graph_replays == NB and eng.eager_forwards == 0
    assert [r.graph for r in eng.stats.records] == [True] * NB
    assert len(eng._graphs.slots) == max_in_flight + 1 and eng.graph_capture_s > 0
    # a replay counts the launches of the forward it replays; a capture none
    assert [a - b for a, b in zip(_launches(), before)] == [(NB + 1) * n for n in per]
    for k, (ids, dense) in enumerate(batches):
        np.testing.assert_array_equal(got[k], eng.score_fn(ids, dense).cpu().numpy(),
                                      err_msg=f"batch {k}")


@pytest.mark.cuda
def test_a_bad_take_id_poisons_its_row_through_the_replay(cuda):
    cfg, model = _model("criteo_int8")
    eng = ServingEngine.from_model(model, batch_size=B)
    eng.warmup()
    batches = _batches(cfg, 3, np.random.default_rng(5))
    batches[1][0][3, 0] = cfg.tables[0].rows  # a take table's id past its rows
    got = _served(eng, batches)
    assert [r.graph for r in eng.stats.records] == [True] * 3
    assert np.isnan(got[1][3]) and np.isnan(got[1]).sum() == 1
    assert not np.isnan(got[0]).any() and not np.isnan(got[2]).any()
    for k, (ids, dense) in enumerate(batches):
        np.testing.assert_array_equal(got[k], eng.score_fn(ids, dense).cpu().numpy())


@pytest.mark.cuda
def test_another_batch_shape_and_int64_ids_run_eagerly(cuda):
    cfg, model = _model("model1")
    eng = ServingEngine.from_model(model, batch_size=B)
    eng.warmup()
    rng = np.random.default_rng(6)
    (half,) = _batches(cfg, 1, rng, rows=B // 2)
    wide, fits = _batches(cfg, 2, rng)
    batches = [half, (wide[0].astype(np.int64), wide[1]), fits]
    got = _served(eng, batches)
    assert eng.eager_forwards == 2 and eng.graph_replays == 1
    assert [r.graph for r in eng.stats.records] == [False, False, True]
    for k, (ids, dense) in enumerate(batches):
        np.testing.assert_array_equal(got[k], eng.score_fn(ids, dense).cpu().numpy())
