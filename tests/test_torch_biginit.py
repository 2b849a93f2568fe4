"""The port's pm1 table generator (``fleetrec_tpu_torch/models/biginit.py``)
against the JAX package's (``fleetrec_tpu/models/biginit.py``) and the
port's own packing, the twin of tests/test_ops.py:79.

* ``pm1_take_chunk`` byte-equal to JAX's, on criteo with rows capped at
  4000 and 30000, float32 and int8, 16 stripes and 1, in 777-row chunks
  that cross table and stripe boundaries, with the factored tier off (as
  JAX's test) and on; the torch generator ``fill_pm1_take`` byte-equal to
  it on the same chunks;
* the device generator (``pack_pm1_sharded`` on the CPU) equal to
  ``pack_tables`` of the pm1 reference tables, buffers and scales, in
  float32, bfloat16 and int8, on criteo and on layouts with several take
  groups, stripes, QR remainders and wide lanes;
* its windows on (1, 2) and (1, 4), pad rows included, equal to
  ``shard_operands``' slices, and ``packed_operands(window_only=True)``
  equal to ``shard_operands`` field by field;
* gloo worlds where every rank's ``ShardedFleetRec.from_packed`` of its
  generated window scores bit-equal to ``ShardedFleetRec`` of the whole
  model and to JAX's ``ShardedFleetRec`` over ``pack_pm1_sharded`` on the
  8-device virtual mesh, NaN on the rows with a bad take id; a config with
  an interaction head refused by ``from_packed``.

Tolerance: exact throughout."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models.biginit import pack_pm1_sharded as j_pack_pm1_sharded
from fleetrec_tpu.models.biginit import pm1_take_chunk as j_pm1_take_chunk
from fleetrec_tpu.parallel import ShardedFleetRec as JSharded
from fleetrec_tpu.parallel import make_mesh as j_make_mesh
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import init_model, pack_pm1_sharded
from fleetrec_tpu_torch.models.biginit import fill_pm1_take, pm1_take_chunk
from fleetrec_tpu_torch.models.fleetrec import ModelPlan
from fleetrec_tpu_torch.parallel import ShardedFleetRec, packed_operands, shard_operands
from fleetrec_tpu_torch.parallel.mesh import Mesh
import chip_smoke as cs
from torch_variants import CPU, cap, variant
from torch_worlds import case_config, run_generated, spawn_world

CHUNK = 777


def criteo(C, rows, table_dtype="float32", stripes=16, factored=True):
    """criteo_terabyte with rows capped at ``rows`` (float32 activations);
    ``factored=False`` turns the factored tier off, as tests/test_ops.py:79
    does so that its 4000-row cap keeps a take buffer."""
    kw = {} if factored else {"onehot_factor_max": 0}
    cfg = C.criteo_terabyte(batch_size=16, dtype="float32", take_stripes=stripes, **kw)
    return dataclasses.replace(cap(cfg, rows), table_dtype=table_dtype)


@pytest.mark.parametrize("factored", [False, True], ids=["factored_off", "factored_on"])
@pytest.mark.parametrize("stripes", [16, 1])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("rows", [4000, 30000])
def test_pm1_take_chunk_byte_equal_to_jax(rows, dtype, stripes, factored):
    cfg_t = criteo(TC, rows, dtype, stripes, factored)
    cfg_j = criteo(JC, rows, dtype, stripes, factored)
    lay_t = ModelPlan.create(cfg_t).layout
    lay_j = JModel.create(cfg_j).layout
    assert lay_t.take_phys_total == lay_j.take_phys_total
    total = lay_t.take_phys_total
    np_dtype = np.int8 if dtype == "int8" else np.float32
    for lo in range(0, total, CHUNK):
        hi = min(lo + CHUNK, total)
        got = pm1_take_chunk(lay_t, cfg_t, lo, hi, np_dtype)
        want = j_pm1_take_chunk(lay_j, cfg_j, lo, hi, np_dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"rows [{lo}, {hi})")
    if not factored or rows == 30000:
        assert total > 0  # a take buffer to generate
    # the whole buffer, chunk by chunk, is JAX's packed take buffer
    if total:
        _m, params = j_init_model(cfg_j, table_scheme="pm1")
        whole = np.concatenate([pm1_take_chunk(lay_t, cfg_t, lo, min(lo + CHUNK, total),
                                               np_dtype) for lo in range(0, total, CHUNK)])
        np.testing.assert_array_equal(whole, np.asarray(params["tables"].take_buffer))


@pytest.mark.parametrize("factored", [False, True], ids=["factored_off", "factored_on"])
@pytest.mark.parametrize("stripes", [16, 1])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("rows", [4000, 30000])
def test_fill_pm1_take_byte_equal_to_pm1_take_chunk(rows, dtype, stripes, factored):
    """The torch generator writes, into a zeroed slice of buffer rows
    [lo, hi), the bytes of the numpy reference, in 777-row slices and in
    steps of 100 rows within each (both cross table and stripe
    boundaries)."""
    cfg = criteo(TC, rows, dtype, stripes, factored)
    lay = ModelPlan.create(cfg).layout
    total = lay.take_phys_total
    if not factored or rows == 30000:
        assert total > 0  # a take buffer to generate
    np_dtype, t_dtype = ((np.int8, torch.int8) if dtype == "int8"
                         else (np.float32, torch.float32))
    for lo in range(0, total, CHUNK):
        hi = min(lo + CHUNK, total)
        buf = torch.zeros((hi - lo, lay.take_lanes), dtype=t_dtype)
        got = fill_pm1_take(buf, lay, cfg, lo, chunk_rows=100)
        np.testing.assert_array_equal(got.numpy(), pm1_take_chunk(lay, cfg, lo, hi, np_dtype),
                                      err_msg=f"rows [{lo}, {hi})")


GEN_CASES = ["criteo_30000", "criteo_4000_s1", "tiers", "striped", "qr", "lanes256",
             "model1_tiers"]


def gen_config(name, dtype):
    if name == "criteo_30000":
        cfg = criteo(TC, 30000)
    elif name == "criteo_4000_s1":
        cfg = criteo(TC, 4000, stripes=1, factored=False)
    else:
        cfg = variant(name, TC)
    return dataclasses.replace(cfg, table_dtype=dtype)


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert torch.equal(a, b), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", GEN_CASES)
def test_device_generator_equals_pack_tables(name, dtype):
    """pack_pm1_sharded on the CPU (no mesh: the whole buffer) writes the
    bytes pack_tables writes for the pm1 reference tables, in small chunks
    (and its default chunk), with the same scales and plan constants."""
    cfg = gen_config(name, dtype)
    want = init_model(cfg, device=CPU).packed
    for chunk in (CHUNK, 1 << 22):
        got = pack_pm1_sharded(cfg, want.layout, device=CPU, chunk_rows=chunk)
        _same(got.take_buffer, want.take_buffer, "take")
        _same(got.take_scales, want.take_scales, "take scales")
        assert len(got.onehot_buffers) == len(want.onehot_buffers)
        for i, (a, b) in enumerate(zip(got.onehot_buffers, want.onehot_buffers)):
            _same(a, b, f"class {i}")
        assert (got.onehot_scales is None) == (want.onehot_scales is None)
        for i, (a, b) in enumerate(zip(got.onehot_scales or [], want.onehot_scales or [])):
            _same(a, b, f"class {i} scales")
        assert got.plan.keys() == want.plan.keys()
        for k in got.plan:
            _same(got.plan[k], want.plan[k], k)


def test_device_generator_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = criteo(TC, 4000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_pm1_sharded(cfg, ModelPlan.create(cfg).layout)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name,dtype", [("criteo_30000", "int8"), ("criteo_30000", "float32"),
                                        ("criteo_4000_s1", "int8"), ("striped", "bfloat16"),
                                        ("qr", "float32")])
def test_windows_equal_shard_operands_slices(name, dtype, M):
    """Rank m's generated window is shard m's slice of the whole model's
    take buffer, the zero pad rows past its end included; its operands
    (packed_operands, window_only) are shard_operands' field by field."""
    cfg = gen_config(name, dtype)
    model = init_model(cfg, device=CPU)
    lay = model.layout
    rows_local = -(-lay.take_phys_total // M)
    if name == "criteo_4000_s1":  # 15553 rows: the last window has pad rows
        assert lay.take_phys_total % M
    for m in range(M):
        mesh = Mesh(1, M, 0, m, None, torch.device(CPU))
        packed = pack_pm1_sharded(cfg, lay, mesh, chunk_rows=CHUNK)
        want = shard_operands(model, m, M, CPU)
        assert packed.take_buffer.shape == (rows_local, lay.take_lanes)
        _same(packed.take_buffer, want["bufs"][-1], f"window of shard {m}")
        got = packed_operands(model.plan, packed, m, M, CPU, window_only=True)
        assert got.keys() == want.keys()
        for k in want:
            if k in ("bufs", "scales"):
                assert (got[k] is None) == (want[k] is None)
                for i, (a, b) in enumerate(zip(got[k] or [], want[k] or [])):
                    _same(a, b, f"{k}[{i}] of shard {m}")
            elif isinstance(want[k], torch.Tensor):
                _same(got[k], want[k], k)
            else:
                assert got[k] == want[k], k
        # the window is taken as it is: no copy on its own device
        assert got["bufs"][-1].data_ptr() == packed.take_buffer.data_ptr()


def test_a_window_of_the_wrong_rows_is_refused():
    cfg = gen_config("criteo_30000", "int8")
    model = init_model(cfg, device=CPU)
    packed = pack_pm1_sharded(cfg, model.layout, Mesh(1, 2, 0, 0, None, torch.device(CPU)))
    with pytest.raises(ValueError, match="take window of shard 0 of 4"):
        packed_operands(model.plan, packed, 0, 4, CPU, window_only=True)


@pytest.mark.parametrize("name", ["micro_dlrm", "micro_cross"])
def test_from_packed_refuses_an_interaction_head(name):
    cfg = getattr(TC, name)(batch_size=8)
    plan = ModelPlan.create(cfg)
    mesh = Mesh(1, 1, 0, 0, None, torch.device(CPU))
    packed = pack_pm1_sharded(cfg, plan.layout, mesh)
    with pytest.raises(ValueError, match="interaction head"):
        ShardedFleetRec.from_packed(plan, packed, mesh, [])


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("stripes", [16, 1])
def test_chip_smoke_addressing_check(stripes, M):
    """chip_smoke.py's addressing check of the full-cardinality phase on
    capped criteo (int8): over take rows that hold their index pattern, the
    edge targets of every window read their own row's pattern through the
    shard's operands (zeros outside its window), and a pattern written one
    row off is caught."""
    cfg = criteo(TC, 30000, "int8", stripes)
    plan = ModelPlan.create(cfg)
    lay = plan.layout
    rows_local = -(-lay.take_phys_total // M)
    windows = [(m * rows_local, min((m + 1) * rows_local, lay.take_phys_total))
               for m in range(M)]
    targets = cs.edge_targets(cfg, lay, windows)
    assert len({P for _j, _r, P, _s in targets}) >= 2 * len(cs.take_segments(lay, cfg))
    big = max(range(cfg.num_tables), key=lambda j: cfg.tables[j].rows)
    assert any(j == big and r == cfg.tables[big].rows - 1 for j, r, _P, _s in targets)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(cs.pattern_ids(cfg, targets, 1024, rng))
    dense = torch.from_numpy(rng.choice([-1.0, 1.0], (1024, cfg.dense_dim)).astype(np.float32))
    inside = 0
    for m in range(M):
        mesh = Mesh(1, M, 0, m, None, torch.device(CPU))
        packed = pack_pm1_sharded(cfg, lay, mesh, chunk_rows=CHUNK)
        ops = packed_operands(plan, packed, m, M, CPU, window_only=True)
        lo, n = ops["window"]
        cs.fill_row_pattern(ops["bufs"][-1], lo, chunk_rows=CHUNK)
        d = dense if m == 0 else None
        n_in, err = cs.check_addressing(cfg, lay, ops, ids, d, targets, (lo, n))
        assert err == 0
        inside += n_in
        cs.fill_row_pattern(ops["bufs"][-1], lo + 1, chunk_rows=CHUNK)
        with pytest.raises(AssertionError, match="pattern of its row"):
            cs.check_addressing(cfg, lay, ops, ids, d, targets, (lo, n))
    assert inside == len(targets)


WORLD_NAMES = ("criteo_30000", "criteo_30000_int8")
B = 16
BAD_ROWS = (3, 11)


def world_inputs(tmp_path):
    """Per config: uniform ids over every table (the row-id parity picks
    each feature's sign), a too-large id in a take table on BAD_ROWS, and
    dense of ±1 (integer sums: every path is exact)."""
    rng = np.random.default_rng(12)
    data = {}
    for name in WORLD_NAMES:
        cfg = case_config(TC, name)
        idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
        big = max(range(cfg.num_tables), key=lambda j: cfg.tables[j].rows)
        idx[list(BAD_ROWS), big] = cfg.tables[big].rows
        data[f"{name}/idx"] = idx
        data[f"{name}/dense"] = rng.choice([-1.0, 1.0], (B, cfg.dense_dim)).astype(np.float32)
    path = tmp_path / "inputs.npz"
    np.savez(path, **data)
    return data, str(path)


def _jax_generated(name, idx, dense):
    """JAX's ShardedFleetRec over its pack_pm1_sharded on the (1, 8) mesh."""
    cfg = case_config(JC, name)
    model, params = j_init_model(cfg, table_scheme="pm1", mlp_scheme="ones")
    mesh = j_make_mesh(data=1, model=8)
    sh = JSharded(model, mesh)
    packed = j_pack_pm1_sharded(cfg, model.layout, mesh)
    sp = sh.shard_params({**params, "tables": packed})
    si, sd = sh.shard_batch(jnp.asarray(idx), jnp.asarray(dense))
    return np.asarray(sh.forward(sp, si, sd))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_sharded_from_generated_windows_bit_equal(tmp_path, shape):
    D, M = shape
    data, path = world_inputs(tmp_path)
    res = spawn_world(D * M, run_generated, (D, M, WORLD_NAMES, path), tmp_path)
    for name in WORLD_NAMES:
        cfg = case_config(TC, name)
        lay = ModelPlan.create(cfg).layout
        rows_local = -(-lay.take_phys_total // M)
        item = 1 if cfg.table_dtype == "int8" else 4
        for r in res:
            assert r[name]["take_shape"] == (rows_local, lay.take_lanes)
            assert r[name]["take_bytes"] == rows_local * lay.take_lanes * item
        # a data row's scores: its leader's (every rank of the row has them)
        for key in ("generated", "whole"):
            for d in range(D):
                for m in range(1, M):
                    np.testing.assert_array_equal(res[d * M + m][name][key],
                                                  res[d * M][name][key])
        got = np.concatenate([res[d * M][name]["generated"] for d in range(D)])
        whole = np.concatenate([res[d * M][name]["whole"] for d in range(D)])
        want_j = _jax_generated(name, data[f"{name}/idx"], data[f"{name}/dense"])
        nan = np.zeros(B, bool)
        nan[list(BAD_ROWS)] = True
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got, whole)
        np.testing.assert_array_equal(got, want_j)
