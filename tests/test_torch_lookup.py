"""The fused lookup (``FleetRecModel.lookup`` -> ``ops/lookup.py::
lookup_fused``, which runs ``lookup_fused_plain`` on the CPU) against the
JAX package on the same inputs, made from a numpy seed: JAX's
``plan_indices`` -> ``lookup_concat`` and ``take_bad_rows``, and the port's
own ``lookup_concat(plan_indices(...))``.  Features and flags must be
bit-equal; the descriptors of ``models/embedding.py::lookup_tensors`` must
cover every output column once and hold no pointer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models import embedding as jemb
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import ModelPlan, init_model
from fleetrec_tpu_torch.models import embedding as temb
from fleetrec_tpu_torch.ops import lookup as tlk
from chip_smoke import ids_with_bad
from torch_variants import CPU, LAYOUT_CASES, variant

DTYPES = ["float32", "bfloat16", "int8"]
OUT_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.float32}


def _bits(a):
    """numpy bits of a port tensor or a JAX array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


def _dense(cfg, B, seed):
    if not cfg.dense_dim:
        return None
    return np.random.default_rng(seed).uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)


def _pair(name, table_dtype, scheme="uniform"):
    """(JAX model, JAX params, the port's model converted from them, cfg)."""
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    tables = [jref.init_table(t, scheme) for t in JModel.create(jc).spec_tables]
    jm, jp = j_init_model(jc, tables_np=tables)
    return jm, jp, params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp), device=CPU), tc


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_fused_lookup_bit_equal_to_jax(name, table_dtype, id_dtype):
    jm, jp, model, cfg = _pair(name, table_dtype)
    B = cfg.batch_size
    idx, dense = ids_with_bad(cfg, B, np.random.default_rng(3)), _dense(cfg, B, 4)
    jd = None if dense is None else jnp.asarray(dense)
    gi = jm.plan_indices(jnp.asarray(idx))
    want = np.asarray(jemb.lookup_concat(jp["tables"], gi, jd))
    lay = jm.layout
    want_bad = (np.asarray(jemb.take_bad_rows(lay, gi[:, lay.n_onehot:]))
                if lay.n_take else None)
    ti = torch.from_numpy(idx).to(id_dtype)
    td = None if dense is None else torch.from_numpy(dense)
    with torch.no_grad():
        got, bad = model.lookup(ti, td)
        port = temb.lookup_concat(model.packed, model.plan_indices(ti), td)
    assert got.dtype == OUT_DTYPE[table_dtype] and got.shape == (B, lay.feature_dim)
    # the port's own tier-by-tier lookup, every row
    np.testing.assert_array_equal(_bits(got), _bits(port))
    if want_bad is None:
        assert bad is None
        ok = np.arange(B)
    else:
        # JAX reads a bad take id as NaN or a wrapped row; the port as a zero
        # row: both poison the row's score, so only the flags are compared
        np.testing.assert_array_equal(bad.numpy(), want_bad)
        assert want_bad[1:5].any()
        ok = np.flatnonzero(~want_bad)
    np.testing.assert_array_equal(_bits(got)[ok], _bits(want)[ok])


@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo", "model3_full", "criteo_full",
                                  "dlrm_full"])
def test_descriptors_cover_each_output_column_once(name):
    """Every output column reads exactly one source: one element of one
    visible table (each once), one dense column (each once) or a zero; a QR
    quotient column adds its remainder table's same element; the plan
    columns' rows hold ids, offsets and limits, no pointer."""
    full = {"model3_full": TC.fleetrec_model3, "criteo_full": TC.criteo_terabyte,
            "dlrm_full": TC.dlrm_terabyte}
    cfg = full[name]() if name in full else variant(name, TC)
    mp = ModelPlan.create(cfg)
    lay = mp.layout
    d = temb.lookup_tensors(lay, mp.index_perm, mp.qr_positions, "cpu")
    cols, pos = d["cols"].numpy(), d["pos"].numpy()
    F = tlk._F
    assert cols.dtype == np.int64 and pos.dtype == np.int32
    assert cols.shape == (lay.n_onehot + lay.n_take, len(tlk.LOOKUP_COL_FIELDS))
    assert pos.shape == (lay.feature_dim, 2)
    src = ((pos[:, 0] & 0xFFFF) ^ 0x8000) - 0x8000
    add, off = pos[:, 0] >> 16, pos[:, 1] & tlk.OFF_MASK
    table_cols = src >= 0
    dense_cols = src == tlk.POS_DENSE
    assert np.all(table_cols | dense_cols | (src == tlk.POS_ZERO))
    # each (plan column, offset) at most once, inside the column's row
    pairs = set(zip(src[table_cols].tolist(), off[table_cols].tolist()))
    assert len(pairs) == table_cols.sum()
    assert np.all(off[table_cols] < cols[src[table_cols], F["dim"]])
    # every visible table whole; the QR remainder tables only as additions
    hidden = {k for k in range(len(cols)) if cols[k, F["op"]] == tlk.OP_MOD}
    shown = {k for k, _ in pairs}
    assert shown == set(range(len(cols))) - hidden
    assert len(pairs) == sum(cols[k, F["dim"]] for k in shown)
    assert set(add[add >= 0].tolist()) == hidden
    assert np.all(cols[add[add >= 0], F["op"]] == tlk.OP_MOD)
    # the dense tail, each column once, at the end
    np.testing.assert_array_equal(np.flatnonzero(dense_cols),
                                  np.arange(lay.feature_dim - lay.dense_dim, lay.feature_dim))
    np.testing.assert_array_equal(off[dense_cols], np.arange(lay.dense_dim))
    # a VEC4 / VEC8 bit starts an aligned run of one source (or zeros)
    widths = np.append(cols[:, F["dim"]], lay.dense_dim)
    for bit, n in ((tlk.VEC4, 4), (tlk.VEC8, 8)):
        for p in np.flatnonzero(pos[:, 1] & bit):
            c, a, o = src[p:p + n], add[p:p + n], off[p:p + n]
            assert p % n == 0 and len(c) == n and len(set(c)) == len(set(a)) == 1
            assert c[0] == tlk.POS_ZERO or (
                o[0] % n == 0 and np.array_equal(o - o[0], np.arange(n))
                and widths[c[0] if c[0] >= 0 else -1] % n == 0)
    # ids, codes, offsets and limits: nothing the size of a device pointer
    assert np.all(cols[:, F["src"]] < cfg.num_tables)
    assert np.all(cols[:, F["lim"]] <= np.iinfo(np.int32).max)
    assert np.all(cols[:, F["buf"]] <= len(lay.onehot_classes))
    assert cols.max(initial=0) < max(lay.take_phys_total, 1 << 31)


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_loaded_models_give_the_same_features(tmp_path, table_dtype):
    """init_model, params_from_jax and save_npz -> load_npz build the same
    descriptors, and their lookups the same features and flags; the
    checkpoint holds no descriptor."""
    name = "model1_tiers"
    jm, jp, conv, cfg = _pair(name, table_dtype)
    tables = [jref.init_table(t, "uniform") for t in jm.spec_tables]
    built = init_model(cfg, tables_np=tables, device=CPU)
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, built)
    with np.load(path) as data:
        assert not [k for k in data.files if "lookup" in k]
    loaded = tio.load_npz(path, cfg, device=CPU)
    idx = torch.from_numpy(ids_with_bad(cfg, 40, np.random.default_rng(5)))
    with torch.no_grad():
        want, want_bad = built.lookup(idx)
        for other in (conv, loaded):
            assert torch.equal(other.lookup_cols, built.lookup_cols)
            assert torch.equal(other.lookup_pos, built.lookup_pos)
            got, bad = other.lookup(idx)
            np.testing.assert_array_equal(_bits(got), _bits(want))
            assert torch.equal(bad, want_bad)


def test_forward_runs_the_fused_lookup(monkeypatch):
    """The forward's features are FleetRecModel.lookup's: one lookup_fused
    call a forward, no gather_rows call; the flagged rows' scores are NaN."""
    from fleetrec_tpu_torch.models import fleetrec as tfr

    cfg = variant("model1_tiers", TC)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return tlk.lookup_fused(*a, **kw)

    monkeypatch.setattr(tfr, "lookup_fused", spy)
    monkeypatch.setattr(temb, "gather_rows", lambda *a: pytest.fail("gather_rows called"))
    idx = torch.from_numpy(ids_with_bad(cfg, 16, np.random.default_rng(6)))
    with torch.no_grad():
        scores = model(idx)
    assert calls == [(16, cfg.num_tables)]
    _, bad = model.lookup(idx)
    np.testing.assert_array_equal(np.isnan(scores.numpy()), bad.numpy())


def test_lookup_fused_checks_its_inputs():
    model = init_model(variant("micro", TC), device=CPU)
    ops = model.lookup_operands()
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        tlk.lookup_fused(ids.float(), None, **ops)
    with pytest.raises(ValueError):
        tlk.lookup_fused(ids, torch.zeros(3, 8), **ops)
    with pytest.raises(ValueError):
        tlk.lookup_fused(ids, None, **{**ops, "cols": ops["cols"][:, :3]})
    with pytest.raises(ValueError):  # float buffers with scales
        tlk.lookup_fused(ids, None, **{**ops, "scales": [torch.ones(1)] * 4})
    # the descriptors read a dense tail: dense must be there, at its width
    # (the kernel would read through a null or short row)
    assert ops["dense_dim"] > 0
    for dense in (None, torch.zeros(4, ops["dense_dim"] + 1), torch.zeros(4, 0)):
        with pytest.raises(ValueError, match="dense"):
            tlk.lookup_fused(ids, dense, **ops)
        with pytest.raises(ValueError, match="dense"):
            tlk.lookup_fused_plain(ids, dense, **ops)
    cfg1 = variant("model1_tiers", TC)
    no_dense = init_model(cfg1, device=CPU).lookup_operands()
    ids1 = torch.zeros((4, cfg1.num_tables), dtype=torch.int32)
    assert no_dense["dense_dim"] == 0
    with pytest.raises(ValueError, match="dense"):
        tlk.lookup_fused(ids1, torch.zeros(4, 3), **no_dense)
    assert tlk.lookup_fused(ids1, torch.zeros(4, 0), **no_dense)[0].shape == (4, cfg1.feature_dim)
    assert tlk.launch_shape(4096, 352, 47, 132) == (10, 410)
    assert tlk.launch_shape(1024, 352, 47, 132) == (2, 512)
    assert tlk.launch_shape(4096, 3968, 376, 132) == (1, 528)
    # a sweep's (rows, blocks an SM); rows halve until a tile fits
    assert tlk.launch_shape(4096, 352, 47, 132, 16, 1) == (16, 132)
    assert tlk.launch_shape(4096, 28_800, 10, 132, 16) == (4, 528)
    with pytest.raises(ValueError):
        tlk.launch_shape(8, 30000, 10, 132)


def test_lookup_sweep_tables_its_points():
    """utils/lookup_sweep.py's table: a row per rows-a-tile, a column per
    blocks an SM, the default point starred, the best one named; with no
    CUDA device the sweep exits nonzero."""
    from fleetrec_tpu_torch.utils import lookup_sweep as ls

    pts = [{"shape": "s B=8", "tile": None, "rows": 2, "grid": 4, "blocks_per_sm": 4,
            "default": True, "ms": 0.24}]
    pts += [{"shape": "s B=8", "tile": (r, b), "rows": r, "grid": 4, "blocks_per_sm": b,
             "default": (r, b) == (2, 4), "ms": r * 0.1 + b * 0.01}
            for r in (1, 2) for b in ls.BLOCKS]
    lines = ls.table(pts)
    assert lines[0] == ("s B=8: default (rows 2, grid 4) 0.2400 ms; best 0.1100 ms at "
                        "rows 1 and 1 blocks an SM")
    assert lines[-1] == "| 2 | 0.2100 | 0.2200 | 0.2400* | 0.2800 |"
    assert len(lines) == 5
    if not torch.cuda.is_available():
        assert ls.main([]) == 1
