"""The port's model path (models/embedding.py, models/mlp.py,
models/fleetrec.py, convert.py) against the JAX package on the same
inputs, made from a numpy seed: equal layouts, bit-equal packed buffers,
bit-equal lookups, and forwards within a stated tolerance (bit-equal on the
pm1 / all-ones parity data).  On the CPU the port runs its plain PyTorch
path; the JAX side runs as its own tests run it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models import embedding as jemb
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import ModelPlan, init_model
from fleetrec_tpu_torch.models import embedding as temb
from torch_variants import CPU, LAYOUT_CASES, PAPER, cap, variant

def _np(t):
    """Port tensor -> numpy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _ids(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, t.rows, B) for t in cfg.tables],
                    1).astype(np.int32)


def _dense(cfg, B, seed):
    if not cfg.dense_dim:
        return None
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, cfg.dense_dim)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jax_pair(cfg, tables, mlp_np=None, mlp_scheme="ones"):
    model, params = j_init_model(cfg, tables_np=tables, mlp_np=mlp_np,
                                 mlp_scheme=mlp_scheme)
    return model, params, jax.tree_util.tree_map(np.asarray, params)


# ---- plan and packing -----------------------------------------------------

@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo_full", "model3_full", "dlrm_full"])
def test_layout_and_plan_equal(name):
    if name == "criteo_full":
        jc, tc = JC.criteo_terabyte(), TC.criteo_terabyte()
    elif name == "model3_full":
        jc, tc = JC.fleetrec_model3(), TC.fleetrec_model3()
    elif name == "dlrm_full":
        jc, tc = JC.dlrm_terabyte(), TC.dlrm_terabyte()
    else:
        jc, tc = variant(name, JC), variant(name, TC)
    jm, tp = JModel.create(jc), ModelPlan.create(tc)
    assert dataclasses.asdict(jm.layout) == dataclasses.asdict(tp.layout)
    assert jm.index_perm == tp.index_perm
    assert jm.qr_positions == tp.qr_positions
    assert ([dataclasses.asdict(t) for t in jm.spec_tables]
            == [dataclasses.asdict(t) for t in tp.spec_tables])


@pytest.mark.parametrize("name,table_dtype,scheme", [
    ("micro", "float32", "rowid"), ("fleetrec_model1", "float32", "rowid"),
    ("fleetrec_model2", "float32", "rowid"), ("fleetrec_model3", "float32", "rowid"),
    ("fleetrec_model3", "int8", "pm1"), ("tiers", "int8", "uniform"),
    ("model1_tiers", "bfloat16", "uniform"), ("striped", "float32", "rowid"),
    ("qr", "float32", "rowid"),
])
def test_pack_tables_bit_equal(name, table_dtype, scheme):
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    jm = JModel.create(jc)
    tables = [jref.init_table(t, scheme) for t in jm.spec_tables]
    _, _, pj = _jax_pair(jc, tables)
    model = init_model(tc, tables_np=tables, device=CPU)
    pt = model.packed
    assert len(pt.onehot_buffers) == len(pj["tables"].onehot_buffers)
    for a, b in zip(pj["tables"].onehot_buffers, pt.onehot_buffers):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(_jnp(a), _np(b))
    if pj["tables"].take_buffer is None:
        assert pt.take_buffer is None
    else:
        np.testing.assert_array_equal(_jnp(pj["tables"].take_buffer), _np(pt.take_buffer))
    if table_dtype == "int8":
        for a, b in zip(pj["tables"].onehot_scales, pt.onehot_scales):
            np.testing.assert_array_equal(a.reshape(-1), b.numpy())
        if pt.take_scales is not None:
            np.testing.assert_array_equal(pj["tables"].take_scales, pt.take_scales.numpy())
    # the converted JAX params and the port's own packing are the same model
    conv = params_from_jax(tc, pj, device=CPU)
    for (ka, a), (kb, b) in zip(conv.named_buffers(), model.named_buffers()):
        assert ka == kb
        assert torch.equal(a, b), ka


# ---- lookup ---------------------------------------------------------------

@pytest.mark.parametrize("name,table_dtype,scheme", [
    ("micro", "float32", "rowid"), ("fleetrec_model1", "float32", "rowid"),
    ("fleetrec_model2", "float32", "rowid"), ("fleetrec_model3", "float32", "rowid"),
    ("tiers", "float32", "rowid"), ("model1_tiers", "float32", "rowid"),
    ("tiers", "int8", "pm1"), ("model1_tiers", "bfloat16", "rowid"),
    ("lanes64", "float32", "rowid"), ("micro", "bfloat16", "rowid"),
    ("lanes128", "float32", "rowid"), ("lanes256", "float32", "rowid"), ("striped", "float32", "rowid"),
    ("qr", "float32", "uniform"),
])
def test_lookup_concat_bit_equal(name, table_dtype, scheme):
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    jm, jp, pj = _jax_pair(jc, [jref.init_table(t, scheme)
                                for t in JModel.create(jc).spec_tables])
    model = params_from_jax(tc, pj, device=CPU)
    B = jc.batch_size
    idx, dense = _ids(jc, B, 3), _dense(jc, B, 4)
    gi_j = jm.plan_indices(jnp.asarray(idx))
    want = np.asarray(jemb.lookup_concat(jp["tables"], gi_j,
                                         None if dense is None else jnp.asarray(dense)))
    with torch.no_grad():
        gi_t = model.plan_indices(_t(idx))
        np.testing.assert_array_equal(np.asarray(gi_j), gi_t.numpy())
        got = temb.lookup_concat(model.packed, gi_t, _t(dense))
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                         "int8": torch.float32}[table_dtype]
    np.testing.assert_array_equal(_jnp(want), _np(got))
    # and against the float64 oracle for the exact storage types
    if table_dtype == "float32" and name != "qr":
        tables = [jref.init_table(t, scheme) for t in jc.tables]
        np.testing.assert_array_equal(
            _np(got), jref.gather_concat(jc, tables, idx, dense))


def test_lookup_counts_one_gather_per_tier():
    tc = variant("model1_tiers", TC)
    model = init_model(tc, device=CPU)
    lay = model.layout
    tiers = temb.tier_gathers(model.packed, model.plan_indices(_t(_ids(tc, 16, 0))))
    assert len(tiers) == len(lay.onehot_classes) + len(lay.take_groups)
    assert {t.name.split()[0] for t in tiers} == {"class", "factored", "take"}
    for t in tiers:
        assert t.ids.dtype == torch.int64 and t.ids.numel() == 16 * t.n
        assert t.table.shape[1] == t.dim


# ---- forward --------------------------------------------------------------

@pytest.mark.parametrize("name", ["micro", "fleetrec_model1", "tiers",
                                  "model1_tiers", "striped", "qr"])
def test_forward_matches_jax_uniform(name):
    """Uniform tables and weights: rtol/atol 1e-5, the fp32 sums run in
    another order."""
    jc, tc = variant(name, JC), variant(name, TC)
    jm = JModel.create(jc)
    tables = [jref.init_table(t, "uniform") for t in jm.spec_tables]
    ws = jref.init_mlp_weights(jc, "uniform")
    jm, jp, pj = _jax_pair(jc, tables, mlp_np=ws)
    model = params_from_jax(tc, pj, device=CPU)
    B = jc.batch_size
    idx, dense = _ids(jc, B, 5), _dense(jc, B, 6)
    want = np.asarray(jax.jit(jm.forward)(jp, jnp.asarray(idx),
                                          None if dense is None else jnp.asarray(dense)))
    with torch.no_grad():
        got = model(_t(idx), _t(dense)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,table_dtype", [
    ("micro", "float32"), ("model1_tiers", "float32"), ("tiers", "int8"),
    ("fleetrec_model3", "int8"), ("striped", "float32"),
])
def test_forward_pm1_ones_bit_equal(name, table_dtype):
    """pm1 tables, all-ones weights, ones dense: integer-valued, so the
    scores are exact and equal in both packages and the oracle."""
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    tables = jref.init_tables(jc, "pm1")
    jm, jp, pj = _jax_pair(jc, tables)
    model = params_from_jax(tc, pj, device=CPU)
    B = jc.batch_size
    idx = _ids(jc, B, 7)
    dense = np.ones((B, jc.dense_dim), np.float32) if jc.dense_dim else None
    want = np.asarray(jax.jit(jm.forward)(jp, jnp.asarray(idx),
                                          None if dense is None else jnp.asarray(dense)))
    with torch.no_grad():
        got = model(_t(idx), _t(dense)).numpy()
    np.testing.assert_array_equal(got, want)
    golden = jref.forward(jc, tables, jref.init_mlp_weights(jc, "ones"), idx, dense)
    np.testing.assert_array_equal(got, golden.astype(np.float32))


@pytest.mark.parametrize("name", ["model1_tiers", "striped", "lanes256"])
def test_out_of_range_take_ids_poison_the_same_rows(name):
    """Out-of-range and negative take ids: NaN scores on the same rows in
    both packages; features and scores of the other rows agree."""
    jc, tc = variant(name, JC), variant(name, TC)
    jm = JModel.create(jc)
    tables = [jref.init_table(t, "uniform") for t in jm.spec_tables]
    ws = jref.init_mlp_weights(jc, "uniform")
    jm, jp, pj = _jax_pair(jc, tables, mlp_np=ws)
    model = params_from_jax(tc, pj, device=CPU)
    assert jm.layout.n_take > 0
    B = jc.batch_size
    idx, dense = _ids(jc, B, 8), _dense(jc, B, 9)
    take_ids = set(jm.layout.index_table_ids[jm.layout.n_onehot:])
    take_cols = [j for j, t in enumerate(jc.tables) if t.table_id in take_ids]
    c0, c1 = take_cols[0], take_cols[-1]
    idx[1, c0] = -1
    idx[4, c1] = jc.tables[c1].rows
    idx[6, c0] = -jc.tables[c0].rows - 5
    idx[7, c1] = 2**31 - 1
    jd = None if dense is None else jnp.asarray(dense)
    want = np.asarray(jax.jit(jm.forward)(jp, jnp.asarray(idx), jd))
    with torch.no_grad():
        got = model(_t(idx), _t(dense)).numpy()
    bad = [1, 4, 6, 7]
    np.testing.assert_array_equal(np.flatnonzero(np.isnan(want)), bad)
    np.testing.assert_array_equal(np.flatnonzero(np.isnan(got)), bad)
    ok = np.setdiff1d(np.arange(B), bad)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
    f_want = np.asarray(jemb.lookup_concat(jp["tables"], jm.plan_indices(jnp.asarray(idx)), jd))
    with torch.no_grad():
        f_got = temb.lookup_concat(model.packed, model.plan_indices(_t(idx)), _t(dense))
    np.testing.assert_array_equal(f_got.numpy()[ok], f_want[ok])


def test_negative_ids_floor_like_jnp():
    """QR split and take arithmetic on negative ids: floored // and %."""
    jc, tc = variant("qr", JC), variant("qr", TC)
    jm, tp = JModel.create(jc), init_model(tc, device=CPU)
    idx = _ids(jc, 24, 10)
    idx[:, :] = np.random.default_rng(11).integers(-300, 300, idx.shape)
    np.testing.assert_array_equal(np.asarray(jm.plan_indices(jnp.asarray(idx))),
                                  tp.plan_indices(_t(idx)).numpy())
    lay = tp.layout
    tidx = torch.arange(-40, 40, dtype=torch.int32)[:, None].expand(-1, lay.n_take)
    phys, sub = temb.take_phys_sub(lay, tidx, tp.plan_take_base, tp.plan_take_s)
    jphys, jsub = jemb.take_phys_sub(jm.layout, jnp.asarray(tidx.numpy()))
    np.testing.assert_array_equal(np.asarray(jphys), phys.numpy())
    np.testing.assert_array_equal(np.asarray(jsub), sub.numpy())


@pytest.mark.parametrize("width,expected", [(512, 68719476736.0), (1024, 137438953472.0)])
def test_closed_form_parity_constant(width, expected):
    """Twin of test_parity.py::test_closed_form_parity_constant."""
    model = init_model(TC.parity_synthetic(width, batch_size=8), device=CPU)
    with torch.no_grad():
        scores = model(torch.zeros((8, 0), dtype=torch.int32), torch.ones(8, width))
    np.testing.assert_array_equal(scores.numpy(), np.full(8, expected, np.float32))


@pytest.mark.parametrize("name", ["micro_test", "fleetrec_model1"])
def test_end_to_end_vs_oracle(name):
    """Twin of test_parity.py::test_end_to_end_vs_oracle (rows capped at
    256; rtol 1e-3 / atol 2e-3 against the float64 oracle)."""
    cfg = TC.get_config(name, batch_size=8)
    cfg = cap(cfg, 256)
    tables = jref.init_tables(cfg, "uniform")
    ws = jref.init_mlp_weights(cfg, "uniform")
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
    idx, dense = _ids(cfg, 8, 0), _dense(cfg, 8, 1)
    with torch.no_grad():
        scores = model(_t(idx), _t(dense)).numpy()
    np.testing.assert_allclose(scores, jref.forward(cfg, tables, ws, idx, dense),
                               rtol=1e-3, atol=2e-3)


def test_forward_checks_shapes():
    model = init_model(TC.micro_test(batch_size=4), device=CPU)
    with pytest.raises(ValueError):
        model(torch.zeros((4, 3), dtype=torch.int32), torch.zeros(4, 8))
    with pytest.raises(ValueError):
        model(torch.zeros((4, 8), dtype=torch.int32), None)
