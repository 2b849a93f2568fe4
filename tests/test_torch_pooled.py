"""Pooled bags (``fleetrec_tpu_torch/models/pooled.py``, ``ops/lookup.py::
lookup_fused_bags``, the engine's ``bag_L`` mode) against the JAX package
(``fleetrec_tpu/models/pooled.py``, jitted on the CPU) on the same inputs,
made from a numpy seed, and against a float64 numpy oracle.  On the CPU
``lookup_fused_bags`` runs ``lookup_fused_bags_plain``, the kernel's
stand-in, which follows the kernel's arithmetic to the bit.

Tolerances.  On pm1 tables every pooled sum is a small integer, exact in
every dtype, and int8 sums are exact in int32: bit-equal.  On uniform
float32 tables the packages add the same L terms in another order: rtol
2e-6 / atol 1e-6.  In bfloat16 the JAX package rounds after each of a
factored class's L adds and multiplies the mean in bfloat16, where the
fused rule rounds once: rtol 2e-2, atol one bfloat16 ulp of the largest
possible sum (L * 2^-7)."""

import dataclasses
import functools
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models import pooled as jpool
from fleetrec_tpu_torch import cli
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models import pooled as tpool
from fleetrec_tpu_torch.ops import lookup as tlk
from fleetrec_tpu_torch.serving import IngestServer, ServeSpec, ServingEngine, serve
from chip_smoke import bags_with_bad, make_bags, pooled_oracle
from torch_variants import CPU, mixed, variant

L = 4
# layouts whose config has no interaction head: every tier, stripes, QR, a
# narrower take row, and model1's geometry
NAMES = ["micro", "fleetrec_model1", "tiers", "model1_tiers", "striped", "qr", "lanes64"]
DTYPES = ["float32", "bfloat16", "int8"]


def _np(t):
    """A port tensor or a JAX array as float32 / bool numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.itemsize == 2 else a


def _close(got, want, table_dtype, exact, what):
    """``exact`` (pm1 or int8 data): bit-equal; else the module docstring's
    tolerance of the storage dtype."""
    got, want = _np(got), _np(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif table_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=L * 2.0 ** -7, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6, err_msg=what)


@functools.lru_cache(maxsize=None)
def _pair(name, table_dtype, scheme):
    """(JAX model, JAX params, the port's model converted from them, cfg)."""
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    tables = [jref.init_table(t, scheme) for t in JModel.create(jc).spec_tables]
    jm, jp = j_init_model(jc, tables_np=tables,
                          mlp_np=jref.init_mlp_weights(jc, "uniform"))
    return jm, jp, params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp), device=CPU), tc


def _inputs(cfg, seed=3):
    B = max(cfg.batch_size, 8)
    rng = np.random.default_rng(seed)
    ids = bags_with_bad(cfg, B, L, rng)
    dense = (rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)
             if cfg.dense_dim else None)
    return ids, dense


@functools.lru_cache(maxsize=None)
def _jax_case(name, table_dtype, scheme, mean):
    """The JAX package's plan_bags, pooled_bad_rows, pooled_lookup_concat
    and forward_pooled on ``_inputs``, as numpy."""
    jm, jp, _model, cfg = _pair(name, table_dtype, scheme)
    ids, dense = _inputs(cfg)

    @jax.jit
    def run(p, i, d):
        planned = jpool.plan_bags(jm, i)
        return (planned, jpool.pooled_bad_rows(jm, planned),
                jpool.pooled_lookup_concat(p["tables"], planned, d, mean=mean),
                jpool.forward_pooled(jm, p, i, d, mean=mean))

    planned, bad, feats, scores = run(jp, jnp.asarray(ids),
                                      None if dense is None else jnp.asarray(dense))
    return (np.asarray(planned), None if bad is None else np.asarray(bad), _np(feats),
            np.asarray(scores))


def _ok_rows(bad, B):
    """The rows the JAX package reads no out-of-range take row for (it
    reads those as NaN or another table's row; the port as a zero row;
    both poison the score)."""
    return np.arange(B) if bad is None else np.flatnonzero(~bad)


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("scheme", ["pm1", "uniform"])
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_pooled_functions_match_jax(name, table_dtype, scheme, mean):
    """plan_bags and pooled_bad_rows equal; pooled_lookup_concat bit-equal
    on pm1 and int8 data, within the dtype's tolerance on uniform data."""
    _jm, _jp, model, cfg = _pair(name, table_dtype, scheme)
    ids, dense = _inputs(cfg)
    want_plan, want_bad, want_feats, _ = _jax_case(name, table_dtype, scheme, mean)
    ti = torch.from_numpy(ids)
    td = None if dense is None else torch.from_numpy(dense)
    with torch.no_grad():
        planned = tpool.plan_bags(model, ti)
        bad = tpool.pooled_bad_rows(model, planned)
        feats = tpool.pooled_lookup_concat(model.packed, planned, td, mean=mean)
    np.testing.assert_array_equal(planned.numpy(), want_plan)
    assert (bad is None) == (want_bad is None)
    if bad is not None:
        np.testing.assert_array_equal(bad.numpy(), want_bad)
        assert want_bad[1:4].any() and not want_bad[0] and not want_bad[4]
    ok = _ok_rows(want_bad, ids.shape[0])
    # int8 sums are exact in int32; the mean's product is not (XLA may fuse
    # it).  bfloat16 mean on pm1 data: both packages multiply the exact sum
    # by the same bfloat16 inverse count, so that is bit-equal too
    exact = scheme == "pm1" or (table_dtype == "int8" and not mean)
    _close(_np(feats)[ok], want_feats[ok], table_dtype, exact, (name, table_dtype))


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("scheme", ["pm1", "uniform"])
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_fused_bags_plain_matches_both_packages(name, table_dtype, scheme, mean):
    """lookup_fused_bags (on the CPU its plain version) against
    pooled_lookup_concat(plan_bags(..)) + pooled_bad_rows of the port (every
    row) and of the JAX package (the rows it reads no bad take row for),
    int32 and int64 ids."""
    _jm, _jp, model, cfg = _pair(name, table_dtype, scheme)
    ids, dense = _inputs(cfg)
    _, want_bad, want_feats, _ = _jax_case(name, table_dtype, scheme, mean)
    td = None if dense is None else torch.from_numpy(dense)
    with torch.no_grad():
        planned = tpool.plan_bags(model, torch.from_numpy(ids))
        port = tpool.pooled_lookup_concat(model.packed, planned, td, mean=mean)
        port_bad = tpool.pooled_bad_rows(model, planned)
        for idt in (torch.int32, torch.int64):
            got, bad = model.lookup_pooled(torch.from_numpy(ids).to(idt), td, mean)
            assert got.dtype == port.dtype and got.shape == port.shape
            assert (bad is None) == (port_bad is None)
            if bad is not None:
                assert torch.equal(bad, port_bad)
                np.testing.assert_array_equal(bad.numpy(), want_bad)
            # float32 / int8: the same float32 adds in the same order as the
            # port's tiers; bfloat16 mean and factored sums round elsewhere
            exact = table_dtype != "bfloat16" or (scheme == "pm1" and not mean)
            _close(got, port, table_dtype, exact, (name, table_dtype, "port"))
            ok = _ok_rows(want_bad, ids.shape[0])
            exact = ((scheme == "pm1" and not (mean and table_dtype == "bfloat16"))
                     or (table_dtype == "int8" and not mean))
            _close(_np(got)[ok], want_feats[ok], table_dtype, exact, (name, table_dtype, "jax"))


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_forward_pooled_matches_jax(name, table_dtype, mean):
    """forward_pooled with the JAX params tree carried across
    (params_from_jax), uniform tables and weights: rtol 1e-5 with float32
    and int8 tables (atol 1e-5 * max|score|: the tower's sums cancel);
    bfloat16 tables differ by the lookup's roundings (rtol 2e-2, atol 2e-2 *
    max|score|).  Bad rows are NaN in both."""
    _jm, _jp, model, cfg = _pair(name, table_dtype, "uniform")
    ids, dense = _inputs(cfg)
    _, want_bad, _, want = _jax_case(name, table_dtype, "uniform", mean)
    with torch.no_grad():
        got = tpool.forward_pooled(model, torch.from_numpy(ids),
                                   None if dense is None else torch.from_numpy(dense),
                                   mean=mean).numpy()
    assert got.dtype == np.float32 and got.shape == (ids.shape[0],)
    ok = _ok_rows(want_bad, ids.shape[0])
    if want_bad is not None:
        assert np.isnan(got[want_bad]).all() and np.isnan(want[want_bad]).all()
    assert np.isfinite(got[ok]).all()
    tol = 2e-2 if table_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol,
                               atol=tol * np.abs(want[ok]).max())


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", ["striped", "model1_tiers"])
def test_pooled_take_extract_window_matches_jax(name, table_dtype):
    """pooled_take_extract over a row-range shard of the take buffer
    (local_start / local_rows: clip + mask, the mean over the whole bag's
    count), and over the whole buffer, against the JAX function."""
    jm, jp, model, cfg = _pair(name, table_dtype, "pm1")
    ids, _ = _inputs(cfg)
    lay = jm.layout
    assert lay.n_take
    with torch.no_grad():
        planned = tpool.plan_bags(model, torch.from_numpy(ids))
    tidx = planned[:, lay.n_onehot:]
    # rows with a bad take id read other rows in JAX: compare the others
    ok = _ok_rows(tpool.pooled_bad_rows(model, planned).numpy(), ids.shape[0])
    total = lay.take_phys_total
    for start, rows in ((0, None), (total // 3, total // 2)):
        for mean in (False, True):
            jpacked, tpacked = jp["tables"], model.packed
            if rows is not None:
                jpacked = dataclasses.replace(
                    jpacked, take_buffer=jpacked.take_buffer[start : start + rows])
                tpacked = dataclasses.replace(
                    tpacked, take_buffer=tpacked.take_buffer[start : start + rows])
            want = jax.jit(functools.partial(
                jpool.pooled_take_extract, local_start=start, local_rows=rows, mean=mean))(
                    jpacked, jnp.asarray(tidx.numpy()), jnp.asarray((tidx >= 0).numpy()))
            with torch.no_grad():
                got = tpool.pooled_take_extract(tpacked, tidx, tidx >= 0, start, rows,
                                                mean=mean)
            assert len(got) == len(want) == len(lay.take_groups)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g)[ok], _np(w)[ok])


# -- twins of tests/test_pooled.py's single-device tests ----------------------

def _forward(model, idx, dense, mean=False):
    with torch.no_grad():
        return model.forward_pooled(torch.from_numpy(idx), torch.from_numpy(dense),
                                    mean=mean).numpy()


@pytest.mark.parametrize("mean", [False, True])
def test_pooled_matches_oracle_mixed_tiers(mean):
    cfg = mixed(TC)
    tables = ref.init_tables(cfg, scheme="pm1")
    ws = ref.init_mlp_weights(cfg, scheme="ones")
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
    idx, dense = make_bags(cfg, 16, L, all_empty_row=5)
    out = _forward(model, idx, dense, mean)
    golden = pooled_oracle(cfg, tables, ws, idx, dense, mean=mean)
    if mean:
        np.testing.assert_allclose(out, golden, rtol=1e-5, atol=1e-4)
    else:
        # pm1 sums are exact integers end to end
        np.testing.assert_array_equal(out, golden.astype(np.float32))


def test_pooled_factored_tier_and_int8():
    cfg = dataclasses.replace(TC.micro_test(batch_size=12), onehot_max=8,
                              onehot_factor_max=100, table_dtype="int8")
    tables = ref.init_tables(cfg, scheme="pm1")
    ws = ref.init_mlp_weights(cfg, scheme="ones")
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
    assert any(c.r2 for c in model.layout.onehot_classes)
    idx, dense = make_bags(cfg, 12, L, seed=3)
    golden = pooled_oracle(cfg, tables, ws, idx, dense)
    np.testing.assert_array_equal(_forward(model, idx, dense), golden.astype(np.float32))


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("name", ["mixed", "qr", "tiers", "criteo"])
def test_pooled_L1_matches_single_id_forward(name, table_dtype):
    """L = 1 with no padding: the features and flags of lookup_fused_plain
    and the scores of the single-id forward, bit for bit, sum and mean."""
    cfg = mixed(TC) if name == "mixed" else variant(name, TC)
    cfg = dataclasses.replace(cfg, table_dtype=table_dtype)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, t.rows + 2, 16) for t in cfg.tables], 1).astype(np.int32)
    ti = torch.from_numpy(idx)
    td = torch.from_numpy(rng.uniform(-1, 1, (16, cfg.dense_dim)).astype(np.float32))
    with torch.no_grad():
        want, want_bad = model.lookup(ti, td)
        single = model(ti, td)
        for mean in (False, True):
            got, bad = model.lookup_pooled(ti[:, :, None], td, mean)
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            assert bad is None or torch.equal(bad, want_bad)
            pooled = model.forward_pooled(ti[:, :, None], td, mean=mean)
            np.testing.assert_array_equal(pooled.numpy(), single.numpy())


def test_pooled_qr_config():
    """QR configs derive the Q / R columns per bag slot; pooling commutes
    with the linear QR sum."""
    cfg = dataclasses.replace(mixed(TC), qr_threshold=100, qr_rem=16)
    cfg.validate()
    tables_logical = ref.init_tables(
        dataclasses.replace(cfg, qr_threshold=0, qr_rem=0), scheme="pm1")
    ws = ref.init_mlp_weights(cfg, scheme="ones")
    model = init_model(cfg, mlp_np=ws, device=CPU)  # packs Q + R internally
    internal, qr_positions, _sum = TC.qr_expand(cfg)
    qr_at = dict(qr_positions)
    assert qr_at
    mats = []
    for pos, spec in enumerate(cfg.tables):
        if pos in qr_at:
            rem = qr_at[pos]
            Q = ref.init_table(internal[pos], scheme="pm1")
            ridx = len(cfg.tables) + [p for p, _ in qr_positions].index(pos)
            R = ref.init_table(internal[ridx], scheme="pm1")
            i = np.arange(spec.rows)
            mats.append(Q[i // rem] + R[i % rem])
        else:
            mats.append(tables_logical[pos])
    idx, dense = make_bags(cfg, 16, L, seed=7)
    golden = pooled_oracle(cfg, mats, ws, idx, dense)
    np.testing.assert_array_equal(_forward(model, idx, dense), golden.astype(np.float32))


def test_pooled_bad_id_nan_padding_ok():
    cfg = mixed(TC)
    model = init_model(cfg, device=CPU)
    idx, dense = make_bags(cfg, 16, L, seed=2, all_empty_row=4)
    idx[7, -1, 0] = 1 << 28  # beyond the last (take) table's rows
    idx[9, -1, 1] = -(1 << 28)  # any negative id is padding
    out = _forward(model, idx, dense)
    assert np.isnan(out[7])
    assert np.isfinite(np.delete(out, 7)).all()  # padding alone never poisons


def test_pooled_engine_serving_e2e():
    """Pooled bags served end to end: a TCP sender ships int32 [B, T, L]
    bags (+ dense) -> ingest ring -> ServingEngine.from_model(bag_L=L),
    fuse=2 -> scores bit-equal to the float64 oracle."""
    cfg = mixed(TC, batch_size=8)
    B, NB, FUSE = 8, 4, 2
    tables = ref.init_tables(cfg, scheme="pm1")
    ws = ref.init_mlp_weights(cfg, scheme="ones")
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
    eng = ServingEngine.from_model(model, batch_size=B, fuse=FUSE, bag_L=L)
    eng.warmup()
    batches = [make_bags(cfg, B, L, seed=20 + k) for k in range(NB)]
    payloads = [idx.tobytes() + dense.tobytes() for idx, dense in batches]
    outs = {}
    nbytes = [B * (cfg.num_tables * L + cfg.dense_dim) * 4]
    port = _free_port()
    with IngestServer(nbytes, n_slots=4, port_base=port) as ing:
        def send():
            with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
                for p in payloads:
                    s.sendall(p)

        th = threading.Thread(target=send, daemon=True)
        th.start()
        summary = eng.run_from_ingest(
            ing, NB, mode="index", timeout_ms=10_000,
            row_limits=[t.rows for t in cfg.tables],
            on_done=lambda bid, sc: outs.__setitem__(bid, np.asarray(sc)))
        th.join(5)
    assert summary["fuse"] == FUSE and summary["wire_batches"] == NB
    flat = np.concatenate([outs[g].reshape(-1, B) for g in sorted(outs)])
    for k, (idx, dense) in enumerate(batches):
        golden = pooled_oracle(cfg, tables, ws, idx, dense)
        np.testing.assert_array_equal(flat[k], golden.astype(np.float32))


def test_pooled_engine_validates_bags():
    cfg = mixed(TC, batch_size=8)
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=8, bag_L=L)
    limits = [t.rows for t in cfg.tables]
    idx, _ = make_bags(cfg, 8, L)
    eng.validate_indices(idx, limits)  # -1 padding is allowed
    bad = idx.copy()
    bad[2, 1, 0] = cfg.tables[1].rows  # one past the end
    with pytest.raises(ValueError, match="bag index out of range: batch row 2, table 1, "
                                         "slot 0"):
        eng.validate_indices(bad, limits)
    bad = idx.copy()
    bad[3, 0, 2] = -2
    with pytest.raises(ValueError, match="batch row 3, table 0, slot 2"):
        eng.validate_indices(bad, limits)
    with pytest.raises(ValueError, match="expected"):
        eng.validate_indices(idx[:, :, 0], limits)


# -- the kernel's stand-in, its checks and its launch shape --------------------

def test_lookup_fused_bags_checks_its_inputs():
    model = init_model(variant("micro", TC), device=CPU)
    ops = model.lookup_operands()
    dense = torch.zeros(4, ops["dense_dim"])
    ids = torch.zeros((4, 8, 3), dtype=torch.int32)
    assert tlk.lookup_fused_bags(ids, dense, **ops)[0].shape == (4, model.layout.feature_dim)
    with pytest.raises(TypeError):
        tlk.lookup_fused_bags(ids[:, :, 0], dense, **ops)  # [B, T]: no slot axis
    with pytest.raises(TypeError):
        tlk.lookup_fused_bags(ids[:, :, :0], dense, **ops)  # L = 0
    with pytest.raises(TypeError):
        tlk.lookup_fused_bags(ids.float(), dense, **ops)
    with pytest.raises(TypeError):
        tlk.lookup_fused(ids, dense, **ops)  # bags into the single-id lookup
    for d in (None, torch.zeros(4, ops["dense_dim"] + 1), torch.zeros(3, ops["dense_dim"])):
        with pytest.raises(ValueError, match="dense"):
            tlk.lookup_fused_bags(ids, d, **ops)
        with pytest.raises(ValueError, match="dense"):
            tlk.lookup_fused_bags_plain(ids, d, **ops)
    with pytest.raises(ValueError):
        tlk.lookup_fused_bags(ids, dense, **{**ops, "cols": ops["cols"][:, :3]})
    with pytest.raises(ValueError, match=r"indices must be \[B, 8, L\]"):
        model.forward_pooled(ids[:, :5], dense)
    with pytest.raises(ValueError, match="indices must be"):
        model.forward_pooled(ids[:, :, 0], dense)


def test_bag_launch_shape_and_shared_memory():
    """bag_smem_bytes / bags_plan: a block holds the ring of a tile's ids
    (16-byte rounded, two edge lines a slot), 8 bytes a staged output
    descriptor (a 16-byte chunk each), 40 a plan column and two tiles'
    records (bag_record_words each) and flags; rows give a block about one
    tile and halve until the blocks an SM fit, and a shape whose single row
    does not fit raises."""
    assert [tlk.bag_record_words(L) for L in (1, 3, 4, 8)] == [3, 5, 7, 11]
    assert tlk.bag_smem_bytes(88, 47, 47, 8, 16, 2, 4) == (
        16 + 2 * (16 * 47 * 8 * 4 + 32) + 8 * 88 + 40 * 47 + 8 * 16 * 47 * 11 + 8 * 16)
    assert tlk.bag_smem_bytes(88, 47, 47, 8, 16, 2, 4) == 117096
    # model1 (88 chunks of 4 float32 columns) at B = 4096 / 1024 and L = 8
    assert tlk.bags_plan(4096, 47, 8, 352, 47, 132, pos_cols=4) == tlk.BagPlan(
        4, 528, 2, 4, 31272)
    assert tlk.bags_plan(1024, 47, 8, 352, 47, 132, pos_cols=4).rows == 2
    # model3 (376 bags a row, 992 chunks): one row a tile at L = 4
    assert tlk.bags_plan(4096, 376, 4, 3968, 376, 132, pos_cols=4) == tlk.BagPlan(
        1, 528, 2, 4, 56152)
    # explicit rows are kept; the grid follows them
    assert tlk.bags_plan(4096, 47, 8, 352, 47, 132, rows=16, blocks_per_sm=4,
                         pos_cols=4).grid == 256
    assert tlk.bags_plan(4096, 47, 64, 352, 47, 132, pos_cols=4).rows == 1
    with pytest.raises(ValueError, match="shared memory"):
        tlk.bags_plan(4096, 376, 64, 3968, 376, 132, pos_cols=4)


def test_forward_pooled_runs_one_fused_bag_lookup(monkeypatch):
    """One lookup_fused_bags call a pooled forward, no lookup_fused and no
    gather_rows call; the flagged rows' scores are NaN."""
    from fleetrec_tpu_torch.models import embedding as temb
    from fleetrec_tpu_torch.models import fleetrec as tfr

    cfg = variant("model1_tiers", TC)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    calls = []

    def spy(*a, **kw):
        calls.append((a[0].shape, kw["mean"]))
        return tlk.lookup_fused_bags(*a, **kw)

    monkeypatch.setattr(tfr, "lookup_fused_bags", spy)
    monkeypatch.setattr(tfr, "lookup_fused", lambda *a, **k: pytest.fail("lookup_fused called"))
    monkeypatch.setattr(temb, "gather_rows", lambda *a: pytest.fail("gather_rows called"))
    idx = torch.from_numpy(bags_with_bad(cfg, 16, L, np.random.default_rng(6)))
    with torch.no_grad():
        scores = model.forward_pooled(idx, mean=True)
        _, bad = model.lookup_pooled(idx, mean=True)
    assert calls == [((16, cfg.num_tables, L), True)] * 2
    assert bad.any() and not bad.all()
    np.testing.assert_array_equal(np.isnan(scores.numpy()), bad.numpy())


# -- the refusals ---------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("name", ["micro_dlrm", "micro_cross"])
def test_bags_refuse_an_interaction_head(name):
    """The JAX package's forward_pooled runs the plain tower whatever
    cfg.interaction says; the port raises for a DLRM dot head, in the model
    and in the engine, and serves bags to a DCNv2 cross head: scores served
    over the wire equal ``forward_pooled`` to the bit and the float64
    oracle (the bags' sums, the cross layers, the tower)."""
    cfg = TC.get_config(name, batch_size=8)
    if name == "micro_cross":
        tables = ref.init_tables(cfg, scheme="pm1")
        ws = ref.init_mlp_weights(cfg, scheme="uniform", seed=1)
        cross = ref.init_cross_weights(cfg, scheme="uniform", seed=1)
        model = init_model(cfg, tables_np=tables, mlp_np=ws, mlp_scheme="uniform", seed=1,
                           device=CPU)
        batches = [make_bags(cfg, 8, L, seed=30 + k) for k in range(2)]
        eng = ServingEngine.from_model(model, batch_size=8, bag_L=L)
        for idx, dense in batches:
            served = eng.score_fn(idx, dense).numpy()
            with torch.inference_mode():
                direct = model.forward_pooled(torch.from_numpy(idx), torch.from_numpy(dense))
            np.testing.assert_array_equal(served, direct.numpy())
            feats = np.zeros((8, cfg.feature_dim))
            for j, t in enumerate(cfg.tables):
                for l in range(L):
                    v = idx[:, j, l] >= 0
                    feats[v, t.out_offset:t.out_offset + t.dim] += tables[j][idx[v, j, l]]
            feats[:, cfg.feature_dim - cfg.dense_dim:] = dense
            want = ref.mlp_chain(ref.cross_network_np(feats, cross), ws,
                                 cfg.mlp.activation)[:, 0]
            np.testing.assert_allclose(served, want, rtol=1e-5, atol=1e-5)
        return
    model = init_model(cfg, device=CPU)
    idx = torch.zeros((8, cfg.num_tables, L), dtype=torch.int32)
    dense = torch.zeros(8, cfg.dense_dim)
    with pytest.raises(ValueError, match="interaction"):
        model.forward_pooled(idx, dense)
    with pytest.raises(ValueError, match="interaction"):
        tpool.forward_pooled(model, idx, dense)
    with pytest.raises(ValueError, match="interaction"):
        ServingEngine.from_model(model, batch_size=8, bag_L=L)
    with pytest.raises(ValueError, match="interaction"):
        serve(cfg, model, ServeSpec(batch=8, batches=1, port=_free_port(), bag_L=L))
    ServingEngine.from_model(model, batch_size=8)  # single ids are served


def test_bags_refuse_several_senders():
    """The multi-sender wire frames single ids: serve and loadgen refuse it
    with bags, and an engine refuses a wire format."""
    cfg = mixed(TC, batch_size=8)
    model = init_model(cfg, device=CPU)
    with pytest.raises(ValueError, match="single-sender"):
        serve(cfg, model, ServeSpec(batch=8, batches=1, port=_free_port(), senders=2,
                                    bag_L=L))
    with pytest.raises(SystemExit, match="--senders 1"):
        cli.main(["loadgen", "--config", "micro_test", "--batch", "8", "--bag-l", "4",
                  "--senders", "2", "--port", str(_free_port())])
    eng = ServingEngine.from_model(model, batch_size=8, bag_L=L)
    with pytest.raises(ValueError, match="single-sender"):
        eng.run_from_ingest(None, 1, wire=object())
    with pytest.raises(ValueError):
        ServingEngine.from_model(model, batch_size=8, bag_L=-1)
