"""The port's sharded path (``fleetrec_tpu_torch/parallel``: the forwards and
``train_step``) against the JAX package's ``ShardedFleetRec`` on the
8-device virtual CPU mesh (tests/conftest.py), against the port's
single-device forward and SGD step, and, where the JAX tests do, against the
float64 oracle.

The port's ranks are processes of a gloo world (tests/torch_worlds.py),
one world a mesh shape, spawned once for this file and running every case
of that shape; the ranks import only the port.  The cases are the twins of
tests/test_sharding.py:30, :67, :114, :135, :181; tests/test_hlo.py:57, :72,
:87, :141, :173, :206, :231, :245, :275 (the staged fold of :102 has no
counterpart: the port multiplies its features by W1 and stages no fold);
tests/test_dlrm.py:63, tests/test_cross.py:77, tests/test_pooled.py:162,
:185-214, tests/test_io_multihost.py:75, :98, :177 and
tests/test_multisender.py:230 (``from_sharded(fuse=2)``).  Where the JAX HLO
tests count all-reduces, these count ``ShardedFleetRec._exchange`` calls
and their shapes.  The training cases are the twins of
tests/test_sharding.py:48 and :163, tests/test_dlrm.py:99,
tests/test_cross.py:130 and tests/test_hlo.py:115 (the port stages no fold
to refresh: after a step the sharded forward equals the forward of a
one-device model holding the updated weights), and hold one step on (1, 2),
(2, 2), (1, 4) and (2, 4) against JAX's ``train_step`` and the port's
one-device ``Trainer(model, optimizer=SGD(lr))``.

Tolerances, as the JAX tests state them: pm1 / parity data and int8
partitioned classes bit-exact; uniform data rtol 2e-6 / atol 1e-6 (the
W1-partial sums add in another order); mean pooling rtol 1e-5 / atol 1e-3;
rowid tables against the oracle rtol 1e-4 / atol 2e-3.  A training step:
float32 tensors within rtol 1e-5 / atol 1e-6 (gradients summed in another
order), bfloat16 ones within the repo's bar (rtol 2e-2, atol 2e-2 *
max|want|), the loss within rtol 1e-6 of JAX's and of one device's in
float32 and within the bar in bfloat16 (JAX rounds a QR pair's sum in
bfloat16 at another place; on the fold path a QR pair split over two shards
adds its parts in float32 after W1, where one device rounds their sum to
bfloat16 first), and bit-equal to one device's on a one-row mesh that
exchanges features (the same arithmetic: each feature column is one shard's
value plus zeros).

The window tests below run in this process: the fused lookup's row window
(``lookup_fused_plain`` / ``lookup_fused_bags_plain``) against the sliced
buffer, the shards' lookups summed against one device's, the bag window
against JAX's ``pooled_take_extract(local_start, local_rows)``, and the
backward's window (``lookup_fused_backward_plain``) against the whole
buffer's gradient."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models import pooled as jpool
from fleetrec_tpu.parallel import ShardedFleetRec as JSharded
from fleetrec_tpu.parallel import make_mesh as j_make_mesh
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.embedding import TORCH_DTYPES as TC_DTYPES
from fleetrec_tpu_torch.models.embedding import class_tables, lookup_tensors
from fleetrec_tpu_torch.models.fleetrec import trainable_tensors
from fleetrec_tpu_torch.models.pooled import plan_bags
from fleetrec_tpu_torch.models.train import SGD, Trainer
from fleetrec_tpu_torch.ops.lookup import (lookup_fused_backward_plain, lookup_fused_bags_plain,
                                          lookup_fused_plain)
from fleetrec_tpu_torch.parallel import (ShardedFleetRec, global_scores_to_host_local,
                                         host_local_batch_to_global, make_mesh,
                                         shard_operands, single_device_mesh)
from torch_variants import CPU
from torch_worlds import case_config, run_cases, spawn_world

L = 4  # bag slots, as tests/test_pooled.py
EXACT = "exact"
CLOSE = dict(rtol=2e-6, atol=1e-6)
MEAN = dict(rtol=1e-5, atol=1e-3)
ORACLE = dict(rtol=1e-4, atol=2e-3)
# the heads against JAX (tests/test_torch_dlrm.py, tests/test_torch_cross.py):
# uniform dense features make fp32 sums that the two packages add in
# another order; against the port's own single-device forward: bit-exact
HEADS_JAX = dict(rtol=1e-5, atol=1e-6)
# a training step (module docstring)
STEP = dict(rtol=1e-5, atol=1e-6)
LR = 0.1


def case(name, cfg, kind="forward", tables="uniform", mlp="uniform", check=CLOSE, **kw):
    return dict(name=name, cfg=cfg, kind=kind, tables=tables, mlp=mlp, check=check, **kw)


def train_cases():
    """One SGD step of each training config in float32 and bfloat16: the
    fold path (micro_test, QR) and the feature exchange (the DLRM and DCNv2
    heads); the take tier's window on QR and micro_dlrm."""
    return [case(f"train_{name}_{dtype}", name, kind="train", dtype=dtype, seed=5, lr=LR,
                 check=STEP) for name in ("micro", "qr", "micro_dlrm", "micro_cross")
            for dtype in ("float32", "bfloat16")]


# the cases of each mesh shape (data, model)
WORLDS = {
    (1, 2): train_cases(),
    (1, 4): train_cases(),
    (1, 8): [
        case("fwd_uniform", "micro32", exchange="h1"),
        case("int8_pm1", "micro_int8", tables="pm1", mlp="ones", dense="ones", check=EXACT),
        case("fold_pm1", "micro32", tables="pm1", mlp="ones", dense="int3", seed=7,
             check=EXACT),
        case("pip_overlap", "micro32", kind="pipelined", K=4, dense="int3", seed=7),
        case("pooled_mean", "mixed", kind="pooled", tables="pm1", mlp="ones", B=16, seed=4,
             mean=True, check=MEAN),
        case("criteo_rowid", "criteo_4096", tables="rowid", check=ORACLE),
        case("qr", "qr", B=24),
    ],
    (2, 4): [
        case("fwd_uniform", "micro32"),
        case("int8_pm1", "micro_int8", tables="pm1", mlp="ones", dense="ones", check=EXACT),
        case("criteo_pm1", "criteo_20265", tables="pm1", mlp="ones", dense="sign",
             check=EXACT),
        case("bad_float32", "micro_take", tables="pm1", mlp="ones", B=16, bad=True),
        case("bad_int8", "micro_take_int8", tables="pm1", mlp="ones", B=16, bad=True),
        case("fallback", "tiny_dlrm", exchange="features"),
        case("model3_fold", "model3_128", B=16, exchange="h1"),
        case("fold_pm1", "micro32", tables="pm1", mlp="ones", dense="int3", seed=7,
             check=EXACT),
        case("pip_micro", "micro32", kind="pipelined", tables="pm1", mlp="ones", K=3,
             dense="int3", seed=7, check=EXACT),
        case("pip_tiny_dlrm", "tiny_dlrm", kind="pipelined", tables="pm1", mlp="ones", K=3,
             seed=7, check=EXACT),
        case("pip_dlrm", "micro_dlrm70", kind="pipelined", tables="pm1", mlp="ones", K=3,
             dense="int3", seed=7, check=EXACT),
        case("pip_int8", "micro_int8", kind="pipelined", tables="pm1", mlp="ones", K=3,
             dense="int3", seed=7, check=EXACT),
        case("dlrm", "micro_dlrm70", tables="pm1", mlp="ones", seed=1, check=EXACT,
             jax=HEADS_JAX, exchange="features"),
        case("cross", "micro_cross70", tables="pm1", mlp="ones", seed=1, check=EXACT,
             jax=HEADS_JAX),
        case("pooled_sum", "mixed", kind="pooled", tables="pm1", mlp="ones", B=16, seed=4),
        case("pooled_int8", "mixed_int8", kind="pooled", tables="pm1", mlp="ones", B=16,
             seed=4),
        case("pooled_bad", "mixed", kind="pooled", tables="pm1", mlp="ones", B=16, seed=6,
             bad=True),
        case("engine", "micro32", kind="engine", B=16, check=dict(rtol=1e-4, atol=1e-3)),
        case("helpers", None, kind="helpers"),
        case("qr", "qr", B=24),
        *train_cases(),
        # tests/test_sharding.py:48: five steps lower the loss
        case("train_5_steps", "micro32", kind="train", steps=5, seed=6, lr=LR),
        case("train_int8", "micro_int8", kind="train", lr=LR),
    ],
    (8, 1): [
        case("fwd_uniform", "micro32"),
        case("dlrm", "micro_dlrm70", tables="pm1", mlp="ones", seed=1, check=EXACT,
             jax=HEADS_JAX),
        case("cross", "micro_cross70", tables="pm1", mlp="ones", seed=1, check=EXACT,
             jax=HEADS_JAX),
        case("pooled_dp", "mixed", kind="pooled", tables="pm1", mlp="ones", B=16, seed=9),
        # tests/test_multisender.py:230: two batches a call, 4 batches of 2
        # rows a data row
        case("engine_fused", "micro32", kind="engine", tables="rowid", fuse=2, K=4, B=16,
             seed=5, check=ORACLE),
    ],
    # model3's two-FPGA split (tests/test_sharding.py:67)
    (2, 2): [case("model3_rowid", "model3_128_f32", tables="rowid", B=16, check=ORACLE),
             *train_cases()],
}


def make_bags(cfg, B, seed=0, all_empty_row=None):
    """tests/test_pooled.py's bags: random valid lengths in [1, L], -1
    padding, dense of -1 / 1."""
    rng = np.random.default_rng(seed)
    idx = np.full((B, cfg.num_tables, L), -1, np.int32)
    for j, t in enumerate(cfg.tables):
        lens = rng.integers(1, L + 1, B)
        for b in range(B):
            idx[b, j, : lens[b]] = rng.integers(0, t.rows, lens[b])
    if all_empty_row is not None:
        idx[all_empty_row, :, :] = -1
    dense = (rng.choice([-1.0, 1.0], (B, cfg.dense_dim)).astype(np.float32)
             if cfg.dense_dim else None)
    return idx, dense


def make_labels(c):
    """A training case's [B] labels of 0 / 1, from its own seed."""
    return np.random.default_rng(c.get("seed", 0) + 1000).integers(
        0, 2, c.get("B", 32)).astype(np.float32)


def make_inputs(c):
    """(ids, dense or None) of a case, from its numpy seed, as the JAX test
    it twins makes them."""
    cfg = case_config(TC, c["cfg"], c.get("dtype"))
    B, seed = c.get("B", 32), c.get("seed", 0)
    if c["kind"] == "pooled":
        idx, dense = make_bags(cfg, B, seed=seed, all_empty_row=None if c.get("bad") else 2)
        if c.get("bad"):
            idx[3, -1, 1] = 1 << 28  # past the last (take) table's rows
        return idx, dense
    rng = np.random.default_rng(seed)
    lead = (c["K"], B) if "K" in c else (B,)
    idx = np.stack([rng.integers(0, t.rows, lead) for t in cfg.tables], -1).astype(np.int32)
    kind = c.get("dense", "uniform")
    dense = None
    if cfg.dense_dim:
        shape = lead + (cfg.dense_dim,)
        dense = (rng.integers(0, 3, shape) if kind == "int3" else rng.uniform(-1, 1, shape)
                 ).astype(np.float32)
        dense = {"ones": np.ones_like(dense), "sign": np.sign(dense)}.get(kind, dense)
    if c.get("bad"):
        idx[3, 0] = 1 << 28  # far past the unified buffer's last row
        idx[9, 4] = -7       # negative ids poison too
    return idx, dense


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{shape: (cases, inputs, per-rank results)}, each world spawned at its
    first use (a failed world fails every test of its shape)."""
    done = {}

    def get(shape):
        if shape not in done:
            tmp = tmp_path_factory.mktemp(f"world_{shape[0]}x{shape[1]}")
            cases = WORLDS[shape]
            inputs = {c["name"]: make_inputs(c) for c in cases if c["cfg"]}
            arrays = {f"{n}/{k}": a for n, (i, d) in inputs.items()
                      for k, a in (("idx", i), ("dense", d)) if a is not None}
            arrays.update({f"{c['name']}/labels": make_labels(c) for c in cases
                           if c["kind"] == "train"})
            np.savez(tmp / "inputs.npz", **arrays)
            try:
                res = spawn_world(shape[0] * shape[1], run_cases,
                                  (*shape, cases, str(tmp / "inputs.npz")), tmp)
                done[shape] = ({c["name"]: c for c in cases}, inputs, res)
            except AssertionError as e:
                done[shape] = e
        if isinstance(done[shape], AssertionError):
            raise done[shape]
        return done[shape]

    return get


def _row_scores(res, name, D, M, axis=0, key="scores"):
    """The data rows' leaders' results of one case, joined along the batch
    axis; every rank of a row must hold the leader's scores."""
    for d in range(D):
        lead = res[d * M][name][key]
        for m in range(1, M):
            got = res[d * M + m][name].get(key)
            if got is not None:
                np.testing.assert_array_equal(got, lead)
    return np.concatenate([res[d * M][name][key] for d in range(D)], axis=axis)


def _port_single(c, idx, dense):
    cfg = case_config(TC, c["cfg"])
    model = init_model(cfg, table_scheme=c["tables"], mlp_scheme=c["mlp"], device=CPU)
    t = torch.from_numpy
    d = None if dense is None else t(dense)
    with torch.inference_mode():
        if c["kind"] == "pooled":
            return model.forward_pooled(t(idx), d, mean=c.get("mean", False)).numpy()
        if c["kind"] == "pipelined":
            return np.stack([model(t(idx[k]), None if d is None else d[k]).numpy()
                             for k in range(idx.shape[0])])
        return model(t(idx), d).numpy()


def _jax_sharded(c, idx, dense, shape):
    cfg = case_config(JC, c["cfg"])
    model, params = j_init_model(cfg, table_scheme=c["tables"], mlp_scheme=c["mlp"])
    sh = JSharded(model, j_make_mesh(*shape))
    sp = sh.shard_params(params)
    d = None if dense is None else jnp.asarray(dense)
    if c["kind"] == "pooled":
        return np.asarray(sh.forward_pooled(sp, jnp.asarray(idx), d,
                                            mean=c.get("mean", False)))
    if c["kind"] == "pipelined":
        return np.asarray(sh.forward_pipelined(sp, jnp.asarray(idx), d))
    si, sd = sh.shard_batch(jnp.asarray(idx), d)
    return np.asarray(sh.forward(sp, si, sd))


def _oracle(c, idx, dense):
    cfg = case_config(JC, c["cfg"])
    return jref.forward(cfg, jref.init_tables(cfg, scheme=c["tables"]),
                        jref.init_mlp_weights(cfg, scheme=c["mlp"]), idx, dense)


def _agree(got, want, check, what):
    if check == EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **check)


def _cases(kinds):
    return [pytest.param(shape, c["name"], id=f"{shape[0]}x{shape[1]}-{c['name']}")
            for shape, cs in WORLDS.items() for c in cs if c["kind"] in kinds]


@pytest.mark.parametrize("shape,name", _cases(("forward", "pooled")))
def test_sharded_forward_matches_jax_and_one_device(worlds, shape, name):
    """The sharded forward (or forward_pooled) of every data row, joined:
    equal to JAX's ShardedFleetRec on the same mesh shape and to the port's
    single-device forward, bit for bit on pm1 / int8 data, within the
    case's tolerance elsewhere; the oracle's tolerance for rowid tables.
    Rows with a bad take id are NaN on every path and only they."""
    cases, inputs, res = worlds(shape)
    c = cases[name]
    idx, dense = inputs[name]
    got = _row_scores(res, name, *shape)
    want_j = _jax_sharded(c, idx, dense, shape)
    want_t = _port_single(c, idx, dense)
    if c.get("bad"):
        nan = np.isnan(want_t)
        assert nan.any()
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(np.isnan(want_j), nan)
        got, want_j, want_t = got[~nan], want_j[~nan], want_t[~nan]
    if c["check"] is ORACLE:
        oracle = _oracle(c, idx, dense)
        _agree(got, oracle, ORACLE, "against the float64 oracle")
        _agree(got, want_j, ORACLE, "against JAX's ShardedFleetRec")
        return
    _agree(got, want_j, c.get("jax", c["check"]), "against JAX's ShardedFleetRec")
    _agree(got, want_t, c["check"], "against the port's single-device forward")


@pytest.mark.parametrize("shape,name", _cases(("pipelined",)))
def test_pipelined_forward_bitexact(worlds, shape, name):
    """forward_pipelined's K batches are bit-identical to K sequential
    sharded forwards (the same exchange and order of sums; only the
    schedule moves), to JAX's forward_pipelined on pm1 data and to the
    single-device forwards."""
    cases, inputs, res = worlds(shape)
    c = cases[name]
    idx, dense = inputs[name]
    got = _row_scores(res, name, *shape, axis=1)
    seq = _row_scores(res, name, *shape, axis=1, key="sequential")
    np.testing.assert_array_equal(got, seq)
    _agree(got, _jax_sharded(c, idx, dense, shape), c["check"], "against JAX")
    _agree(got, _port_single(c, idx, dense), c["check"], "against one device")


def _exchanges(log):
    return [e[1:] for e in log if e[0] == "exchange"]


@pytest.mark.parametrize("shape,name", [
    pytest.param((1, 8), "fwd_uniform", id="fold-1x8"),
    pytest.param((2, 4), "model3_fold", id="model3-fold-2x4"),
    pytest.param((2, 4), "fallback", id="features-2x4"),
    pytest.param((2, 4), "dlrm", id="interaction-features-2x4"),
])
def test_one_exchange_a_forward_at_the_right_size(worlds, shape, name):
    """Exactly one exchange (all_reduce) a forward on every rank: of the
    [B_loc, H1] float32 W1-partial where H1 < the feature width (micro_test
    32 < 92, model3 2048 < 3968), else of the [B_loc, F] features
    (tiny_dlrm F=128 < H1=256; a DLRM head consumes the [B_loc, T*D]
    concat), never at the size of the rows the lookup read."""
    cases, _, res = worlds(shape)
    c = cases[name]
    cfg = case_config(TC, c["cfg"])
    B_loc = c.get("B", 32) // shape[0]
    want_fold = c["exchange"] == "h1"
    width = (cfg.mlp.widths[1] if want_fold else
             cfg.num_tables * cfg.tables[0].dim if cfg.interaction == "dot" else cfg.feature_dim)
    for rank in res:
        r = rank[name]
        assert r["fold"] == want_fold
        ex = _exchanges(r["log"])
        assert len(ex) == 1, r["log"]
        shp, dtype, _ = ex[0]
        assert shp == (B_loc, width), (shp, B_loc, width)
        assert dtype == "float32"
    if name == "model3_fold":
        assert width == 2048 and cfg.feature_dim == 3968


def test_pipelined_exchange_is_issued_before_the_next_lookup(worlds):
    """forward_pipelined on K=4 batches: batch k's all_reduce is issued
    (asynchronously) right after its lookup and before batch k+1's lookup,
    and batch k's post follows batch k+1's exchange: K exchanges in all,
    each of the [B_loc, H1] partial (the JAX scan's body and epilogue
    all-reduces)."""
    cases, _, res = worlds((1, 8))
    K = cases["pip_overlap"]["K"]
    want = [("lookup",), "ex", ("lookup",), "ex", ("post",)]
    for k in range(2, K):
        want += [("lookup",), "ex", ("post",)]
    want += [("post",)]
    for rank in res:
        log = rank["pip_overlap"]["pipelined_log"]
        assert [e if e[0] != "exchange" else "ex" for e in log] == want, log
        assert all(e[3] for e in log if e[0] == "exchange")  # async
        assert {e[1] for e in log if e[0] == "exchange"} == {(32, 32)}


def test_onehot_classes_partitioned_over_model_axis(worlds):
    """criteo's geometry capped into the one-hot and factored tiers (a
    plain class of 10 tables, a factored one of 16) over M=4: each shard
    holds ceil(n / 4) tables of each class (3 and 4), never the whole
    class."""
    cases, _, res = worlds((2, 4))
    cfg = case_config(TC, cases["criteo_pm1"]["cfg"])
    model = init_model(cfg, device=CPU)
    ns = [c.num_tables for c in model.layout.onehot_classes]
    assert sorted(ns) == [10, 16]
    for rank in res:
        assert rank["criteo_pm1"]["class_tables"] == [-(-n // 4) for n in ns]


def test_sharded_serving_engine(worlds):
    """One ingest point a data row feeding a (2, 4) mesh: each row's leader
    runs ServingEngine.from_sharded's submit / drain over its 8 rows,
    broadcasting each batch to its row; the followers follow until the
    leader's close; the joined scores match the oracle."""
    cases, inputs, res = worlds((2, 4))
    c = cases["engine"]
    idx, dense = inputs["engine"]
    for r, rank in enumerate(res):
        if r % 4:
            assert rank["engine"]["follow"] == {"role": "follower", "rank": r, "batches": 1}
        else:
            assert rank["engine"]["summary"]["batches"] == 1
    got = np.concatenate([res[0]["engine"]["scores"], res[4]["engine"]["scores"]])
    _agree(got, _oracle(c, idx, dense), c["check"], "against the oracle")


def test_multihost_helpers(worlds):
    """host_local_batch_to_global carries each row's leader's rows to every
    rank of the row; global_scores_to_host_local gives them back on the
    leader only.  One process: a one-rank mesh passes the rows through."""
    _, _, res = worlds((2, 4))
    for r, rank in enumerate(res):
        h = rank["helpers"]
        np.testing.assert_array_equal(h["received"], h["want"])
        assert (h["host_local"] is None) == (r % 4 != 0)
    mesh = single_device_mesh(CPU)
    arr = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    g = host_local_batch_to_global(mesh, arr)
    np.testing.assert_array_equal(g.numpy(), arr)
    np.testing.assert_array_equal(global_scores_to_host_local(mesh, g), arr)


def test_one_rank_mesh_forward_is_the_single_device_forward():
    """A mesh of one rank and no process group: the shard is the whole
    model and nothing is exchanged; the scores are the forward's, bit for
    bit, on uniform data."""
    c = case("one", "micro32")
    idx, dense = make_inputs(c)
    model = init_model(case_config(TC, "micro32"), table_scheme="uniform",
                       mlp_scheme="uniform", device=CPU)
    sh = ShardedFleetRec(model, make_mesh(1, 1, CPU))
    with torch.inference_mode():
        got = sh.forward(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(got, _port_single(c, idx, dense), **CLOSE)


def test_a_mesh_needs_its_world():
    with pytest.raises(ValueError, match="world of 8 ranks"):
        make_mesh(2, 4, CPU)


# ---- the row window, in this process ---------------------------------------

# layouts with a take tier: every tier, stripes, QR, a narrower take row,
# the dense-free dot layout and model1's geometry
WINDOW_LAYOUTS = ["tiers", "striped", "qr", "lanes64", "micro_dlrm", "model1_tiers"]


def _window_inputs(cfg, bags, seed=3):
    rng = np.random.default_rng(seed)
    if bags:
        idx, dense = make_bags(cfg, 16, seed=seed, all_empty_row=1)
        idx[5, -1, 0] = cfg.tables[-1].rows  # out of range: flags when a take table
        return torch.from_numpy(idx), None if dense is None else torch.from_numpy(dense)
    idx = np.stack([rng.integers(0, t.rows, 16) for t in cfg.tables], 1)
    idx[2, 0], idx[3, -1] = -1, cfg.tables[-1].rows
    dense = rng.uniform(-1, 1, (16, cfg.dense_dim)).astype(np.float32) if cfg.dense_dim else None
    return (torch.from_numpy(idx.astype(np.int32)),
            None if dense is None else torch.from_numpy(dense))


def _lookup(bags):
    return lookup_fused_bags_plain if bags else lookup_fused_plain


@pytest.mark.parametrize("bags", [False, True], ids=["ids", "bags"])
@pytest.mark.parametrize("name", WINDOW_LAYOUTS)
def test_window_equals_the_buffer_with_other_rows_zeroed(name, bags):
    """The window (lo, n) over a take buffer sliced to rows [lo, lo + n)
    gives the features of the whole buffer with every other row zeroed,
    and the whole buffer's flags (the window flags nothing)."""
    cfg = case_config(TC, name)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    assert model.take is not None
    ops = model.lookup_operands()
    idx, dense = _window_inputs(cfg, bags)
    dense = dense if ops["dense_dim"] else None
    fn = _lookup(bags)
    _, want_bad = fn(idx, dense, **ops)
    R = model.take.shape[0]
    for lo, n in ((0, R // 2), (R // 3, R // 3 + 1), (R - 2, 2)):
        zeroed = torch.zeros_like(model.take)
        zeroed[lo:lo + n] = model.take[lo:lo + n]
        want, _ = fn(idx, dense, **{**ops, "bufs": ops["bufs"][:-1] + [zeroed]})
        got, bad = fn(idx, dense, **{**ops, "bufs": ops["bufs"][:-1] + [model.take[lo:lo + n]]},
                      window=(lo, n))
        assert torch.equal(got, want), (lo, n)
        assert torch.equal(bad, want_bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("name", ["tiers", "qr", "model1_tiers", "micro_dlrm"])
def test_shard_lookups_sum_to_the_single_device_lookup(name, M, dtype):
    """Each column of a lookup is one shard's (a class table's, a take
    row's, shard 0's dense) and a QR pair adds its two parts, each a
    rounding of one value: the sum over the M shards' lookups
    (shard_operands: descriptors, class slices padded with zero tables,
    take window) is the single-device lookup bit for bit on uniform data,
    and every shard's flags are its flags.  A bag's members may sit on
    several shards, which sum them in another order: bags on pm1 data
    (integer sums)."""
    cfg = dataclasses.replace(case_config(TC, name), table_dtype=dtype)
    for bags in (False, True):
        model = init_model(cfg, table_scheme="pm1" if bags else "uniform", device=CPU)
        idx, dense = _window_inputs(cfg, bags, seed=M)
        ops = model.lookup_operands()
        d = dense if ops["dense_dim"] else None
        want, want_bad = _lookup(bags)(idx, d, **ops)
        total = None
        for m in range(M):
            sops = shard_operands(model, m, M, CPU)
            got, bad = _lookup(bags)(idx, d if sops["dense_dim"] else None, **sops)
            if bad is not None or want_bad is not None:
                assert torch.equal(bad, want_bad)
            total = got if total is None else total + got
        assert torch.equal(total, want), (name, M, dtype, bags)


def test_unsharded_descriptors_are_unchanged():
    """lookup_tensors with no shard, or shard (0, 1), writes the
    single-device descriptors byte for byte; shard m of M rebases its own
    class tables, gives every other class column lim 0, and (m > 0) zeros
    the dense tail."""
    from fleetrec_tpu_torch.ops.lookup import LOOKUP_COL_FIELDS, POS_DENSE, POS_ZERO

    cfg = case_config(TC, "tiers")
    model = init_model(cfg, device=CPU)
    lay, plan = model.layout, model.plan
    base = lookup_tensors(lay, plan.index_perm, plan.qr_positions, CPU)
    one = lookup_tensors(lay, plan.index_perm, plan.qr_positions, CPU, shard=(0, 1))
    for k in base:
        assert torch.equal(base[k], one[k])
        assert torch.equal(base[k], getattr(model, f"lookup_{k}"))
    F = {f: i for i, f in enumerate(LOOKUP_COL_FIELDS)}
    for m in range(3):
        sh = lookup_tensors(lay, plan.index_perm, plan.qr_positions, CPU, shard=(m, 3))
        k = 0
        for c in lay.onehot_classes:
            lo, hi = class_tables(c.num_tables, m, 3)
            for j in range(c.num_tables):
                row = sh["cols"][k]
                if lo <= j < hi:
                    assert int(row[F["base"]]) == (j - lo) * c.rows_pad
                    assert int(row[F["scale"]]) == j - lo and int(row[F["lim"]]) == c.rows_pad
                else:
                    assert int(row[F["lim"]]) == 0
                k += 1
        assert torch.equal(sh["cols"][k:], base["cols"][k:])  # take columns: global
        col = ((sh["pos"][:, 0] & 0xFFFF) ^ 0x8000) - 0x8000
        base_col = ((base["pos"][:, 0] & 0xFFFF) ^ 0x8000) - 0x8000
        dense = base_col == POS_DENSE
        assert dense.any()
        assert bool((col[dense] == (POS_DENSE if m == 0 else POS_ZERO)).all())


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_bag_window_matches_jax_pooled_take_extract(table_dtype, mean):
    """The bag lookup's take columns over a window equal JAX's
    pooled_take_extract(local_start, local_rows) on the same buffer and
    bags: a row outside the window adds nothing, the mean divides by the
    whole bag's count.  pm1 tables: exact."""
    cfg_j, cfg_t = (dataclasses.replace(case_config(C, "mixed"), table_dtype=table_dtype)
                    for C in (JC, TC))
    _, jparams = j_init_model(cfg_j)
    model = init_model(cfg_t, device=CPU)  # the same pm1 buffers (tests/test_torch_model.py)
    lay = model.layout
    idx, _ = make_bags(cfg_t, 16, seed=11, all_empty_row=3)
    planned = plan_bags(model, torch.from_numpy(idx)).numpy()
    n_oh = lay.n_onehot
    tidx = planned[:, n_oh:n_oh + lay.n_take]
    R = model.take.shape[0]
    ops = model.lookup_operands()
    perm = np.asarray(lay.feature_perm)
    cls_total = sum(c.num_tables * c.dim for c in lay.onehot_classes)
    emb_total = cls_total + sum(g.num_tables * g.dim for g in lay.take_groups)
    take_out = np.flatnonzero((perm >= cls_total) & (perm < emb_total))
    for lo, n in ((0, R // 2), (R // 2, R - R // 2), (R // 4, R // 3)):
        # both read a take buffer that holds only the window's rows
        local = dataclasses.replace(jparams["tables"],
                                    take_buffer=jparams["tables"].take_buffer[lo:lo + n])
        want = np.concatenate([np.asarray(o) for o in jpool.pooled_take_extract(
            local, jnp.asarray(tidx), jnp.asarray(tidx >= 0), local_start=lo,
            local_rows=n, mean=mean)], axis=1)
        got, _ = lookup_fused_bags_plain(
            torch.from_numpy(idx), None,
            **{**ops, "bufs": ops["bufs"][:-1] + [model.take[lo:lo + n]], "dense_dim": 0,
               "window": (lo, n)}, mean=mean)
        np.testing.assert_array_equal(got.numpy()[:, take_out],
                                      want.astype(np.float32)[:, perm[take_out] - cls_total])


def test_sharded_engine_fused_dispatch_oracle(worlds):
    """Twin of tests/test_multisender.py:230: ServingEngine.from_sharded
    with fuse=2 on an (8, 1) mesh, each data row's leader submitting 4
    batches of its 2 rows two at a time (forward_pipelined); the joined
    scores match the rowid oracle."""
    cases, inputs, res = worlds((8, 1))
    c = cases["engine_fused"]
    idx, dense = inputs["engine_fused"]
    got = np.concatenate([rank["engine_fused"]["scores"] for rank in res], axis=1)
    assert got.shape == idx.shape[:2]
    for k in range(idx.shape[0]):
        _agree(got[k], _oracle(c, idx[k], dense[k]), ORACLE, f"batch {k}")


# ---- the training step ------------------------------------------------------

def _train_cases():
    """The one-step training cases of train_cases(), on every shape."""
    return [pytest.param(shape, c["name"], id=f"{shape[0]}x{shape[1]}-{c['name']}")
            for shape, cs in WORLDS.items() for c in cs if c["kind"] == "train" and "dtype" in c]


def _is_table(name):
    return name.startswith("onehot_") or name == "take"


def _shard_of(name, arr, m, M):
    """Shard m of M of a global array, as shard_operands slices it: a
    class's tables [m * n_loc, (m + 1) * n_loc) or the take buffer's rows
    [m * rows_local, ...), zero-padded past the end; a weight whole."""
    if not _is_table(name):
        return arr
    n = -(-arr.shape[0] // M)
    part = arr[m * n:(m + 1) * n]
    return np.concatenate([part, np.zeros((n - part.shape[0],) + arr.shape[1:], arr.dtype)])


def _jax_named(params):
    """JAX's params pytree by ``trainable_tensors``' names, as float32 numpy."""
    t = params["tables"]
    out = {f"onehot_{i}": b for i, b in enumerate(t.onehot_buffers)}
    if t.take_buffer is not None:
        out["take"] = t.take_buffer
    for tower in ("mlp", "bottom"):
        out.update({f"{tower}_{i}": w for i, w in enumerate(params.get(tower, ()))})
    for li, layer in enumerate(params.get("cross", ())):
        out.update({f"cross_{li}_{j}": w for j, w in enumerate(layer)})
    return {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in out.items()}


def _train_inputs(inputs, c):
    idx, dense = inputs[c["name"]]
    return idx, dense, make_labels(c)


def _jax_step(c, shape, idx, dense, labels):
    """JAX's ShardedFleetRec.train_step on the 8-device mesh: (loss, the
    updated global (padded) arrays).  train_step donates the params it is
    given, which nothing reads again."""
    cfg = case_config(JC, c["cfg"], c.get("dtype"))
    model, params = j_init_model(cfg, table_scheme=c["tables"], mlp_scheme=c["mlp"])
    sh = JSharded(model, j_make_mesh(*shape))
    sp = sh.shard_params(params)
    si, sd = sh.shard_batch(jnp.asarray(idx), None if dense is None else jnp.asarray(dense))
    loss, new = sh.train_step(sp, si, sd, jnp.asarray(labels), c["lr"])
    return float(loss), _jax_named(new)


def _one_device(c):
    cfg = case_config(TC, c["cfg"], c.get("dtype"))
    return init_model(cfg, table_scheme=c["tables"], mlp_scheme=c["mlp"], device=CPU)


def _port_step(c, idx, dense, labels):
    """The same step on one device: Trainer with SGD(lr) -> (loss, every
    tensor after it as float32 numpy)."""
    model = _one_device(c)
    t = torch.from_numpy
    loss = Trainer(model, optimizer=SGD(c["lr"]), device=CPU).step(
        t(idx), None if dense is None else t(dense), t(labels))
    return float(loss), {k: v.float().numpy() for k, v in trainable_tensors(model).items()}


def _step_tol(c, want):
    if c.get("dtype") == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2 * max(float(np.abs(want).max()), 1e-30))
    return STEP


@pytest.mark.parametrize("shape,name", _train_cases())
def test_train_step_matches_jax_and_one_device(worlds, shape, name):
    """One sharded SGD step: every rank returns the global batch's loss,
    equal to JAX's train_step's and to one device's (bit-equal on a one-row
    mesh that exchanges features); each rank's shard and weights after it
    are the same slice of JAX's updated global arrays and of one device's
    updated tensors, the same on every data row of its model column, its pad
    tables and pad rows still 0; one exchange a step, of the W1-partial on
    the fold path, else of the features."""
    cases, inputs, res = worlds(shape)
    c = cases[name]
    D, M = shape
    idx, dense, labels = _train_inputs(inputs, c)
    loss_j, want_j = _jax_step(c, shape, idx, dense, labels)
    loss_t, want_t = _port_step(c, idx, dense, labels)
    losses = {rank[name]["losses"][0] for rank in res}
    assert len(losses) == 1, losses
    loss = losses.pop()
    # bfloat16 rounds at other places (module docstring): the repo's bar
    rtol = 1e-6 if c["dtype"] == "float32" else 2e-2
    np.testing.assert_allclose(loss, loss_j, rtol=rtol, err_msg="loss against JAX")
    fold = res[0][name]["fold"]
    if D == 1 and not fold:
        assert loss == loss_t
    else:
        np.testing.assert_allclose(loss, loss_t, rtol=rtol, err_msg="loss against one device")
    cfg = case_config(TC, c["cfg"])
    width = cfg.mlp.widths[1] if fold else (
        cfg.num_tables * cfg.tables[0].dim if cfg.interaction == "dot" else cfg.feature_dim)
    for r, rank in enumerate(res):
        d, m = divmod(r, M)
        got = rank[name]["tensors"]
        assert list(got) == list(want_t) == list(want_j)
        assert [e[:2] for e in _exchanges(rank[name]["log"])] == [
            ((idx.shape[0] // D, width), "float32" if fold else str(
                TC_DTYPES[c["dtype"]]).replace("torch.", ""))]
        for k, v in got.items():
            for want, who in ((want_j[k], "JAX"), (want_t[k], "one device")):
                w = _shard_of(k, want, m, M)
                assert v.shape == w.shape, (k, who)
                np.testing.assert_allclose(v, w, err_msg=f"rank {r} {k} against {who}",
                                           **_step_tol(c, w))
            np.testing.assert_array_equal(v, res[m][name]["tensors"][k])
            if _is_table(k):
                real = max(0, min(v.shape[0], want_t[k].shape[0] - m * v.shape[0]))
                assert not v[real:].any(), (r, k, "pad tables / rows")


@pytest.mark.parametrize("shape,name", _train_cases())
def test_forward_after_a_step_is_the_forward_of_the_updated_weights(worlds, shape, name):
    """Twin of tests/test_hlo.py:115 (the port stages no W1 fold, so nothing
    can go stale): after the step, the sharded forward of every data row
    equals the one-device forward of a model holding the updated weights,
    gathered from the ranks' shards (bit-equal where features are
    exchanged, within the forward's tolerance on the fold path)."""
    cases, inputs, res = worlds(shape)
    c = cases[name]
    D, M = shape
    idx, dense, _ = _train_inputs(inputs, c)
    model = _one_device(c)
    with torch.no_grad():
        for k, v in trainable_tensors(model).items():
            if _is_table(k):
                whole = np.concatenate([res[m][name]["tensors"][k] for m in range(M)])
                whole = whole[:v.shape[0]]
            else:
                whole = res[0][name]["tensors"][k]
            v.copy_(torch.from_numpy(whole).to(v.dtype))
        want = model(torch.from_numpy(idx), None if dense is None else torch.from_numpy(dense))
    got = _row_scores(res, name, D, M, key="scores_after")
    if not res[0][name]["fold"]:
        np.testing.assert_array_equal(got, want.numpy())
    elif c["dtype"] == "float32":
        np.testing.assert_allclose(got, want.numpy(), **CLOSE)
    else:
        np.testing.assert_allclose(got, want.numpy(), **_step_tol(c, want.numpy()))


def test_train_steps_lower_the_loss(worlds):
    """Twin of tests/test_sharding.py:48: five steps at lr 0.1 on a (2, 4)
    mesh lower the loss; every rank holds the same losses."""
    _, _, res = worlds((2, 4))
    losses = res[0]["train_5_steps"]["losses"]
    assert len(losses) == 5 and losses[-1] < losses[0], losses
    assert all(rank["train_5_steps"]["losses"] == losses for rank in res)


def test_train_after_shard_params_with_padded_onehot(worlds):
    """Twin of tests/test_sharding.py:163: micro_test's one-hot classes
    (padded to a multiple of M = 4 tables) train, and the mesh serves the
    trained shard at once: a finite loss, finite scores of every row."""
    _, _, res = worlds((2, 4))
    for rank in res:
        r = rank["train_micro_float32"]
        assert np.isfinite(r["losses"][0])
        assert r["scores_after"].shape == (16,) and np.isfinite(r["scores_after"]).all()


@pytest.mark.parametrize("name,tensor", [("train_micro_dlrm_float32", "bottom_0"),
                                         ("train_micro_cross_float32", "cross_0_0")])
def test_a_step_updates_the_heads(worlds, name, tensor):
    """Twins of tests/test_dlrm.py:99 (the DLRM bottom tower) and
    tests/test_cross.py:130 (a DCNv2 cross layer): a step on (2, 4) moves
    the head's first weight and every other weight."""
    cases, _, res = worlds((2, 4))
    before = {k: v.float().numpy() for k, v in trainable_tensors(_one_device(cases[name])).items()}
    after = res[0][name]["tensors"]
    assert np.isfinite(res[0][name]["losses"][0])
    assert tensor in after and not np.array_equal(after[tensor], before[tensor])
    for k, v in after.items():
        if not _is_table(k):
            assert not np.array_equal(v, before[k]), k


def test_int8_shards_refuse_to_train(worlds):
    """An int8 shard's train_step raises on every rank, as JAX's
    check_trainable and the one-device Trainer do."""
    _, _, res = worlds((2, 4))
    for rank in res:
        assert "int8" in rank["train_int8"]["refused"]


# ---- the backward's row window, in this process ----------------------------

def _cotangent(rng, kind, B, F, dtype):
    ct = rng.integers(-3, 4, (B, F)) if kind == "integer" else rng.uniform(-1, 1, (B, F))
    return torch.from_numpy(ct.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", WINDOW_LAYOUTS)
def test_backward_window_is_the_whole_buffers_rows(name, dtype):
    """lookup_fused_backward_plain with the window (lo, n), given the take
    buffer sliced to rows [lo, lo + n): its take gradient is rows
    [lo, lo + n) of the whole buffer's, its class gradients the whole's, bit
    for bit (each element sums the same terms in the same order), on
    integer and uniform cotangents, ids with bad ones among them."""
    cfg = dataclasses.replace(case_config(TC, name), table_dtype=dtype)
    model = init_model(cfg, table_scheme="uniform", device=CPU)
    ops = model.lookup_operands()
    idx, _ = _window_inputs(cfg, False)
    rng = np.random.default_rng(8)
    args = (ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
    R = model.take.shape[0]
    for kind in ("integer", "uniform"):
        ct = _cotangent(rng, kind, idx.shape[0], model.layout.feature_dim, model.take.dtype)
        whole = lookup_fused_backward_plain(ct, idx, ops["bufs"], *args)
        for lo, n in ((0, R // 2), (R // 3, R // 3 + 1), (R - 2, 2)):
            got = lookup_fused_backward_plain(
                ct, idx, ops["bufs"][:-1] + [model.take[lo:lo + n]], *args, window=(lo, n))
            for g, w in zip(got[:-1], whole[:-1]):
                assert torch.equal(g, w), (kind, lo, n)
            assert got[-1].shape == (n,) + tuple(model.take.shape[1:])
            assert torch.equal(got[-1], whole[-1][lo:lo + n]), (kind, lo, n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("name", ["tiers", "qr", "model1_tiers", "micro_dlrm"])
def test_shard_backwards_place_into_the_unsharded_gradient(name, M, dtype):
    """The M shards' lookup gradients (shard_operands: each shard's class
    tables, take rows and descriptors; the window backward), placed at their
    tables and rows, are the unsharded gradient bit for bit, integer and
    uniform cotangents: every element is one shard's (a QR pair's two tables
    each take their part), and a shard's pad tables and pad rows get 0."""
    cfg = dataclasses.replace(case_config(TC, name), table_dtype=dtype)
    model = init_model(cfg, table_scheme="uniform", device=CPU)
    ops = model.lookup_operands()
    idx, _ = _window_inputs(cfg, False, seed=M)
    rng = np.random.default_rng(M)
    names = [f"onehot_{i}" for i in range(len(model.layout.onehot_classes))] + ["take"]
    for kind in ("integer", "uniform"):
        ct = _cotangent(rng, kind, idx.shape[0], model.layout.feature_dim, model.take.dtype)
        whole = lookup_fused_backward_plain(ct, idx, ops["bufs"], ops["cols"], ops["pos"],
                                            ops["stripes"], ops["stripe_height"])
        shards = []
        for m in range(M):
            s = shard_operands(model, m, M, CPU)
            shards.append(lookup_fused_backward_plain(ct, idx, s["bufs"], s["cols"], s["pos"],
                                                      s["stripes"], s["stripe_height"],
                                                      window=s["window"]))
        for i, (k, w) in enumerate(zip(names, whole)):
            placed = torch.cat([g[i] for g in shards])
            assert torch.equal(placed[:w.shape[0]], w), (kind, k)
            assert not placed[w.shape[0]:].any(), (kind, k, "pad")
