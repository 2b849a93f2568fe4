"""MLPerf's DLRM-DCNv2 head in the port at a tiny size, held against the
benchmark's plain reference (``portbench/reference.py``: plain PyTorch in
float64, importing neither JAX nor the port), with the benchmark's seeded
tables and weights (``portbench/tables.py``): ragged multi-hot bags of 1 to
12 members over every storage tier (plain classes, factored classes, take
tables), a bottom tower with a ReLU after its last layer whose output fills
the feature vector's first columns, biases in both towers and three
low-rank cross layers.  Through ``FleetRecModel.forward_ragged`` and through
whole served runs (``portbench.serve.run_single`` on the CPU); each planted
fault reads not correct.  Bags of one size served as ``bag_sizes`` equal
``bag_L`` to the bit, ``validate_indices`` names a bad member, and the
defaults (no last activation, no biases) leave the existing heads' scores as
they were.

The tests marked ``cuda`` run the kernels on the card (the ragged bag
kernel against its plain twin, the biased tower against its plain chain,
the cross layers' tail against its torch expression, a DCNv2 engine's graph
replays against its eager forward) and skip without a CUDA device.  The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_dcnv2.py
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.models import fleetrec as tfr
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.ops.cross import cross_tail, cross_tail_plain
from fleetrec_tpu_torch.ops.lookup import (lookup_fused_bags, lookup_fused_bags_plain,
                                          lookup_fused_ragged, lookup_fused_ragged_plain,
                                          pad_ragged)
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp, fused_mlp_plain
from fleetrec_tpu_torch.serving import ServingEngine
from portbench import inputs, reference, serve, tables
from portbench.model import build_model, port_config
from portbench.serve import Cell
from torch_variants import cap

SEED = 3_000_000_019
# (rows, dim, hot): two plain classes, two factored classes, two take tables
TABLES = [(100, 8, 1), (3000, 8, 12), (50000, 16, 3), (7, 4, 7), (200000, 32, 2),
          (90000, 16, 5)]
W_BOTTOM = 16  # the bottom tower's output: feature columns 0 .. 15


def dcnv2_model(table_dtype="bfloat16", hot=None, stripes=2):
    """A tiny DLRM-DCNv2: the bottom tower 8-32-16 (ReLU after every layer)
    in the first 16 columns, the tables after it, 3 cross layers of rank 8
    over the 100 features, a biased ReLU top tower 100-32-16-1."""
    tabs, off = [], W_BOTTOM
    for i, (r, d, h) in enumerate(TABLES):
        tabs.append({"rows": r, "dim": d, "out_offset": off,
                     "hot": h if hot is None else hot[i]})
        off += d
    return {"tables": tabs, "feature_dim": off, "dense_dim": 8,
            "bottom_mlp": {"widths": [8, 32, W_BOTTOM], "activation": "relu",
                           "last_activation": True},
            "interaction": "cross", "cross_layers": 3, "cross_rank": 8,
            "mlp": [off, 32, 16, 1], "activation": "relu", "bias": True,
            "dtype": "float32", "table_dtype": table_dtype,
            "storage": {"onehot_max": 4096, "onehot_factor_max": 60000, "onehot_r2": 16,
                        "take_stripes": stripes, "take_lanes": 128}}


def dcnv2_cell(m, batch=32):
    traffic = {"kind": "stream", "pool_batches": 4, "warmup_batches": 4, "end_timeout_ms": 1000}
    sv = {"batch": batch, "senders": 1, "slots": 8, "fuse": 1, "bg_drain": True, "warm": True}
    return Cell("tiny_dcnv2", "tiny_dcnv2", 1, m, sv, {"max_err": 1e-4}, traffic)


def _built(m, device="cpu", batch=32):
    cfg = port_config("tiny_dcnv2", m, {"batch": batch})
    return cfg, build_model(cfg, m, SEED, torch.device(device))


def _pool(m, batch=32, pool=2):
    return inputs.pools(SEED, m, batch, pool)


def _reference(m, ids, dense, device="cpu"):
    """The reference's scores, from the weights ``head_weights`` makes on
    ``device`` (the program's device: a CUDA generator draws other values
    than the CPU's)."""
    w = tables.head_weights(SEED, m, device)
    return reference.pool_scores(m, tables.seed_key(SEED), ids, dense, w)


def _ragged_scores(model, m, ids, dense, device="cpu"):
    hot = inputs.hot_of(m)
    with torch.inference_mode():
        return np.stack([model.forward_ragged(torch.from_numpy(i).to(device), hot,
                                              torch.from_numpy(d).to(device)).cpu().numpy()
                         for i, d in zip(ids, dense)])


# -- the model and served runs against the reference ---------------------------

@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8", "float32"])
def test_forward_ragged_matches_the_reference(table_dtype):
    m = dcnv2_model(table_dtype)
    cfg, model = _built(m)
    assert cfg.dense_columns() == (0, W_BOTTOM) and model.layout.dense_dim == 0
    ids, dense = _pool(m)
    assert ids.shape[2] == sum(h for _, _, h in TABLES)
    got = _ragged_scores(model, m, ids, dense)
    assert reference.max_err(got, _reference(m, ids, dense)) < 1e-5


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_served_ragged_run_is_correct(table_dtype):
    """A whole served run on the CPU: the harness's wire ([B, 41] ids and
    the dense floats), ``ServeSpec.bag_sizes``, the engine's ragged path."""
    out = serve.run_single(dcnv2_cell(dcnv2_model(table_dtype)), SEED, 0.5, False,
                           time.monotonic_ns(), device="cpu")
    assert serve.correct(out), out.checks
    assert out.checks["max_err"]["value"] < 1e-5
    assert len(out.window()) > 0


def _tower_fault(monkeypatch, drop_biases=False, drop_last_activation=False):
    """The model's towers with their biases, or the bottom tower's last
    ReLU, left out."""
    mlp_apply = tfr.mlp_apply

    def faulty(weights, x, activation=None, out_dtype=torch.float32, biases=None,
               last_activation=False):
        return mlp_apply(weights, x, activation, out_dtype, None if drop_biases else biases,
                         last_activation and not drop_last_activation)

    monkeypatch.setattr(tfr, "mlp_apply", faulty)


def _no_last_activation(monkeypatch):
    _tower_fault(monkeypatch, drop_last_activation=True)


def _no_biases(monkeypatch):
    _tower_fault(monkeypatch, drop_biases=True)


def _bag_last_dropped(monkeypatch):
    forward = tfr.FleetRecModel.forward_ragged

    def bad(self, indices, bag_sizes, dense=None, mean=False):
        indices = indices.clone()
        indices[:, np.cumsum(bag_sizes) - 1] = -1
        return forward(self, indices, bag_sizes, dense, mean)

    monkeypatch.setattr(tfr.FleetRecModel, "forward_ragged", bad)


def _tf32_cross(monkeypatch):
    from portbench.tests import faults

    monkeypatch.setattr(tfr, "cross_network", tfr.cross_network)  # restored after the test
    faults.tf32_cross()


FAULTS = {"bottom_last_relu_dropped": _no_last_activation, "biases_dropped": _no_biases,
          "bag_last_member_dropped": _bag_last_dropped, "tf32_cross": _tf32_cross}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = serve.run_single(dcnv2_cell(dcnv2_model()), SEED, 0.5, False, time.monotonic_ns(),
                           device="cpu")
    assert out.checks["unanswered"]["value"] == 0 and out.checks["wire_errors"]["value"] == 0
    assert not serve.correct(out)
    assert out.checks["max_err"]["value"] > out.checks["max_err"]["limit"]


# -- bags of one size, validation, the defaults --------------------------------

def test_uniform_bag_sizes_equal_bag_L():
    """Bags of one size: the ragged lookup's plain twin and ``forward_ragged``
    give the bag lookup's bits, and an engine serving ``bag_sizes`` scores
    exactly as one serving ``bag_L``."""
    L = 4
    m = dcnv2_model(hot=[L] * len(TABLES))
    cfg, model = _built(m, batch=16)
    ids, dense = _pool(m, batch=16, pool=1)
    i, d = torch.from_numpy(ids[0]), torch.from_numpy(dense[0])
    T = cfg.num_tables
    bags = i.view(16, T, L)
    ops = model.lookup_operands()
    for a, b in zip(lookup_fused_ragged(i, None, bag_sizes=[L] * T, **ops),
                    lookup_fused_bags(bags, None, **ops)):
        assert torch.equal(a, b)
    with torch.inference_mode():
        assert torch.equal(model.forward_ragged(i, [L] * T, d), model.forward_pooled(bags, d))
    e_sizes = ServingEngine.from_model(model, batch_size=16, bag_sizes=[L] * T)
    e_bag = ServingEngine.from_model(model, batch_size=16, bag_L=L)
    assert e_sizes._served_shapes()[0] == (16, T * L)
    calls = []
    forward_ragged = model.forward_ragged
    model.forward_ragged = lambda *a, **kw: calls.append(1) or forward_ragged(*a, **kw)
    np.testing.assert_array_equal(e_sizes.score_fn(ids[0], dense[0]).numpy(),
                                  e_bag.score_fn(ids[0].reshape(16, T, L), dense[0]).numpy())
    assert calls == [1]  # bags of one size take the ragged path too


def test_ragged_plain_twin_pads_nothing_into_the_sums():
    """``lookup_fused_ragged_plain`` is the bag rule on the bags padded with
    -1: a padded slot adds nothing and counts no member (mean pooling)."""
    m = dcnv2_model()
    cfg, model = _built(m, batch=16)
    ids = torch.from_numpy(_pool(m, batch=16, pool=1)[0][0])
    hot = inputs.hot_of(m)
    padded = pad_ragged(ids, hot)
    assert padded.shape == (16, len(hot), max(hot))
    assert int((padded >= 0).sum()) == ids.numel()
    ops = model.lookup_operands()
    for mean in (False, True):
        a = lookup_fused_ragged_plain(ids, None, bag_sizes=hot, mean=mean, **ops)
        b = lookup_fused_bags_plain(padded, None, mean=mean, **ops)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_validate_indices_names_the_table_and_member():
    m = dcnv2_model()
    cfg, model = _built(m, batch=8)
    hot = inputs.hot_of(m)
    eng = ServingEngine.from_model(model, batch_size=8, bag_sizes=hot)
    limits = [t.rows for t in cfg.tables]
    ids = _pool(m, batch=8, pool=1)[0][0]
    eng.validate_indices(ids, limits)
    starts = np.concatenate([[0], np.cumsum(hot)])
    bad = ids.copy()
    bad[5, starts[1] + 11] = 3000  # table 1's last member, one past its rows
    with pytest.raises(ValueError, match="batch row 5, table 1, member 11, id 3000"):
        eng.validate_indices(bad, limits)
    bad = ids.copy()
    bad[2, starts[4]] = -2
    with pytest.raises(ValueError, match="batch row 2, table 4, member 0"):
        eng.validate_indices(bad, limits)
    with pytest.raises(ValueError, match="expected ragged bags"):
        eng.validate_indices(ids[:, :-1], limits)
    with pytest.raises(ValueError, match="bag_sizes"):
        ServingEngine.from_model(model, batch_size=8, bag_sizes=hot[:-1])


def test_out_of_range_take_member_poisons_only_its_row():
    """A take table's member past its rows poisons its row's score with NaN,
    in any slot of the bag; -1 (padding) poisons nothing."""
    m = dcnv2_model()
    _, model = _built(m, batch=8)
    hot = inputs.hot_of(m)
    ids, dense = _pool(m, batch=8, pool=1)
    ids, dense = ids[0].copy(), dense[0]
    starts = np.concatenate([[0], np.cumsum(hot)])
    ids[3, starts[5] + 4] = 90000  # table 5 (take), its last member
    ids[6, starts[4]] = -1         # padding
    with torch.inference_mode():
        s = model.forward_ragged(torch.from_numpy(ids), hot, torch.from_numpy(dense)).numpy()
    assert np.isnan(s[3]) and np.isfinite(np.delete(s, 3)).all()


def test_ragged_bags_refuse_several_senders_and_a_mesh():
    from fleetrec_tpu_torch.serving import ServeSpec, build_engine, serve

    m = dcnv2_model()
    cfg, model = _built(m, batch=8)
    hot = tuple(inputs.hot_of(m))
    with pytest.raises(ValueError, match="single-sender"):
        serve(cfg, model, ServeSpec(batch=8, batches=1, senders=2, bag_sizes=hot))
    with pytest.raises(ValueError, match="single-device"):
        build_engine(model, ServeSpec(batch=8, batches=1, mesh=(1, 1), device="cpu",
                                      bag_sizes=hot))


@pytest.mark.parametrize("name", ["micro_cross", "micro_dlrm", "criteo"])
def test_defaults_leave_the_heads_scores(name):
    """No last activation and no biases: the port's forward of micro_cross,
    micro_dlrm and criteo (int8 tables, float32 tower, rows capped) equals
    the float64 oracle to the bit on the parity data (pm1 tables, all-ones
    weights), as before tower biases and the DCNv2 bottom tower."""
    if name == "criteo":
        cfg = cap(TC.criteo_terabyte(batch_size=16, dtype="float32", table_dtype="int8"), 4000)
    else:
        cfg = TC.get_config(name, batch_size=16)
    assert cfg.mlp.last_activation is False
    assert cfg.bottom_mlp is None or cfg.bottom_mlp.last_activation is False
    model = init_model(cfg, device="cpu")
    assert model.mlp_biases is None and model.bottom_biases is None
    rng = np.random.default_rng(5)
    idx = np.stack([rng.integers(0, t.rows, 16) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.choice([-1.0, 1.0], (16, cfg.dense_dim)).astype(np.float32)
    tables_np = ref.init_tables(cfg, "pm1")
    ws = ref.init_mlp_weights(cfg, "ones")
    kw = {}
    if cfg.bottom_mlp is not None:
        kw["bottom_weights"] = ref.init_bottom_weights(cfg, "ones")
    if cfg.interaction == "cross":
        kw["cross_weights"] = ref.init_cross_weights(cfg, "ones")
    want = ref.forward(cfg, tables_np, ws, idx, dense if cfg.dense_dim else None, **kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(idx), torch.from_numpy(dense) if cfg.dense_dim else None)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_config_places_the_bottom_tower_and_refuses_what_does_not_fit():
    m = dcnv2_model()
    cfg = port_config("tiny_dcnv2", m, {"batch": 8})
    assert cfg.bottom_mlp.last_activation and cfg.mlp.use_bias
    assert cfg.dense_columns() == tuple(int(c) for c in (reference.dense_columns(m)[0],
                                                         W_BOTTOM))
    with pytest.raises(ValueError, match="no room"):
        dataclasses.replace(cfg, bottom_mlp=dataclasses.replace(cfg.bottom_mlp, out_dim=32)
                            ).validate()
    with pytest.raises(AssertionError, match="dense_dim"):
        dataclasses.replace(cfg, dense_dim=6).validate()
    _, model = _built(m, batch=8)
    with pytest.raises(ValueError, match="tower biases"):
        model.forward_train(torch.zeros((8, 6), dtype=torch.int32), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="float32 tower only"):
        fused_mlp([torch.ones(4, 4, dtype=torch.bfloat16)], torch.ones(2, 4, dtype=torch.bfloat16),
                  biases=[torch.ones(4)])


def test_tower_biases_follow_use_bias():
    """The config's ``MLPSpec.use_bias`` is the one switch: a model is built
    with biases exactly where its towers say so, and ``init_model`` gives
    such a tower zero biases, which leave the scores as they were."""
    m = dcnv2_model()
    cfg, model = _built(m, batch=8)
    assert model.has_biases and cfg.mlp.use_bias and cfg.bottom_mlp.use_bias
    args = (model.plan, model.packed, model.mlp_weights, model.bottom_weights,
            model.cross_weights)
    with pytest.raises(ValueError, match="use_bias=True, so mlp_bias must be given"):
        tfr.FleetRecModel(*args, bottom_bias=model.bottom_biases)
    with pytest.raises(ValueError, match="use_bias=True, so bottom_bias must be given"):
        tfr.FleetRecModel(*args, mlp_bias=model.mlp_biases)
    free = TC.get_config("micro_cross", batch_size=8)
    plain = init_model(free, device="cpu")
    assert not plain.has_biases and plain.mlp_biases is None
    with pytest.raises(ValueError, match="use_bias=False, so mlp_bias must be None"):
        tfr.FleetRecModel(plain.plan, plain.packed, plain.mlp_weights,
                          cross=plain.cross_weights, mlp_bias=[torch.zeros(w.shape[1])
                                                               for w in plain.mlp_weights])
    biased = init_model(dataclasses.replace(free, mlp=dataclasses.replace(free.mlp,
                                                                          use_bias=True)),
                        device="cpu")
    assert biased.has_biases and all(not b.any() for b in biased.mlp_biases)
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.stack([rng.integers(0, t.rows, 8) for t in free.tables], 1))
    dense = torch.from_numpy(rng.uniform(-1, 1, (8, free.dense_dim)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(biased(idx, dense), plain(idx, dense))


def test_training_takes_the_plain_cross_tail(monkeypatch):
    """The served forward runs ``cross_tail`` (the kernel's wrapper) and
    training passes ``cross_tail_plain`` to ``cross_network`` itself: with
    the wrapper made to fail, training still runs and its gradients reach
    the cross layers."""
    from fleetrec_tpu_torch.models import interaction

    cfg = TC.get_config("micro_cross", batch_size=8)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device="cpu")
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(np.stack([rng.integers(0, t.rows, 8) for t in cfg.tables], 1))
    dense = torch.from_numpy(rng.uniform(-1, 1, (8, cfg.dense_dim)).astype(np.float32))
    with torch.inference_mode():
        want = model(idx, dense)

    def refused(*a):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(interaction, "cross_tail", refused)
    with pytest.raises(AssertionError, match="wrapper was called"), torch.inference_mode():
        model(idx, dense)
    t = {k: v.detach().clone().requires_grad_(True)
         for k, v in tfr.trainable_tensors(model).items()}
    scores = model.forward_train(idx, dense, t)
    torch.testing.assert_close(scores.detach(), want, rtol=1e-6, atol=1e-6)
    scores.sum().backward()
    assert t["cross_0_0"].grad is not None and t["cross_0_0"].grad.abs().sum() > 0


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def _draw(m, batch, draw):
    ids, dense = _pool(m, batch=batch, pool=1)
    if draw == "ids0":
        ids = np.zeros_like(ids)
    return ids[0], dense[0]


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["uniform", "ids0"])
@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("hot", ["ragged", "uniform"])
def test_ragged_kernel_equals_its_plain_twin(cuda, hot, table_dtype, draw):
    m = dcnv2_model(table_dtype, hot=None if hot == "ragged" else [5] * len(TABLES))
    _, model = _built(m, "cuda", batch=300)
    ids, _ = _draw(m, 300, draw)
    ops = model.lookup_operands()
    sizes = inputs.hot_of(m)
    i = torch.from_numpy(ids).to(cuda)
    before = lookup_fused_ragged.launches
    got = lookup_fused_ragged(i, None, bag_sizes=sizes, **ops)
    assert lookup_fused_ragged.launches == before + 1
    want = lookup_fused_ragged_plain(i, None, bag_sizes=sizes, **ops)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if hot == "uniform":  # the uniform bag kernel's bits on the same ids
        b = lookup_fused_bags(i.view(300, len(sizes), 5), None, **ops)
        assert torch.equal(got[0], b[0]) and torch.equal(got[1], b[1])


@pytest.mark.cuda
def test_biased_tower_against_its_plain_chain(cuda):
    """Small-integer data (sparse weights, so that every sum stays exact in
    float32): the biased kernels equal the plain chain to the bit, ReLU after
    the last layer or not; random data: close."""
    g = torch.Generator().manual_seed(7)
    for widths in ((13, 512, 256, 128), (3456, 1024, 1024, 512, 256, 1)):
        ws = [torch.randint(-1, 2, (a, b), generator=g).float()
              * (torch.rand(a, b, generator=g) < 1 / 16)
              for a, b in zip(widths[:-1], widths[1:])]
        bs = [torch.randint(-3, 4, (b,), generator=g).float() for b in widths[1:]]
        x = torch.randint(-1, 2, (257, widths[0]), generator=g).float()
        for last in (False, True):
            got = fused_mlp([w.to(cuda) for w in ws], x.to(cuda), "relu",
                            [b.to(cuda) for b in bs], last)
            want = fused_mlp_plain(ws, x, "relu", bs, last)
            assert torch.equal(got.cpu(), want)
        ws = [w / 8 for w in ws]
        x = torch.rand(257, widths[0], generator=g)
        got = fused_mlp([w.to(cuda) for w in ws], x.to(cuda), "relu", [b.to(cuda) for b in bs])
        torch.testing.assert_close(got.cpu(), fused_mlp_plain(ws, x, "relu", bs),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_tail_equals_its_torch_expression(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    for F in (3456, 99):
        x0, x = (torch.randn(77, F, generator=g, device=cuda).to(dtype) for _ in range(2))
        xw = torch.randn(77, F, generator=g, device=cuda)
        b = torch.randn(F, generator=g, device=cuda).to(dtype)
        assert torch.equal(cross_tail(x0, xw, b, x), cross_tail_plain(x0, xw, b, x))


@pytest.mark.cuda
def test_cross_tail_refuses_autograd_on_the_card(cuda):
    """The kernel has no backward: a tensor that requires grad raises, and
    does not fall back to the torch expression."""
    x0, xw, x = (torch.ones(4, 8, device=cuda) for _ in range(3))
    b = torch.zeros(8, device=cuda, requires_grad=True)
    before = cross_tail.launches
    with pytest.raises(ValueError, match="no backward"):
        cross_tail(x0, xw, b, x)
    assert cross_tail.launches == before
    with torch.no_grad():
        assert torch.equal(cross_tail(x0, xw, b, x), cross_tail_plain(x0, xw, b, x))


@pytest.mark.cuda
def test_dcnv2_graph_replays_equal_the_eager_forward(cuda):
    """An engine serving ragged bags on the card scores every dispatched
    batch by a graph replay, bit-equal to the eager ``forward_ragged``; one
    replay is one ragged-kernel launch, two tower calls and three tails."""
    m = dcnv2_model()
    B = 256
    _, model = _built(m, "cuda", batch=B)
    hot = inputs.hot_of(m)
    ids, dense = _pool(m, batch=B, pool=6)
    eng = ServingEngine.from_model(model, batch_size=B, bag_sizes=hot, background_drain=True)
    eng.warmup()
    outs = {}
    before = (lookup_fused_ragged.launches, fused_mlp.launches, cross_tail.launches)
    for i, d in zip(ids, dense):
        eng.submit(i, d, on_done=lambda bid, s: outs.__setitem__(bid, s.copy()))
    eng.close()
    assert eng.graph_replays == len(ids)
    assert (lookup_fused_ragged.launches - before[0], fused_mlp.launches - before[1],
            cross_tail.launches - before[2]) == (len(ids), 2 * len(ids), 3 * len(ids))
    eager = _ragged_scores(model, m, ids, dense, cuda)
    got = np.stack([outs[k] for k in sorted(outs)])[-len(ids):]
    np.testing.assert_array_equal(got, eager)
    assert reference.max_err(got, _reference(m, ids, dense, cuda)) < 1e-5
