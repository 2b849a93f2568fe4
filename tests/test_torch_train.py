"""Twin of the JAX package's training path (``fleetrec_tpu/models/train.py``
and the training tests of tests/test_sharding.py and
tests/test_io_multihost.py; the sharded ``train_step``'s are in
tests/test_torch_sharded.py): the port's ``models/train.py``, ``forward_train`` and
the lookup's backward against JAX on the same inputs, made from a numpy
seed.  JAX runs on the CPU with optax, as its own tests run it; the port runs
its plain PyTorch path (``lookup_fused_backward_plain``).

Tolerances: pm1 tables with small integer cotangents keep every sum an
integer below 2^8, so the lookup's gradients are bit-equal in float32 and
bfloat16; uniform data is held to rtol 1e-5 / atol 1e-6 in float32 (sums in
another order) and to the repo's bfloat16 bar, rtol 2e-2 with atol 2e-2 *
max|JAX|.  Gradients of the whole model and Trainer steps compose products
and sums in another order: rtol 1e-4 with atol 1e-6 * max|JAX| a tensor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import ID_DRAWS, draw_ids
from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models import embedding as jemb
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models import train as jtrain
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.fleetrec import trainable_tensors
from fleetrec_tpu_torch.models.train import SGD, Adagrad, Trainer, bce_with_logits, check_trainable
from fleetrec_tpu_torch.ops import lookup as tlk
from torch_variants import CPU, HEADS, LAYOUT_CASES, variant

BF16 = {"rtol": 2e-2}


def _np(t):
    """A port tensor or a JAX array as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _bits(t):
    """The bits of a port tensor or a JAX array (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        a = t.detach()
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    else:
        a = np.asarray(t)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _close(got, want, rtol=1e-4, atol_rel=1e-6, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30), err_msg=what)


def _pair(cfg_j, cfg_t, table_scheme="uniform", mlp_scheme="uniform"):
    """(JAX model, JAX params, the port's model converted from them)."""
    jm, jp = j_init_model(cfg_j, table_scheme=table_scheme, mlp_scheme=mlp_scheme)
    return jm, jp, params_from_jax(cfg_t, jax.tree_util.tree_map(np.asarray, jp), device=CPU)


def _jax_named(params):
    """The JAX params pytree's leaves by ``trainable_tensors``' names."""
    t = params["tables"]
    out = {f"onehot_{i}": b for i, b in enumerate(t.onehot_buffers)}
    if t.take_buffer is not None:
        out["take"] = t.take_buffer
    for tower in ("mlp", "bottom"):
        out.update({f"{tower}_{i}": w for i, w in enumerate(params.get(tower, ()))})
    for li, layer in enumerate(params.get("cross", ())):
        out.update({f"cross_{li}_{j}": w for j, w in enumerate(layer)})
    return out


def _batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    dense = (rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)
             if cfg.dense_dim else None)
    return idx, dense, rng.integers(0, 2, B).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_bce_with_logits_matches_jax():
    """Scores of both signs, 0, and |s| > 30 (where exp(-|s|) underflows
    log1p's argument); labels 0 and 1: value and gradient."""
    s = np.asarray([-80.0, -31.5, -3.0, -0.25, 0.0, 0.0, 0.5, 2.0, 30.5, 95.0], np.float32)
    y = np.asarray([1, 0, 1, 0, 1, 0, 1, 0, 0, 1], np.float32)
    want, want_g = jax.value_and_grad(jtrain.bce_with_logits)(jnp.asarray(s), jnp.asarray(y))
    st = torch.from_numpy(s).requires_grad_()
    got = bce_with_logits(st, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)


def test_int8_tables_are_refused():
    """check_trainable, Trainer, forward_train and the lookup's backward
    refuse int8 storage, as the JAX package's check_trainable does."""
    cfg = dataclasses.replace(variant("striped", TC), table_dtype="int8")
    model = init_model(cfg, device=CPU)
    with pytest.raises(ValueError, match="int8"):
        check_trainable(model)
    with pytest.raises(ValueError, match="int8"):
        Trainer(model, device=CPU)
    idx, dense, _ = _batch(cfg, 8, 0)
    with pytest.raises(ValueError, match="int8"):
        model.forward_train(_t(idx), _t(dense))
    ops = model.lookup_operands()
    with pytest.raises(ValueError, match="int8"):
        tlk.lookup_fused_backward(torch.zeros(8, cfg.feature_dim), _t(idx), ops["bufs"],
                                  ops["cols"], ops["pos"])
    with pytest.raises(ValueError, match="int8"):
        jtrain.check_trainable(j_init_model(dataclasses.replace(variant("striped", JC),
                                                                table_dtype="int8"))[1])


@pytest.mark.parametrize("draw", ID_DRAWS)
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_lookup_backward_matches_jax_vjp(name, table_dtype, draw):
    """lookup_fused_backward (plain on the CPU) against jax.vjp of JAX's
    lookup_concat(packed, plan_indices(ids), dense) with respect to the
    packed buffers, and against autograd through lookup_fused_plain, on pm1
    tables (the lookup is linear in the tables: its gradient reads no table
    value): small integer cotangents bit-equal, uniform ones within the
    dtype's tolerance.  ``draw``: the ids, uniform, every id 0 (every
    cotangent of a table on one row) or skewed (chip_smoke.draw_ids)."""
    jc = dataclasses.replace(variant(name, JC), table_dtype=table_dtype)
    tc = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[table_dtype]
    B = jc.batch_size
    rng = np.random.default_rng(21)
    jm, jp, model = _pair(jc, tc, table_scheme="pm1")
    idx, dense, _ = _batch(jc, B, 22)
    if draw != "uniform":
        idx = draw_ids(tc, B, np.random.default_rng(23), draw)
    gi = jm.plan_indices(jnp.asarray(idx))
    vjp = jax.jit(lambda packed, ct: jax.vjp(
        lambda p: jemb.lookup_concat(p, gi, _j(dense)), packed)[1](ct)[0])
    ops = model.lookup_operands()
    leaves = [b.detach().requires_grad_() for b in ops["bufs"]]
    feats, _ = tlk.lookup_fused_plain(_t(idx), _t(dense) if model.layout.dense_dim else None,
                                      leaves, None, ops["cols"], ops["pos"], ops["stripes"],
                                      ops["stripe_height"], ops["dense_dim"])
    F = jm.layout.feature_dim
    for kind in ("integer", "uniform"):
        ct = rng.integers(-3, 4, (B, F)) if kind == "integer" else rng.uniform(-1, 1, (B, F))
        ct_j = jnp.asarray(ct.astype(np.float32), dt)
        gt = vjp(jp["tables"], ct_j)
        want = list(gt.onehot_buffers) + ([gt.take_buffer] if gt.take_buffer is not None else [])
        ct_t = torch.tensor(np.asarray(ct_j.astype(jnp.float32))).to(ops["bufs"][0].dtype)
        got = tlk.lookup_fused_backward(ct_t, _t(idx), ops["bufs"], ops["cols"], ops["pos"],
                                        ops["stripes"], ops["stripe_height"])
        auto = torch.autograd.grad(feats, leaves, ct_t, retain_graph=True)
        assert len(got) == len(want) == len(auto)
        for i, (g, w, a) in enumerate(zip(got, want, auto)):
            what = f"{name} {table_dtype} {draw} {kind} buffer {i}"
            assert g.dtype == ops["bufs"][i].dtype and g.shape == ops["bufs"][i].shape, what
            if kind == "integer":
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=what)
                np.testing.assert_array_equal(_bits(g), _bits(a), err_msg=what)
            else:
                tol = ({"rtol": 1e-5, "atol": 1e-6} if table_dtype == "float32" else
                       {**BF16, "atol": 2e-2 * float(np.abs(_np(w)).max())})
                np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=what)
                np.testing.assert_allclose(_np(g), _np(a), **tol, err_msg=what)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adagrad_matches_optax(dtype, steps):
    """Adagrad against optax.adagrad(0.3) over ``steps`` steps of uniform
    gradients: float32 within rtol 1e-6 (one rsqrt may differ by an ulp),
    bfloat16 within the repo's bar."""
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (33,), (4, 3, 2)]
    params = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.uniform(-2, 2, s).astype(np.float32) for s in shapes] for _ in range(steps)]
    jd = jnp.dtype(dtype)
    opt = optax.adagrad(0.3)
    jp = [jnp.asarray(p, jd) for p in params]
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x, jd) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tp = [torch.from_numpy(p).to(td) for p in params]
    ada = Adagrad(0.3)
    st = ada.init(tp)
    for g in grads:
        ada.update(tp, [torch.from_numpy(x).to(td) for x in g], st)
    for a, b, s, js in zip(tp, jp, st, state[0].sum_of_squares):
        assert a.dtype == td and s.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=2e-2, atol=2e-2)
            np.testing.assert_allclose(_np(s), _np(js), rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_matches_jax_update(dtype):
    """SGD's step against the JAX package's train_step update ``p - lr * g``
    under jit, with lr a Python float (weakly typed, so rounded to the
    tensor's dtype), and no state: bit-equal in bfloat16 (XLA rounds each
    bfloat16 op); float32 within rtol 1e-6 / atol 1e-7, since XLA contracts
    the float32 update into one fused multiply-add on the CPU where SGD
    rounds the product first."""
    rng = np.random.default_rng(6)
    shapes = [(7, 5), (33,), (4, 3, 2)]
    params = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [rng.uniform(-2, 2, s).astype(np.float32) for s in shapes]
    jd = jnp.dtype(dtype)
    want = jax.jit(lambda ps, gs, lr: [p - lr * g for p, g in zip(ps, gs)])(
        [jnp.asarray(p, jd) for p in params], [jnp.asarray(g, jd) for g in grads], 0.3)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tp = [torch.from_numpy(p).to(td) for p in params]
    sgd = SGD(0.3)
    assert sgd.init(tp) == []
    sgd.update(tp, [torch.from_numpy(g).to(td) for g in grads])
    for a, b in zip(tp, want):
        assert a.dtype == td
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["micro", "qr", *HEADS])
def test_forward_train_gradients_match_jax(name):
    """The gradient of the BCE loss with respect to every trainable tensor,
    through forward_train, against jax.grad of the JAX loss through
    model.forward, from the same weights (params_from_jax); forward_train's
    scores equal forward's."""
    jc, tc = variant(name, JC), variant(name, TC)
    jm, jp, model = _pair(jc, tc)
    idx, dense, labels = _batch(jc, jc.batch_size, 31)

    def loss_fn(params):
        return jtrain.bce_with_logits(jm.forward(params, jnp.asarray(idx), _j(dense)),
                                      jnp.asarray(labels))

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jp)
    want = _jax_named(want)
    tensors = trainable_tensors(model)
    assert list(tensors) == list(want), (list(tensors), list(want))
    leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
    scores = model.forward_train(_t(idx), _t(dense), leaves)
    with torch.no_grad():
        np.testing.assert_array_equal(scores.detach().numpy(), model(_t(idx), _t(dense)).numpy())
    loss = bce_with_logits(scores, _t(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, v), g in zip(tensors.items(), grads):
        assert g.shape == v.shape and g.dtype == v.dtype, k
        _close(g, want[k], what=f"{name} {k}")


@pytest.mark.parametrize("name", ["micro", "micro_dlrm"])
def test_three_trainer_steps_match_jax(name):
    """Three Trainer steps (Adagrad 1e-2) on three batches against JAX's
    Trainer (optax.adagrad(1e-2)): losses and every tensor after them."""
    jc, tc = variant(name, JC), variant(name, TC)
    jm, jp, model = _pair(jc, tc)
    batches = [_batch(jc, jc.batch_size, 40 + k) for k in range(3)]
    jparams, jlosses = jtrain.Trainer(jm).fit(jp, batches)
    losses = Trainer(model, device=CPU).fit(batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = _jax_named(jparams)
    for k, v in trainable_tensors(model).items():
        _close(v, want[k], rtol=1e-5, what=f"{name} {k}")


def test_bad_take_id_poisons_the_loss_and_not_the_gradients():
    """A batch with an out-of-range take id: the loss is NaN in both
    packages; every gradient is finite and equal (the poisoned row's
    cotangent is 0; JAX's wrapped read of the id adds 0 where the port reads
    no row)."""
    jc, tc = variant("striped", JC), variant("striped", TC)
    jm, jp, model = _pair(jc, tc)
    idx, dense, labels = _batch(jc, jc.batch_size, 51)
    take = [j for j, t in enumerate(tc.tables) if t.rows > tc.onehot_max]
    idx[3, take[0]] = -1
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jtrain.bce_with_logits(
        jm.forward(p, jnp.asarray(idx), _j(dense)), jnp.asarray(labels))))(jp)
    want = _jax_named(want)
    tensors = trainable_tensors(model)
    leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
    scores = model.forward_train(_t(idx), _t(dense), leaves)
    assert np.flatnonzero(np.isnan(scores.detach().numpy())).tolist() == [3]
    loss = bce_with_logits(scores, _t(labels))
    assert np.isnan(loss.item()) and np.isnan(float(want_loss))
    for k, g in zip(tensors, torch.autograd.grad(loss, list(leaves.values()))):
        assert np.isfinite(_np(g)).all() and np.isfinite(_np(want[k])).all(), k
        _close(g, want[k], what=k)


def test_trainer_reduces_loss_and_serves():
    """Twin of tests/test_sharding.py::test_trainer_reduces_loss_and_serves:
    Adagrad(0.3) on micro_test, the label the sign of one dense feature: the
    loss falls, and the trained module serves through its forward."""
    cfg = TC.micro_test(batch_size=64)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, t.rows, 64) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, (64, cfg.dense_dim)).astype(np.float32)
    labels = (dense[:, 0] > 0).astype(np.float32)
    losses = Trainer(model, lr=0.3, device=CPU).fit([(idx, dense, labels)] * 80)
    assert losses[-1] < losses[0] * 0.7, losses[::20]
    with torch.inference_mode():
        scores = model(_t(idx), _t(dense)).numpy()
    assert np.mean((scores > 0) == (labels > 0.5)) > 0.8


def test_float_train_then_quantized_serve_roundtrip(tmp_path):
    """Twin of tests/test_io_multihost.py::
    test_float_train_then_quantized_serve_roundtrip: train float tables,
    quantize_tables, save, load into the int8 config, serve within the
    quantization error; the fingerprint refuses the float config."""
    cfg = TC.micro_test(batch_size=32)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    idx, dense, _ = _batch(cfg, 32, 0)
    labels = (dense[:, 0] > 0).astype(np.float32)
    Trainer(model, device=CPU).fit([(idx, dense, labels)] * 3)
    with torch.inference_mode():
        float_scores = model(_t(idx), _t(dense)).numpy()
    cfg8 = dataclasses.replace(cfg, table_dtype="int8")
    path = str(tmp_path / "q.npz")
    tio.save_npz(path, tio.quantize_tables(model))
    loaded = tio.load_npz(path, cfg8, device=CPU)
    with torch.inference_mode():
        q_scores = loaded(_t(idx), _t(dense)).numpy()
    assert np.all(np.isfinite(q_scores))
    np.testing.assert_allclose(q_scores, float_scores, atol=0.35, rtol=0.1)
    with pytest.raises(tio.ConfigMismatchError):
        tio.load_npz(path, cfg, device=CPU)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """init_model, load_npz, params_from_jax and Trainer run on the card
    unless asked for the CPU: on a host without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.micro_test(batch_size=8)
    model = init_model(cfg, device=CPU)
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, model)
    _, jp = j_init_model(JC.micro_test(batch_size=8))
    pj = jax.tree_util.tree_map(np.asarray, jp)
    for call in (lambda: init_model(cfg), lambda: tio.load_npz(path, cfg),
                 lambda: params_from_jax(cfg, pj), lambda: Trainer(model)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    Trainer(model, device=CPU)
