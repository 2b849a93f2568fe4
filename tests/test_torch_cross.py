"""Twin of tests/test_cross.py's single-device tests (the sharded and
training ones wait for the port's multi-device and training modules): the
port's DCNv2 cross-interaction model against the JAX package and the
float64 oracle on the same inputs, made from a numpy seed.  On the CPU the
port runs its plain PyTorch path; the JAX side runs as its own tests run it
(``jax.jit(model.forward)``).  pm1 tables, all-ones weights (zero biases)
and 0/1 dense values keep every sum an integer below 2^24, so those scores
are bit-equal; uniform data is held to rtol 1e-5 / atol 1e-6, bfloat16 to
rtol 2e-2 with atol 2e-2 * max|oracle|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import io as jio
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu.models import interaction as jint
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models import interaction as tint
from torch_variants import CPU, variant

RANKS = ["micro_cross", "micro_cross_r4"]


def make_inputs(cfg, B, seed=0):
    """Ids and 0/1 dense values, as tests/test_cross.py makes them."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    return idx, rng.integers(0, 2, (B, cfg.dense_dim)).astype(np.float32)


def oracle(cfg, idx, dense, table_scheme="pm1", mlp_scheme="ones"):
    return jref.forward(cfg, jref.init_tables(cfg, table_scheme),
                        jref.init_mlp_weights(cfg, mlp_scheme), idx, dense,
                        cross_weights=jref.init_cross_weights(cfg, mlp_scheme))


def jax_scores(model, params, idx, dense):
    return np.asarray(jax.jit(model.forward)(params, jnp.asarray(idx), jnp.asarray(dense)))


def port_scores(model, idx, dense):
    with torch.inference_mode():
        return model(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()


@pytest.mark.parametrize("name", ["micro_cross", "mixed"])
def test_micro_cross_parity_bitexact(name):
    """Two full-rank layers on pm1 / all-ones data: bit-equal to the oracle
    and to JAX, also with table 0 one-hot and the rest take tables."""
    jc, tc = (variant("micro_cross", C) for C in (JC, TC))
    if name == "mixed":
        jc, tc = (dataclasses.replace(c, onehot_max=70) for c in (jc, tc))
    model = init_model(tc, device=CPU)
    assert len(model.cross_weights) == 2 and len(model.cross_weights[0]) == 2
    idx, dense = make_inputs(jc, 32)
    got = port_scores(model, idx, dense)
    np.testing.assert_array_equal(got, oracle(jc, idx, dense).astype(np.float32))
    np.testing.assert_array_equal(got, jax_scores(*j_init_model(jc), idx, dense))


def test_micro_cross_lowrank_parity():
    jc, tc = variant("micro_cross_r4", JC), variant("micro_cross_r4", TC)
    model = init_model(tc, device=CPU)
    assert [tuple(w.shape) for w in model.cross_weights[0]] == [(92, 4), (4, 92), (92,)]
    idx, dense = make_inputs(jc, 32, seed=5)
    got = port_scores(model, idx, dense)
    np.testing.assert_array_equal(got, oracle(jc, idx, dense).astype(np.float32))
    np.testing.assert_array_equal(got, jax_scores(*j_init_model(jc), idx, dense))


@pytest.mark.parametrize("name", RANKS)
def test_micro_cross_uniform_close(name):
    jc, tc = variant(name, JC), variant(name, TC)
    idx, dense = make_inputs(jc, 32, seed=6)
    got = port_scores(init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU), idx, dense)
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    np.testing.assert_allclose(got, jax_scores(jm, jp, idx, dense), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle(jc, idx, dense, "uniform", "uniform"),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", RANKS)
def test_bfloat16_matches_the_oracle(name):
    """bfloat16 tables and activations against the float64 oracle: rtol
    2e-2, atol 2e-2 * max|oracle|.  (JAX's CPU backend refuses the bf16 x
    bf16 -> f32 products of its cross layers, so the oracle stands in.)"""
    jc = variant(name, JC)
    tc = dataclasses.replace(variant(name, TC), dtype="bfloat16", table_dtype="bfloat16")
    rng = np.random.default_rng(7)
    idx = make_inputs(jc, 32, seed=7)[0]
    dense = rng.uniform(-1, 1, (32, jc.dense_dim)).astype(np.float32)
    got = port_scores(init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU), idx, dense)
    want = oracle(jc, idx, dense, "uniform", "uniform")
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("rank", [0, 4])
@pytest.mark.parametrize("scheme", ["ones", "uniform"])
def test_cross_layers_equal_jax(scheme, rank):
    """init_cross_params gives JAX's weights bit for bit; cross_network
    gives JAX's output within 1e-6 in fp32 (sums in another order)."""
    F = 92
    tl = tint.init_cross_params(F, 2, rank=rank, scheme=scheme, seed=3)
    jl = jint.init_cross_params(F, 2, rank=rank, scheme=scheme, seed=3)
    assert [[tuple(w.shape) for w in layer] for layer in tl] == \
        [[w.shape for w in layer] for layer in jl]
    for a, b in zip(jax.tree_util.tree_leaves(jl), [w for layer in tl for w in layer]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if scheme == "uniform":
        x0 = np.random.default_rng(4).uniform(-1, 1, (16, F)).astype(np.float32)
        got = tint.cross_network(torch.from_numpy(x0), tl).numpy()
        want = np.asarray(jint.cross_network(jnp.asarray(x0), jl, precision="highest"))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_params_from_jax_is_the_ports_own_model():
    jc, tc = variant("micro_cross_r4", JC), variant("micro_cross_r4", TC)
    _, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    pj = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_jax(tc, pj, device=CPU)
    built = init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    for (ka, a), (kb, b) in zip(conv.named_buffers(), built.named_buffers()):
        assert ka == kb and torch.equal(a, b), ka
    with pytest.raises(ValueError, match="cross"):
        params_from_jax(tc, {**pj, "cross": [pj["cross"][0][1:]]}, device=CPU)


@pytest.mark.parametrize("name", RANKS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_checkpoint_crosses_both_ways(tmp_path, direction, name):
    """JAX save_npz -> port load_npz, and port save_npz -> JAX load_npz:
    every ``cross_<layer>_<j>`` array bit-equal, the scores
    within rtol 1e-5 / atol 1e-6 of JAX's and bit-equal to the model the
    file was written from."""
    jc, tc = variant(name, JC), variant(name, TC)
    path = str(tmp_path / "cross.npz")
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    built = init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    idx, dense = make_inputs(jc, 32, seed=8)
    if direction == "jax_to_port":
        jio.save_npz(path, jp, cfg=jc)
        scores = port_scores(tio.load_npz(path, tc, device=CPU), idx, dense)
        want = jax_scores(jm, jp, idx, dense)
        np.testing.assert_array_equal(scores, port_scores(built, idx, dense))
    else:
        tio.save_npz(path, built)
        loaded = jio.load_npz(path, jm)
        scores, want = jax_scores(jm, loaded, idx, dense), port_scores(built, idx, dense)
        np.testing.assert_array_equal(scores, jax_scores(jm, jp, idx, dense))
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-6)
    with np.load(path) as data:
        for li, layer in enumerate(jp["cross"]):
            for j, w in enumerate(layer):
                np.testing.assert_array_equal(data[f"cross_{li}_{j}"], np.asarray(w))
        assert f"cross_{len(jp['cross'])}_0" not in data


def test_a_checkpoint_of_another_rank_raises_naming_the_array(tmp_path):
    """With its fingerprint gone, a full-rank file loaded as a rank-4 model
    fails the shape check on the first cross array."""
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, init_model(variant("micro_cross", TC), device=CPU))
    with np.load(path) as data:
        arrs = {k: data[k] for k in data.files if k != "config_fingerprint"}
    np.savez(path, **arrs)
    r4 = dataclasses.replace(variant("micro_cross", TC), cross_rank=4)
    with pytest.raises(tio.ConfigMismatchError, match=r"array 'cross_0_0' has shape \(92, 92\)"):
        tio.load_npz(path, r4, device=CPU)


def test_cross_fingerprint_depends_on_knobs():
    cfgs = [dict(cross_layers=2), dict(cross_layers=3), dict(cross_layers=2, cross_rank=4)]
    fps = {tio.config_fingerprint(TC.micro_cross(**kw)) for kw in cfgs}
    fps.add(tio.config_fingerprint(TC.micro_test()))
    assert len(fps) == 4  # depth, rank and interaction all distinguish
    for kw in cfgs:
        assert (tio.config_fingerprint(TC.micro_cross(**kw))
                == jio.config_fingerprint(JC.micro_cross(**kw)))


def test_cross_knob_validation():
    # stale cross knobs on a non-cross config must be rejected
    with pytest.raises(AssertionError):
        dataclasses.replace(TC.micro_test(), cross_rank=4).validate()
    with pytest.raises(AssertionError):
        dataclasses.replace(TC.micro_dlrm(), cross_layers=1).validate()
    with pytest.raises(AssertionError):
        dataclasses.replace(TC.micro_test(), interaction="cross", cross_layers=0).validate()
