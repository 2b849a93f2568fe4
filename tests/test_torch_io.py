"""The port's io.py against the JAX package's: the same config
fingerprints, the same int8 bytes and scales from quantize_tables, and npz
checkpoints that cross between the packages both ways (bfloat16 from JAX
to the port only: the JAX package cannot read its own bfloat16 files back).
Scores are compared bit for bit on the pm1 / all-ones parity data, whose
sums are exact in float32."""

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
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.models import init_model


def _variant(name, C, table_dtype="float32"):
    """Configs built the same way from either package's config module."""
    base = C.micro_test(batch_size=24)
    if name == "tiers":
        # rows straddle all three tiers (plain / factored / take)
        rows = [40, 50, 300, 700, 900, 1400, 3000, 5000]
        cfg = dataclasses.replace(
            base, tables=tuple(dataclasses.replace(t, rows=rows[i])
                               for i, t in enumerate(base.tables)),
            onehot_max=64, onehot_factor_max=1500, onehot_r2=32)
    elif name == "striped":
        cfg = dataclasses.replace(base, onehot_max=70, take_stripes=4)
    elif name == "qr":
        cfg = dataclasses.replace(base, onehot_max=8, qr_threshold=80, qr_rem=16)
    else:
        raise KeyError(name)
    return dataclasses.replace(cfg, table_dtype=table_dtype)


CASES = ["tiers", "striped", "qr"]


def _data(cfg, B=24, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.choice([-1.0, 1.0], (B, cfg.dense_dim)).astype(np.float32)
    return idx, dense


def _jax_scores(model, params, idx, dense):
    return np.asarray(jax.jit(model.forward)(params, jnp.asarray(idx), jnp.asarray(dense)))


def _port_scores(model, idx, dense):
    with torch.inference_mode():
        return model(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", sorted(JC.CONFIGS))
def test_fingerprint_equals_jax_for_every_config(name):
    assert tio.config_fingerprint(TC.get_config(name)) == jio.config_fingerprint(JC.get_config(name))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("table_dtype", ["float32", "int8", "bfloat16"])
def test_fingerprint_equals_jax_for_layout_variants(name, table_dtype):
    assert (tio.config_fingerprint(_variant(name, TC, table_dtype))
            == jio.config_fingerprint(_variant(name, JC, table_dtype)))


@pytest.mark.parametrize("name", CASES)
def test_quantize_tables_bytes_equal_jax(name):
    """Twin of the int8 half of test_ops.py::test_pm1_direct_pack_matches_
    pack_tables, through quantize_tables on uniform float tables: the same
    int8 bytes and power-of-two scales, bit for bit."""
    jcfg, tcfg = _variant(name, JC), _variant(name, TC)
    jmodel, _ = j_init_model(jcfg)
    tables = [jref.init_table(t, scheme="uniform", seed=4)
              for t in (jmodel.spec_tables or jcfg.tables)]
    jmodel, jparams = j_init_model(jcfg, tables_np=tables)
    jq = jio.quantize_tables(jparams, jmodel)["tables"]
    tq = tio.quantize_tables(init_model(tcfg, tables_np=tables))
    assert tq.cfg.table_dtype == "int8"
    packed = tq.packed
    assert len(packed.onehot_buffers) == len(jq.onehot_buffers)
    for a, b in zip(packed.onehot_buffers, jq.onehot_buffers):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(packed.onehot_scales, jq.onehot_scales):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(-1))
    if jq.take_buffer is not None:
        np.testing.assert_array_equal(packed.take_buffer.numpy(), np.asarray(jq.take_buffer))
        np.testing.assert_array_equal(packed.take_scales.numpy(), np.asarray(jq.take_scales))
    with pytest.raises(ValueError, match="already"):
        tio.quantize_tables(tq)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, name, table_dtype):
    """JAX save_npz -> port load_npz: the same buffers, and scores
    bit-equal to the JAX forward on the pm1 / all-ones data."""
    jcfg, tcfg = _variant(name, JC, table_dtype), _variant(name, TC, table_dtype)
    jmodel, jparams = j_init_model(jcfg)
    path = str(tmp_path / "j.npz")
    jio.save_npz(path, jparams, cfg=jcfg)
    tmodel = tio.load_npz(path, tcfg)
    assert tmodel.cfg == tcfg
    for a, b in zip(tmodel.packed.onehot_buffers, jparams["tables"].onehot_buffers):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx, dense = _data(tcfg)
    np.testing.assert_array_equal(_port_scores(tmodel, idx, dense),
                                  _jax_scores(jmodel, jparams, idx, dense))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_port_checkpoint_loads_into_jax(tmp_path, name, table_dtype):
    """Port save_npz -> JAX load_npz: scores bit-equal to the port's."""
    jcfg, tcfg = _variant(name, JC, table_dtype), _variant(name, TC, table_dtype)
    tmodel = init_model(tcfg)
    path = str(tmp_path / "t.npz")
    tio.save_npz(path, tmodel)
    jmodel, _ = j_init_model(jcfg)
    jparams = jio.load_npz(path, jmodel)
    idx, dense = _data(tcfg, seed=1)
    np.testing.assert_array_equal(_jax_scores(jmodel, jparams, idx, dense),
                                  _port_scores(tmodel, idx, dense))


def test_int8_export_of_the_port_loads_into_jax(tmp_path):
    """quantize_tables -> save_npz in the port, load_npz in JAX: the int8
    checkpoint is fingerprinted for the int8 config and scores the same."""
    tcfg = _variant("tiers", TC)
    tq = tio.quantize_tables(init_model(tcfg))
    path = str(tmp_path / "q.npz")
    tio.save_npz(path, tq)
    jmodel, _ = j_init_model(_variant("tiers", JC, "int8"))
    jparams = jio.load_npz(path, jmodel)
    idx, dense = _data(tcfg, seed=2)
    np.testing.assert_array_equal(_jax_scores(jmodel, jparams, idx, dense),
                                  _port_scores(tq, idx, dense))


@pytest.mark.parametrize("name", CASES)
def test_bfloat16_jax_checkpoint_loads_into_the_port(tmp_path, name):
    """JAX writes bfloat16 arrays as |V2; the port reads them through a
    uint16 view, bit for bit, and scores them as a model built directly
    in bfloat16 does."""
    jcfg, tcfg = _variant(name, JC, "bfloat16"), _variant(name, TC, "bfloat16")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    _, jparams = j_init_model(jcfg)
    path = str(tmp_path / "b.npz")
    jio.save_npz(path, jparams, cfg=jcfg)
    with np.load(path) as data:
        assert data["onehot_0"].dtype == np.dtype("V2")
    tmodel = tio.load_npz(path, tcfg)
    for a, b in zip(tmodel.packed.onehot_buffers, jparams["tables"].onehot_buffers):
        np.testing.assert_array_equal(_port_bits(a), _bits(b))
    for a, b in zip(tmodel.mlp_weights, jparams["mlp"]):
        np.testing.assert_array_equal(_port_bits(a), _bits(b))
    idx, dense = _data(tcfg, seed=3)
    np.testing.assert_array_equal(_port_scores(tmodel, idx, dense),
                                  _port_scores(init_model(tcfg), idx, dense))


def test_bfloat16_round_trip_in_the_port(tmp_path):
    tcfg = dataclasses.replace(_variant("tiers", TC, "bfloat16"), dtype="bfloat16")
    tmodel = init_model(tcfg, table_scheme="uniform", mlp_scheme="uniform")
    path = str(tmp_path / "b.npz")
    tio.save_npz(path, tmodel)
    with np.load(path) as data:
        assert data["take"].dtype == np.dtype("V2") and data["mlp_0"].dtype == np.dtype("V2")
    back = tio.load_npz(path, tcfg)
    for (n, a), (_, b) in zip(tmodel.named_buffers(), back.named_buffers()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_a_mismatched_shape_raises_naming_the_array(tmp_path):
    """onehot_r2 is not in the fingerprint (as in the reference) but
    reshapes the factored classes: the shape check catches it."""
    tcfg = _variant("tiers", TC)
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, init_model(tcfg))
    other = dataclasses.replace(tcfg, onehot_r2=64)
    assert tio.config_fingerprint(other) == tio.config_fingerprint(tcfg)
    with pytest.raises(tio.ConfigMismatchError, match=r"array 'onehot_\d+' has shape"):
        tio.load_npz(path, other)


def test_a_missing_array_and_a_wrong_fingerprint_raise(tmp_path):
    tcfg = _variant("tiers", TC)
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, init_model(tcfg))
    with np.load(path) as data:
        arrs = {k: data[k] for k in data.files if k != "mlp_1"}
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **arrs)
    with pytest.raises(tio.ConfigMismatchError, match="no array 'mlp_1'"):
        tio.load_npz(cut, tcfg)
    with pytest.raises(tio.ConfigMismatchError, match="fingerprint"):
        tio.load_npz(path, _variant("striped", TC))
