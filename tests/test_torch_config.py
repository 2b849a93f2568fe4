"""The port's copies of the jax-free modules (config, reference oracle,
wire format) against the JAX package's originals, and the port's import
rule: nothing in fleetrec_tpu_torch/ or chip_smoke.py imports jax or
fleetrec_tpu."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.serving.wire import IndexWireFormat as JWire
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import reference as tref
from fleetrec_tpu_torch.serving.wire import IndexWireFormat as TWire

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(JC.CONFIGS))
def test_every_config_equal_field_by_field(name):
    j, t = JC.get_config(name), TC.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert sorted(TC.CONFIGS) == sorted(JC.CONFIGS)


@pytest.mark.parametrize("kw", [
    {"batch_size": 4096}, {"dtype": "bfloat16"}, {"onehot_max": 1024},
])
def test_factory_arguments_equal(kw):
    for name in ("fleetrec_model1", "fleetrec_model2", "fleetrec_model3"):
        j, t = JC.get_config(name, **kw), TC.get_config(name, **kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("width", [512, 1024])
def test_parity_synthetic_and_closed_form_equal(width):
    assert (dataclasses.asdict(JC.parity_synthetic(width))
            == dataclasses.asdict(TC.parity_synthetic(width)))
    assert (jref.closed_form_all_ones_score(width)
            == tref.closed_form_all_ones_score(width))


def test_qr_expand_equal():
    j = JC.criteo_terabyte(qr_threshold=1_000_000, qr_rem=131072)
    t = TC.criteo_terabyte(qr_threshold=1_000_000, qr_rem=131072)
    ji, jp, js = JC.qr_expand(j)
    ti, tp, ts = TC.qr_expand(t)
    assert [dataclasses.asdict(x) for x in ji] == [dataclasses.asdict(x) for x in ti]
    assert (jp, js) == (tp, ts)


def test_validate_rejects_int8_activations():
    with pytest.raises(AssertionError, match="activation"):
        dataclasses.replace(TC.micro_test(), dtype="int8").validate()


@pytest.mark.parametrize("scheme", ["pm1", "plram", "rowid", "uniform"])
def test_oracle_tables_equal(scheme):
    cfg_j, cfg_t = JC.micro_test(), TC.micro_test()
    for a, b in zip(jref.init_tables(cfg_j, scheme, seed=3),
                    tref.init_tables(cfg_t, scheme, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_oracle_forward_equal():
    cfg_j, cfg_t = JC.micro_test(batch_size=8), TC.micro_test(batch_size=8)
    tabs = jref.init_tables(cfg_j, "uniform")
    for scheme in ("ones", "uniform"):
        wj = jref.init_mlp_weights(cfg_j, scheme, seed=2)
        wt = tref.init_mlp_weights(cfg_t, scheme, seed=2)
        for a, b in zip(wj, wt):
            np.testing.assert_array_equal(a, b)
        rng = np.random.default_rng(0)
        idx = np.stack([rng.integers(0, t.rows, 8) for t in cfg_j.tables], 1)
        dense = rng.uniform(-1, 1, (8, cfg_j.dense_dim)).astype(np.float32)
        np.testing.assert_array_equal(
            jref.forward(cfg_j, tabs, wj, idx, dense),
            tref.forward(cfg_t, tabs, wt, idx, dense))


def test_wire_format_equal():
    cfg_j = JC.fleetrec_model3(batch_size=4)
    cfg_t = TC.fleetrec_model3(batch_size=4)
    wj, wt = JWire.plan(cfg_j, 4, 3), TWire.plan(cfg_t, 4, 3)
    assert dataclasses.asdict(wj) == dataclasses.asdict(wt)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 100, (4, cfg_j.num_tables)).astype(np.int32)
    dense = rng.uniform(-1, 1, (4, 64)).astype(np.float32)
    pj, pt = wj.payloads(idx, dense), wt.payloads(idx, dense)
    assert pj == pt
    view = np.frombuffer(b"".join(pt), np.float32)
    for (a, b) in zip(wj.parse(view), wt.parse(view)):
        np.testing.assert_array_equal(a, b)


def _port_files():
    files = sorted((REPO / "fleetrec_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_fleetrec_tpu():
    """AST scan of every module of the port and chip_smoke.py."""
    bad = []
    files = _port_files()
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "fleetrec_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, bad
