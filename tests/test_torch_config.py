"""The port's copies of the jax-free modules (config, reference oracle,
wire format) and of the data and native files (configs' JSON, the ingest
tier's C++) against the JAX package's originals, and the port's import
rule: nothing in fleetrec_tpu_torch/, chip_smoke.py or chip_mesh.py imports
jax, optax or fleetrec_tpu, or names a path under fleetrec_tpu/."""

import ast
import dataclasses
import pathlib
import re

import numpy as np
import pytest

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.serving.wire import IndexWireFormat as JWire
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import reference as tref
from fleetrec_tpu_torch.serving.wire import IndexWireFormat as TWire

REPO = pathlib.Path(__file__).resolve().parent.parent


def _leaves(tree):
    """The arrays of nested lists and dicts (dicts in key order), in order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _leaves(t)]
    return [tree]


def _as_jax(cfg) -> dict:
    """``dataclasses.asdict`` of a port config without the fields the JAX
    package's dataclasses lack (``MLPSpec.last_activation``), each of which
    must hold its default there."""
    d = dataclasses.asdict(cfg)
    for tower in ("mlp", "bottom_mlp"):
        if d.get(tower) is not None:
            assert d[tower].pop("last_activation") is False
    return d


@pytest.mark.parametrize("name", sorted(JC.CONFIGS))
def test_every_config_equal_field_by_field(name):
    j, t = JC.get_config(name), TC.get_config(name)
    assert dataclasses.asdict(j) == _as_jax(t)
    assert sorted(TC.CONFIGS) == sorted(JC.CONFIGS)


@pytest.mark.parametrize("kw", [
    {"batch_size": 4096}, {"dtype": "bfloat16"}, {"onehot_max": 1024},
])
def test_factory_arguments_equal(kw):
    for name in ("fleetrec_model1", "fleetrec_model2", "fleetrec_model3"):
        j, t = JC.get_config(name, **kw), TC.get_config(name, **kw)
        assert dataclasses.asdict(j) == _as_jax(t)


@pytest.mark.parametrize("width", [512, 1024])
def test_parity_synthetic_and_closed_form_equal(width):
    assert (dataclasses.asdict(JC.parity_synthetic(width))
            == _as_jax(TC.parity_synthetic(width)))
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
    """The oracle's weights and forward, for the plain model and both
    interaction heads (the bottom tower's and the cross layers' weights,
    ``dot_interaction_np`` and ``cross_network_np``)."""
    for kw in ({"name": "micro_test"}, {"name": "micro_dlrm"}, {"name": "micro_cross"},
               {"name": "micro_cross", "cross_layers": 1, "cross_rank": 4}):
        cfg_j, cfg_t = JC.get_config(batch_size=8, **kw), TC.get_config(batch_size=8, **kw)
        tabs = jref.init_tables(cfg_j, "uniform")
        for scheme in ("ones", "uniform"):
            wj = jref.init_mlp_weights(cfg_j, scheme, seed=2)
            wt = tref.init_mlp_weights(cfg_t, scheme, seed=2)
            heads_j, heads_t = {}, {}
            if cfg_j.bottom_mlp is not None:
                heads_j["bottom_weights"] = jref.init_bottom_weights(cfg_j, scheme, seed=2)
                heads_t["bottom_weights"] = tref.init_bottom_weights(cfg_t, scheme, seed=2)
            if cfg_j.interaction == "cross":
                heads_j["cross_weights"] = jref.init_cross_weights(cfg_j, scheme, seed=2)
                heads_t["cross_weights"] = tref.init_cross_weights(cfg_t, scheme, seed=2)
            assert heads_j.keys() == heads_t.keys() and len(heads_j) == (kw["name"] != "micro_test")
            leaves_j, leaves_t = _leaves([wj, heads_j]), _leaves([wt, heads_t])
            assert len(leaves_j) == len(leaves_t)
            for a, b in zip(leaves_j, leaves_t):
                np.testing.assert_array_equal(a, b)
            rng = np.random.default_rng(0)
            idx = np.stack([rng.integers(0, t.rows, 8) for t in cfg_j.tables], 1)
            dense = rng.uniform(-1, 1, (8, cfg_j.dense_dim)).astype(np.float32)
            np.testing.assert_array_equal(
                jref.forward(cfg_j, tabs, wj, idx, dense, **heads_j),
                tref.forward(cfg_t, tabs, wt, idx, dense, **heads_t))
            if cfg_j.interaction == "dot":
                vecs = rng.standard_normal((8, 5, 8))
                np.testing.assert_array_equal(jref.dot_interaction_np(vecs),
                                              tref.dot_interaction_np(vecs))


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
    return files + [REPO / "chip_smoke.py", REPO / "chip_mesh.py"]


def test_port_imports_neither_jax_nor_fleetrec_tpu():
    """AST scan of every module of the port (the training module among
    them), chip_smoke.py and chip_mesh.py: no jax, optax, orbax or
    fleetrec_tpu import (the sharded checkpoints use
    torch.distributed.checkpoint)."""
    bad = []
    files = _port_files()
    assert len(files) > 15 and REPO / "fleetrec_tpu_torch/models/train.py" in files
    assert {REPO / f"fleetrec_tpu_torch/parallel/{m}.py"
            for m in ("__init__", "mesh", "multihost", "sharded", "planner", "dryrun")} <= set(files)
    assert {REPO / "fleetrec_tpu_torch/io.py", REPO / "fleetrec_tpu_torch/models/biginit.py",
            REPO / "fleetrec_tpu_torch/benchmarks/collectives.py",
            REPO / "fleetrec_tpu_torch/serving/stress.py"} <= set(files)
    assert (REPO / "chip_mesh.py").is_file()
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
                if n.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "fleetrec_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad, bad


# the port's copies of the JAX package's data and native files
COPIES = [("fleetrec_tpu_torch/configs/fleetrec_model1.json", "fleetrec_tpu/configs/fleetrec_model1.json"),
          ("fleetrec_tpu_torch/configs/fleetrec_model2.json", "fleetrec_tpu/configs/fleetrec_model2.json"),
          ("fleetrec_tpu_torch/configs/fleetrec_model3_fpga.json",
           "fleetrec_tpu/configs/fleetrec_model3_fpga.json"),
          ("fleetrec_tpu_torch/native/ingest.cpp", "fleetrec_tpu/native/ingest.cpp"),
          ("fleetrec_tpu_torch/native/scatter.cpp", "fleetrec_tpu/native/scatter.cpp"),
          ("fleetrec_tpu_torch/native/stress_test.cpp", "fleetrec_tpu/native/stress_test.cpp")]


@pytest.mark.parametrize("copy,original", COPIES)
def test_data_and_native_copies_are_byte_equal(copy, original):
    assert (REPO / copy).read_bytes() == (REPO / original).read_bytes()


def test_every_config_json_of_the_jax_package_is_copied():
    copied = {pathlib.Path(o).name for _, o in COPIES}
    assert {p.name for p in (REPO / "fleetrec_tpu" / "configs").glob("*.json")} <= copied


def _docstrings(tree):
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


# a "file:line" citation of a TPU kernel (the kernels' record): no path to open
_CITATION = re.compile(r"fleetrec_tpu/[\w/]+\.py:\d+")


def test_port_names_no_path_under_fleetrec_tpu():
    """Scan of every string in the code of the port's modules,
    chip_smoke.py and chip_mesh.py (docstrings aside): none is the path component
    ``fleetrec_tpu`` or a path under ``fleetrec_tpu/``."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        skip = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in skip):
                text = _CITATION.sub("", node.value)
                if text.strip("/\\") == "fleetrec_tpu" or re.search(r"fleetrec_tpu[/\\]", text):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {node.value!r}")
    assert not bad, bad


@pytest.mark.parametrize("where", ["port", "tests"])
def test_no_module_defines_a_function_or_class_twice(where):
    """AST scan of the port's modules, chip_smoke.py and chip_mesh.py, or of
    the port's test modules: no module or class body defines one name twice
    (the later definition would hide the earlier, and pytest would collect
    only the later of two tests of one name)."""
    files = (_port_files() if where == "port" else
             sorted((REPO / "tests").glob("test_torch_*.py")) + [REPO / "tests/torch_variants.py"])
    assert len(files) > 10
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Module, ast.ClassDef)):
                continue
            names = [n.name for n in node.body
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in set(names) if names.count(n) > 1]
    assert not bad, bad
