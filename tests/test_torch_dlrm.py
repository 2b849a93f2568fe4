"""Twin of tests/test_dlrm.py's single-device tests (the sharded and
training ones wait for the port's multi-device and training modules): the
port's DLRM dot-interaction model against the JAX package and the float64
oracle on the same inputs, made from a numpy seed.  On the CPU the port
runs its plain PyTorch path; the JAX side runs as its own tests run it
(``jax.jit(model.forward)``).  pm1 tables with all-ones weights and small
integer dense values keep every sum an integer below 2^24, so those scores
are bit-equal; uniform data is held to rtol 1e-5 / atol 1e-6 (fp32 sums in
another order), bfloat16 to rtol 2e-2 with atol 2e-2 * max|JAX|.  Ports
21620-21621 are used by no other test file (xdist runs files in parallel)."""

import dataclasses
import json
import socket
import threading
import time

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
from fleetrec_tpu_torch.cli import main as cli_main
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models import interaction as tint
from fleetrec_tpu_torch.serving import ServeSpec, serve
from chip_smoke import ids_with_bad
from torch_variants import CPU, cap, variant


def make_inputs(cfg, B, seed=0):
    """Ids and small-integer dense values, as tests/test_dlrm.py makes them."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    return idx, rng.integers(0, 4, (B, cfg.dense_dim)).astype(np.float32)


def uniform_inputs(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    return idx, rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)


def oracle(cfg, idx, dense, table_scheme="pm1", mlp_scheme="ones"):
    return jref.forward(cfg, jref.init_tables(cfg, table_scheme),
                        jref.init_mlp_weights(cfg, mlp_scheme), idx, dense,
                        bottom_weights=jref.init_bottom_weights(cfg, mlp_scheme))


def jax_scores(model, params, idx, dense):
    return np.asarray(jax.jit(model.forward)(params, jnp.asarray(idx), jnp.asarray(dense)))


def port_scores(model, idx, dense):
    with torch.inference_mode():
        return model(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()


@pytest.mark.parametrize("name", ["micro_dlrm_onehot", "micro_dlrm"])
def test_micro_dlrm_parity_bitexact(name):
    """pm1 tables, all-ones weights: bit-equal to the oracle and to JAX, with
    every table one-hot and with both tiers (``onehot_max=70``, 4 stripes)."""
    jc, tc = variant(name, JC), variant(name, TC)
    idx, dense = make_inputs(jc, jc.batch_size, seed=3)
    got = port_scores(init_model(tc, device=CPU), idx, dense)
    np.testing.assert_array_equal(got, oracle(jc, idx, dense).astype(np.float32))
    np.testing.assert_array_equal(got, jax_scores(*j_init_model(jc), idx, dense))


def test_micro_dlrm_uniform_close():
    jc, tc = variant("micro_dlrm", JC), variant("micro_dlrm", TC)
    idx, dense = uniform_inputs(jc, 32, seed=6)
    got = port_scores(init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU), idx, dense)
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    np.testing.assert_allclose(got, jax_scores(jm, jp, idx, dense), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle(jc, idx, dense, "uniform", "uniform"),
                               rtol=1e-5, atol=1e-6)


def _dlrm_capped(C, **kw):
    """dlrm_terabyte at full widths with every table capped at 512 rows."""
    return cap(C.dlrm_terabyte(batch_size=16, **kw), 512)


def test_dlrm_terabyte_full_widths_matches_jax():
    """26 x 128 tables (512 rows each), bottom 13-512-256-128, 351 pairs,
    ReLU top 479-1024-1024-512-256-1, B = 16: uniform data within rtol
    1e-5 / atol 1e-6 of JAX, rtol 1e-3 / atol 2e-3 of the float64 oracle."""
    jc, tc = _dlrm_capped(JC), _dlrm_capped(TC)
    idx, dense = uniform_inputs(jc, 16, seed=7)
    model = init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    assert model.layout.feature_dim == 26 * 128 and model.layout.dense_dim == 0
    got = port_scores(model, idx, dense)
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    np.testing.assert_allclose(got, jax_scores(jm, jp, idx, dense), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle(jc, idx, dense, "uniform", "uniform"),
                               rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["micro_dlrm", "dlrm_terabyte"])
def test_bfloat16_matches_jax(name):
    """bfloat16 tables and activations: rtol 2e-2, atol 2e-2 * max|JAX|."""
    if name == "dlrm_terabyte":
        jc, tc = _dlrm_capped(JC, dtype="bfloat16"), _dlrm_capped(TC, dtype="bfloat16")
    else:
        jc, tc = (dataclasses.replace(variant(name, C), dtype="bfloat16",
                                      table_dtype="bfloat16") for C in (JC, TC))
    idx, dense = uniform_inputs(jc, jc.batch_size, seed=8)
    got = port_scores(init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU), idx, dense)
    want = jax_scores(*j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform"),
                      idx, dense)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_out_of_range_take_ids_poison_the_same_rows():
    """Bad take ids (-1, rows, 2^31 - 1, -rows - 5 at rows 1-4): NaN on the
    same rows in both packages; the other rows agree."""
    jc, tc = variant("micro_dlrm", JC), variant("micro_dlrm", TC)
    idx = ids_with_bad(jc, 32, np.random.default_rng(9))
    dense = uniform_inputs(jc, 32, seed=10)[1]
    got = port_scores(init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU), idx, dense)
    want = jax_scores(*j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform"),
                      idx, dense)
    bad = np.isnan(want)
    assert bad[1:5].all() and not bad[5:].any()
    np.testing.assert_array_equal(np.isnan(got), bad)
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-5, atol=1e-6)


def test_lookup_is_the_dense_free_concat():
    """The dot layout's lookup gives the [B, T*D] concat in offset order and
    reads no dense tail; the forward still needs the dense features."""
    cfg = variant("micro_dlrm", TC)
    tables = jref.init_tables(cfg, "rowid")
    model = init_model(cfg, tables_np=tables, device=CPU)
    idx, dense = uniform_inputs(cfg, 32, seed=11)
    ti, td = torch.from_numpy(idx), torch.from_numpy(dense)
    with torch.no_grad():
        feats, bad = model.lookup(ti)
        np.testing.assert_array_equal(model.lookup(ti, td)[0].numpy(), feats.numpy())
        with pytest.raises(ValueError, match="dense"):
            model(ti)
    want = np.concatenate([tables[j][idx[:, j]] for j in range(cfg.num_tables)], 1)
    np.testing.assert_array_equal(feats.numpy(), want)
    assert not bad.any()


def test_dot_interaction_equals_jax():
    """[B, n, D] -> the strict lower triangle of the Gram matrix, row-major,
    in the input dtype: fp32 within 1e-6 (sums in another order), bf16 by
    one bf16 rounding of the fp32 sums."""
    vecs = np.random.default_rng(12).standard_normal((16, 27, 128)).astype(np.float32)
    assert tint.num_pairs(27) == jint.num_pairs(27) == 351
    got = tint.dot_interaction(torch.from_numpy(vecs))
    want = np.asarray(jint.dot_interaction(jnp.asarray(vecs)))
    assert got.shape == (16, 351) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    got16 = tint.dot_interaction(torch.from_numpy(vecs).bfloat16())
    want16 = np.asarray(jint.dot_interaction(jnp.asarray(vecs, jnp.bfloat16))).astype(np.float32)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2e-2, atol=2e-2)


def test_pair_columns_are_the_flat_triangle():
    """pair_columns(n) is row-major li * n + lj over the strict lower
    triangle; passed in (as a model passes its buffer) it gives the same
    dots as the columns made per call; a dot model holds it for its
    bottom vector plus its tables."""
    cols = tint.pair_columns(5)
    assert cols.dtype == torch.int64
    assert cols.tolist() == [5, 10, 11, 15, 16, 17, 20, 21, 22, 23]
    vecs = torch.from_numpy(np.random.default_rng(14).standard_normal((4, 27, 16))
                            .astype(np.float32))
    assert torch.equal(tint.dot_interaction(vecs, tint.pair_columns(27)),
                       tint.dot_interaction(vecs))
    model = init_model(variant("micro_dlrm", TC), device=CPU)
    n = model.cfg.num_tables + 1
    assert torch.equal(model.pair_cols, tint.pair_columns(n))
    assert "pair_cols" not in {n for n, _ in init_model(variant("micro_cross", TC), device=CPU)
                               .named_buffers()}


def test_params_from_jax_is_the_ports_own_model():
    """The JAX params (bottom tower included) converted: the same buffers
    and the same scores as the port's own init_model; a bottom tower of the
    wrong depth is refused."""
    jc, tc = variant("micro_dlrm", JC), variant("micro_dlrm", TC)
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    pj = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_jax(tc, pj, device=CPU)
    built = init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    names = [n for n, _ in built.named_buffers()]
    assert "bottom_0" in names and "bottom_1" in names
    for (ka, a), (kb, b) in zip(conv.named_buffers(), built.named_buffers()):
        assert ka == kb and torch.equal(a, b), ka
    idx, dense = uniform_inputs(jc, 32, seed=13)
    np.testing.assert_array_equal(port_scores(conv, idx, dense), port_scores(built, idx, dense))
    with pytest.raises(ValueError, match="bottom"):
        params_from_jax(tc, {**pj, "bottom": pj["bottom"][:1]}, device=CPU)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dlrm_checkpoint_crosses_both_ways(tmp_path, direction):
    """JAX save_npz -> port load_npz, and the port's ``cli export`` -> JAX
    load_npz: every array (``bottom_<i>`` included) bit-equal, the scores
    within rtol 1e-5 / atol 1e-6 of JAX's and bit-equal to the model the
    file was written from."""
    jc, tc = variant("micro_dlrm", JC), variant("micro_dlrm", TC)
    path = str(tmp_path / "dlrm.npz")
    jm, jp = j_init_model(jc, table_scheme="uniform", mlp_scheme="uniform")
    built = init_model(tc, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    idx, dense = uniform_inputs(jc, 32, seed=14)
    if direction == "jax_to_port":
        jio.save_npz(path, jp, cfg=jc)
        loaded = tio.load_npz(path, tc, device=CPU)
        scores, want = port_scores(loaded, idx, dense), jax_scores(jm, jp, idx, dense)
        np.testing.assert_array_equal(scores, port_scores(built, idx, dense))
    else:
        cli_main(["export", "--config", "micro_dlrm", "--batch", "32", "--device", "cpu",
                  "--onehot-max", "70", "--take-stripes", "4", "--table-scheme", "uniform",
                  "--mlp-scheme", "uniform", "--out", path])
        loaded = jio.load_npz(path, jm)
        assert len(loaded["bottom"]) == 2
        scores, want = jax_scores(jm, loaded, idx, dense), port_scores(built, idx, dense)
        np.testing.assert_array_equal(scores, jax_scores(jm, jp, idx, dense))
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-6)
    with np.load(path) as data:
        for i, w in enumerate(jp["bottom"]):
            np.testing.assert_array_equal(data[f"bottom_{i}"], np.asarray(w))


def test_a_checkpoint_without_its_bottom_tower_raises(tmp_path):
    tc = variant("micro_dlrm", TC)
    path = str(tmp_path / "m.npz")
    tio.save_npz(path, init_model(tc, device=CPU))
    with np.load(path) as data:
        arrs = {k: data[k] for k in data.files if k != "bottom_1"}
    np.savez(path, **arrs)
    with pytest.raises(tio.ConfigMismatchError, match="no array 'bottom_1'"):
        tio.load_npz(path, tc, device=CPU)


def test_dlrm_fingerprint_differs_from_plain():
    assert tio.config_fingerprint(TC.micro_dlrm()) != tio.config_fingerprint(TC.micro_test())
    assert tio.config_fingerprint(TC.micro_dlrm()) == jio.config_fingerprint(JC.micro_dlrm())


@pytest.mark.parametrize("stage", ["e2e", "lookup", "mlp"])
def test_cli_bench_stages_on_dlrm(capsys, stage):
    """``cli bench`` on a DLRM config: the lookup stage times the dense-free
    lookup, the mlp stage the top tower (479 wide for dlrm_terabyte)."""
    cli_main(["bench", "--config", "micro_dlrm", "--batch", "16", "--device", "cpu",
              "--iters", "2", "--stage", stage])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["stage"] == stage and r["ms_per_batch"] > 0 and r["device"] == "cpu"


def test_dlrm_terabyte_capped_layout():
    """dlrm_terabyte at 4096 rows a table: a one-hot class of the 10 small
    tables and 16 striped take tables, 26 x 128 features, no dense tail."""
    model = init_model(cap(TC.dlrm_terabyte(batch_size=8), 4096), device=CPU)
    lay = model.layout
    assert (lay.n_onehot, lay.n_take, lay.take_stripes) == (10, 16, 16)
    assert (lay.feature_dim, lay.dense_dim) == (26 * 128, 0)
    assert [tuple(w.shape) for w in model.bottom_weights] == [(13, 512), (512, 256), (256, 128)]


def test_serve_dlrm_over_loopback():
    """serve() of micro_dlrm with replies: ids and dense features of each
    batch on one wire, the replied scores bit-equal to a direct forward."""
    cfg = dataclasses.replace(variant("micro_dlrm", TC), batch_size=8)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    batches = [uniform_inputs(cfg, 8, seed=20 + k) for k in range(3)]
    spec = ServeSpec(batch=8, batches=3, port=21620, slots=4, reply=True)
    out = {}
    th = threading.Thread(target=lambda: out.update(summary=serve(cfg, model, spec)),
                          daemon=True)
    th.start()
    for _ in range(200):
        try:
            sock = socket.create_connection(("127.0.0.1", 21620), timeout=10)
            break
        except OSError:
            time.sleep(0.05)
    else:
        raise AssertionError("serve() never bound its port")
    buf = b""
    with sock:
        for idx, dense in batches:
            sock.sendall(idx.tobytes() + dense.tobytes())
        while len(buf) < 3 * 8 * 4:
            chunk = sock.recv(3 * 8 * 4 - len(buf))
            if not chunk:
                break
            buf += chunk
    th.join(60)
    assert not th.is_alive() and out["summary"]["wire_batches"] == 3
    scores = np.frombuffer(buf, np.float32).reshape(3, 8)
    for k, (idx, dense) in enumerate(batches):
        np.testing.assert_array_equal(scores[k], port_scores(model, idx, dense))


def test_cli_serve_loadgen_and_servebench_on_dlrm(capsys):
    """`cli serve` of dlrm_terabyte (rows capped at 512) against `cli
    loadgen --read-scores`, ids and dense on one wire; `cli servebench`."""
    common = ["--config", "dlrm_terabyte", "--max-rows", "512", "--batch", "16"]
    th = threading.Thread(target=cli_main, args=(
        ["serve", *common, "--device", "cpu", "--batches", "3", "--port", "21621",
         "--slots", "2", "--reply"],), daemon=True)
    th.start()
    cli_main(["loadgen", *common, "--batches", "3", "--port", "21621", "--read-scores"])
    th.join(60)
    assert not th.is_alive()
    text = capsys.readouterr().out
    assert "scores received: 48" in text and '"wire_batches": 3' in text
    cli_main(["servebench", *common, "--device", "cpu", "--qps", "2000", "--duration", "0.5"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["config"] == "dlrm_terabyte" and r["n_queries"] > 100 and r["device"] == "cpu"
