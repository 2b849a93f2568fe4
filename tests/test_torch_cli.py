"""The port's CLI commands on --device cpu: twins of tests/test_cli.py
(bench stages, export + --ckpt round trip, autotune, servebench, the
qr-threshold refusal) plus gatherbench, netbench and checkpoints that
cross from the JAX package's `export`.  Port 21560 is used by no other
test file (xdist runs files in parallel)."""

import json
import os

import numpy as np
import pytest
import torch

from fleetrec_tpu.cli import main as jax_main
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.cli import main

COMMON = ["--config", "micro_test", "--batch", "16", "--device", "cpu"]


def run_cli(capsys, *argv, entry=main):
    entry(list(argv))
    out = capsys.readouterr().out.strip()
    return json.loads(out.splitlines()[-1])


@pytest.mark.parametrize("stage", ["e2e", "lookup", "mlp"])
def test_cli_bench_stages(capsys, stage):
    r = run_cli(capsys, "bench", *COMMON, "--iters", "2", "--stage", stage)
    assert r["stage"] == stage and r["ms_per_batch"] > 0
    assert r["device"] == "cpu" and r["batch"] == 16
    assert {"inferences_per_sec", "ms_per_batch_two_k", "percall_const_ms"} <= set(r)


def test_cli_export_and_ckpt_roundtrip(tmp_path, capsys):
    path = os.path.join(tmp_path, "m.npz")
    r = run_cli(capsys, "export", *COMMON, "--out", path)
    assert r["config"] == "micro_test" and os.path.exists(path)
    assert r["fingerprint"] == tio.config_fingerprint(TC.micro_test())[:12]
    r = run_cli(capsys, "bench", *COMMON, "--iters", "2", "--ckpt", path)
    assert r["ms_per_batch"] > 0
    # wrong geometry fails fast
    with pytest.raises(tio.ConfigMismatchError):
        run_cli(capsys, "bench", "--config", "tiny_dlrm", "--batch", "16",
                "--device", "cpu", "--iters", "2", "--ckpt", path)


def test_cli_ckpt_model_scores_as_the_exported_one(tmp_path, capsys):
    """`export` of uniform data -> load_npz: the same buffers and scores
    as the model export built from the same flags."""
    from fleetrec_tpu_torch.models import init_model

    path = os.path.join(tmp_path, "u.npz")
    run_cli(capsys, "export", *COMMON, "--table-scheme", "uniform",
            "--mlp-scheme", "uniform", "--out", path)
    cfg = TC.micro_test(batch_size=16)
    built = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform")
    loaded = tio.load_npz(path, cfg)
    for (n, a), (_, b) in zip(built.named_buffers(), loaded.named_buffers()):
        assert torch.equal(a, b), n


def test_cli_export_quantize_int8_then_bench(tmp_path, capsys):
    path = os.path.join(tmp_path, "q.npz")
    r = run_cli(capsys, "export", *COMMON, "--out", path, "--quantize-int8")
    assert r["table_dtype"] == "int8"
    r = run_cli(capsys, "bench", *COMMON, "--iters", "2", "--ckpt", path,
                "--dtype", "int8")
    assert r["ms_per_batch"] > 0
    with pytest.raises(SystemExit):
        main(["export", *COMMON, "--out", path, "--quantize-int8", "--dtype", "int8"])


def test_cli_jax_export_serves_from_the_port(tmp_path, capsys):
    """A checkpoint written by the JAX package's `export` loads with the
    port's `--ckpt`."""
    path = os.path.join(tmp_path, "j.npz")
    run_cli(capsys, "export", "--config", "micro_test", "--batch", "16",
            "--platform", "cpu", "--out", path, entry=jax_main)
    r = run_cli(capsys, "bench", *COMMON, "--iters", "2", "--ckpt", path)
    assert r["ms_per_batch"] > 0


def test_cli_autotune(capsys):
    r = run_cli(capsys, "autotune", *COMMON, "--iters", "2",
                "--thresholds", "64", "128")
    assert r["best"]["onehot_max"] in (64, 128)
    assert len(r["sweep"]) == 2 and r["device"] == "cpu"
    assert [s["onehot_tables"] + s["take_tables"] for s in r["sweep"]] == [8, 8]


def test_cli_servebench(capsys):
    r = run_cli(capsys, "servebench", *COMMON, "--qps", "3000",
                "--duration", "0.5", "--fuse", "2")
    assert r["n_queries"] > 100 and r["fuse"] == 2 and r["device"] == "cpu"


def test_cli_gatherbench(capsys):
    r = run_cli(capsys, "gatherbench", "--device", "cpu", "--rows", "4096",
                "--n-rows", "512", "--iters", "2", "--chunk", "1024")
    for k in ("plain_ns_per_row", "kernel_ns_per_row", "grouped_ns_per_row"):
        assert r[k] > 0
    assert (r["rows"], r["gathered_rows"], r["chunk"]) == (4096, 512, 1024)
    assert (r["group"], r["window"], r["grouped_chunk"]) == (8, 8, 440)


def test_cli_netbench(capsys):
    r = run_cli(capsys, "netbench", "--senders", "2", "--bytes-per-batch",
                str(64 * 1024), "--batches", "6", "--port", "21560")
    assert r["GB_s"] > 0 and r["batches"] == 6
    assert [s["batches"] for s in r["per_sender"]] == [6, 6]


def test_cli_qr_threshold_without_rem_rejected():
    """--qr-threshold alone would silently build the exact model (the gate
    is --qr-rem); it must fail loudly instead."""
    with pytest.raises(SystemExit):
        main(["bench", *COMMON, "--iters", "1", "--qr-threshold", "100"])


def test_cli_device_is_not_moved_without_a_card():
    """--device cuda on a machine without one raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["bench", "--config", "micro_test", "--batch", "16", "--iters", "1"])
