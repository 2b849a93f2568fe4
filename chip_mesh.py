#!/usr/bin/env python3
"""The port's mesh (``fleetrec_tpu_torch/parallel``) over NCCL on four
NVIDIA GPUs of one host (written for four H100s joined by NVLink), one rank
a card:

    python3 chip_mesh.py

Builds the kernels from the sources in this checkout, then runs three
worlds of four spawned ranks, each rank bound to its own card
(``init_distributed`` with the ``nccl`` backend; it never falls back to
gloo):

1. (data=1, model=4): the serving forwards of ``chip_smoke.serving_checks``
   (model1 at full rows and model3 (int8, take tables at 1M rows) on pm1
   tables and all-ones weights, from checkpoints): every rank's scores
   bit-equal to the float64 oracle and to the single-device forward,
   ``forward_pipelined`` bit-equal to as many ``forward`` calls,
   ``forward_pooled`` to one device's, NaN on the rows with a bad take id,
   one ``lookup_fused`` and one ``fused_mlp`` launch a forward; each
   forward's time by part with the exchange's bytes, time and rate (the
   feature exchange of model1, the W1-partial exchange of model3), and
   ``forward_pipelined``'s K batches against K forwards; then the sharded
   SGD step (``chip_smoke.train_check``) on model1 at full rows and model3 in
   float32 with its take tables at 1M rows, each against the same step of
   ``Trainer(model, optimizer=SGD)`` on one device, with its time by part
   and each collective's bytes, time and rate;
2. (data=2, model=2): the same sharded steps, whose gradients are summed
   over the model columns;
3. ``cli serve --mesh 2,2 --procs 4 --backend nccl`` on model1 at full
   rows from its checkpoint, each data row's leader fed 4 batches of 1024
   rows over loopback: the replies bit-equal to the oracle.

Exits nonzero, printing no result, with fewer than four CUDA devices.
Prints the cards' names and power limits (``nvidia-smi``), one line per
check and timing, and as its last line one JSON object of the results:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4},
"results": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from chip_smoke import B_SERVE, B_TIME, C, N_SERVE, fio, init_model, log, pm1_scores

CARDS = 4


def forward_results(r0):
    """Rank 0's forward splits and overlap (serving_checks) as JSON fields."""
    out = {}
    for tag, split, overlap in (("model1", "split1", "overlap1"), ("model3", "split3", "overlap3")):
        sp = r0[split]
        out[tag] = {"exchange_ms": sp["exchange"], "exchange_bytes": sp["exchange_bytes"],
                    "exchange_gb_per_s": sp["exchange_bytes"] / sp["exchange"] / 1e6,
                    "lookup_ms": sp["lookup"], "w1_partial_ms": sp["W1-partial matmul"],
                    "tower_ms": sp["tower"], "forward_ms": sp["forward"],
                    "pipelined_ms": r0[overlap]["pipelined"],
                    "sequential_ms": r0[overlap]["sequential"], "pipelined_k": cs.OVERLAP_K}
    return out


def train_results(res):
    """Every training config's results of a world (train_check), rank 0's
    split, the worst error over the ranks."""
    return {key[6:]: {"loss": res[0][key]["loss"], "ref_loss": res[0][key]["ref_loss"],
                      "loss_bit_equal": res[0][key]["exact"], "losses": res[0][key]["losses"],
                      "max_abs_err": max(r[key]["max_abs_err"] for r in res),
                      "launches": res[0][key]["launches"], **res[0][key]["split"]}
            for key in res[0] if key.startswith("train_")}


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < CARDS:
        print(f"chip_mesh: needs {CARDS} CUDA devices (one NCCL rank a card), this host has "
              f"{n}; no result", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = torch.cuda.nccl.version()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
        f"{'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl} on {n} x "
        f"{torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line}")
    t0 = time.perf_counter()
    cs._build.kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp(prefix="chip_mesh_")
    results = {}
    try:
        t1 = time.time()
        cfg1 = C.fleetrec_model1(batch_size=B_TIME)
        cfg3 = cs._cap(C.fleetrec_model3(batch_size=B_TIME), cs.LOOKUP_CAPS["fleetrec_model3"])
        paths = {"model1": os.path.join(tmp, "model1.npz"),
                 "model3": os.path.join(tmp, "model3.npz")}
        model1 = init_model(cfg1, device="cpu")
        fio.save_npz(paths["model1"], model1)
        model1 = model1.to(dev)
        m3 = init_model(cfg3, device="cpu")
        fio.save_npz(paths["model3"], m3)
        del m3
        rng = np.random.default_rng(22)
        data = {**cs.serving_inputs(rng), **cs.train_inputs(rng)}
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **data)
        golden1 = pm1_scores(cfg1, data["m1/idx"], None).astype(np.float32)
        golden3 = pm1_scores(cfg3, data["m3/idx"], data["m3/dense"]).astype(np.float32)
        with torch.inference_mode():
            singles = [fn(torch.from_numpy(data[k]).to(dev)).cpu().numpy()
                       for fn, k in ((model1, "m1/idx"), (model1, "m1/bad"),
                                     (model1.forward_pooled, "m1/bags"))]
        del model1
        torch.cuda.empty_cache()
        log(f"set-up: model1 (pm1, full rows) and model3 (int8 pm1, take tables at "
            f"{cs.LOOKUP_CAPS['fleetrec_model3']} rows) checkpoints, inputs, the oracles and "
            f"model1's single-device scores ({time.time() - t1:.1f}s)")

        t2 = time.time()
        res, _ = cs.run_world(CARDS, cs.sharded_rank,
                              (1, CARDS, paths, inputs, ("model1", "model3")), tmp, "nccl_1x4",
                              backend="nccl")
        cs.check_serving(res, golden1, *singles, golden3, "(1, 4) nccl")
        log(f"(1) a (data=1, model=4) world over NCCL, one rank a card ({time.time() - t2:.1f}s): "
            f"model1 at full rows and model3 (int8) on pm1 / ones, B={B_TIME}: every rank's scores "
            f"bit-equal to the oracle and to the single-device forward, forward_pipelined to "
            f"forward, forward_pooled to one device's, bad ids NaN on rows [5, 9]; launches per "
            f"sharded forward {res[0]['launches_forward']}, pooled {res[0]['launches_pooled']}")
        cs.log_forward_splits(res[0], "(1, 4), one card a rank", "NCCL all_reduce")
        cs.log_training("(1, 4) nccl world", res)
        for tag in ("model1", "model3"):
            cs.log_step_split(tag, "a (1, 4) nccl world", res[0][f"train_{tag}"])
        results["nccl_1x4"] = {"forward": forward_results(res[0]), "train": train_results(res)}

        t3 = time.time()
        res, _ = cs.run_world(CARDS, cs.sharded_rank, (2, 2, None, inputs, ("model1", "model3")),
                              tmp, "nccl_2x2", backend="nccl")
        log(f"(2) a (data=2, model=2) world over NCCL ({time.time() - t3:.1f}s)")
        cs.log_training("(2, 2) nccl world", res)
        for tag in ("model1", "model3"):
            cs.log_step_split(tag, "a (2, 2) nccl world", res[0][f"train_{tag}"])
        results["nccl_2x2"] = {"train": train_results(res)}

        t4 = time.time()
        served = cs.serve_world(tmp, "serve_2x2_nccl", 2, 2, B_SERVE, N_SERVE,
                                C.fleetrec_model1(), ["--ckpt", paths["model1"]],
                                lambda idx: pm1_scores(cfg1, idx, None).astype(np.float32),
                                backend="nccl")
        log(f"(3) cli serve --mesh 2,2 --procs 4 --backend nccl (model1 full rows from its "
            f"checkpoint): {N_SERVE} batches x {B_SERVE} rows a data row over loopback, replies "
            f"bit-equal to the oracle; summaries {[r['summary'] for r in served]}; launches of "
            f"the leaders' runs {served[0]['launches']} ({time.time() - t4:.1f}s)")
        results["serve_2x2_nccl"] = [r["summary"] for r in served]
    finally:
        shutil.rmtree(tmp)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()},
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
