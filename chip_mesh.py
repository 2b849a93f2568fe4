#!/usr/bin/env python3
"""The port's mesh (``fleetrec_tpu_torch/parallel``) over NCCL on four
NVIDIA GPUs of one host (written for four H100s joined by NVLink), one rank
a card:

    python3 chip_mesh.py

Builds the kernels from the sources in this checkout, then runs worlds of
four spawned ranks, each rank bound to its own card
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
   rows over loopback: the replies bit-equal to the oracle;
4. (data=1, model=4): criteo_terabyte at full cardinality (int8 tables,
   1,655,169,127 rows; ``chip_smoke.criteo_mesh_rank``): each rank
   generates only its window of the take buffer on its card
   (``pack_pm1_sharded`` with the mesh) and builds its shard from it
   (``ShardedFleetRec.from_packed``), its take bytes equal to
   ``plan(cfg, 4).take_bytes_per_chip``; sharded forwards at B = 4096 and
   1024 on every rank bit-equal to the pm1 oracle, NaN on the bad rows;
   each window's rows overwritten with their index pattern and the
   window's ``lookup_fused`` held to its plain version and to the pattern
   on ids at the edges of every rank's window (zeros outside its own); the
   forward's time by part with the exchange's bytes, time and rate; then
   ``ici_bench`` at 64 MiB a rank over the row (all_gather, psum,
   ppermute); then the same world in criteo's own default dtypes, bf16
   tables (26.5 GB a rank's window; 106 GB in all, more than one card) and
   the bf16 tower: the hard gate (the same windows under a float32 tower)
   bit-equal to the oracle, the bf16 tower within rtol 2e-2 / atol 2e-2 x
   max|oracle|, the addressing check and the forward's time by part;
5. sharded checkpoints (``io.save_sharded`` / ``io.load_sharded``;
   ``chip_smoke.checkpoint_mesh_rank``), a world of four holding a (2, 2)
   and a (1, 4) mesh: model1 at full rows, uniform tables and weights,
   saved from one device here and restored onto (2, 2), trained one SGD
   step (``ShardedFleetRec.train_step``), saved, and restored onto (2, 2)
   (arrays and scores bit-equal to the trained mesh's) and onto (1, 4)
   (every array, gathered over each mesh's model group, byte-equal to the
   (2, 2) mesh's; the whole batch's scores within rtol 1e-6 of the (2, 2)
   rows'); then model1's pm1 windows generated on the cards
   (``pack_pm1_sharded`` with the (2, 2) mesh, ``from_packed``) saved and
   restored onto (2, 2), scores bit-equal to the pm1 oracle; each save's
   and load's seconds and GB/s with its bytes on disk (the first save and
   the first load twice: the first carries a process's first use of DCP);
6. (data=2, model=2): ``parallel/dryrun.py::dryrun_multichip`` on every
   rank;
7. ``cli plan --config criteo_terabyte --recommend 4`` for bfloat16 and
   int8 tables (host only).

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


def criteo_step(tmp, table_dtype="int8"):
    """Step 4: ``chip_smoke.criteo_mesh_rank`` of ``table_dtype`` on a (1,
    CARDS) NCCL world (int8 with ``ici_bench``), its checks and timings
    logged; returns its results."""
    t5 = time.time()
    card = cs.card_line()
    int8 = table_dtype == "int8"
    res, _ = cs.run_world(CARDS, cs.criteo_mesh_rank,
                          (1, CARDS, 15, 64 if int8 else None, table_dtype), tmp,
                          f"criteo_1x4_{table_dtype}", backend="nccl")
    cfg = cs.criteo_full_config(B_TIME, table_dtype)
    towers = (f"{cfg.table_dtype} tables, {cfg.dtype} tower"
              + ("" if int8 else ", and the hard gate: the same windows under a float32 tower"))
    for r in res:
        log(f"(4) {table_dtype} rank {r['rank']} ({r['card']}): its take window of criteo full "
            f"cardinality built on its card in {r['build_s']:.2f} s, {r['take_bytes']} B = "
            f"plan(cfg, {CARDS}).take_bytes_per_chip; memory_allocated {r['allocated']} B; "
            f"ru_maxrss {r['rss']} B (this process's peak at the spawn included); forwards at "
            f"B={cs.FULL_BATCHES} ({towers}) "
            + ("bit-equal to the pm1 oracle" if int8 else
               f"the gate bit-equal to the pm1 oracle, the bf16 tower within rtol "
               f"{cs.BF16_RTOL} / atol {cs.BF16_ATOL_OF_MAX} x max|oracle| (max abs err "
               f"{r['max_abs_err_bf16']!r})")
            + f", NaN on the bad rows; launches {r['launches']}; over its patterned "
            f"window {r['window']} lookup_fused bit-equal to lookup_fused_plain and "
            f"{r['targets']} edge targets to their rows' pattern ({r['targets_inside']} "
            f"inside its window, zeros outside)")
    if sum(r["targets_inside"] for r in res) != res[0]["targets"]:
        raise AssertionError(f"the windows hold {[r['targets_inside'] for r in res]} of "
                             f"{res[0]['targets']} targets, not each one once")
    sp = res[0]["split"]
    log(f"(4) a (data=1, model=4) world over NCCL on criteo_terabyte at full cardinality "
        f"({towers}) on {CARDS} x {card}, every rank from its own generated window "
        f"({time.time() - t5:.1f}s); rank 0 B={B_TIME}, median of {cs.SPLIT_ITERS} (each part "
        f"closed by a synchronize): window lookup {sp['lookup']:.4f} ms, exchange "
        f"{sp['exchange']:.4f} ms wall for {sp['exchange_bytes']} B {sp['exchange_shape']} "
        f"({sp['exchange_bytes'] / sp['exchange'] / 1e6:.3f} GB/s), tower and poison "
        f"{sp['tower']:.4f} ms; whole forward {sp['forward']:.4f} ms wall")
    for r in res if int8 else ():
        ici = r["ici"]
        log(f"(4) ici_bench rank {r['rank']} ({r['card']}), {ici['per_device_mbytes']} MiB a "
            f"rank over (1, {ici['model_axis']}): " + ", ".join(
                f"{op} {ici[op]['ms']} ms {ici[op]['GB_s']} GB/s"
                for op in ("all_gather", "psum", "ppermute")))
    out = {
        "take_bytes_per_rank": [r["take_bytes"] for r in res],
        "targets_inside": [r["targets_inside"] for r in res],
        "build_s": [r["build_s"] for r in res], "rss": [r["rss"] for r in res],
        "allocated": [r["allocated"] for r in res],
        "exchange_ms": sp["exchange"], "exchange_bytes": sp["exchange_bytes"],
        "exchange_gb_per_s": sp["exchange_bytes"] / sp["exchange"] / 1e6,
        "lookup_ms": sp["lookup"], "tower_ms": sp["tower"], "forward_ms": sp["forward"],
        "card": card}
    if int8:
        out["ici_bench"] = [r["ici"] for r in res]
    else:
        out["max_abs_err_bf16"] = max(r["max_abs_err_bf16"] for r in res)
    return out


def checkpoint_step(tmp):
    """Step 5: ``chip_smoke.checkpoint_mesh_rank`` on a world of CARDS
    ranks over NCCL, from a one-device checkpoint of uniform model1 written
    here; its checks and times logged; returns its results."""
    t0 = time.time()
    cfg = C.fleetrec_model1(batch_size=B_TIME)
    paths = {k: os.path.join(tmp, f"ckpt_{k}") for k in ("one", "trained", "packed")}
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device="cpu")
    save_s = []
    for _ in range(2):  # the first carries this process's first use of DCP
        shutil.rmtree(paths["one"], ignore_errors=True)
        t = time.perf_counter()
        fio.save_sharded(paths["one"], model)
        save_s.append(time.perf_counter() - t)
    del model
    rng = np.random.default_rng(55)
    idx = cs._rand_ids(cfg, 2 * B_TIME, rng)
    inputs = os.path.join(tmp, "ckpt_inputs.npz")
    np.savez(inputs, **{"ck/idx": idx,
                        "ck/labels": rng.integers(0, 2, 2 * B_TIME).astype(np.float32)})
    golden = pm1_scores(cfg, idx, None).astype(np.float32)
    setup_s = time.time() - t0
    res, _ = cs.run_world(CARDS, cs.checkpoint_mesh_rank, (paths, inputs), tmp, "ckpt_2x2",
                          backend="nccl")

    def rows(key):
        for d in range(2):
            if not np.array_equal(res[2 * d][key], res[2 * d + 1][key]):
                raise AssertionError(f"step 5: the ranks of data row {d} disagree on {key}")
        return np.concatenate([res[0][key], res[2][key]])

    trained = rows("trained_22")
    if not np.array_equal(rows("again_22"), trained):
        raise AssertionError("step 5: the (2, 2) restore's scores differ from the trained mesh's")
    for r in res[1:]:
        if not np.array_equal(r["scores_14"], res[0]["scores_14"]):
            raise AssertionError(f"step 5: (1, 4) rank {r['rank']} disagrees with rank 0")
    np.testing.assert_allclose(res[0]["scores_14"], trained, rtol=1e-6, atol=0,
                               err_msg="step 5: (1, 4) against the trained (2, 2) mesh")
    exact14 = bool(np.array_equal(res[0]["scores_14"], trained))
    if not np.array_equal(rows("packed_22"), golden):
        raise AssertionError("step 5: the restored from_packed windows' scores differ from the "
                             "pm1 oracle")
    for r in res:
        if (r["launches_step"] != cs._launches(lookup=1, backward=1)
                or r["launches_forward"] != cs._launches(lookup=1, mlp=1)
                or r["launches_packed"] != cs._launches(lookup=1, mlp=1)):
            raise AssertionError(f"step 5: rank {r['rank']} launched {r['launches_step']} "
                                 f"(step), {r['launches_forward']} / {r['launches_packed']} "
                                 f"(forwards)")
    if len({r["loss"] for r in res}) != 1:
        raise AssertionError(f"step 5: the ranks' losses differ: {[r['loss'] for r in res]}")
    card = cs.card_line()
    nbytes = {k: cs.disk_bytes(p) for k, p in paths.items()}
    times = {"save one device (host tensors)": ("one", save_s[0]),
             "save one device (host tensors), again": ("one", save_s[1])}
    for key, what, path in (("load_one_22_s", "load one device -> (2, 2)", "one"),
                            ("load_one_22_again_s", "load one device -> (2, 2), again", "one"),
                            ("save_22_s", "save (2, 2), trained", "trained"),
                            ("load_22_22_s", "load (2, 2) -> (2, 2)", "trained"),
                            ("load_22_14_s", "load (2, 2) -> (1, 4)", "trained"),
                            ("save_packed_s", "save (2, 2) from_packed windows", "packed"),
                            ("load_packed_s", "load (2, 2) -> (2, 2) windows", "packed")):
        times[what] = (path, max(r[key] for r in res))
    for what, (path, sec) in times.items():
        log(f"(5) time checkpoint model1 {what} on {CARDS} x {card}: {nbytes[path]} B on disk, "
            f"{sec:.3f} s ({nbytes[path] / sec / 1e9:.3f} GB/s; the slowest rank, host clock "
            f"between barriers and synchronizes; loads page-cache warm)")
    log(f"(5) sharded checkpoints over NCCL, (2, 2) and (1, 4) in one world of {CARDS} "
        f"({time.time() - t0:.1f}s, set-up {setup_s:.1f}s): uniform model1 at full rows from a "
        f"one-device checkpoint onto (2, 2), one SGD step (loss {res[0]['loss']!r}, launches "
        f"{res[0]['launches_step']}), saved and restored onto (2, 2) with its {res[0]['arrays']} "
        f"arrays and scores bit-equal, and onto (1, 4) with every array gathered byte-equal and "
        f"the scores of {2 * B_TIME} rows within rtol 1e-6 of the (2, 2) rows' "
        f"({'bit-equal' if exact14 else 'not bit-equal'}); pm1 windows generated on the cards "
        f"(from_packed) saved and restored onto (2, 2), scores bit-equal to the oracle; "
        f"launches of a restored forward {res[0]['launches_forward']}")
    return {"bytes_on_disk": nbytes, "seconds": {k: v[1] for k, v in times.items()},
            "loss": res[0]["loss"], "scores_14_bit_equal": exact14, "card": card}


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

        results["criteo_full_1x4"] = criteo_step(tmp)
        results["criteo_full_1x4_bf16"] = criteo_step(tmp, "bfloat16")

        results["checkpoint_2x2_1x4"] = checkpoint_step(tmp)

        t6 = time.time()
        res, _ = cs.run_world(CARDS, cs.dryrun_rank, (2, 2), tmp, "dryrun_2x2", backend="nccl")
        if len({r["loss"] for r in res}) != 1:
            raise AssertionError(f"the dry run's ranks disagree on the loss: {res}")
        log(f"(6) dryrun_multichip on a (data=2, model=2) NCCL world: every rank passed "
            f"({time.time() - t6:.1f}s); loss {res[0]['loss']}, score shapes "
            f"{ {k: v for k, v in res[0].items() if k.startswith('scores')} }")
        results["dryrun_2x2"] = res

        plans = {}
        for dtype in ("bfloat16", "int8"):
            run = subprocess.run(
                [sys.executable, "-m", "fleetrec_tpu_torch.cli", "plan", "--config",
                 "criteo_terabyte", "--recommend", str(CARDS), "--dtype", dtype],
                capture_output=True, text=True, timeout=120, check=True)
            plans[dtype] = json.loads(run.stdout)
            log(f"(7) cli plan --config criteo_terabyte --recommend {CARDS} --dtype {dtype}: "
                f"{json.dumps(plans[dtype])}")
        results["plan_recommend_4"] = plans
    finally:
        shutil.rmtree(tmp)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()},
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
