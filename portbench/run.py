#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, from the root of a
checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--workload`` names a cell of ``BENCHMARK.json``.  The run builds the
port's served path for the cell's configuration on the card (on as many
cards as the cell asks for), drives it with the cell's traffic for
``--seconds`` after its warm-up, compares every score it replied with the
plain reference, and prints one JSON object as its last line of standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``), the device,
and the numbers compared with their limits (``checks``, also the last lines
of standard error).  Exits nonzero, printing no result, without enough CUDA
devices, or when JAX or the JAX package was loaded.

A stretch at the window's end is profiled in every traced run, and in the
untraced runs of a cell whose end-to-end metrics read the device's trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# whole top-level module names that a run may not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "fleetrec_tpu")
CACHES = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "cuda"))
# CPU thread pools held at one thread, so that none takes a core from the
# engine's loop and drain threads (set before numpy or torch is imported)
ONE_THREAD = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return " | ".join(r.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES:
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    for var in ONE_THREAD:
        os.environ[var] = "1"

    from portbench import loader, serve, yardstick

    t_start = serve.process_start_ns()
    cell = loader.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    stamps = {"python, torch imported": serve.now()}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA devices, this host has {n}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    torch.cuda.init()
    stamps["CUDA initialized"] = serve.now()
    split = serve.split_cores()
    if split is not None:  # the server off the senders' cores
        os.sched_setaffinity(0, split[0])
    gc_watch = serve.GcWatch()
    profile = bool(args.trace) or loader.needs_trace(args.workload)
    out = serve.run_single(cell, args.seed, args.seconds, profile, t_start, stamps=stamps,
                           client_cores=None if split is None else split[1])

    metrics = {}
    for m in loader.metrics(args.workload, bool(args.trace)):
        v = loader.reader(m["name"])(out)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": serve.correct(out), "attempted": out.expected(),
              "failed": out.checks["unanswered"]["value"], "metrics": metrics,
              "device": serve.device_block(out, kind, bool(args.trace))}
    if args.trace:
        bd = serve.trace_breakdown(out)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = out.checks

    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    h = out.head
    print(f"card: {card_line()}; peaks (H100 SXM data sheet, 700 W): float32 "
          f"{yardstick.PEAK_FLOPS['float32'] / 1e12:g} / bfloat16 "
          f"{yardstick.PEAK_FLOPS['bfloat16'] / 1e12:g} TFLOP/s, HBM "
          f"{yardstick.HBM_BYTES_PER_S / 1e12:g} TB/s", file=sys.stderr)
    print(f"batches sent {h['n_sent']}, answered {h['n_recv']}, warm-up {h['warm']}, in the "
          f"window {len(out.window())}; setup {out.setup_s:.3f} s: "
          f"{out.setup_phases(t_start)}", file=sys.stderr)
    print(gc_watch.line(out.head["t_open_ns"], out.head["t_close_ns"]), file=sys.stderr)
    print(f"after the window's close: {out.after_phases()}", file=sys.stderr)
    for line in serve.diagnostics(out):
        print(line, file=sys.stderr)
    for e in out.errors + h["errors"]:
        print(f"error: {e}", file=sys.stderr)
    for k, c in out.checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
