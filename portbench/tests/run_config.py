#!/usr/bin/env python3
"""Serve a configuration file that ``BENCHMARK.json`` does not name (a
cell of ``loader.make_cell``), through the same path as a benchmark run,
on one card, from the root of a checkout:

    python3 portbench/tests/run_config.py --config portbench/tests/dcnv2_width.json \\
        --traffic stream --seeds 11,12 --seconds 20 [--control-seeds 21,22,23] [--fault tf32_cross]

Prints one JSON line a run (``correct``, the numbers compared with their
limits, queries/s, set-up seconds, the device's peak memory) and one a
control reading (``control.reading`` at the cell's own size); ``--fault``
plants one of ``faults.py``'s faults in the timed path of every run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="stream")
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import run

    for var, sub in run.CACHES:
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    for var in run.ONE_THREAD:
        os.environ[var] = "1"
    import torch

    from portbench import control, loader, serve
    from portbench.tests import faults

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    name = os.path.splitext(os.path.basename(args.config))[0]
    cell = loader.make_cell(name, name, 1, args.config, args.traffic)
    if args.fault:
        getattr(faults, args.fault)()
    split = serve.split_cores()
    if split is not None:
        os.sched_setaffinity(0, split[0])
    for seed in (int(s) for s in args.seeds.split(",") if s):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = serve.run_single(cell, seed, args.seconds, False, serve.now(), device=dev,
                               client_cores=None if split is None else split[1])
        print(json.dumps({"config": name, "seed": seed, "fault": args.fault,
                          "correct": serve.correct(out), "checks": out.checks,
                          "qps": loader.reader("qps.stream")(out), "setup_s": out.setup_s,
                          "memory_peak_bytes": out.memory_peak,
                          "window_batches": int(len(out.window())),
                          "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                                   else "cpu")}), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        err = control.reading(cell, seed, dev)
        print(json.dumps({"config": name, "seed": seed, "control_max_err": err,
                          "limit": cell.check["max_err"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
