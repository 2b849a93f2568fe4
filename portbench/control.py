#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place one precision below the
configuration's (every product of the head on TF32 operands for a float32
configuration, on fp8 e4m3 operands for a bfloat16 one, float32 sums;
``reference.head(control=True)``), read by the same number
a run compares (``reference.max_err`` over every pool entry of the cell)
against the reference at the configuration's precision:

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--device cuda]

Prints one line a seed and, last, one JSON object with every reading.  A
limit is sound only where every control reading is above it.  The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def reading(cell, seed: int, device, pool=None, batch=None) -> float:
    """max_err of the control's scores against the reference's, over
    ``pool`` entries (the cell's pool) of ``batch`` rows (the cell's)."""
    from portbench import inputs, reference, tables

    P = pool or cell.traffic["pool_batches"]
    B = batch or cell.serve["batch"]
    m = cell.model
    ids, dense = inputs.pools(seed, m, B, P)
    w = tables.head_weights(seed, m, device)
    key = tables.seed_key(seed)
    ref = reference.pool_scores(m, key, ids, dense, w)
    ctl = reference.pool_scores(m, key, ids, dense, w, control=True)
    return reference.max_err(ctl, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import loader

    cell = loader.cell(args.workload)
    dev = torch.device(args.device)
    out = {}
    for s in (int(x) for x in args.seeds.split(",")):
        out[s] = reading(cell, s, dev)
        print(f"{cell.name} seed {s}: control max_err {out[s]!r} (limit "
              f"{cell.check['max_err']})", flush=True)
    print(json.dumps({"cell": cell.name, "control_max_err": out,
                      "limit": cell.check["max_err"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
