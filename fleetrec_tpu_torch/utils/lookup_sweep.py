"""Timing sweep of the fused lookup's launch shape on one CUDA device.

    python -m fleetrec_tpu_torch.utils.lookup_sweep [--out FILE]

For each shape (fleetrec_model1 at full rows, B = 1024 and 4096;
fleetrec_model3, int8 with dense 64, its tables capped at 1M rows, B =
4096; criteo_terabyte, bf16 with 16 stripes and 845 wide, capped at 100000
rows, B = 4096) it times ``lookup_fused`` on random in-range int32 ids at
``launch_shape``'s default and at every (rows a tile, blocks an SM) of ROWS
x BLOCKS: CUDA events around replays of a CUDA graph of ITERS calls, the
median of REPS replays, and every point timed twice, in a forward and then
a backward pass over the grid, so that drift falls on all points alike
(the two medians are reported, the point's time is their mean).  Each
point's features and flags must equal the default's bit for bit.  Prints
the card's name and power limit, one JSON line a point (also written to
``--out``), then a table a shape: ms at each point, the default marked.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import config as C
from ..models import init_model
from ..ops import lookup as lk

ROWS = (1, 2, 4, 6, 8, 10, 12, 16)
BLOCKS = (1, 2, 4, 8)
ITERS, REPS = 20, 5
# (config, batch, row cap): the shapes chip_smoke.py's report times
SHAPES = (("fleetrec_model1", 1024, None), ("fleetrec_model1", 4096, None),
          ("fleetrec_model3", 4096, 1_000_000), ("criteo_terabyte", 4096, 100_000))


def _graph_ms(fn) -> float:
    """Median ms a call over REPS replays of a graph of ITERS calls of
    ``fn`` (warmed up on a side stream first, as capture needs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(ITERS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / ITERS)
    return float(np.median(times))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def sweep_shape(name: str, B: int, cap, dev) -> List[Dict]:
    """Every point of one shape, timed and checked against the default."""
    cfg = C.get_config(name, batch_size=B)
    if cap is not None:
        cfg = dataclasses.replace(cfg, tables=tuple(
            dataclasses.replace(t, rows=min(t.rows, cap)) for t in cfg.tables))
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=dev)
    ops = model.lookup_operands()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1)
                           .astype(np.int32)).to(dev)
    dense = (torch.from_numpy(rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)).to(dev)
             if cfg.dense_dim else None)
    F, n_plan = ops["pos"].shape[0], ops["cols"].shape[0]
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    default = lk.launch_shape(B, F, n_plan, sm)
    points = [None] + [(r, b) for r in ROWS for b in BLOCKS]

    def call(tile):
        return lk.lookup_fused(ids, dense, **ops, tile=tile)

    with torch.inference_mode():
        want, want_bad = call(None)
        out = []
        for tile in points:
            got, bad = call(tile)
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)) or (
                    bad is not None and not torch.equal(bad, want_bad)):
                raise AssertionError(f"{name} B={B} tile {tile}: output differs from the default's")
            rows, grid = lk.launch_shape(B, F, n_plan, sm, *(tile or ()))
            out.append({"shape": f"{name} B={B}", "tile": tile, "rows": rows, "grid": grid,
                        "blocks_per_sm": lk.BLOCKS_PER_SM if tile is None else tile[1],
                        "default": tile is None or (rows, grid) == default})
        for order in (range(len(points)), reversed(range(len(points)))):
            for i in order:
                out[i].setdefault("ms_passes", []).append(
                    _graph_ms(lambda t=points[i]: call(t)))
    for p in out:
        p["ms"] = float(np.mean(p["ms_passes"]))
    del model
    torch.cuda.empty_cache()
    return out


def table(points: List[Dict]) -> List[str]:
    """A markdown table of one shape: a row per rows-a-tile, a column per
    blocks an SM, ms at each point (* the default shape's point)."""
    by = {(p["rows"], p["blocks_per_sm"]): p for p in points if p["tile"] is not None}
    lines = [f"{points[0]['shape']}: default (rows {points[0]['rows']}, "
             f"grid {points[0]['grid']}) {points[0]['ms']:.4f} ms; best "
             + "{:.4f} ms at rows {} and {} blocks an SM".format(
                 *min((p["ms"], p["rows"], p["blocks_per_sm"]) for p in by.values())),
             "| rows \\ blocks an SM | " + " | ".join(map(str, BLOCKS)) + " |",
             "| --- " * (len(BLOCKS) + 1) + "|"]
    for r in sorted({k[0] for k in by}):
        cells = []
        for b in BLOCKS:
            p = by.get((r, b))
            cells.append("-" if p is None else f"{p['ms']:.4f}{'*' if p['default'] else ''}")
        lines.append(f"| {r} | " + " | ".join(cells) + " |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write one JSON line a point here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookup_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    shapes = [sweep_shape(name, B, cap, dev) for name, B, cap in SHAPES]
    lines = [json.dumps(p) for points in shapes for p in points]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    for points in shapes:
        print("\n".join(table(points)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
