"""Timing sweep of the lookup's backward kernel on one CUDA device.

    python -m fleetrec_tpu_torch.utils.backward_sweep [--out FILE]

Run it from the repository's root: it takes its id draws, its
``index_add_`` yardstick and its byte bound from ``chip_smoke.py``.  At B =
4096, for each shape of SHAPES (fleetrec_model1 at full rows, whole and in
the row-window form on model shard 0 of 2; fleetrec_model3 and
dlrm_terabyte, each with its tables capped at 1M rows) and each id draw of
``chip_smoke.ID_DRAWS``, it times ``lookup_fused_backward`` in the plan of
each variant of VARIANTS (``backward_plan``'s arguments: its grid of
blocks an SM, and 16-byte reductions or one float at a time) and ``chip_smoke.backward_yardstick``'s
``index_add_`` of the same sums, into preallocated float32 sums, on uniform
cotangents: CUDA events around replays of a CUDA graph of 20 calls, the
median of 5 replays, every point in a forward and a backward pass over the
list (the point's time is the mean of the two medians).  The backward reads
no table value, so the packed buffers are float32 zeros of their sizes.
Each plan's sums on integer cotangents must equal
``lookup_fused_backward_plain``'s bit for bit.  Prints the card's name and
power limit, one JSON line a point (also written to ``--out``), then a
table a shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import config as C
from ..models.embedding import lookup_tensors
from ..models.fleetrec import ModelPlan
from ..ops import lookup as lk

B = 4096
# (config, row cap, model shard (m, M) or None)
SHAPES = (("fleetrec_model1", None, None), ("fleetrec_model1", None, (0, 2)),
          ("fleetrec_model3", 1_000_000, None), ("dlrm_terabyte", 1_000_000, None))
# (label, backward_plan's keyword arguments)
VARIANTS = (("default", {}), ("scalar reductions", {"vec": False}),
            *((f"{n} blocks an SM", {"blocks_per_sm": n}) for n in (2, 4, 8)))


def sweep_shape(name: str, cap, shard, dev) -> List[Dict]:
    """Every point of one shape; ``shard`` (m, M): the row-window form on
    model shard m of M (its descriptors, class tables and take window)."""
    import chip_smoke as cs

    cfg = C.get_config(name, batch_size=B)
    if cap is not None:
        cfg = dataclasses.replace(cfg, tables=tuple(
            dataclasses.replace(t, rows=min(t.rows, cap)) for t in cfg.tables))
    mp = ModelPlan.create(cfg)
    lay = mp.layout
    d = lookup_tensors(lay, mp.index_perm, mp.qr_positions, dev, shard=shard)
    m, M = shard or (0, 1)
    tag = f"{name} B={B}" + (f" shard {m} of {M}" if shard else "")
    sizes = [-(-c.num_tables // M) * c.rows_pad * c.dim for c in lay.onehot_classes]
    rows_local = -(-lay.take_phys_total // M)
    if lay.take_phys_total:
        sizes.append(rows_local * lay.take_lanes)
    ops = {"bufs": [torch.zeros(n, device=dev) for n in sizes], "cols": d["cols"],
           "pos": d["pos"], "stripes": lay.take_stripes, "stripe_height": lay.stripe_height,
           "window": (m * rows_local, rows_local) if shard else None}
    args = (ops["bufs"], ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    F = ops["pos"].shape[0]
    plans = [(label, lk.backward_plan(ops["cols"], ops["pos"], B, sm, **kw))
             for label, kw in VARIANTS]
    rng = np.random.default_rng(0)
    out = []
    for draw in cs.ID_DRAWS:
        ids = torch.from_numpy(cs.draw_ids(cfg, B, rng, draw)).to(dev)
        sums = [torch.zeros_like(b) for b in ops["bufs"]]
        exact = torch.from_numpy(rng.integers(-3, 4, (B, F)).astype(np.float32)).to(dev)
        want = lk.lookup_fused_backward_plain(exact, ids, *args, window=ops["window"])
        for label, plan in plans:
            for s in sums:
                s.zero_()
            lk.lookup_fused_backward(exact, ids, *args, out=sums, window=ops["window"],
                                     plan=plan)
            torch.cuda.synchronize()
            if not all(torch.equal(s, w.reshape(-1)) for s, w in zip(sums, want)):
                raise AssertionError(f"{tag} {draw} {label}: sums differ from the plain version")
        del want
        g = torch.from_numpy(rng.uniform(-1, 1, (B, F)).astype(np.float32)).to(dev)
        points = [(label, functools.partial(lk.lookup_fused_backward, g, ids, *args, out=sums,
                                            window=ops["window"], plan=plan))
                  for label, plan in plans]
        library, nbytes = cs.backward_yardstick(ops, g, ids)
        points.append(("index_add_", library))
        times = {label: [] for label, _ in points}
        for order in (points, points[::-1]):
            for label, fn in order:
                times[label].append(cs._graph_ms(fn))
        bound_ms = cs.bound(nbytes)[0]
        for label, plan in plans + [("index_add_", None)]:
            p = {"shape": tag, "draw": draw, "variant": label, "ms_passes": times[label],
                 "ms": float(np.mean(times[label])), "bound_ms": bound_ms}
            if plan is not None:
                p.update(grid=plan.grid, vec=plan.vec)
            out.append(p)
        del sums, library
    del ops, args
    torch.cuda.empty_cache()
    return out


def table(points: List[Dict]) -> List[str]:
    """A markdown table of one shape: a row a variant, a column a draw."""
    draws = list(dict.fromkeys(p["draw"] for p in points))
    cell = {(p["variant"], p["draw"]): p["ms"] for p in points}
    variants = list(dict.fromkeys(p["variant"] for p in points))
    bounds = {p["draw"]: p["bound_ms"] for p in points}
    lines = [f"{points[0]['shape']} (ms a call)",
             "| variant | " + " | ".join(draws) + " |", "| --- " * (len(draws) + 1) + "|"]
    for v in variants:
        lines.append(f"| {v} | " + " | ".join(f"{cell[v, d]:.4f}" for d in draws) + " |")
    lines.append("| bound (bytes) | " + " | ".join(f"{bounds[d]:.4f}" for d in draws) + " |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write one JSON line a point here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("backward_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    shapes = [sweep_shape(name, cap, shard, dev) for name, cap, shard in SHAPES]
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
