"""Timing sweep of the bag lookup kernel on one CUDA device.

    python -m fleetrec_tpu_torch.utils.bag_sweep [--out FILE] [--default-only]

Run it from the repository's root: it takes its bags, its id draws and its
byte bound from ``chip_smoke.py``.  For each shape of SHAPES (fleetrec_model1
at full rows, B = 4096 with L = 1, 4 and 8 and B = 1024 with L = 8;
model1's row-window form on model shard 0 of 2, B = 4096, L = 8;
fleetrec_model3, int8 with dense 64, its take tables capped at 1M rows, B =
4096, L = 4)
and each draw of ``chip_smoke.BAG_DRAWS`` (loadgen's prefixes of 1 .. L
uniform ids, every id 0, loadgen's prefixes of skewed ids), it times
``lookup_fused_bags`` (sum pooling, int32 ids) in ``bags_plan``'s default
and, on the loadgen draw, in each variant of VARIANTS (its keyword
arguments: rows a tile, blocks an SM, ring stages, slots in flight):
CUDA events around replays of a CUDA graph of 20 calls, the median of 5
replays, every point in a forward and a backward pass over the list (the
point's time is the mean of the two medians).  Each point's features and
flags must equal ``lookup_fused_bags_plain``'s bit for bit; a variant
whose tile does not fit a block is left out.  Prints the card's name and
power limit, one JSON line a point as each shape ends (also written to
``--out``), then a table a shape beside the byte bound.
``--default-only`` times the default launch alone (the wrapper called
without a plan), which any version of the kernel takes.
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
from ..models import init_model
from ..ops import lookup as lk

# (label, config, batch, L, row cap, model shard (m, M) or None)
SHAPES = (("model1 B=4096 L=1", "fleetrec_model1", 4096, 1, None, None),
          ("model1 B=4096 L=4", "fleetrec_model1", 4096, 4, None, None),
          ("model1 B=4096 L=8", "fleetrec_model1", 4096, 8, None, None),
          ("model1 B=1024 L=8", "fleetrec_model1", 1024, 8, None, None),
          ("model1 window shard 0 of 2 B=4096 L=8", "fleetrec_model1", 4096, 8, None, (0, 2)),
          ("model3 B=4096 L=4", "fleetrec_model3", 4096, 4, 1_000_000, None))
# (label, bags_plan's keyword arguments), timed on the loadgen draw
VARIANTS = (*((f"rows {r}, {b} blocks an SM", {"rows": r, "blocks_per_sm": b})
              for b in (2, 3, 4) for r in (1, 2, 4, 8, 16)),
            *((f"{s} stages", {"stages": s}) for s in (2, 3, 4)),
            *((f"{s} slots", {"slots": s}) for s in (4, 8)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def _plan(ops, ids, kw) -> Dict:
    """The fields of the plan the wrapper launches with ``plan=kw``."""
    B, T, L = ids.shape
    F, n_plan = ops["pos"].shape[0], ops["cols"].shape[0]
    out_bytes = torch.empty((), dtype=lk.lookup_out_dtype(ops["bufs"])).element_size()
    chunk = 16 // out_bytes
    sm = torch.cuda.get_device_properties(ids.device).multi_processor_count
    p = lk.bags_plan(B, T, L, F, n_plan, sm, id_bytes=ids.element_size(),
                     pos_cols=chunk if F % chunk == 0 else 1, **kw)
    return dataclasses.asdict(p)


def sweep_shape(label, model, B, L, shard, default_only, dev) -> List[Dict]:
    """Every point of one shape; ``shard`` (m, M): the row-window form on
    model shard m of M (its descriptors, class tables and take window)."""
    import chip_smoke as cs
    from ..parallel import shard_operands

    cfg = model.cfg
    if shard is None:
        ops = model.lookup_operands()
    else:
        ops = shard_operands(model, *shard, dev)
    rng = np.random.default_rng(1)
    dense = cs._dense(model.layout.dense_dim, B, rng, dev)
    d = dense if ops["dense_dim"] else None
    variants = [("default", {})]
    for name, kw in [] if default_only else VARIANTS:
        try:  # a variant whose tile does not fit a block is left out
            _plan(ops, torch.empty((B, cfg.num_tables, L), dtype=torch.int32, device=dev), kw)
        except ValueError:
            continue
        variants.append((name, kw))
    out = []
    for draw in cs.BAG_DRAWS:
        ids = torch.from_numpy(cs.draw_bags(cfg, B, L, draw, seed=15 + L)).to(dev)
        want, want_bad = lk.lookup_fused_bags_plain(ids, d, **ops)
        points = variants if draw == "loadgen" else variants[:1]
        fns = []
        for name, kw in points:
            fn = functools.partial(lk.lookup_fused_bags, ids, d, **ops,
                                   **({"plan": kw} if kw else {}))
            got, bad = fn()
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)) or (
                    (bad is None) != (want_bad is None)
                    or (bad is not None and not torch.equal(bad, want_bad))):
                raise AssertionError(f"{label} {draw} {name}: differs from the plain version")
            fns.append(fn)
        del want, want_bad
        times = [[] for _ in points]
        for order in (range(len(points)), reversed(range(len(points)))):
            for i in order:
                times[i].append(cs._graph_ms(fns[i]))
        nbytes = cs.lookup_bytes(ops, ids, d)
        bound_ms = cs.bound(nbytes)[0]
        members = int((ids >= 0).sum())
        for (name, kw), ms in zip(points, times):
            p = {"shape": label, "draw": draw, "variant": name, "ms_passes": ms,
                 "ms": float(np.mean(ms)), "bound_ms": bound_ms, "bytes": nbytes,
                 "members": members}
            p["share_of_bound"] = bound_ms / p["ms"]
            if not default_only:
                p["plan"] = _plan(ops, ids, kw)
            out.append(p)
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
        lines.append(f"| {v} | " + " | ".join(
            f"{cell[v, d]:.4f}" if (v, d) in cell else "-" for d in draws) + " |")
    lines.append("| bound (bytes) | " + " | ".join(f"{bounds[d]:.4f}" for d in draws) + " |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write one JSON line a point here")
    ap.add_argument("--default-only", action="store_true",
                    help="time the default launch alone (no variants)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bag_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    shapes, models = [], {}
    if args.out:
        open(args.out, "w").close()
    with torch.inference_mode():
        for label, name, B, L, cap, shard in SHAPES:
            if name not in models:
                models.clear()
                torch.cuda.empty_cache()
                cfg = C.get_config(name, batch_size=B)
                if cap is not None:
                    cfg = dataclasses.replace(cfg, tables=tuple(
                        dataclasses.replace(t, rows=min(t.rows, cap)) for t in cfg.tables))
                models[name] = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform",
                                          device=dev)
            points = sweep_shape(label, models[name], B, L, shard, args.default_only, dev)
            for p in points:
                p["card"] = card
            shapes.append(points)
            lines = [json.dumps(p) for p in points]
            print("\n".join(lines), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write("\n".join(lines) + "\n")
    for points in shapes:
        print("\n".join(table(points)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
