"""Serve-tier assembly, the port of ``fleetrec_tpu/serving/compose.py``:
bind the ingest ports, build the scoring engine over one device, then pump
n batches from the wire through the device and back out (replies /
scatter fan-out).  Serving over a mesh is not ported yet (ROADMAP.md
queue 1, 'Multi-device')."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Tuple

from .engine import ServingEngine
from .ingest import IngestServer, ScatterEgress
from .wire import IndexWireFormat


@dataclasses.dataclass
class ServeSpec:
    """Everything that shapes one serving session (mirrors `cli serve`)."""

    batch: int                      # rows per wire batch
    batches: int                    # wire batches to serve then exit
    port: int = 7080                # ingest port base (sender s -> port+s)
    slots: int = 8                  # ingest ring depth
    senders: int = 1                # index-mode senders (N>1: 3-node topo)
    fuse: int = 1                   # wire batches per device call
    bg_drain: bool = False          # readbacks on a background thread
    reply: bool = False             # stream fp32 scores back to sender 0
    scatter: Tuple[str, ...] = ()   # "host:port" fan-out consumers
    warm: bool = False              # run the path once before traffic


def build_engine(model, spec: ServeSpec) -> ServingEngine:
    """The scoring half of the assembly: a one-device engine."""
    return ServingEngine.from_model(model, batch_size=spec.batch,
                                    background_drain=spec.bg_drain,
                                    fuse=spec.fuse)


def serve(cfg, model, spec: ServeSpec) -> dict:
    """Run one full serving session; returns the latency/throughput
    summary (engine.run_from_ingest's dict + per-sender rx counters +
    scatter stats).  Prints the 'serving ...' banner once the ingest ports
    are bound — clients key their connects off it."""
    eng = build_engine(model, spec)
    if spec.warm:
        t0 = time.time()
        eng.warmup()
        print(f"warmup: {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    B = spec.batch
    wire = None
    if spec.senders > 1:
        wire = IndexWireFormat.plan(cfg, B, spec.senders)
        nbytes = wire.bytes_per_sender()
    else:
        nbytes = [B * (cfg.num_tables + cfg.dense_dim) * 4]
    scatter = None
    if spec.scatter:
        scatter = ScatterEgress(queue_blocks=spec.slots)
        for dest in spec.scatter:
            host, _, port = dest.partition(":")
            scatter.connect(host, int(port))
    try:
        with IngestServer(nbytes, n_slots=spec.slots, port_base=spec.port) as ing:
            print(f"serving {cfg.name} B={B} on ports {spec.port}"
                  f"..{spec.port + len(nbytes) - 1} ({nbytes} B/batch)",
                  flush=True)
            try:
                summary = eng.run_from_ingest(
                    ing, spec.batches, wire=wire,
                    row_limits=[t.rows for t in cfg.tables],
                    reply_to=0 if spec.reply else None,
                    scatter=scatter,
                )
            finally:
                eng.close()
            # per-sender rx counters: spot the slow/flapping sender
            summary["per_sender"] = ing.sender_stats()
        if scatter is not None:
            summary["scatter"] = scatter.stats()
    finally:
        if scatter is not None:
            scatter.close()
    return summary
