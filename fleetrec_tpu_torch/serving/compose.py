"""Serve-tier assembly, the port of ``fleetrec_tpu/serving/compose.py``:
bind the ingest ports, build the scoring engine over one device or, with
``ServeSpec.mesh``, over this rank's shard of a (data, model) mesh (arming
the peer watchdog), then pump n batches from the wire through the device and
back out (replies / scatter fan-out); single ids or, on one device, pooled
bags (``ServeSpec.bag_L``, or ``ServeSpec.bag_sizes`` for bags of different
sizes).  On a mesh each data row's leader binds its own
ingest ports and replies its own rows; the other ranks of the row follow
it."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional, Tuple

from .engine import PeerWatchdog, ServingEngine
from .ingest import IngestServer, ScatterEgress
from .wire import IndexWireFormat


@dataclasses.dataclass
class ServeSpec:
    """Everything that shapes one serving session (mirrors `cli serve`)."""

    batch: int                      # rows per wire batch (a data row's)
    batches: int                    # wire batches to serve then exit
    port: int = 7080                # ingest port base (sender s -> port+s)
    slots: int = 8                  # ingest ring depth
    senders: int = 1                # index-mode senders (N>1: 3-node topo)
    # (data, model) mesh of torch.distributed ranks, one device a rank: the
    # sharded engine (parallel/sharded.py); None = one device
    mesh: Optional[Tuple[int, int]] = None
    multiprocess: bool = False      # the mesh spans an initialized world
    # the device of a rank's shard ("cuda": cuda:<local rank % cards>)
    device: str = "cuda"
    # a lockstep peer stalled past this many seconds aborts this process
    # with a diagnostic (engine.PeerWatchdog); None = no bound
    peer_timeout_s: Optional[float] = None
    fuse: int = 1                   # wire batches per device call
    bg_drain: bool = False          # readbacks on a background thread
    reply: bool = False             # stream fp32 scores back to sender 0
    scatter: Tuple[str, ...] = ()   # "host:port" fan-out consumers
    warm: bool = False              # run the path once before traffic
    # pooled bag serving (models/pooled.py): slots carry int32 [B, T, L]
    # bags (-1 padding); one device, single-sender wire only
    bag_L: int = 0
    bag_mean: bool = False          # mean pooling instead of sum
    # ragged bags: table t's bag_sizes[t] members in one run of a query's
    # int32 ids [B, sum(bag_sizes)], tables in config order, then the dense
    # floats; one device, single-sender wire only (excludes bag_L)
    bag_sizes: Tuple[int, ...] = ()

    def ids_per_query(self, num_tables: int) -> int:
        """int32 ids a query sends: one a table, L a table, or the bags'."""
        if self.bag_sizes:
            return sum(self.bag_sizes)
        return num_tables * max(self.bag_L, 1)


def build_engine(model, spec: ServeSpec) -> ServingEngine:
    """The scoring half of the assembly: a one-device engine over
    ``model``, or with ``spec.mesh`` a sharded engine over this rank's
    shard of ``model`` (built on the host: only the shard moves to the
    device)."""
    if spec.mesh is None:
        if spec.multiprocess:
            raise ValueError("multiprocess serving requires a mesh")
        return ServingEngine.from_model(model, batch_size=spec.batch,
                                        background_drain=spec.bg_drain,
                                        fuse=spec.fuse, bag_L=spec.bag_L,
                                        bag_mean=spec.bag_mean, bag_sizes=spec.bag_sizes)
    if spec.bag_L or spec.bag_sizes:
        raise ValueError("pooled bag serving is single-device (no mesh); use "
                         "ShardedFleetRec.forward_pooled directly for sharded bags")
    from ..parallel import ShardedFleetRec, global_mesh

    D, M = spec.mesh
    mesh = global_mesh(D, M, device=spec.device)
    eng = ServingEngine.from_sharded(
        ShardedFleetRec(model, mesh), batch_size=spec.batch,
        background_drain=spec.bg_drain, fuse=spec.fuse, multiprocess=spec.multiprocess)
    if spec.multiprocess and spec.peer_timeout_s:
        eng.watchdog = PeerWatchdog(spec.peer_timeout_s, process_id=mesh.rank)
    return eng


def serve(cfg, model, spec: ServeSpec) -> dict:
    """Run one full serving session; returns the latency/throughput
    summary (engine.run_from_ingest's dict + per-sender rx counters +
    scatter stats).  Prints the 'serving ...' banner once the ingest ports
    are bound — clients key their connects off it.  A follower rank of a
    mesh binds nothing: it follows its leader and returns its count."""
    if (spec.bag_L or spec.bag_sizes) and spec.senders > 1:
        raise ValueError("pooled bag serving is single-sender wire only")
    eng = build_engine(model, spec)
    if eng.is_follower:
        mesh = eng._sharded.mesh
        print(f"following the leader of data row {mesh.d} as model rank {mesh.m}",
              flush=True)
        return eng.follow()
    try:  # a leader's close() also stops its followers, whatever happens here
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
            nbytes = [B * (spec.ids_per_query(cfg.num_tables) + cfg.dense_dim) * 4]
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
    finally:
        eng.close()
    return summary
