"""Latency-bounded serving loop, the port of the index-mode core of
``fleetrec_tpu/serving/engine.py``: the reference's per-thread
receive->H2D->matmul loop (cuda_server.c:495-627) and its end-of-run
latency post-processing (:704-744: per-batch max over senders, skip the
first batch, average).

Two modes, as in the JAX engine:

* index mode (``from_model``): batches of table ids (+ the dense slice) are
  scored by the whole forward (lookup + concat + MLP) on the device; with
  ``bag_L=L`` the ids are pooled bags ``[B, T, L]`` (``models/pooled.py``:
  -1 is padding) scored by the pooled forward, and with
  ``bag_sizes=(n_0, ..)`` ragged bags ``[B, sum(n_t)]``, table t's n_t members
  in one run (``FleetRecModel.forward_ragged``).  On a CUDA device a batch of
  the served shape is scored by replaying that forward from a CUDA graph
  (``GraphSlots``);
* feature mode (``mlp_only``): batches arrive as pre-gathered feature
  vectors, the reference's wire, and only the MLP tower runs (the
  ``fused_mlp`` kernel on CUDA).

Sharded serving (``from_sharded``) scores through a ``ShardedFleetRec``
(``parallel/sharded.py``) on a (data, model) mesh of ranks, one device a
rank: each data row's model-rank 0 (its leader) runs this engine's loop over
its own rows, broadcasting every batch to its row's ranks, which run
``follow`` until the leader's ``close`` stops them.  A ``PeerWatchdog``
(``engine.watchdog``) bounds every collective dispatch and readback: a
stalled peer aborts the process instead of hanging it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.fleetrec import check_pooled_config
from ..models.mlp import mlp_apply
from ..ops.cross import cross_tail
from ..ops.lookup import lookup_fused, lookup_fused_bags, lookup_fused_ragged
from ..ops.mlp_fused import fused_mlp

# watchdog abort status: 124 is the `timeout(1)` convention
EXIT_PEER_TIMEOUT = 124


class PeerWatchdog:
    """Bounded entry into the collective program for multi-process serving.

    The ranks of a data row run each batch's forward in lockstep, so a
    stalled or dead peer hangs every other rank's dispatch or readback: a
    collective has no local timeout short of the process group's.  The
    reference fails loud instead (printf + exit on a bad sender,
    cuda_server.c:370-401); this watchdog does the same: any guarded section
    that overruns ``timeout_s`` prints a per-process diagnostic to stderr
    and aborts the process with EXIT_PEER_TIMEOUT, so that a supervisor can
    restart the job.

    Guards may overlap (the submit thread dispatches while the drain thread
    reads back); each holds its own deadline and the watcher fires on the
    earliest expiry.  ``on_timeout`` overrides the abort for tests."""

    def __init__(self, timeout_s: float, process_id: int = 0,
                 on_timeout: Optional[Callable[[str], None]] = None):
        self.timeout_s = float(timeout_s)
        self.process_id = process_id
        self._on_timeout = on_timeout
        self._cv = threading.Condition()
        self._active: dict = {}  # token -> (deadline, label)
        self._fired = False
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    @contextlib.contextmanager
    def guard(self, label: str):
        token = object()
        with self._cv:
            self._active[token] = (time.monotonic() + self.timeout_s, label)
            self._cv.notify()
        try:
            yield
        finally:
            with self._cv:
                self._active.pop(token, None)
                self._cv.notify()

    def _watch(self):
        with self._cv:
            while not self._fired:
                if not self._active:
                    self._cv.wait()
                    continue
                deadline, label = min(self._active.values())
                now = time.monotonic()
                if now < deadline:
                    self._cv.wait(deadline - now)
                    continue
                self._fired = True
                msg = (f"[fleetrec peer-watchdog] process {self.process_id}: "
                       f"no progress for {self.timeout_s:.1f}s in '{label}' — "
                       f"a lockstep peer has stalled or died; aborting this "
                       f"process (the collective would otherwise hang "
                       f"forever)")
                if self._on_timeout is not None:
                    cb = self._on_timeout
                    self._cv.release()
                    try:
                        cb(msg)
                    finally:
                        self._cv.acquire()
                else:
                    print(msg, file=sys.stderr, flush=True)
                    os._exit(EXIT_PEER_TIMEOUT)


# the header a leader broadcasts before each batch of a sharded engine:
# [stop, ndim, dims (3), ids are int64, dense follows]
_HEADER = 7
_ID_DTYPES = (torch.int32, torch.int64)


@dataclasses.dataclass(slots=True)
class BatchRecord:
    """One device call's stamps, all on the monotonic clock the native
    ingest tier stamps with (steady_clock = CLOCK_MONOTONIC =
    time.monotonic_ns).

    Beside the three the latency reads (first byte, submit, done), the
    engine's loop and drain threads stamp every layer boundary a batch
    crosses; ``SPANS`` names each span, a pair of consecutive stamps.  A
    stamp the batch never reached (a batch given to ``submit`` directly has
    no ring stamps) stays 0.  With ``fuse`` K > 1 one record covers the K
    wire batches of a call: ``t_complete_ns`` and ``t_acquired_ns`` are the
    group's first slot's, ``t_parsed_ns`` the K-th slot parsed and released
    (so ``parse`` holds the other K - 1 acquires too) and ``t_validated_ns``
    the K-th batch validated."""

    batch_id: int
    t_first_byte_ns: int  # earliest first byte across senders (0 if host-gen)
    t_submit_ns: int      # host submit to the device
    t_done_ns: int = 0    # scores on the host
    t_complete_ns: int = 0      # the slot whole in the ingest ring
    t_acquire_call_ns: int = 0  # the loop done with the batch before, asking for a slot
    t_acquired_ns: int = 0      # the slot in the loop's hands
    t_parsed_ns: int = 0        # ids and dense copied out of the slot, the slot released
    t_validated_ns: int = 0     # every id checked against its table's rows
    t_h2d_ns: int = 0           # ids and dense on the device
    t_dispatched_ns: int = 0    # the forward's checks and launches returned
    t_dequeued_ns: int = 0      # the readback taken up (drain thread, or the loop inline)
    t_replied_ns: int = 0       # on_done returned: scores replied
    graph: bool = False         # scored by a CUDA graph's replay (else the eager forward)
    n_ids: int = 0              # ids the loop copied out of the ring and validated

    @property
    def latency_ns(self) -> int:
        """First byte -> scores on the host: time the slot waited in the
        ingest ring, host parsing/validation and any wait on the in-flight
        window all count.  Batches submitted directly start at submit."""
        return self.t_done_ns - (self.t_first_byte_ns or self.t_submit_ns)


# A batch's spans in order, (name, where, from stamp, to stamp).  First
# byte -> submit is wire + ring_wait + parse + validate + slot_wait, and
# submit -> done is h2d + dispatch + queued + readback.  ``acquire`` is the
# loop thread's wait for the slot: it starts at the stamp the loop's work
# on the batch before ended with (``t_dispatched_ns``, or, draining inline,
# the last ``t_replied_ns`` it drained), so the loop's spans tile its time.
SPANS = (
    ("wire", "ingest", "t_first_byte_ns", "t_complete_ns"),
    ("ring_wait", "ingest", "t_complete_ns", "t_acquired_ns"),
    ("acquire", "loop", "t_acquire_call_ns", "t_acquired_ns"),
    ("parse", "loop", "t_acquired_ns", "t_parsed_ns"),
    ("validate", "loop", "t_parsed_ns", "t_validated_ns"),
    ("slot_wait", "loop", "t_validated_ns", "t_submit_ns"),
    ("h2d", "loop", "t_submit_ns", "t_h2d_ns"),
    ("dispatch", "loop", "t_h2d_ns", "t_dispatched_ns"),
    ("queued", "in flight", "t_dispatched_ns", "t_dequeued_ns"),
    ("readback", "drain", "t_dequeued_ns", "t_done_ns"),
    ("reply", "drain", "t_done_ns", "t_replied_ns"),
)


class LatencyStats:
    """Per-batch latency collector with the reference's reporting rules:
    first batch excluded, per-batch latency = first byte -> scores ready."""

    def __init__(self):
        self.records: List[BatchRecord] = []

    def add(self, rec: BatchRecord):
        self.records.append(rec)

    def _lat_ms(self) -> np.ndarray:
        recs = self.records[1:] if len(self.records) > 1 else self.records
        return np.asarray([r.latency_ns for r in recs], dtype=np.float64) / 1e6

    def summary(self) -> dict:
        if not self.records:
            return {"batches": 0}
        lat = self._lat_ms()
        out = {
            "batches": len(self.records),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_ms_mean": float(lat.mean()),
        }
        if len(self.records) > 1:
            span = (self.records[-1].t_done_ns - self.records[0].t_submit_ns) / 1e9
            if span > 0:
                out["batches_per_sec"] = len(self.records) / span
        return out


def _to_np(scores: torch.Tensor) -> np.ndarray:
    """Device scores -> host numpy (waits for the device)."""
    return scores.cpu().numpy()


def _broadcast_header(mesh, ids: torch.Tensor, has_dense: bool) -> None:
    """The leader's header of one batch (ids [B, T] or [K, B, T])."""
    if ids.dim() > 3 or ids.dtype not in _ID_DTYPES:
        raise ValueError(f"a sharded engine takes int32 / int64 ids [B, T] or [K, B, T], "
                         f"got {tuple(ids.shape)} {ids.dtype}")
    dims = list(ids.shape) + [0] * (3 - ids.dim())
    hdr = torch.tensor([0, ids.dim(), *dims, int(ids.dtype == torch.int64), int(has_dense)],
                       dtype=torch.int64)
    dist.broadcast(hdr.to(mesh.device), src=mesh.leader, group=mesh.group)


# the kernel wrappers a served forward calls: a replay adds to their
# ``launches`` what one capture of the forward called
_FORWARD_KERNELS = (lookup_fused, lookup_fused_bags, lookup_fused_ragged, fused_mlp, cross_tail)


@dataclasses.dataclass(slots=True)
class _Slot:
    ids: torch.Tensor                # static ids of the served shape, int32
    dense: Optional[torch.Tensor]    # static dense, float32 (None: no dense)
    graph: Optional[object] = None   # torch.cuda.CUDAGraph of the forward on them
    out: Optional[torch.Tensor] = None  # the graph's static scores


class GraphSlots:
    """The served forward of a one-device engine on a CUDA device, replayed
    from CUDA graphs.  ``copy_in`` and ``forward`` stand in for the eager
    pair they wrap: ids of exactly the served shape as int32 (and dense of
    the served shape as float32, where the model reads dense) are copied
    into the next of ``n`` slots and scored by one replay of the graph
    captured on that slot; any other batch runs the eager pair as it is.

    The graphs are captured at the first batch of the served shape (the
    engine's ``warmup`` sends one): that batch's forward runs eagerly on a
    side stream, which sets the kernels' function attributes and loads
    their modules, then each slot's forward is captured.  A replay's scores
    are the slot's static output, overwritten by the slot's next replay:
    ``n`` must exceed the batches that can be in flight (the argument is
    at the slot rotation in ``copy_in``)."""

    def __init__(self, copy_in: Callable, forward: Callable, ids_shape: tuple,
                 dense_shape: Optional[tuple], n: int, device: torch.device):
        self.eager_copy_in, self.eager_forward = copy_in, forward
        self.ids_shape, self.dense_shape = tuple(ids_shape), dense_shape
        self.n, self.device = n, device
        self.slots: List[_Slot] = []
        self.capture_s = 0.0    # seconds spent capturing the graphs
        self.replayed = False   # whether the last forward was a replay
        self._batches = 0       # batches copied into a slot so far
        self._next: Optional[_Slot] = None  # the slot the last copy_in filled
        self._launches: tuple = ()  # (kernel wrapper, launches) a replay adds

    def fits(self, indices_np, dense_np) -> bool:
        """A batch of the served shape and dtypes, which a slot can take."""
        if dense_np is None or self.dense_shape is None:
            dense_ok = dense_np is None and self.dense_shape is None
        else:
            dense_ok = dense_np.shape == self.dense_shape and dense_np.dtype == np.float32
        return (dense_ok and isinstance(indices_np, np.ndarray)
                and indices_np.shape == self.ids_shape and indices_np.dtype == np.int32)

    def copy_in(self, indices_np, dense_np):
        self._next = None
        if not self.fits(indices_np, dense_np):
            return self.eager_copy_in(indices_np, dense_np)
        if not self.slots:
            self.slots = [_Slot(
                torch.empty(self.ids_shape, dtype=torch.int32, device=self.device),
                None if self.dense_shape is None else
                torch.empty(self.dense_shape, dtype=torch.float32, device=self.device))
                for _ in range(self.n)]
        # Batch k of this shape takes slot k % n, n = max_in_flight + 1.  Its
        # copies are queued on the stream behind the replay of batch k - n,
        # the slot's last user, so they cannot change that replay's inputs.
        # Its replay overwrites the slot's scores, which batch k - n's
        # readback must have copied out first, and it has: the engine's
        # batches are read back in order, and when batch k is copied in at
        # most max_in_flight older batches are not read back yet (draining
        # in the background, batch k holds one of max_in_flight permits, and
        # a batch gives its permit back once read back; draining inline,
        # ``_dispatch`` reads back until at most max_in_flight are left
        # after each dispatch), so batch k - n = k - max_in_flight - 1 is.
        slot = self.slots[self._batches % self.n]
        self._batches += 1
        slot.ids.copy_(torch.from_numpy(np.ascontiguousarray(indices_np)))
        if slot.dense is not None:
            slot.dense.copy_(torch.from_numpy(np.ascontiguousarray(dense_np)))
        self._next = slot
        return slot.ids, slot.dense

    def forward(self, ids, dense):
        slot, self._next = self._next, None
        self.replayed = slot is not None and ids is slot.ids and dense is slot.dense
        if not self.replayed:
            return self.eager_forward(ids, dense)
        if slot.graph is None:
            self.replayed = False
            return self._capture(slot)
        slot.graph.replay()
        for kernel, n in self._launches:
            kernel.launches += n
        return slot.out

    def _capture(self, first: _Slot) -> torch.Tensor:
        """Score ``first``'s batch eagerly on a side stream, then capture
        every slot's forward; returns ``first``'s scores."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            scores = self.eager_forward(first.ids, first.dense)
        cur.wait_stream(side)
        scores.record_stream(cur)
        t0 = time.perf_counter()
        before = [k.launches for k in _FORWARD_KERNELS]
        for s in self.slots:
            s.graph = torch.cuda.CUDAGraph()
            # relaxed: a kernel's entry point may set a function attribute
            with torch.cuda.graph(s.graph, capture_error_mode="relaxed"):
                s.out = self.eager_forward(s.ids, s.dense)
        # a capture launches nothing: put the counts back, and add one
        # capture's calls at each replay
        self._launches = tuple((k, (k.launches - b) // self.n)
                               for k, b in zip(_FORWARD_KERNELS, before) if k.launches != b)
        for k, b in zip(_FORWARD_KERNELS, before):
            k.launches = b
        self.capture_s += time.perf_counter() - t0
        return scores


class ServingEngine:
    """Dispatch loop with a bounded in-flight window.

    A batch is scored in two parts, stamped apart: ``copy_in``
    (indices_np, dense_np) -> the forward's operands on the device, then
    ``forward`` (operands) -> device scores tensor.  Built from a
    FleetRecModel by from_model().

    A one-device ``from_model`` engine on a CUDA device keeps
    ``max_in_flight + 1`` graph slots (``GraphSlots``): a dispatched batch of
    the served shape, int32 ids and float32 dense, is copied into the next
    slot and scored by replaying the forward's CUDA graph captured there;
    any other batch, and every batch of an engine on the CPU, of a sharded
    engine or of ``mlp_only``, runs the forward eagerly.  ``score_fn`` is
    always eager: its caller keeps the tensor, which a slot's next replay
    would overwrite.  ``graph_replays`` and ``eager_forwards`` count the
    dispatched batches each way, ``graph_capture_s`` the seconds spent
    capturing, and each ``BatchRecord`` says which way it went (``graph``)."""

    def __init__(self, copy_in: Callable, forward: Callable, num_tables: int,
                 dense_dim: int, batch_size: int, max_in_flight: int = 2,
                 background_drain: bool = False):
        self.copy_in = copy_in
        self.forward = forward
        self.num_tables = num_tables
        self.dense_dim = dense_dim
        self.batch_size = batch_size
        self.max_in_flight = max_in_flight
        self.fuse = 1  # ingest batches per device call (from_model(fuse=K))
        self.bag_L = 0  # > 0: pooled bag serving (from_model(bag_L=L))
        self.bag_sizes: tuple = ()  # ragged bag serving (from_model(bag_sizes=...))
        # optional PeerWatchdog bounding dispatch / readback (sharded serving)
        self.watchdog: Optional[PeerWatchdog] = None
        # from_sharded: the sharded model, the forward it runs, and whether
        # the leader's followers still wait for batches
        self._sharded = None
        self._run: Optional[Callable] = None
        self._followers_live = False
        # from_model on a CUDA device: the forward replayed from CUDA graphs
        self._graphs: Optional[GraphSlots] = None
        self.graph_replays = 0   # dispatched batches scored by a graph's replay
        self.eager_forwards = 0  # dispatched batches scored by the eager forward
        self.stats = LatencyStats()
        self._in_flight: "queue.Queue" = queue.Queue()
        self._batch_id = 0
        # Background drain: a daemon thread owns the device->host readbacks
        # so submit() overlaps the next batch's host-side work with the
        # previous readback; window flow control moves to a semaphore and
        # on_done callbacks fire on the drain thread.
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_error: Optional[BaseException] = None
        if background_drain:
            self._sem = threading.Semaphore(max_in_flight)
            self._drain_thread = threading.Thread(
                target=self._drain_loop, daemon=True
            )
            self._drain_thread.start()

    @property
    def graph_capture_s(self) -> float:
        """Seconds spent capturing the forward's CUDA graphs (0.0 without)."""
        return 0.0 if self._graphs is None else self._graphs.capture_s

    def score_fn(self, inputs_np, dense_np):
        """(indices_np, dense_np) -> device scores: both parts at once,
        eagerly (a graph slot's scores are overwritten by its next replay,
        and the caller keeps this tensor)."""
        g = self._graphs
        copy_in, forward = ((g.eager_copy_in, g.eager_forward) if g is not None
                            else (self.copy_in, self.forward))
        return forward(*copy_in(inputs_np, dense_np))

    # -- construction ----------------------------------------------------
    @classmethod
    def from_model(cls, model, batch_size: int, max_in_flight: int = 2,
                   background_drain: bool = False, fuse: int = 1,
                   bag_L: int = 0, bag_mean: bool = False, bag_sizes=()):
        """Serve a FleetRecModel on its device.  Each call copies the numpy
        ids (and dense features) to the device and runs the module.

        fuse=K > 1 scores K ingest batches per call: the [K, B, T] ids are
        reshaped to [K*B, T] for one forward, which is exact because rows
        are independent, and the [K*B] scores reshaped back to [K, B].

        bag_L=L > 0 serves the pooled forward (``forward_pooled``): slots
        carry int32 [B, T, L] bag ids (-1 = padding) instead of [B, T], sum-
        pooled, or mean-pooled with ``bag_mean``; fused dispatch reshapes
        [K, B, T, L] to [K*B, T, L].  A DLRM dot config is refused.

        bag_sizes=(n_0, .., n_{T-1}) serves ragged bags: slots carry int32
        [B, sum(n_t)] ids, table t's n_t members in one run, tables in config
        order (-1 = padding), which stay that shape through the graph slot
        into ``forward_ragged``'s one ragged-kernel launch (bags of one size
        too).  Excludes bag_L.

        On a CUDA device the engine keeps ``max_in_flight + 1`` graph slots
        (``GraphSlots``), each the static ids ([B, T], [K, B, T] fused, with
        a trailing L for bags; int32) and dense ([B, dense_dim] or
        [K, B, dense_dim]; float32) of the served shape, the CUDA graph of
        this forward captured on them, and its static scores.  They are
        captured in ``warmup``, or at the first dispatched batch of the
        served shape.  Dispatched batch k of that shape is copied into slot
        k % (max_in_flight + 1) and scored by one replay: the same kernels
        on the same inputs, so the same scores to the bit.  Another shape,
        int64 ids, and ``score_fn`` run the forward eagerly."""
        if bag_L < 0:
            raise ValueError(f"bag_L must be >= 0, got {bag_L}")
        bag_sizes = tuple(int(n) for n in bag_sizes)
        T = model.cfg.num_tables
        if bag_sizes and (bag_L or len(bag_sizes) != T or min(bag_sizes) < 1):
            raise ValueError(f"bag_sizes must give each of the {T} tables 1 or more members, "
                             f"without bag_L; got {bag_sizes} (bag_L {bag_L})")
        if bag_L or bag_sizes:
            check_pooled_config(model.cfg)
        dev = model.device
        n_id = 2 if bag_L else 1  # trailing axes of one query's ids

        def copy_in(indices_np, dense_np):
            i = torch.from_numpy(np.ascontiguousarray(indices_np)).to(dev)
            d = (None if dense_np is None
                 else torch.from_numpy(np.ascontiguousarray(dense_np)).to(dev))
            return i, d

        def forward(i, d):
            lead = i.shape[:-n_id]
            i = i.reshape(-1, *i.shape[-n_id:])
            d = None if d is None else d.reshape(-1, d.shape[-1])
            with torch.inference_mode():
                if bag_sizes:
                    s = model.forward_ragged(i, bag_sizes, d, mean=bag_mean)
                else:
                    s = model.forward_pooled(i, d, mean=bag_mean) if bag_L else model(i, d)
            return s.reshape(lead)

        eng = cls(copy_in, forward, model.cfg.num_tables, model.cfg.dense_dim, batch_size,
                  max_in_flight, background_drain)
        eng.fuse = fuse
        eng.bag_L = bag_L
        eng.bag_sizes = bag_sizes
        if dev.type == "cuda":
            ids_shape, dense_shape = eng._served_shapes()
            eng._graphs = GraphSlots(copy_in, forward, ids_shape, dense_shape,
                                     max_in_flight + 1, dev)
            eng.copy_in, eng.forward = eng._graphs.copy_in, eng._graphs.forward
        return eng

    @classmethod
    def from_sharded(cls, sharded, batch_size: int, max_in_flight: int = 2,
                     background_drain: bool = False, fuse: int = 1,
                     multiprocess: bool = False):
        """Serve through a ShardedFleetRec on its mesh: tables sharded over
        the "model" axis, batches over "data" (the reference's scatter tier,
        one ingest point a data row).  ``batch_size`` is a data row's rows.

        multiprocess=True: the mesh spans a ``torch.distributed`` world (one
        rank a device).  On a data row's leader (model rank 0) this engine
        takes the row's batches (``submit`` / ``run_from_ingest``) and each
        dispatch broadcasts a header, the ids and the dense features to the
        row's ranks (``multihost.host_local_batch_to_global``) before the
        sharded forward; the scores are the leader's.  The row's other ranks
        call ``follow``: receive, compute, drop, until ``close`` on the
        leader broadcasts the stop header.  Every rank of a row must take
        part in every batch: set ``engine.watchdog`` (a PeerWatchdog) to
        bound the wait on a stalled peer.  multiprocess=False: a mesh of one
        rank and no process group.

        fuse=K > 1 scores K ingest batches [K, B, T] a call through
        ``forward_pipelined`` (batch k's exchange overlaps batch k+1's
        lookup)."""
        mesh = sharded.mesh
        if multiprocess != (mesh.group is not None):
            raise ValueError(
                "multiprocess=True serves a mesh over a torch.distributed world "
                "(init_distributed, global_mesh); multiprocess=False a mesh of one rank "
                "and no process group")
        dev = mesh.device
        run = sharded.forward_pipelined if fuse > 1 else sharded.forward

        def copy_in(indices_np, dense_np):
            if not mesh.is_leader:
                raise ValueError("a follower rank runs follow(); its leader takes the batches")
            i = torch.from_numpy(np.ascontiguousarray(indices_np))
            d = (None if dense_np is None
                 else torch.from_numpy(np.ascontiguousarray(dense_np)))
            if multiprocess:
                from ..parallel.multihost import host_local_batch_to_global

                _broadcast_header(mesh, i, d is not None)
                i = host_local_batch_to_global(mesh, i)
                d = None if d is None else host_local_batch_to_global(mesh, d)
            else:
                i, d = i.to(dev), None if d is None else d.to(dev)
            return i, d

        def forward(i, d):
            with torch.inference_mode():
                return run(i, d)

        eng = cls(copy_in, forward, sharded.cfg.num_tables, sharded.cfg.dense_dim,
                  batch_size, max_in_flight, background_drain)
        eng.fuse = fuse
        eng._sharded, eng._run = sharded, run
        eng._followers_live = multiprocess and mesh.is_leader and mesh.model > 1
        return eng

    @property
    def is_follower(self) -> bool:
        """A sharded engine on a rank that is not its data row's leader."""
        return self._sharded is not None and not self._sharded.mesh.is_leader

    def follow(self) -> dict:
        """The loop of a follower rank of a sharded engine: receive each
        batch its leader broadcasts, run the sharded forward (its part of the
        exchange), drop the scores; return at the leader's stop header."""
        if not self.is_follower:
            raise ValueError("follow() is the loop of a sharded engine's follower ranks")
        from ..parallel.multihost import host_local_batch_to_global

        mesh = self._sharded.mesh
        n = 0
        while True:
            hdr = torch.zeros(_HEADER, dtype=torch.int64, device=mesh.device)
            dist.broadcast(hdr, src=mesh.leader, group=mesh.group)
            stop, ndim, *rest = hdr.tolist()
            if stop:
                return {"role": "follower", "rank": mesh.rank, "batches": n}
            shape, id64, has_dense = tuple(rest[:ndim]), rest[3], rest[4]
            wd = (self.watchdog.guard(f"follow batch {n}") if self.watchdog is not None
                  else contextlib.nullcontext())
            with wd:
                i = host_local_batch_to_global(
                    mesh, torch.empty(shape, dtype=_ID_DTYPES[id64], device=mesh.device))
                d = None
                if has_dense:
                    d = host_local_batch_to_global(mesh, torch.empty(
                        shape[:-1] + (self.dense_dim,), dtype=torch.float32, device=mesh.device))
                with torch.inference_mode():
                    self._run(i, d)
            n += 1

    def _stop_followers(self):
        """The leader's stop header, once."""
        if self._followers_live:
            self._followers_live = False
            hdr = torch.zeros(_HEADER, dtype=torch.int64)
            hdr[0] = 1
            mesh = self._sharded.mesh
            dist.broadcast(hdr.to(mesh.device), src=mesh.leader, group=mesh.group)

    @classmethod
    def mlp_only(cls, model, batch_size: int, max_in_flight: int = 2,
                 background_drain: bool = False):
        """Feature mode: score pre-gathered float32 feature vectors
        [B, feature_dim] with the model's MLP tower only (the reference's
        wire semantics: its server runs just the matmul chain)."""
        dev = model.device
        weights = model.mlp_weights
        activation = model.cfg.mlp.activation

        def copy_in(feats_np, _dense):
            return torch.from_numpy(np.ascontiguousarray(feats_np)).to(dev), None

        def forward(x, _dense):
            with torch.inference_mode():
                return mlp_apply(weights, x, activation)[:, 0]

        return cls(copy_in, forward, 0, 0, batch_size, max_in_flight, background_drain)

    def _query_ids_shape(self) -> tuple:
        """The shape of one query's ids: (T,), (T, L) with bag_L, or
        (sum(bag_sizes),) with ragged bags."""
        if self.bag_sizes:
            return (sum(self.bag_sizes),)
        return (self.num_tables,) + ((self.bag_L,) if self.bag_L else ())

    def _served_shapes(self):
        """The ids' and the dense features' shapes of one dispatched batch
        (the dense None without dense features)."""
        lead = (self.fuse, self.batch_size) if self.fuse > 1 else (self.batch_size,)
        ids = lead + self._query_ids_shape()
        return ids, (lead + (self.dense_dim,) if self.dense_dim else None)

    def warmup(self):
        """Run the scoring path once on dummy data before the first real
        batch, so that building the kernels (first use) and capturing the
        forward's CUDA graphs stay out of the latency records.  Index-mode
        engines only."""
        if self.num_tables == 0:
            raise ValueError("warmup is for index-mode engines")
        ids_shape, dense_shape = self._served_shapes()
        idx = np.zeros(ids_shape, np.int32)
        dense = None if dense_shape is None else np.zeros(dense_shape, np.float32)
        _to_np(self.forward(*self.copy_in(idx, dense)))  # readback forces completion

    # -- validation (host-side guard against out-of-range ids) -----------
    def validate_indices(self, indices: np.ndarray, row_limits: Sequence[int]):
        """Single ids [B, T]: every id must be in [0, rows) of its table.
        Pooled bags [B, T, L] (a ``bag_L`` engine) and ragged bags [B,
        sum(bag_sizes)] (a ``bag_sizes`` engine): -1 marks padding and is
        allowed; anything else must be in range."""
        if self.bag_sizes:
            return self._validate_ragged(indices, row_limits)
        ndim = 3 if self.bag_L else 2
        if indices.ndim != ndim or indices.shape[1] != len(row_limits):
            raise ValueError(f"expected [B, {len(row_limits)}{', L' if self.bag_L else ''}] "
                             f"index columns, got {indices.shape}")
        lim = np.minimum(np.asarray(row_limits, dtype=np.int64),
                         np.iinfo(indices.dtype).max).astype(indices.dtype)
        if self.bag_L:
            lo, hi = indices.min(axis=(0, 2)), indices.max(axis=(0, 2))
            if (lo >= -1).all() and (hi < lim).all():
                return
            bad = (indices < -1) | (indices >= lim[None, :, None])
            b, t, sl = np.argwhere(bad)[0]
            raise ValueError(
                f"bag index out of range: batch row {b}, table {t}, slot {sl}, "
                f"id {indices[b, t, sl]} (limit {lim[t]}; -1 = padding)")
        # hot path: two column reductions instead of full [B, T] masks; the
        # full scan runs only on the error path to name the offender
        mn, mx = indices.min(axis=0), indices.max(axis=0)
        if (mn >= 0).all() and (mx < lim).all():
            return
        bad = (indices < 0) | (indices >= lim[None, :])
        b, t = np.argwhere(bad)[0]
        raise ValueError(
            f"index out of range: batch row {b}, table {t}, "
            f"id {indices[b, t]} >= {lim[t]}"
        )

    def _validate_ragged(self, indices: np.ndarray, row_limits: Sequence[int]):
        """Ragged bags [B, sum(bag_sizes)]: each member against its table's
        rows (two column reductions; the full scan only to name the
        offender)."""
        sizes = self.bag_sizes
        if (indices.ndim != 2 or indices.shape[1] != sum(sizes)
                or len(row_limits) != len(sizes)):
            raise ValueError(f"expected ragged bags [B, {sum(sizes)}] of {len(sizes)} tables, "
                             f"got {indices.shape} and {len(row_limits)} row limits")
        lim = np.repeat(np.minimum(np.asarray(row_limits, dtype=np.int64),
                                   np.iinfo(indices.dtype).max).astype(indices.dtype), sizes)
        if (indices.min(axis=0) >= -1).all() and (indices.max(axis=0) < lim).all():
            return
        b, c = np.argwhere((indices < -1) | (indices >= lim[None, :]))[0]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        t = int(np.searchsorted(starts, c, side="right") - 1)
        raise ValueError(
            f"bag index out of range: batch row {b}, table {t}, member {c - starts[t]}, "
            f"id {indices[b, c]} (limit {lim[c]}; -1 = padding)")

    # -- dispatch --------------------------------------------------------
    def submit(self, inputs_np, dense_np=None, t_first_byte_ns: int = 0,
               on_done: Optional[Callable] = None):
        """Dispatch one batch; blocks only when the in-flight window is full
        (synchronous mode drains inline; background mode waits on the
        semaphore while the drain thread reads back).  t_first_byte_ns:
        the ingest tier's monotonic first-byte stamp, where the batch's
        latency starts."""
        rec = BatchRecord(self._batch_id, t_first_byte_ns, 0)
        self._dispatch(rec, inputs_np, dense_np, on_done)
        return rec.batch_id

    def _dispatch(self, rec: BatchRecord, inputs_np, dense_np, on_done) -> int:
        """Submit one batch under ``rec`` (its stamps up to validation set
        by the caller); returns the loop thread's last stamp: the batch's
        ``t_dispatched_ns``, or the last ``t_replied_ns`` it drained
        inline."""
        self._check_drain_error()
        rec.batch_id = self._batch_id
        wd = (self.watchdog.guard(f"dispatch batch {rec.batch_id}")
              if self.watchdog is not None else contextlib.nullcontext())
        if self._drain_thread is not None:
            self._sem.acquire()
            try:
                rec.t_submit_ns = time.monotonic_ns()
                with wd:
                    operands = self.copy_in(inputs_np, dense_np)
                    rec.t_h2d_ns = time.monotonic_ns()
                    scores = self.forward(*operands)
            except BaseException:
                self._sem.release()  # a lost permit shrinks the window forever
                raise
        else:
            rec.t_submit_ns = time.monotonic_ns()
            with wd:
                operands = self.copy_in(inputs_np, dense_np)
                rec.t_h2d_ns = time.monotonic_ns()
                scores = self.forward(*operands)
        rec.t_dispatched_ns = mark = time.monotonic_ns()
        rec.graph = self._graphs is not None and self._graphs.replayed
        if rec.graph:
            self.graph_replays += 1
        else:
            self.eager_forwards += 1
        self._batch_id += 1
        self._in_flight.put((scores, rec, on_done))
        if self._drain_thread is None:
            while self._in_flight.qsize() > self.max_in_flight:
                mark = self._drain_one(t_dequeued_ns=mark)
        return mark

    def _drain_one(self, item=None, t_dequeued_ns: int = 0) -> int:
        """Read one batch back and hand its scores to on_done; returns its
        ``t_replied_ns``.  ``t_dequeued_ns``: where its readback starts on
        the loop thread when drained inline (the loop's last stamp)."""
        scores, rec, on_done = item if item is not None else self._in_flight.get()
        rec.t_dequeued_ns = t_dequeued_ns or time.monotonic_ns()
        wd = (self.watchdog.guard(f"readback batch {rec.batch_id}")
              if self.watchdog is not None else contextlib.nullcontext())
        with wd:
            out = _to_np(scores)  # waits for the device (readback)
        rec.t_done_ns = time.monotonic_ns()
        self.stats.add(rec)
        if on_done is not None:
            on_done(rec.batch_id, out)
        rec.t_replied_ns = time.monotonic_ns()
        return rec.t_replied_ns

    def _drain_loop(self):
        while True:
            item = self._in_flight.get()
            try:
                if item is None:
                    return
                try:
                    self._drain_one(item)
                except BaseException as e:  # noqa: BLE001
                    # Record and keep draining: a failing readback/on_done
                    # (e.g. reply to a disconnected client) must not kill
                    # the thread, which would deadlock submit()/drain().
                    # The first error re-raises on the next
                    # submit/drain/close call.
                    if self._drain_error is None:
                        self._drain_error = e
                self._sem.release()
            finally:
                self._in_flight.task_done()

    def _check_drain_error(self):
        if self._drain_error is not None:
            e, self._drain_error = self._drain_error, None
            raise e

    def drain(self):
        """Wait for every in-flight batch, return the latency summary."""
        if self._drain_thread is not None:
            self._in_flight.join()
        else:
            while not self._in_flight.empty():
                self._drain_one()
        self._check_drain_error()
        return self.stats.summary()

    def close(self):
        """Stop the background drain thread (after draining) and, on a
        sharded engine's leader, the followers; idempotent."""
        try:
            if self._drain_thread is not None:
                self._in_flight.join()
                self._in_flight.put(None)
                self._drain_thread.join()
                self._drain_thread = None
                self._check_drain_error()
        finally:
            self._stop_followers()

    # -- ingest loop -----------------------------------------------------
    def run_from_ingest(self, ingest, n_batches: int, mode: str = "index",
                        feature_dim: Optional[int] = None,
                        on_done: Optional[Callable] = None,
                        timeout_ms: int = 20_000,
                        row_limits: Optional[Sequence[int]] = None,
                        reply_to: Optional[int] = None,
                        scatter=None, wire=None) -> dict:
        """Consume n_batches of slots from an IngestServer and score them.

        Feature mode (mode="feature", an ``mlp_only`` engine): slot floats
        are [B, feature_dim] features; with several senders, each sender's
        block is its [B, width] slice, so the slot is their concatenation
        only when the features are all equal (the parity data).
        Index mode, single sender (wire=None): slot floats are bit-cast
        int32 [B, num_tables] ids (a ``bag_L`` engine: [B, num_tables, L]
        bags, -1 padding) followed by [B, dense_dim] floats.
        Index mode, multi-sender: pass an IndexWireFormat (serving/wire.py)
        describing the per-sender slot layout — the reference's 3-node
        topology.

        reply_to: sender index to stream the fp32 scores back to after each
        batch; the client must read replies or TCP backpressure stalls the
        drain.  scatter: a ScatterEgress fanning each batch's scores out to
        N consumers round-robin.

        Fused dispatch (from_model(fuse=K)): wire batches are grouped K at
        a time into one [K, B, T] call (n_batches must divide by K): the K
        slots are acquired and parsed, then the K batches validated.
        Replies still go out per wire batch; the latency record per group
        spans the earliest first byte to all K scores ready, on the ingest
        tier's monotonic clock, so time a slot waits in the ring counts.
        Each record holds the group's stamps (``BatchRecord``)."""
        B = self.batch_size
        fuse = self.fuse
        if mode not in ("index", "feature"):
            raise ValueError(f"mode {mode!r} not in ('index', 'feature')")
        if mode == "feature":
            if fuse > 1:
                raise ValueError("fused dispatch is index-mode only")
            if not feature_dim:
                raise ValueError("feature mode needs feature_dim")
        if n_batches % fuse:
            raise ValueError(f"n_batches={n_batches} must divide by fuse={fuse}")
        if (self.bag_L or self.bag_sizes) and (wire is not None or mode != "index"):
            raise ValueError("pooled bag serving is index mode on a single-sender "
                             "wire only (no IndexWireFormat)")
        if reply_to is not None or scatter is not None:
            user_on_done = on_done

            def on_done(bid, scores, _u=user_on_done):
                out = np.asarray(scores, dtype=np.float32)
                # fused groups reply per wire batch ([K, B] -> K sends)
                for sub in (out if fuse > 1 else [out]):
                    if reply_to is not None:
                        ingest.reply(reply_to, sub)
                    if scatter is not None:
                        scatter.send(sub)
                if _u is not None:
                    _u(bid, scores)

        def parse_index_slot(view):
            if wire is not None:
                return wire.parse(view)
            ishape = (B,) + self._query_ids_shape()
            n_idx = int(np.prod(ishape))
            idx = view[:n_idx].view(np.int32).reshape(ishape).copy()
            dense = (view[n_idx : n_idx + B * self.dense_dim]
                     .reshape(B, self.dense_dim).copy()
                     if self.dense_dim else None)
            return idx, dense

        mark = time.monotonic_ns()  # the loop thread's last stamp
        for i in range(0, n_batches, fuse):
            rec = BatchRecord(0, 0, 0, t_acquire_call_ns=mark)
            idxs, denses, t_firsts = [], [], []
            for k in range(fuse):
                got = ingest.acquire(timeout_ms)
                if got is None:
                    raise TimeoutError(f"ingest timeout at batch {i + k}")
                slot, view, t_first, t_complete = got
                if not k:
                    rec.t_acquired_ns = time.monotonic_ns()
                    rec.t_complete_ns = t_complete
                if mode == "feature":
                    idx, dense = view.reshape(B, feature_dim).copy(), None
                else:
                    idx, dense = parse_index_slot(view)
                ingest.release(slot)
                idxs.append(idx)
                denses.append(dense)
                t_firsts.append(t_first)
            if fuse > 1:
                idx = np.stack(idxs)  # [K, B, T] ([K, B, T, L] bags)
                dense = None if denses[0] is None else np.stack(denses)
            else:
                idx, dense = idxs[0], denses[0]
            rec.t_parsed_ns = time.monotonic_ns()
            if row_limits is not None and mode == "index":
                # reject bad row ids at the wire (otherwise they surface
                # as NaN scores)
                for one in idxs:
                    self.validate_indices(one, row_limits)
            rec.t_validated_ns = time.monotonic_ns()
            rec.n_ids = sum(one.size for one in idxs)
            rec.t_first_byte_ns = min(t_firsts)
            mark = self._dispatch(rec, idx, dense, on_done)
        summary = self.drain()
        if summary.get("batches_per_sec"):
            # each LatencyStats record covers `fuse` wire batches of B queries
            summary["queries_per_sec"] = summary["batches_per_sec"] * fuse * B
        summary["wire_batches"] = n_batches
        summary["fuse"] = fuse
        summary["graph_replays"] = self.graph_replays
        summary["eager_forwards"] = self.eager_forwards
        summary["graph_capture_s"] = self.graph_capture_s
        return summary
