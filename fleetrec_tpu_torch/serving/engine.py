"""Latency-bounded serving loop, the port of the index-mode core of
``fleetrec_tpu/serving/engine.py``: the reference's per-thread
receive->H2D->matmul loop (cuda_server.c:495-627) and its end-of-run
latency post-processing (:704-744: per-batch max over senders, skip the
first batch, average).

Two modes, as in the JAX engine:

* index mode (``from_model``): batches of table ids (+ the dense slice) are
  scored by the whole forward (lookup + concat + MLP) on the device;
* feature mode (``mlp_only``): batches arrive as pre-gathered feature
  vectors, the reference's wire, and only the MLP tower runs (the
  ``fused_mlp`` kernel on CUDA).

Pooled bags (``bag_L``), sharded serving (``from_sharded``) and the
``PeerWatchdog`` are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.mlp import mlp_apply


@dataclasses.dataclass
class BatchRecord:
    """One device call's stamps, all on the monotonic clock the native
    ingest tier stamps with (steady_clock = CLOCK_MONOTONIC =
    time.monotonic_ns)."""

    batch_id: int
    t_first_byte_ns: int  # earliest first byte across senders (0 if host-gen)
    t_submit_ns: int      # host submit to the device
    t_done_ns: int = 0    # scores on the host

    @property
    def latency_ns(self) -> int:
        """First byte -> scores on the host: time the slot waited in the
        ingest ring, host parsing/validation and any wait on the in-flight
        window all count.  Batches submitted directly start at submit."""
        return self.t_done_ns - (self.t_first_byte_ns or self.t_submit_ns)


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


class ServingEngine:
    """Dispatch loop with a bounded in-flight window.

    score_fn: (indices_np, dense_np) -> device scores tensor.  Built from a
    FleetRecModel by from_model()."""

    def __init__(self, score_fn: Callable, num_tables: int, dense_dim: int,
                 batch_size: int, max_in_flight: int = 2,
                 background_drain: bool = False):
        self.score_fn = score_fn
        self.num_tables = num_tables
        self.dense_dim = dense_dim
        self.batch_size = batch_size
        self.max_in_flight = max_in_flight
        self.fuse = 1  # ingest batches per device call (from_model(fuse=K))
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

    # -- construction ----------------------------------------------------
    @classmethod
    def from_model(cls, model, batch_size: int, max_in_flight: int = 2,
                   background_drain: bool = False, fuse: int = 1):
        """Serve a FleetRecModel on its device.  Each call copies the numpy
        ids (and dense features) to the device and runs the module.

        fuse=K > 1 scores K ingest batches per call: the [K, B, T] ids are
        reshaped to [K*B, T] for one forward, which is exact because rows
        are independent, and the [K*B] scores reshaped back to [K, B]."""
        dev = model.device

        def score(indices_np, dense_np):
            i = torch.from_numpy(np.ascontiguousarray(indices_np)).to(dev)
            d = (None if dense_np is None
                 else torch.from_numpy(np.ascontiguousarray(dense_np)).to(dev))
            lead = i.shape[:-1]
            with torch.inference_mode():
                s = model(i.reshape(-1, i.shape[-1]),
                          None if d is None else d.reshape(-1, d.shape[-1]))
            return s.reshape(lead)

        eng = cls(score, model.cfg.num_tables, model.cfg.dense_dim, batch_size,
                  max_in_flight, background_drain)
        eng.fuse = fuse
        return eng

    @classmethod
    def mlp_only(cls, model, batch_size: int, max_in_flight: int = 2,
                 background_drain: bool = False):
        """Feature mode: score pre-gathered float32 feature vectors
        [B, feature_dim] with the model's MLP tower only (the reference's
        wire semantics: its server runs just the matmul chain)."""
        dev = model.device
        weights = model.mlp_weights
        activation = model.cfg.mlp.activation

        def score(feats_np, _dense):
            x = torch.from_numpy(np.ascontiguousarray(feats_np)).to(dev)
            with torch.inference_mode():
                return mlp_apply(weights, x, activation)[:, 0]

        return cls(score, 0, 0, batch_size, max_in_flight, background_drain)

    def warmup(self):
        """Run the scoring path once on dummy data before the first real
        batch, so that building the kernels (first use) stays out of the
        latency records.  Index-mode engines only."""
        if self.num_tables == 0:
            raise ValueError("warmup is for index-mode engines")
        lead = (self.fuse, self.batch_size) if self.fuse > 1 else (self.batch_size,)
        idx = np.zeros(lead + (self.num_tables,), np.int32)
        dense = (np.zeros(lead + (self.dense_dim,), np.float32)
                 if self.dense_dim else None)
        _to_np(self.score_fn(idx, dense))  # readback forces completion

    # -- validation (host-side guard against out-of-range ids) -----------
    def validate_indices(self, indices: np.ndarray, row_limits: Sequence[int]):
        """[B, T]: every id must be in [0, rows) of its table."""
        if indices.ndim != 2 or indices.shape[1] != len(row_limits):
            raise ValueError(f"expected [B, {len(row_limits)}] index columns, "
                             f"got {indices.shape}")
        lim = np.minimum(np.asarray(row_limits, dtype=np.int64),
                         np.iinfo(indices.dtype).max).astype(indices.dtype)
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

    # -- dispatch --------------------------------------------------------
    def submit(self, inputs_np, dense_np=None, t_first_byte_ns: int = 0,
               on_done: Optional[Callable] = None):
        """Dispatch one batch; blocks only when the in-flight window is full
        (synchronous mode drains inline; background mode waits on the
        semaphore while the drain thread reads back).  t_first_byte_ns:
        the ingest tier's monotonic first-byte stamp, where the batch's
        latency starts."""
        self._check_drain_error()
        if self._drain_thread is not None:
            self._sem.acquire()
            try:
                t_submit = time.monotonic_ns()
                scores = self.score_fn(inputs_np, dense_np)
            except BaseException:
                self._sem.release()  # a lost permit shrinks the window forever
                raise
        else:
            t_submit = time.monotonic_ns()
            scores = self.score_fn(inputs_np, dense_np)
        rec = BatchRecord(self._batch_id, t_first_byte_ns, t_submit)
        self._batch_id += 1
        self._in_flight.put((scores, rec, on_done))
        if self._drain_thread is None:
            while self._in_flight.qsize() > self.max_in_flight:
                self._drain_one()
        return rec.batch_id

    def _drain_one(self, item=None):
        scores, rec, on_done = item if item is not None else self._in_flight.get()
        out = _to_np(scores)  # waits for the device (readback)
        rec.t_done_ns = time.monotonic_ns()
        self.stats.add(rec)
        if on_done is not None:
            on_done(rec.batch_id, out)

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
        """Stop the background drain thread (after draining); idempotent."""
        if self._drain_thread is not None:
            self._in_flight.join()
            self._in_flight.put(None)
            self._drain_thread.join()
            self._drain_thread = None
            self._check_drain_error()

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
        int32 [B, num_tables] ids followed by [B, dense_dim] floats.
        Index mode, multi-sender: pass an IndexWireFormat (serving/wire.py)
        describing the per-sender slot layout — the reference's 3-node
        topology.

        reply_to: sender index to stream the fp32 scores back to after each
        batch; the client must read replies or TCP backpressure stalls the
        drain.  scatter: a ScatterEgress fanning each batch's scores out to
        N consumers round-robin.

        Fused dispatch (from_model(fuse=K)): wire batches are grouped K at
        a time into one [K, B, T] call (n_batches must divide by K).
        Replies still go out per wire batch; the latency record per group
        spans the earliest first byte to all K scores ready, on the ingest
        tier's monotonic clock, so time a slot waits in the ring counts."""
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
            n_idx = B * self.num_tables
            idx = view[:n_idx].view(np.int32).reshape(B, self.num_tables).copy()
            dense = (view[n_idx : n_idx + B * self.dense_dim]
                     .reshape(B, self.dense_dim).copy()
                     if self.dense_dim else None)
            return idx, dense

        for i in range(0, n_batches, fuse):
            idxs, denses, t_firsts = [], [], []
            for k in range(fuse):
                got = ingest.acquire(timeout_ms)
                if got is None:
                    raise TimeoutError(f"ingest timeout at batch {i + k}")
                slot, view, t_first, _ = got
                if mode == "feature":
                    idx, dense = view.reshape(B, feature_dim).copy(), None
                else:
                    idx, dense = parse_index_slot(view)
                ingest.release(slot)
                if row_limits is not None and mode == "index":
                    # reject bad row ids at the wire (otherwise they surface
                    # as NaN scores)
                    self.validate_indices(idx, row_limits)
                idxs.append(idx)
                denses.append(dense)
                t_firsts.append(t_first)
            if fuse > 1:
                idx = np.stack(idxs)  # [K, B, T]
                dense = None if denses[0] is None else np.stack(denses)
            else:
                idx, dense = idxs[0], denses[0]
            self.submit(idx, dense, min(t_firsts), on_done)
        summary = self.drain()
        if summary.get("batches_per_sec"):
            # each LatencyStats record covers `fuse` wire batches of B queries
            summary["queries_per_sec"] = summary["batches_per_sec"] * fuse * B
        summary["wire_batches"] = n_batches
        summary["fuse"] = fuse
        return summary
