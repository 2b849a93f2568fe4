"""ctypes bindings for the native ingest server, load generator and
scatter egress — the port's copy of ``fleetrec_tpu/serving/ingest.py``.

The C++ sources (``fleetrec_tpu/native/{ingest,scatter}.cpp``, the analog
of the reference GPU server's socket tier and sender emulators) are read by
path and compiled with ``g++`` into the port's own build directory
(``fleetrec_tpu_torch/_build/``); nothing is written into the JAX
package.  Batches are exposed as numpy views over the ring slots,
zero-copy.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..ops._build import build_shared

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, os.pardir, "fleetrec_tpu", "native")
_CXX = ("g++", "-O2", "-std=c++17", "-fPIC", "-pthread")
_LINK = ("g++", "-shared", "-pthread")


def build_native() -> str:
    """Compile the native ingest library (once per source change)."""
    srcs = [os.path.normpath(os.path.join(_NATIVE_DIR, f))
            for f in ("ingest.cpp", "scatter.cpp")]
    return build_shared("fleetrec_ingest", srcs, _CXX, _LINK)


@functools.cache
def _load():
    lib = ctypes.CDLL(build_native())
    lib.ing_create.restype = ctypes.c_void_p
    lib.ing_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                               ctypes.c_int, ctypes.c_int]
    lib.ing_create_mc.restype = ctypes.c_void_p
    lib.ing_create_mc.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int64]
    lib.ing_n_stripes.restype = ctypes.c_int
    lib.ing_n_stripes.argtypes = [ctypes.c_void_p]
    lib.ing_listen.restype = ctypes.c_int
    lib.ing_listen.argtypes = [ctypes.c_void_p]
    lib.ing_start.argtypes = [ctypes.c_void_p]
    lib.ing_acquire.restype = ctypes.c_int
    lib.ing_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_slot_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.ing_slot_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_slot_first_byte_ns.restype = ctypes.c_int64
    lib.ing_slot_first_byte_ns.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_slot_complete_ns.restype = ctypes.c_int64
    lib.ing_slot_complete_ns.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_reply.restype = ctypes.c_int
    lib.ing_reply.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_int64]
    lib.ing_total_batches.restype = ctypes.c_int64
    lib.ing_total_batches.argtypes = [ctypes.c_void_p]
    lib.ing_bytes_received.restype = ctypes.c_int64
    lib.ing_bytes_received.argtypes = [ctypes.c_void_p]
    lib.ing_error.restype = ctypes.c_int
    lib.ing_error.argtypes = [ctypes.c_void_p]
    for fn in ("ing_sender_bytes", "ing_sender_fills",
               "ing_sender_reconnects", "ing_sender_last_fill_ns"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_sender_stripes.restype = ctypes.c_int
    lib.ing_sender_stripes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ing_stop.argtypes = [ctypes.c_void_p]
    lib.ing_destroy.argtypes = [ctypes.c_void_p]
    lib.loadgen_run.restype = ctypes.c_int64
    lib.loadgen_run.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_float]
    lib.loadgen_run_striped.restype = ctypes.c_int64
    lib.loadgen_run_striped.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
    ]
    lib.scat_create.restype = ctypes.c_void_p
    lib.scat_create.argtypes = [ctypes.c_int]
    lib.scat_connect.restype = ctypes.c_int
    lib.scat_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.scat_send.restype = ctypes.c_int
    lib.scat_send.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64]
    lib.scat_send_to.restype = ctypes.c_int
    lib.scat_send_to.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int64]
    lib.scat_sent_blocks.restype = ctypes.c_int64
    lib.scat_sent_blocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scat_sent_bytes.restype = ctypes.c_int64
    lib.scat_sent_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scat_is_dead.restype = ctypes.c_int
    lib.scat_is_dead.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scat_skipped.restype = ctypes.c_int64
    lib.scat_skipped.argtypes = [ctypes.c_void_p]
    lib.scat_reconnects.restype = ctypes.c_int64
    lib.scat_reconnects.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scat_reattach.restype = ctypes.c_int
    lib.scat_reattach.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scat_destroy.argtypes = [ctypes.c_void_p]
    return lib


class IngestServer:
    """N-sender fixed-offset batch assembler.

    bytes_per_sender: each sender's per-batch payload (e.g. model-3:
    [64*4, 1952*4, 1952*4] floats*batch — constant.h:25-27).

    n_conns/pkg_bytes: the reference's useConn/pkgWordCount bandwidth pair
    (embedding_krnl.cpp:45-143 sendData; host.cpp:976-977 default 4 conns):
    each sender opens n_conns parallel TCP connections, packet j of its
    payload (pkg_bytes each) rides connection j % n_conns, reassembled at
    deterministic offsets. Sender s's connections use ports
    port_base + s*n_conns + c."""

    def __init__(self, bytes_per_sender: Sequence[int], n_slots: int = 8,
                 port_base: int = 7080, n_conns: int = 1, pkg_bytes: int = 0):
        lib = _load()
        self._lib = lib
        arr = (ctypes.c_int64 * len(bytes_per_sender))(*bytes_per_sender)
        self._h = lib.ing_create_mc(len(bytes_per_sender), arr, n_slots,
                                    port_base, n_conns, pkg_bytes)
        self.n_senders = len(bytes_per_sender)
        self.n_conns = max(1, n_conns)
        self.pkg_bytes = pkg_bytes
        self.slot_floats = sum(bytes_per_sender) // 4
        self.port_base = port_base
        rc = lib.ing_listen(self._h)
        if rc != 0:
            raise OSError(-rc, f"ingest listen failed: {os.strerror(-rc)}")
        lib.ing_start(self._h)

    @property
    def n_stripes(self) -> int:
        """Active connections across all senders (short payloads clamp)."""
        return self._lib.ing_n_stripes(self._h)

    def acquire(self, timeout_ms: int = 10_000):
        """Block for the next complete batch. Returns (slot, view, t_first_ns,
        t_complete_ns) or None on timeout. view is a zero-copy float32
        numpy array over the slot — valid until release(slot)."""
        slot = self._lib.ing_acquire(self._h, timeout_ms)
        if slot < 0:
            return None
        ptr = self._lib.ing_slot_data(self._h, slot)
        view = np.ctypeslib.as_array(ptr, shape=(self.slot_floats,))
        return (
            slot,
            view,
            self._lib.ing_slot_first_byte_ns(self._h, slot),
            self._lib.ing_slot_complete_ns(self._h, slot),
        )

    def release(self, slot: int):
        self._lib.ing_release(self._h, slot)

    def reply(self, sender: int, arr: np.ndarray) -> None:
        """Send bytes back on sender's live connection (scores egress —
        TCP is full-duplex). Raises if the sender is disconnected or the
        send fails; the client MUST read replies or backpressure stalls."""
        arr = np.ascontiguousarray(arr)
        rc = self._lib.ing_reply(
            self._h, sender, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes
        )
        if rc != 0:
            raise OSError(-rc, f"ingest reply failed: {os.strerror(-rc)}")

    @property
    def total_batches(self) -> int:
        return self._lib.ing_total_batches(self._h)

    @property
    def bytes_received(self) -> int:
        return self._lib.ing_bytes_received(self._h)

    def sender_stats(self) -> list:
        """Per-sender rx observability — the analog of the hardware stack's
        per-protocol packet counters (network_stack.sv:1049-1100): bytes,
        completed batches (stripe fills / active stripes), reconnects, and
        ns since the last completed stripe fill (None = never filled) for
        spotting the slow/flapping sender."""
        import time

        now = time.monotonic_ns()
        out = []
        for s in range(self.n_senders):
            stripes = self._lib.ing_sender_stripes(self._h, s)
            fills = self._lib.ing_sender_fills(self._h, s)
            last = self._lib.ing_sender_last_fill_ns(self._h, s)
            out.append({
                "sender": s,
                "bytes": self._lib.ing_sender_bytes(self._h, s),
                "stripes": stripes,
                "batches": fills // max(stripes, 1),
                "reconnects": self._lib.ing_sender_reconnects(self._h, s),
                "ns_since_last_fill": (now - last) if last else None,
            })
        return out

    def close(self):
        if self._h:
            self._lib.ing_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ScatterEgress:
    """One producer fanning result blocks out to N independent downstream
    consumers — the scatter_krnl analog (scatter.cpp:116-235: FSM client
    round-robining fixed packets over up to 11 destination IPs). Each
    consumer owns a bounded queue + sender thread; send() round-robins with
    skip-on-full, so one slow consumer only sheds its own share and never
    stalls the rest (the reference blocks the whole stream on any session's
    backpressure)."""

    def __init__(self, queue_blocks: int = 4):
        self._lib = _load()
        self._h = self._lib.scat_create(queue_blocks)
        self.n_consumers = 0

    def connect(self, ip: str, port: int) -> int:
        cid = self._lib.scat_connect(self._h, ip.encode(), port)
        if cid < 0:
            raise OSError(-cid, f"scatter connect failed: {os.strerror(-cid)}")
        self.n_consumers += 1
        return cid

    def send(self, arr: np.ndarray) -> int:
        """Round-robin one block to the next available consumer; returns the
        consumer id it went to. Blocks only when every live consumer is
        saturated; raises when none remain."""
        arr = np.ascontiguousarray(arr)
        cid = self._lib.scat_send(
            self._h, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
        if cid < 0:
            raise OSError(-cid, f"scatter send failed: {os.strerror(-cid)}")
        return cid

    def send_to(self, consumer: int, arr: np.ndarray) -> int:
        """Targeted enqueue; returns 0, or -EAGAIN (full) / -ENOTCONN (dead)
        without raising — callers shard by key and handle shedding."""
        arr = np.ascontiguousarray(arr)
        return self._lib.scat_send_to(
            self._h, consumer, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)

    def reattach(self, consumer: int) -> None:
        """Revive a dead consumer by redialing its stored destination and
        restarting its sender thread (for outages longer than the in-band
        ~5 s redial window — the reference's session re-arm,
        scatter.cpp:270-276). Raises if the dial fails (the consumer stays
        dead; retry later)."""
        rc = self._lib.scat_reattach(self._h, consumer)
        if rc != 0:
            raise OSError(-rc, f"scatter reattach failed: {os.strerror(-rc)}")

    def stats(self) -> dict:
        return {
            "per_consumer_blocks": [self._lib.scat_sent_blocks(self._h, c)
                                    for c in range(self.n_consumers)],
            "per_consumer_bytes": [self._lib.scat_sent_bytes(self._h, c)
                                   for c in range(self.n_consumers)],
            "dead": [bool(self._lib.scat_is_dead(self._h, c))
                     for c in range(self.n_consumers)],
            "reconnects": [self._lib.scat_reconnects(self._h, c)
                           for c in range(self.n_consumers)],
            "skipped": self._lib.scat_skipped(self._h),
        }

    def close(self):
        if self._h:
            self._lib.scat_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Loadgen:
    """Threaded senders, one per sender — the reference sender emulators.

    With n_conns > 1 each sender stripes its payload over n_conns parallel
    connections (fixed pkg_bytes packets, round-robin — the reference
    sendData/useConn protocol); ramp=True position-codes the payload
    (float i = i) so reassembly offsets are verifiable end to end."""

    def __init__(self, ip: str, port_base: int, bytes_per_sender: Sequence[int],
                 n_batches: int, fill: float = 1.0, n_conns: int = 1,
                 pkg_bytes: int = 0, ramp: bool = False):
        self._lib = _load()
        self.results: List[Optional[int]] = [None] * len(bytes_per_sender)
        self.threads = []
        self.n_conns = max(1, n_conns)
        for s, nbytes in enumerate(bytes_per_sender):
            port0 = port_base + s * self.n_conns
            t = threading.Thread(
                target=self._run,
                args=(s, ip, port0, nbytes, n_batches, fill, pkg_bytes, ramp),
                daemon=True,
            )
            self.threads.append(t)

    def _run(self, s, ip, port0, nbytes, n_batches, fill, pkg_bytes, ramp):
        if self.n_conns == 1 and not ramp:
            self.results[s] = self._lib.loadgen_run(
                ip.encode(), port0, nbytes, n_batches, fill
            )
        else:
            self.results[s] = self._lib.loadgen_run_striped(
                ip.encode(), port0, self.n_conns, pkg_bytes, nbytes,
                n_batches, fill, 1 if ramp else 0
            )

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def join(self, timeout: Optional[float] = None):
        for t in self.threads:
            t.join(timeout)
        return self.results
