"""The load generator, run as a child process of a benchmark run (so it
shares no interpreter lock with the server) and importing nothing of torch
or the program:

    python3 portbench/client.py      (driven over its standard input)

Protocol: one JSON line of the run's spec on standard input; the child
builds its pool of payloads from the seed and prints ``ready``; one JSON
line ``{"port_base": p}``; the child connects sender s to port p + s, runs
the traffic and writes one JSON header line, then the arrays ``recv_ns``
and ``replies`` (``numpy.save`` format, in that order) to standard output,
and exits.

One thread a sender and one reading the replies of sender 0 (one float32
score a query, a batch at a time, in order).  The traffic is ``stream``:
every sender sends its next batch as soon as its socket takes it.  The
window opens when the reply of the last warm-up batch arrives and lasts
``seconds``; then, after ``tail_s`` more (a profiled run's, in which the
profiler may need a second stretch), or as soon as the parent writes
``stop`` on standard input past the window's close, the senders finish the
batches any of them started and stop.
"""

from __future__ import annotations

import json
import os
import select
import socket
import sys
import threading
import time
from typing import Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import inputs  # noqa: E402

REPLY_WAIT_S = 60.0  # how long a reply may be late past the window's close


class Run:
    def __init__(self, spec: dict, stop_fd: Optional[int] = None):
        self.spec = spec
        self.stop_fd = stop_fd
        t = spec["traffic"]
        self.B = spec["batch"]
        self.warm = t["warmup_batches"]
        self.seconds = spec["seconds"]
        P = t["pool_batches"]
        ids = inputs.id_pool(spec["seed"], spec["rows"], self.B, P, spec.get("hot"))
        dense = inputs.dense_pool(spec["seed"], spec["dense_dim"], self.B, P)
        self.pay = [inputs.payloads(ids[p], dense[p], spec["wire"]) for p in range(P)]
        self.S = len(spec["wire"])
        self.lock = threading.Lock()
        self.limit = 1 << 62
        self.stopped = False
        self.next_j = [0] * self.S
        self.n_sent = [0] * self.S
        self.recv_ns, self.replies = [], []
        self.warm_done = threading.Event()
        self.errors = []

    # -- senders ----------------------------------------------------------
    def send_loop(self, s: int, sock: socket.socket):
        P, j = len(self.pay), 0
        try:
            while True:
                with self.lock:
                    if j >= self.limit:
                        return
                    self.next_j[s] = j + 1
                sock.sendall(self.pay[j % P][s])
                j += 1
                self.n_sent[s] = j
        except OSError as e:
            self.errors.append(f"sender {s}: {e!r}")

    # -- replies ------------------------------------------------------------
    def read_loop(self, sock: socket.socket):
        n = self.B * 4
        buf = bytearray(n)
        mv = memoryview(buf)
        deadline = None
        try:
            while True:
                j = len(self.recv_ns)
                if self.stopped and j >= self.limit:
                    return
                if self.stopped and deadline is None:
                    deadline = time.monotonic() + self.seconds + REPLY_WAIT_S
                got = 0
                while got < n:
                    # the socket stays blocking (sender 0 sends on it): wait
                    # for bytes with a timeout, so that the stop is seen
                    if not select.select([sock], [], [], 0.2)[0]:
                        if deadline is not None and time.monotonic() > deadline:
                            self.errors.append(f"replies stopped at {j}")
                            return
                        if got == 0 and self.stopped and len(self.recv_ns) >= self.limit:
                            return
                        continue
                    r = sock.recv_into(mv[got:], n - got)
                    if r == 0:
                        self.errors.append(f"reply connection closed at {j}")
                        return
                    got += r
                self.recv_ns.append(time.monotonic_ns())
                self.replies.append(bytes(buf))
                if j + 1 == self.warm:
                    self.warm_done.set()
        except OSError as e:
            self.errors.append(f"reader: {e!r}")
        finally:
            self.warm_done.set()

    def run(self, port_base: int):
        socks = []
        for s in range(self.S):
            sk = socket.create_connection(("127.0.0.1", port_base + s), timeout=30)
            sk.settimeout(None)
            sk.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            socks.append(sk)
        threads = [threading.Thread(target=self.send_loop, args=(s, socks[s]), daemon=True)
                   for s in range(self.S)]
        reader = threading.Thread(target=self.read_loop, args=(socks[0],), daemon=True)
        reader.start()
        for t in threads:
            t.start()
        self.warm_done.wait()
        if len(self.recv_ns) < self.warm:
            self.errors.append(f"warm-up: {len(self.recv_ns)} of {self.warm} replies")
            with self.lock:
                self.limit, self.stopped = 0, True
        else:
            self.t_open = self.recv_ns[self.warm - 1]
            self.t_close = self.t_open + int(self.seconds * 1e9)
            self.wait_until(self.t_close + int(self.spec.get("tail_s", 0.0) * 1e9))
            with self.lock:
                self.limit, self.stopped = max(self.next_j), True
        for t in threads:
            t.join()
        reader.join()
        for sk in socks:
            sk.close()

    def wait_until(self, t_end: int):
        """Sleep until ``t_end`` (monotonic ns), or until ``stop`` comes
        on ``stop_fd`` (or it closes), but not past the window's close."""
        while (left := t_end - time.monotonic_ns()) > 0:
            if self.stop_fd is None:
                time.sleep(left / 1e9)
                continue
            if select.select([self.stop_fd], [], [], left / 1e9)[0]:
                os.read(self.stop_fd, 64)  # "stop", or b"" once the parent is gone
                self.stop_fd, t_end = None, self.t_close

    def result(self) -> tuple:
        head = {"warm": self.warm, "n_sent": min(self.n_sent), "n_recv": len(self.recv_ns),
                "t_open_ns": getattr(self, "t_open", 0), "t_close_ns": getattr(self, "t_close", 0),
                "errors": self.errors}
        replies = (np.frombuffer(b"".join(self.replies), np.float32).reshape(-1, self.B)
                   if self.replies else np.zeros((0, self.B), np.float32))
        return head, [np.asarray(self.recv_ns, np.int64), replies]


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    run = Run(spec, stop_fd=sys.stdin.fileno())
    print("ready", flush=True)
    go = json.loads(sys.stdin.readline())
    try:
        run.run(go["port_base"])
    except OSError as e:
        run.errors.append(f"connect: {e!r}")
    head, arrays = run.result()
    out = sys.stdout.buffer
    out.write((json.dumps(head) + "\n").encode())
    for a in arrays:
        np.save(out, a)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
