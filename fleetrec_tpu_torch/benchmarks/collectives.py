"""Collective bandwidth, the port of ``fleetrec_tpu/benchmarks/collectives.py``
(the analog of the reference's iperf_krnl network throughput kernel): the
"network" is the link between the mesh's devices (NVLink between the cards
of one host over NCCL; host memory over gloo) and the traffic is the
collectives the sharded engine uses, over the model group of this rank's
data row (``Mesh.group``):

* ``all_gather``: ``all_gather_into_tensor`` of every rank's payload;
* ``psum``: ``all_reduce(SUM)``, the sharded forward's exchange;
* ``ppermute``: a ring, each rank sending its payload to model rank
  ``(m + 1) % M`` and receiving from ``(m - 1) % M``
  (``batch_isend_irecv``, which NCCL runs as one group).

Every rank of the row calls ``ici_bench``; each returns the same keys as
the JAX function, with its own times.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh


def _timed(fn: Callable[[], None], iters: int, device: torch.device) -> float:
    """Seconds a call of ``fn``: one warm call, then ``iters`` calls
    between two CUDA events on the card (the host's clock around them, after
    a synchronizing barrier, on the CPU)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def ici_bench(mesh: Mesh, mbytes: int = 64, iters: int = 16) -> Dict:
    """Measure all_gather / psum / ppermute over the mesh's model group.

    Payload: ``mbytes`` MiB of float32 a rank.  Returns each collective's
    ms a call and algorithm bandwidth in GB/s (the payload a rank moves over
    the time: all_gather (M - 1) payloads, psum 2 (M - 1) / M of one, the
    ring one), as the JAX function computes it."""
    m = mesh.model
    cols = (mbytes * 2**20) // 4 // 128 or 1
    x = torch.ones((8, cols, 16), dtype=torch.float32, device=mesh.device)
    per_dev_bytes = x.numel() * x.element_size()
    results = {"model_axis": m, "per_device_mbytes": per_dev_bytes / 2**20}
    if m == 1:
        results["note"] = "single device: collectives are no-ops"
        return results

    group = mesh.group
    gathered = torch.empty((m * 8, cols, 16), dtype=x.dtype, device=x.device)
    acc = x.clone()
    recv = torch.empty_like(x)
    nxt = mesh.leader + (mesh.m + 1) % m
    prv = mesh.leader + (mesh.m - 1) % m

    def ag():
        dist.all_gather_into_tensor(gathered, x, group=group)

    def ps():
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)

    def pp():
        ops = [dist.P2POp(dist.isend, x, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    for name, fn, moved in [
        ("all_gather", ag, per_dev_bytes * (m - 1)),
        ("psum", ps, 2 * per_dev_bytes * (m - 1) / m),
        ("ppermute", pp, per_dev_bytes),
    ]:
        dist.barrier(group=group)
        dt = _timed(fn, iters, mesh.device)
        results[name] = {
            "ms": round(dt * 1e3, 3),
            "GB_s": round(moved / dt / 1e9, 2),
        }
    return results
