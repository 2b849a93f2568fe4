"""Latency-bounded serving benchmark, the port of
``fleetrec_tpu/serving/servebench.py``: Poisson query arrivals -> batcher
-> scoring on the device, per-query latency percentiles.

Arrivals are synthetic (the ingest tier is measured apart by
``cli netbench``); the measured path is batch formation, scoring on the
device and the readback of the scores.  ``ServeBenchResult`` and
``_run_simulated`` are the JAX package's, unchanged (numpy only).

One departure from the JAX loop: it reads a dispatch's scores back only
once more than ``max_in_flight`` later dispatches are out, so at low load a
query's latency holds up to ``max_in_flight`` more batch-formation windows
than its own.  Here each dispatch records a CUDA event and is read back as
soon as the loop sees the event complete; ``max_in_flight`` stays only as
backpressure.  ``_run_simulated`` keeps the JAX loop's deferred readback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class ServeBenchResult:
    offered_qps: float
    achieved_qps: float
    n_queries: int
    latency_ms_p50: float
    latency_ms_p99: float
    latency_ms_max: float
    mean_batch_fill: float
    # decomposition: end-to-end latency = batch-formation wait (host
    # side) + dispatch -> scores-on-host service time (device compute,
    # host dispatch and the readback).
    wait_ms_p50: float = 0.0   # per query: arrival -> its batch dispatched
    wait_ms_p99: float = 0.0
    service_ms_p50: float = 0.0  # per dispatch: dispatch -> scores on host
    service_ms_p99: float = 0.0
    n_dispatches: int = 0

    def to_json(self):
        return dataclasses.asdict(self)


def run_servebench(
    model,
    batch_size: int,
    offered_qps: float,
    duration_s: float = 5.0,
    max_wait_ms: float = 2.0,
    seed: int = 0,
    max_in_flight: int = 2,
    device_pool: bool = False,
    fuse: int = 1,
    simulate_service_ms: Optional[float] = None,
) -> ServeBenchResult:
    """Poisson arrivals at ``offered_qps``; batches of up to ``batch_size``
    queries, dispatched early ``max_wait_ms`` after their first query
    arrived; scored by ``model`` (a FleetRecModel) on its device.

    Latency per query = arrival -> its batch's scores on the host.
    Arrivals follow a virtual clock that tracks real time, so when the
    engine falls behind the backlog grows and latencies show it.  The loop
    reads back, in dispatch order, every dispatch whose CUDA event has
    completed each time it looks (between sleeps and after a dispatch; on
    the CPU a forward is done when it returns).  At most ``max_in_flight``
    dispatches are outstanding; the loop blocks on the oldest readback
    beyond that.

    device_pool=True keeps the query pool on the device and slices batches
    there, taking the per-batch host-to-device copy out of the measured
    path.  fuse=K (implies device_pool) scores K pool slices as one
    [K*B, T] forward per dispatch, as ``ServingEngine.from_model(fuse=K)``
    does; its latency cost is K*B/offered_qps of added queueing.

    simulate_service_ms=X runs the same arrival, batching and in-flight
    rules as an event-driven recurrence with X ms of virtual service per
    dispatch (``_run_simulated``); ``model`` is unused (may be None)."""
    rng = np.random.default_rng(seed)
    if simulate_service_ms is not None:
        return _run_simulated(
            batch_size=batch_size, offered_qps=offered_qps,
            duration_s=duration_s, max_wait_ms=max_wait_ms, rng=rng,
            max_in_flight=max_in_flight, fuse=fuse,
            service_ms=simulate_service_ms)

    cfg = model.cfg
    dev = model.device

    # a pool of query rows to sample batches from cheaply
    POOL = 1 << 14
    idx_pool = np.stack(
        [rng.integers(0, t.rows, POOL) for t in cfg.tables], 1
    ).astype(np.int32)
    dense_pool = (
        rng.uniform(-1, 1, (POOL, cfg.dense_dim)).astype(np.float32)
        if cfg.dense_dim
        else None
    )

    if fuse > 1:
        device_pool = True
    if device_pool:
        pool_i = torch.from_numpy(idx_pool).to(dev)
        pool_d = None if dense_pool is None else torch.from_numpy(dense_pool).to(dev)

    def fwd_at(starts):
        """Score the pool slices [s, s + B) for each start as one forward:
        [B] for one start, [K, B] for K."""
        i = torch.cat([pool_i[s:s + batch_size] for s in starts])
        d = (None if pool_d is None
             else torch.cat([pool_d[s:s + batch_size] for s in starts]))
        with torch.inference_mode():
            s = model(i, d)
        return s if len(starts) == 1 else s.reshape(len(starts), batch_size)

    def fwd_host(sel):
        i = torch.from_numpy(idx_pool[sel]).to(dev)
        d = None if dense_pool is None else torch.from_numpy(dense_pool[sel]).to(dev)
        with torch.inference_mode():
            return model(i, d)

    # warm-up: builds the kernels and fills the allocator's caches
    if device_pool:
        fwd_at([0] * fuse).cpu()
    else:
        fwd_host(np.arange(batch_size)).cpu()

    # Poisson arrival times
    n_max = int(offered_qps * duration_s * 1.2) + batch_size
    gaps = rng.exponential(1.0 / offered_qps, size=n_max)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]

    group = batch_size * fuse  # queries per dispatch
    lat = []
    fills = []
    waits = []      # per query: arrival -> its batch dispatched (ms)
    services = []   # per dispatch: dispatch -> scores on host (ms)
    # (scores on the device, member arrivals, dispatch time, CUDA event
    # recorded after the forward or None on the CPU)
    in_flight = []
    t0 = time.time()

    def read_back(block: bool):
        """Read back, oldest first, each dispatch whose forward has
        completed; with ``block``, the oldest one whatever its state."""
        while in_flight:
            s, arr, td, ev = in_flight[0]
            if not (block or ev is None or ev.query()):
                return
            in_flight.pop(0)
            s.cpu()  # readback waits for the device
            done = time.time() - t0
            lat.extend((done - arr) * 1e3)
            services.append((done - td) * 1e3)
            block = False

    qi = 0
    wall_cap = duration_s * 10  # overload guard: stop reporting what's done
    while qi < len(arrivals):
        if time.time() - t0 > wall_cap:
            arrivals = arrivals[:qi]
            break
        now = time.time() - t0
        # wait until at least one query has arrived
        if arrivals[qi] > now:
            read_back(False)
            time.sleep(min(arrivals[qi] - now, 0.001))
            continue
        # batch formation: take all arrived, up to group; if fewer, allow
        # up to max_wait_ms from the FIRST query's arrival
        deadline = arrivals[qi] + max_wait_ms / 1e3
        end = qi
        while True:
            now = time.time() - t0
            arrived = np.searchsorted(arrivals, now)
            end = min(arrived, qi + group)
            if end - qi >= group or now >= deadline:
                break
            read_back(False)
            time.sleep(0.0002)
        count = max(end - qi, 1)
        t_disp = time.time() - t0
        waits.extend((t_disp - arrivals[qi:qi + count]) * 1e3)
        wrap = max(POOL - batch_size, 1)
        if device_pool:
            scores = fwd_at([(qi + k * batch_size) % wrap for k in range(fuse)])
        else:
            scores = fwd_host(np.arange(qi, qi + batch_size) % POOL)  # fixed-shape batch
        ev = None
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        in_flight.append((scores, arrivals[qi:qi + count].copy(), t_disp, ev))
        fills.append(count / group)
        qi += count
        while len(in_flight) > max_in_flight:
            read_back(True)
        read_back(False)
    while in_flight:
        read_back(True)
    wall = time.time() - t0
    lat = np.asarray(lat)
    waits_a = np.asarray(waits[: len(lat)])
    services_a = np.asarray(services)
    return ServeBenchResult(
        offered_qps=offered_qps,
        achieved_qps=len(lat) / wall,
        n_queries=len(lat),
        latency_ms_p50=float(np.percentile(lat, 50)),
        latency_ms_p99=float(np.percentile(lat, 99)),
        latency_ms_max=float(lat.max()),
        mean_batch_fill=float(np.mean(fills)),
        wait_ms_p50=float(np.percentile(waits_a, 50)) if len(waits_a) else 0.0,
        wait_ms_p99=float(np.percentile(waits_a, 99)) if len(waits_a) else 0.0,
        service_ms_p50=float(np.percentile(services_a, 50)) if len(services_a) else 0.0,
        service_ms_p99=float(np.percentile(services_a, 99)) if len(services_a) else 0.0,
        n_dispatches=len(services_a),
    )


def _run_simulated(
    batch_size: int,
    offered_qps: float,
    duration_s: float,
    max_wait_ms: float,
    rng,
    max_in_flight: int,
    fuse: int,
    service_ms: float,
) -> ServeBenchResult:
    """EVENT-DRIVEN simulation of the JAX package's servebench loop with a
    virtual device: identical semantics — Poisson arrivals, batch formed when
    `group` queries arrived or max_wait_ms after the first one, one
    virtual device serializing dispatches at ``service_ms`` each, and the
    loop thread blocking on the oldest readback once more than
    ``max_in_flight`` dispatches are outstanding — but computed as a
    deterministic recurrence over the arrival timeline instead of a
    real-time loop, so the host's scheduling stalls stay out of the tail.
    See run_servebench(simulate_service_ms=...).
    """
    n_max = int(offered_qps * duration_s * 1.2) + batch_size
    gaps = rng.exponential(1.0 / offered_qps, size=n_max)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]
    n = len(arrivals)
    group = batch_size * fuse
    max_wait = max_wait_ms / 1e3
    service = service_ms * fuse / 1e3

    lat = np.empty(n)
    waits = np.empty(n)
    fills = []
    comps: list = []   # device completion time per dispatch
    t_disps: list = []
    firsts: list = []  # first query index per dispatch
    loop_free = 0.0    # when the loop thread can start forming the next batch
    qi = 0
    while qi < n:
        first = arrivals[qi]
        start = max(loop_free, first)       # loop waits for the first query
        deadline = first + max_wait         # from the first query's arrival
        # batch closes when `group` queries have arrived or at the
        # deadline, never before the loop thread is free
        full_at = arrivals[qi + group - 1] if qi + group - 1 < n else np.inf
        t_disp = max(start, min(full_at, deadline))
        count = int(np.searchsorted(arrivals, t_disp, side="right")) - qi
        count = max(1, min(count, group))
        d = len(comps)
        comp = max(t_disp, comps[-1] if comps else 0.0) + service
        comps.append(comp)
        t_disps.append(t_disp)
        firsts.append(qi)
        fills.append(count / group)
        # after dispatching, the loop pops until <= max_in_flight are
        # outstanding: it blocks on the (d - max_in_flight)-th completion
        loop_free = (max(t_disp, comps[d - max_in_flight])
                     if d >= max_in_flight else t_disp)
        qi += count
    # Latency is observed at the POP, exactly like the JAX loop: dispatch
    # d's readback is drained right after dispatch d+max_in_flight is
    # submitted (so its observed done time is max(completion, that later
    # dispatch's submit)); the final max_in_flight dispatches drain
    # sequentially after the loop (completions are monotone, so each pops
    # at its own completion).
    D = len(comps)
    services = []
    for d in range(D):
        done = (max(comps[d], t_disps[d + max_in_flight])
                if d + max_in_flight < D else max(comps[d], t_disps[-1]))
        q0 = firsts[d]
        q1 = firsts[d + 1] if d + 1 < D else n
        lat[q0:q1] = (done - arrivals[q0:q1]) * 1e3
        waits[q0:q1] = (t_disps[d] - arrivals[q0:q1]) * 1e3
        services.append((done - t_disps[d]) * 1e3)
    wall = max(comps[-1], arrivals[-1]) if comps else duration_s
    services_a = np.asarray(services)
    return ServeBenchResult(
        offered_qps=offered_qps,
        achieved_qps=n / wall,
        n_queries=n,
        latency_ms_p50=float(np.percentile(lat, 50)),
        latency_ms_p99=float(np.percentile(lat, 99)),
        latency_ms_max=float(lat.max()),
        mean_batch_fill=float(np.mean(fills)),
        wait_ms_p50=float(np.percentile(waits, 50)),
        wait_ms_p99=float(np.percentile(waits, 99)),
        service_ms_p50=float(np.percentile(services_a, 50)),
        service_ms_p99=float(np.percentile(services_a, 99)),
        n_dispatches=len(services_a),
    )
