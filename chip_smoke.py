#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``fleetrec_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and runs,
on cuda:0, with TF32 off:

1. gather: the ``gather_rows`` kernel against its plain PyTorch version,
   bit-equal (float32 / bfloat16 / int8, L in 4..128, N in 512 / 700, ids
   including -1 and R);
2. fused MLP: the ``fused_mlp`` kernel against its plain version at the
   model1 widths (float32 rtol/atol 1e-5; bfloat16 rtol 2e-2 with atol
   2e-2 * max|plain|), the all-ones closed form 68719476736 exactly, and
   ReLU on all-positive data equal to no ReLU;
3. fleetrec_model1 at full rows (47 tables, 1.41 GB of float32 tables on
   the device): pm1 tables + all-ones MLP bit-equal to the numpy oracle at
   B = 4096, uniform tables + weights within rtol 1e-3 / atol 2e-3, bad
   take ids NaN-poisoned, 7 gather launches and 1 fused-MLP launch per
   forward; the ``gather_rows`` kernel bit-equal to its plain version on
   each of the 7 tiers' real inputs (packed-buffer views and flat ids at
   B = 4096, with a few -1 and out-of-range ids added);
4. serve: ``serving.compose.serve`` for model1 (B = 1024, replies on) in a
   thread, 4 index batches sent over loopback, the replied scores equal to
   the oracle; the kernels' launch counters are zeroed just before and
   read just after, and each must be nonzero;
5. report: the card's name and power limit, each kernel's median time
   against its plain version at the model1 shapes (CUDA events over
   CUDA-graph replays, so host dispatch is out of the kernel-against-plain
   comparison; eager back-to-back calls and the profiler's device time
   beside them), and the model1 forward's ms/batch, eager and replayed
   from a CUDA graph.

Every phase raises on failure.  The second-to-last line is the kernels'
JSON record, the last line ``{"ok": true, "device": {...}}``.  Exits
nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import functools
import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.embedding import tier_gathers
from fleetrec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp, fused_mlp_plain
from fleetrec_tpu_torch.serving import ServeSpec, serve

B_TIME = 4096
B_SERVE = 1024
N_SERVE = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def _rand_ids(cfg, B, rng):
    return np.stack([rng.integers(0, t.rows, B) for t in cfg.tables],
                    1).astype(np.int32)


def phase_gather(dev) -> float:
    """gather_rows kernel == plain version, bit for bit."""
    rng = np.random.default_rng(0)
    R = 1000
    worst = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for L in (4, 8, 16, 32, 128):
            vals = rng.standard_normal((R, L)).astype(np.float32) * 40
            if dtype == torch.int8:
                vals = np.clip(np.rint(vals), -127, 127)
            table = torch.from_numpy(vals).to(dev, dtype)
            for N in (512, 700):
                ids = rng.integers(0, R, N)
                ids[:4] = (-1, R, R + 7, -R)
                for idt in (torch.int32, torch.int64):
                    idx = torch.from_numpy(ids).to(dev, idt)
                    got = gather_rows(table, idx)
                    want = gather_rows_plain(table, idx)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"gather mismatch {dtype} L={L} N={N} {idt}")
                    if got[:4].abs().sum().item() != 0:
                        raise AssertionError("out-of-range ids must give zero rows")
                    worst = max(worst, (got.float() - want.float()).abs().max().item())
                    n_cases += 1
    log(f"phase 1 gather: {n_cases} cases bit-equal to the plain version "
        f"(max_abs_err {worst})")
    return worst


def phase_mlp(dev) -> float:
    """fused_mlp kernel == plain version within the stated tolerances."""
    cfg = C.fleetrec_model1()
    ws32 = [torch.from_numpy(w).to(dev) for w in ref.init_mlp_weights(cfg, "uniform", seed=3)]
    rng = np.random.default_rng(1)
    worst = 0.0
    for B in (700, 4096):
        x = torch.from_numpy(rng.uniform(-1, 1, (B, 352)).astype(np.float32)).to(dev)
        got = fused_mlp(ws32, x)
        want = fused_mlp_plain(ws32, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, (got - want).abs().max().item())
        xb = x.to(torch.bfloat16)
        wsb = [w.to(torch.bfloat16) for w in ws32]
        got_b = fused_mlp(wsb, xb)
        want_b = fused_mlp_plain(wsb, xb)
        torch.cuda.synchronize()
        torch.testing.assert_close(got_b, want_b, rtol=2e-2,
                                   atol=2e-2 * want_b.abs().max().item())
    # closed form: all-ones 512-wide input through all-ones 1024-512-256-1
    ones = [torch.ones(a, b, device=dev) for a, b in ((512, 1024), (1024, 512), (512, 256), (256, 1))]
    for dtype in (torch.float32, torch.bfloat16):
        x1 = torch.ones(700, 512, device=dev, dtype=dtype)
        got = fused_mlp([w.to(dtype) for w in ones], x1)
        torch.cuda.synchronize()
        if not bool((got == 68719476736.0).all()):
            raise AssertionError(f"closed form broken in {dtype}: {got[:3, 0].tolist()}")
    # ReLU on all-positive data changes nothing
    xp = torch.from_numpy(rng.uniform(0, 1, (700, 352)).astype(np.float32)).to(dev)
    wp = [w.abs() for w in ws32]
    if not torch.equal(fused_mlp(wp, xp, "relu"), fused_mlp(wp, xp)):
        raise AssertionError("relu on positive data differs from no relu")
    log(f"phase 2 fused MLP: fp32 max_abs_err {worst} (rtol/atol 1e-5), bf16 "
        f"within rtol 2e-2, closed form 68719476736 exact, relu == none on "
        f"positive data")
    return worst


def check_tier_gathers(model, idx_t) -> float:
    """gather_rows kernel == plain version, bit for bit, on each tier's
    real inputs: the packed-buffer view and the flat ids the forward
    passes, then the same ids with -1 and out-of-range ids at a few
    places."""
    worst = 0.0
    for t in tier_gathers(model.packed, model.plan_indices(idx_t)):
        R = t.table.shape[0]
        bad = t.ids.clone()
        bad[:4] = torch.tensor([-1, R, R + 5, -7], device=bad.device)
        for ids in (t.ids, bad):
            got = gather_rows(t.table, ids)
            want = gather_rows_plain(t.table, ids)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather mismatch on tier {t.name}")
            worst = max(worst, (got.float() - want.float()).abs().max().item())
        if got[:4].abs().sum().item() != 0:
            raise AssertionError(f"tier {t.name}: out-of-range ids must give zero rows")
    return worst


def phase_model1(dev):
    """Full-size model1 against the float64 oracle; returns the pm1 model,
    its tables and weights, and the worst gather error on the tiers."""
    cfg = C.fleetrec_model1(batch_size=B_TIME)
    rng = np.random.default_rng(2)
    idx = _rand_ids(cfg, B_TIME, rng)
    idx_t = torch.from_numpy(idx).to(dev)

    t0 = time.time()
    tabs_u = ref.init_tables(cfg, "uniform")
    ws_u = ref.init_mlp_weights(cfg, "uniform")
    model_u = init_model(cfg, tables_np=tabs_u, mlp_np=ws_u, device=dev)
    with torch.inference_mode():
        s_u = model_u(idx_t).cpu().numpy()
    golden_u = ref.forward(cfg, tabs_u, ws_u, idx)
    np.testing.assert_allclose(s_u, golden_u, rtol=1e-3, atol=2e-3)
    err_u = float(np.abs(s_u - golden_u).max())
    with torch.inference_mode():
        err_g = check_tier_gathers(model_u, idx_t)
    del model_u, tabs_u
    torch.cuda.empty_cache()

    tabs = ref.init_tables(cfg, "pm1")
    ws = ref.init_mlp_weights(cfg, "ones")
    model = init_model(cfg, tables_np=tabs, mlp_np=ws, device=dev)
    packed = model.packed
    table_bytes = sum(b.numel() * b.element_size()
                      for b in packed.onehot_buffers + [packed.take_buffer])
    gather_rows.launches = fused_mlp.launches = 0
    with torch.inference_mode():
        s = model(idx_t).cpu().numpy()
    per_fwd = (gather_rows.launches, fused_mlp.launches)
    if per_fwd != (7, 1):
        raise AssertionError(f"launches per forward {per_fwd}, want (7, 1)")
    golden = ref.forward(cfg, tabs, ws, idx)
    if not np.array_equal(s, golden.astype(np.float32)):
        raise AssertionError("model1 pm1/ones scores are not bit-equal to the oracle")
    # fail-loud contract: an out-of-range take id poisons only its row
    bad = idx.copy()
    take_cols = [j for j, t in enumerate(cfg.tables) if t.rows > cfg.onehot_factor_max]
    bad[5, take_cols[-1]] = cfg.tables[take_cols[-1]].rows
    bad[9, take_cols[0]] = -1
    with torch.inference_mode():
        sb = model(torch.from_numpy(bad).to(dev)).cpu().numpy()
    nan_rows = np.flatnonzero(np.isnan(sb)).tolist()
    if nan_rows != [5, 9] or not np.array_equal(np.delete(sb, [5, 9]), np.delete(s, [5, 9])):
        raise AssertionError(f"bad-id poison rows {nan_rows}, want [5, 9]")
    log(f"phase 3 model1 full rows: {cfg.num_tables} tables, "
        f"{table_bytes / 1e9:.3f} GB of packed buffers on {dev}; pm1/ones "
        f"B={B_TIME} bit-equal to the oracle; uniform within rtol 1e-3 / "
        f"atol 2e-3 (max abs err {err_u:.3g}); launches per forward: "
        f"gather_rows {per_fwd[0]}, fused_mlp {per_fwd[1]}; bad ids -> NaN "
        f"rows {nan_rows}; gather_rows kernel bit-equal to its plain version "
        f"on the 7 tiers' inputs (uniform tables, with -1 / out-of-range ids; "
        f"max_abs_err {err_g}) ({time.time() - t0:.1f}s)")
    return cfg, model, tabs, ws, err_g


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(model, tabs, ws):
    """serve() over loopback; returns the launch counts of this run."""
    cfg = C.fleetrec_model1(batch_size=B_SERVE)
    port = _free_port()
    rng = np.random.default_rng(3)
    batches = [_rand_ids(cfg, B_SERVE, rng) for _ in range(N_SERVE)]
    spec = ServeSpec(batch=B_SERVE, batches=N_SERVE, port=port, slots=4,
                     reply=True)
    out = {}

    def run():
        out["summary"] = serve(cfg, model, spec)

    gather_rows.launches = fused_mlp.launches = 0
    th = threading.Thread(target=run, daemon=True)
    th.start()
    sock = None
    for _ in range(200):
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            break
        except OSError:
            time.sleep(0.05)
    if sock is None:
        raise AssertionError("serve() never bound its port")
    want = N_SERVE * B_SERVE * 4
    buf = b""
    with sock:
        for idx in batches:
            sock.sendall(idx.tobytes())
        while len(buf) < want:
            chunk = sock.recv(want - len(buf))
            if not chunk:
                break
            buf += chunk
    th.join(120)
    if th.is_alive() or "summary" not in out:
        raise AssertionError("serve() did not finish")
    launches = {"gather_rows": gather_rows.launches, "fused_mlp": fused_mlp.launches}
    if len(buf) != want:
        raise AssertionError(f"got {len(buf)} reply bytes, want {want}")
    scores = np.frombuffer(buf, np.float32).reshape(N_SERVE, B_SERVE)
    for k, idx in enumerate(batches):
        golden = ref.forward(cfg, tabs, ws, idx).astype(np.float32)
        if not np.array_equal(scores[k], golden):
            raise AssertionError(f"served batch {k} differs from the oracle")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if launches != {"gather_rows": 7 * N_SERVE, "fused_mlp": N_SERVE}:
        raise AssertionError(f"unexpected launch counts {launches}")
    s = out["summary"]
    log(f"phase 4 serve: {s['wire_batches']} batches x {B_SERVE} served over "
        f"loopback, replies bit-equal to the oracle; launches in the run: "
        f"{launches}; latency_ms_p50 {s.get('latency_ms_p50')} (host clock, "
        f"first batch excluded)")
    return launches


def _ms(fn, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, from CUDA events
    (includes any gap the host leaves between launches)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _pair(kernel, plain, reps: int = 5):
    """Median ms of kernel and plain, measured in turns (plain, kernel,
    kernel, plain, ...) after a warm-up of each."""
    for _ in range(3):
        kernel()
        plain()
    torch.cuda.synchronize()
    ks, ps = [], []
    for r in range(reps):
        order = ((plain, ps), (kernel, ks)) if r % 2 == 0 else ((kernel, ks), (plain, ps))
        for f, acc in order:
            acc.append(_ms(f))
    return float(np.median(ks)), float(np.median(ps))


def _graph(fn, iters: int = 20) -> torch.cuda.CUDAGraph:
    """``iters`` back-to-back calls of ``fn`` captured into one CUDA graph
    (after a warm-up on a side stream, as capture needs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def _pair_graph(kernel, plain, iters: int = 20, reps: int = 5):
    """Median ms per call of kernel and plain from CUDA events around
    replays of a graph of ``iters`` calls each, in turns (plain, kernel,
    kernel, plain, ...): device time of back-to-back launches with no
    host dispatch between them."""
    gk, gp = _graph(kernel, iters), _graph(plain, iters)
    ks, ps = [], []
    for r in range(reps):
        order = ((gp, ps), (gk, ks)) if r % 2 == 0 else ((gk, ks), (gp, ps))
        for g, acc in order:
            acc.append(_ms(g.replay, 1) / iters)
    return float(np.median(ks)), float(np.median(ps))


def _profile(fn, iters: int = 20):
    """torch.profiler over ``iters`` calls: (device ms per call summed over
    the device-side kernel events, host wall ms per call, [(kernel, device
    ms per call)]).  Device ms is None when the profiler reports no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = [(e.key, e.self_device_time_total / 1e3 / iters)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return (busy if rows else None), wall, rows


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_report(cfg, model, dev):
    """Kernel-against-plain and forward times.  CUDA-event timings come
    first: once torch.profiler has attached to the device it adds host cost
    to every later launch, so the profiled pass runs last."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(_rand_ids(cfg, B_TIME, rng)).to(dev)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (B_TIME, cfg.feature_dim)).astype(np.float32)).to(dev)
    ws = model.mlp_weights
    xb, wsb = x.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws]
    flops = cfg.mlp.flops_per_query * B_TIME
    with torch.inference_mode():
        cases = []  # (label, kernel, plain, note)
        for t in tier_gathers(model.packed, model.plan_indices(idx)):
            nbytes = 2 * t.ids.numel() * t.dim * t.table.element_size()
            cases.append((f"gather_rows {t.name}",
                          functools.partial(gather_rows, t.table, t.ids),
                          functools.partial(gather_rows_plain, t.table, t.ids),
                          f"{t.ids.numel()} rows of {t.dim} x {t.table.dtype}, "
                          f"{nbytes} B read+written"))
        for tag, w_, x_ in (("fp32", ws, x), ("bf16", wsb, xb)):
            cases.append((f"fused_mlp {tag}", functools.partial(fused_mlp, w_, x_),
                          functools.partial(fused_mlp_plain, w_, x_),
                          f"widths {cfg.mlp.widths}, {flops} FLOP"))
        fwds = {B: functools.partial(model, idx[:B].contiguous()) for B in (1024, B_TIME)}

        events = {label: _pair(k, p) for label, k, p, _ in cases}
        graphed = {label: _pair_graph(k, p) for label, k, p, _ in cases}
        fwd_ms, fwd_graph_ms = {}, {}
        for B, fwd in fwds.items():
            for _ in range(5):
                fwd()
            torch.cuda.synchronize()
            fwd_ms[B] = float(np.median([_ms(fwd) for _ in range(5)]))
            g = _graph(fwd, 10)
            fwd_graph_ms[B] = float(np.median([_ms(g.replay, 1) / 10 for _ in range(5)]))

        for label, k, p, note in cases:
            kd, pd = _profile(k)[0], _profile(p)[0]
            ke, pe = events[label]
            kg, pg = graphed[label]
            rate = ""
            if label.startswith("fused_mlp"):
                rate = f" = {flops / kg / 1e9:.2f} TFLOP/s"
            log(f"time {label} B={B_TIME}: kernel {kg:.4f} ms{rate}, plain "
                f"{pg:.4f} ms (CUDA events over graph replays); eager "
                f"back-to-back calls incl. host dispatch: kernel {ke:.4f} ms, "
                f"plain {pe:.4f} ms; device time kernel {_fmt(kd)}, plain "
                f"{_fmt(pd)} (profiler); {note}")
        g_ms = sum(v[0] for k, v in graphed.items() if k.startswith("gather_rows"))
        g_plain = sum(v[1] for k, v in graphed.items() if k.startswith("gather_rows"))
        log(f"time gather_rows all tiers B={B_TIME}: kernel {g_ms:.4f} ms, plain "
            f"{g_plain:.4f} ms (CUDA events over graph replays, summed)")
        for B, fwd in fwds.items():
            busy, wall, rows = _profile(fwd)
            idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
            log(f"time model1 forward B={B}: {fwd_ms[B]:.4f} ms/batch (CUDA "
                f"events, back-to-back), {B / fwd_ms[B] * 1e3:.0f} inf/s; "
                f"replayed from a CUDA graph {fwd_graph_ms[B]:.4f} ms/batch, "
                f"{B / fwd_graph_ms[B] * 1e3:.0f} inf/s; "
                f"profiled: host wall {wall:.4f} ms/batch, device busy "
                f"{_fmt(busy)}/batch, device idle share {idle}, "
                f"{len(rows)} kernels")
            for name, ms in rows[:6]:
                log(f"  device time per forward B={B}: {ms:.4f} ms  {name[:80]}")
    return {"gather_rows": (g_ms, g_plain), "fused_mlp": graphed["fused_mlp fp32"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    err_g = phase_gather(dev)
    err_m = phase_mlp(dev)
    cfg, model, tabs, ws, err_tiers = phase_model1(dev)
    err_g = max(err_g, err_tiers)
    launches = phase_serve(model, tabs, ws)
    times = phase_report(cfg, model, dev)
    record = {"kernels": [
        {"name": "gather_rows", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/gather_rows.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:182",
         "launches": launches["gather_rows"], "max_abs_err": err_g,
         "ms": times["gather_rows"][0], "plain_ms": times["gather_rows"][1]},
        {"name": "fused_mlp", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/fused_mlp.cu",
         "replaces": "fleetrec_tpu/ops/mlp_fused.py:84",
         "launches": launches["fused_mlp"], "max_abs_err": err_m,
         "ms": times["fused_mlp"][0], "plain_ms": times["fused_mlp"][1]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
