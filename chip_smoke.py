#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``fleetrec_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (and
prints the seconds the build took) and runs, on cuda:0, with TF32 off:

1. gather: the ``gather_rows`` kernel against its plain PyTorch version,
   bit-equal (float32 / bfloat16 / int8, L in 4..128, N in 512 / 700, ids
   including -1 and R);
2. grouped gather: the ``gather_rows_grouped`` kernel against the same
   plain version, bit-equal, on that matrix (plus L = 3 and 5, which take
   its 4-, 2- and 1-byte copy paths), the clamping cases of
   tests/test_ops.py, a 4-byte aligned table, rows wider than shared
   memory, and gatherbench's own shape and flags (a [2^20, 128] float32
   table, 122880 int64 ids with -1 and out-of-range ids among them, chunk
   512 -> 440, group 8, window 8: 280 blocks of 55 groups on 8 barrier
   slots) as well as the kernel's defaults;
3. fused MLP: bf16 ``wgmma`` tiles (m64n128k16, widths 16-128 at
   B = 8192) equal to ``torch.matmul``, then the ``fused_mlp`` kernels
   (one launch a layer) against their plain version at the model1,
   model2, model3, criteo (input padded 845 -> 848) and two ragged towers
   (45-40-24-1, and 45-40-10, which ends in a product), B in 1, 77, 700,
   1000, 1024, 4000, 4096, float32 and bfloat16, ReLU off and on, every
   block tile planned on a ragged batch among them (float32 rtol/atol
   1e-5; bfloat16 rtol 2e-2 with atol 2e-2 * max|plain|); the all-ones
   closed forms 68719476736
   (512 wide) and 532575944704 (3968 wide) exactly in both dtypes; ReLU on
   all-positive data equal to no ReLU;
4. fleetrec_model1 at full rows (47 tables, 1.41 GB of float32 tables on
   the device): pm1 tables + all-ones MLP bit-equal to the numpy oracle at
   B = 4096, uniform tables + weights within rtol 1e-3 / atol 2e-3, bad
   take ids NaN-poisoned, 7 gather launches and 1 fused-MLP launch per
   forward; both gather kernels bit-equal to the plain version on each of
   the 7 tiers' real inputs (packed-buffer views and flat ids at B = 4096,
   with a few -1 and out-of-range ids added), the grouped kernel at its
   defaults and at gatherbench's flags;
5. serve: ``serving.compose.serve`` for model1 (B = 1024, replies on) in a
   thread, 4 index batches sent over loopback, the replied scores equal to
   the oracle;
6. tools, through ``cli.main`` at model1's full rows: ``gatherbench`` at
   its defaults, ``export`` -> ``io.load_npz`` (buffers and scores
   bit-equal to phase 4's model), ``bench --stage e2e|lookup|mlp --ckpt``
   at B = 4096, ``servebench`` at B = 1024 for 2 s;
7. feature mode: ``ServingEngine.mlp_only`` on parity_synthetic(3968) fed
   by three senders over loopback, every score the closed form;
8. report: the card's name and power limit, each kernel's median time
   against its plain version at the model1 shapes and at gatherbench's
   shape and flags, ``fused_mlp`` in both dtypes at model1 and model3
   widths, B = 4096 and 1024 (CUDA events over CUDA-graph replays, so host
   dispatch is out of the kernel-against-plain comparison; eager
   back-to-back calls and the profiler's device time beside them), and the
   model1 forward's ms/batch, eager and replayed from a CUDA graph, with
   the fused-MLP kernels' share of its device time.

In phases 5-7 the kernels' launch counters are zeroed just before each
path runs and read just after; each kernel of the path must have launched.
A counter counts wrapper calls that launched a kernel: eager calls, and
the calls recorded while a CUDA graph is captured.  Replays of a graph
add nothing, so ``gather_rows_grouped``'s count from ``gatherbench``
(one graph of 16 steps: 16 warm-up calls plus 16 captured) says nothing of
the replays it timed.
Every phase raises on failure.  The second-to-last line is the kernels'
JSON record, the last line ``{"ok": true, "device": {...}}``.  Exits
nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from fleetrec_tpu_torch import cli
from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import io as fio
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.embedding import tier_gathers
from fleetrec_tpu_torch.ops import _build
from fleetrec_tpu_torch.ops.gather import (gather_rows, gather_rows_grouped,
                                          gather_rows_plain)
from fleetrec_tpu_torch.models.mlp import init_mlp_params
from fleetrec_tpu_torch.ops.mlp_fused import (PRODUCT, TILES, fused_mlp,
                                             fused_mlp_plain, mlp_plan)
from fleetrec_tpu_torch.serving import (IngestServer, Loadgen, ServeSpec,
                                        ServingEngine, serve)

B_TIME = 4096
B_SERVE = 1024
N_SERVE = 4
# servebench offers this share of the e2e bench's device rate: the served
# path runs eager forwards, several times the device time (PERF.md)
SERVE_SHARE = 0.02
# gatherbench's default shape: a [2^20, 128] float32 table, 122880 rows,
# and its default flags for the grouped kernel
GB_ROWS, GB_N = 1 << 20, 4096 * 30
GB_FLAGS = {"chunk": 512, "group": 8, "window": 8}


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


# (n, chunk, group, window): tests/test_ops.py's clamping cases
GROUPED_CASES = ((512, 256, 8, 4), (700, 256, 8, 4), (256, 256, 16, 64),
                 (96, 64, 5, 2))


def _check_grouped(table, idx, what, **kw) -> float:
    """gather_rows_grouped == gather_rows_plain, bit for bit; returns the
    max abs error (0)."""
    got = gather_rows_grouped(table, idx, **kw)
    want = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"grouped gather mismatch: {what}")
    return (got.float() - want.float()).abs().max().item()


def gatherbench_inputs(dev):
    """gatherbench's default table and one step's ids (int64, as the
    command passes them)."""
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.standard_normal((GB_ROWS, 128)).astype(np.float32)).to(dev)
    return table, torch.from_numpy(rng.integers(0, GB_ROWS, GB_N)).to(dev)


def phase_grouped(dev, gb) -> float:
    """gather_rows_grouped kernel == plain version, bit for bit: the phase-1
    matrix (plus L = 3 and 5, whose rows take the 4-, 2- and 1-byte copy
    paths), the clamping cases of tests/test_ops.py, a table whose base is
    only 4-byte aligned, rows wider than shared memory, and gatherbench's
    table and ids ``gb`` (with -1 and out-of-range ids spread over the
    blocks) at gatherbench's flags and at the kernel's defaults."""
    rng = np.random.default_rng(6)
    R = 1000
    worst = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for L in (3, 4, 5, 8, 16, 32, 128):
            vals = np.clip(np.rint(rng.standard_normal((R, L)) * 40), -127, 127)
            table = torch.from_numpy(vals.astype(np.float32)).to(dev, dtype)
            for N in (512, 700):
                ids = rng.integers(0, R, N)
                ids[:4] = (-1, R, R + 7, -R)
                for idt in (torch.int32, torch.int64):
                    idx = torch.from_numpy(ids).to(dev, idt)
                    worst = max(worst, _check_grouped(table, idx, f"{dtype} L={L} N={N} {idt}"))
                    if gather_rows_grouped(table, idx)[:4].abs().sum().item() != 0:
                        raise AssertionError("out-of-range ids must give zero rows")
                    n_cases += 1
    table = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32)).to(dev)
    for n, chunk, group, window in GROUPED_CASES:
        idx = torch.from_numpy(rng.integers(0, 4096, n)).to(dev, torch.int32)
        worst = max(worst, _check_grouped(table, idx, f"case {(n, chunk, group, window)}",
                                          chunk=chunk, group=group, window=window))
        n_cases += 1
    flat = torch.from_numpy(rng.standard_normal(4097 * 32).astype(np.float32)).to(dev)
    shifted = flat[1:4097 * 32 - 31].view(4096, 32)  # base 4 bytes past the allocation's
    idx = torch.from_numpy(rng.integers(-2, 4100, 700)).to(dev)
    worst = max(worst, _check_grouped(shifted, idx, "4-byte aligned base"))
    wide = torch.from_numpy(rng.standard_normal((40, 60000)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-1, 41, 50)).to(dev)
    worst = max(worst, _check_grouped(wide, idx, "240 KB rows, column slabs"))
    table_gb, idx_gb = gb
    bad_at = torch.tensor([0, 439, 440, 4095, 61443, GB_N - 1], device=dev)
    idx_bad = idx_gb.clone()
    idx_bad[bad_at] = torch.tensor([-1, GB_ROWS, GB_ROWS + 7, -GB_ROWS, 1 << 40, -1],
                                   device=dev)
    for ids in (idx_gb, idx_bad):
        for kw in (GB_FLAGS, {}):
            worst = max(worst, _check_grouped(table_gb, ids, f"gatherbench shape {kw}", **kw))
    if gather_rows_grouped(table_gb, idx_bad, **GB_FLAGS)[bad_at].abs().sum().item() != 0:
        raise AssertionError("gatherbench shape: out-of-range ids must give zero rows")
    log(f"phase 2 grouped gather: {n_cases + 6} cases bit-equal to the plain "
        f"version, gatherbench's [{GB_ROWS}, 128] table and {GB_N} ids at "
        f"{GB_FLAGS} and at the defaults among them (max_abs_err {worst}); "
        f"out-of-range ids give zero rows")
    return worst


# the towers of the repo's configs and two ragged ones (every width padded;
# ragged_wide ends in a 10-wide product, not a row-dot)
MLP_WIDTHS = {"model1": (352, 1024, 512, 256, 1), "model2": (880, 1024, 512, 256, 1),
              "model3": (3968, 2048, 512, 256, 1),
              "criteo": (845, 1024, 1024, 512, 256, 1), "ragged": (45, 40, 24, 1),
              "ragged_wide": (45, 40, 10)}
# 1000 and 4000 reach every block tile on a ragged batch (model1 plans
# 64 x 128, then 128 x 128 and 64 x 64)
MLP_BATCHES = (1, 77, 700, 1000, 1024, 4000, 4096)


def _mlp_weights(widths, dev, seed=3):
    spec = C.MLPSpec(input_dim=widths[0], hidden=widths[1:-1], out_dim=widths[-1])
    return init_mlp_params(spec, "uniform", seed=seed, device=dev)


def _check_mlp(ws, x, activation, what) -> float:
    """fused_mlp == fused_mlp_plain within the dtype's tolerance: float32
    rtol/atol 1e-5 (fp32 sums in another order); bfloat16 rtol 2e-2 with
    atol 2e-2 * max|plain| (one bf16 ulp at a layer boundary may round the
    other way).  Returns the max abs error."""
    got = fused_mlp(ws, x, activation)
    want = fused_mlp_plain(ws, x, activation)
    torch.cuda.synchronize()
    if x.dtype == torch.float32:
        tol = {"rtol": 1e-5, "atol": 1e-5}
    else:
        tol = {"rtol": 2e-2, "atol": 2e-2 * want.abs().max().item()}
    torch.testing.assert_close(got, want, **tol, msg=lambda m: f"fused_mlp {what}: {m}")
    return (got - want).abs().max().item()


def phase_mlp(dev):
    """fused_mlp kernels == plain version: one bf16 wgmma tile shape
    (m64n128k16: widths 16-128, which B=8192 plans to 128 blocks of 64 x
    128, one k16 step each) against torch.matmul; every tower of
    MLP_WIDTHS at every B of MLP_BATCHES, float32 and bfloat16, ReLU off
    and on, which between them plan every block tile; the all-ones closed
    forms exactly in both dtypes; ReLU on positive data equal to no ReLU.
    Returns the worst float32 and bfloat16 errors."""
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    # the m64n128k16 tile: integer data is exact in any order of the 16 terms
    if [(lp.bm, lp.bn) for lp in mlp_plan((16, 128), bf, 8192).layers] != [(64, 128)]:
        raise AssertionError("widths 16-128 at B=8192 no longer plan 64 x 128 tiles")
    a = torch.from_numpy(rng.integers(-8, 9, (8192, 16)).astype(np.float32)).to(dev, bf)
    w = torch.from_numpy(rng.integers(-8, 9, (16, 128)).astype(np.float32)).to(dev, bf)
    got = fused_mlp([w], a)
    if not torch.equal(got, torch.matmul(a.float(), w.float())):
        raise AssertionError("m64n128k16 wgmma tiles differ from torch.matmul")
    worst = {torch.float32: 0.0, bf: 0.0}
    a, w = a.float().normal_(), w.float().normal_()
    worst[bf] = _check_mlp([w.to(bf)], a.to(bf), None, "m64n128k16 wgmma tiles")
    n_cases = 0
    tiles = set()
    for name, widths in MLP_WIDTHS.items():
        ws32 = _mlp_weights(widths, dev)
        x32 = torch.from_numpy(rng.uniform(-1, 1, (max(MLP_BATCHES), widths[0]))
                               .astype(np.float32)).to(dev)
        for dtype in (torch.float32, bf):
            ws = [w.to(dtype) for w in ws32]
            for B in MLP_BATCHES:
                if B % 64:  # a ragged batch: the last row tile is partly empty
                    tiles.update((lp.bm, lp.bn) for lp in mlp_plan(widths, dtype, B).layers
                                 if lp.kind == PRODUCT)
                for act in (None, "relu"):
                    err = _check_mlp(ws, x32[:B].to(dtype), act, f"{name} {dtype} B={B} {act}")
                    worst[dtype] = max(worst[dtype], err)
                    n_cases += 1
    if tiles != set(TILES):
        raise AssertionError(f"ragged batches planned tiles {sorted(tiles)}, not all of {TILES}")
    # closed forms: all-ones input through all-ones F-1024-512-256-1
    for F in (512, 3968):
        widths = (F, 1024, 512, 256, 1)
        want = ref.closed_form_all_ones_score(F)
        ones = [torch.ones(a, b, device=dev) for a, b in zip(widths[:-1], widths[1:])]
        for dtype in (torch.float32, bf):
            for B in (700, 4096):
                got = fused_mlp([w.to(dtype) for w in ones],
                                torch.ones(B, F, device=dev, dtype=dtype))
                torch.cuda.synchronize()
                if not bool((got == want).all()):
                    raise AssertionError(f"closed form {want:.0f} broken in {dtype} "
                                         f"B={B}: {got[:3, 0].tolist()}")
    # ReLU on all-positive data changes nothing
    ws32 = [w.abs() for w in _mlp_weights(MLP_WIDTHS["model1"], dev)]
    xp = torch.from_numpy(rng.uniform(0, 1, (700, 352)).astype(np.float32)).to(dev)
    if not torch.equal(fused_mlp(ws32, xp, "relu"), fused_mlp(ws32, xp)):
        raise AssertionError("relu on positive data differs from no relu")
    log(f"phase 3 fused MLP: bf16 m64n128k16 wgmma tiles (16-128, B=8192) == "
        f"torch.matmul; "
        f"{n_cases} cases ({', '.join(MLP_WIDTHS)} x B {MLP_BATCHES} x "
        f"fp32/bf16 x relu off/on, every tile on a ragged batch) within "
        f"tolerance: fp32 max_abs_err {worst[torch.float32]} (rtol/atol 1e-5), "
        f"bf16 max_abs_err {worst[bf]} (rtol 2e-2, atol 2e-2 * max|plain|); "
        f"closed forms 68719476736 and 532575944704 exact in both dtypes; "
        f"relu == none on positive data")
    return worst[torch.float32], worst[bf]


def check_tier_gathers(model, idx_t):
    """Both gather kernels == the plain version, bit for bit, on each
    tier's real inputs: the packed-buffer view and the flat ids the forward
    passes, then the same ids with -1 and out-of-range ids at a few places;
    the grouped kernel at its defaults and at gatherbench's flags.  Returns
    the worst error of gather_rows and of gather_rows_grouped."""
    kernels = {"gather_rows": gather_rows, "gather_rows_grouped": gather_rows_grouped,
               "gather_rows_grouped at gatherbench's flags":
                   functools.partial(gather_rows_grouped, **GB_FLAGS)}
    worst = dict.fromkeys(kernels, 0.0)
    for t in tier_gathers(model.packed, model.plan_indices(idx_t)):
        R = t.table.shape[0]
        bad = t.ids.clone()
        bad[:4] = torch.tensor([-1, R, R + 5, -7], device=bad.device)
        for ids in (t.ids, bad):
            want = gather_rows_plain(t.table, ids)
            for name, kernel in kernels.items():
                got = kernel(t.table, ids)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} mismatch on tier {t.name}")
                worst[name] = max(worst[name],
                                  (got.float() - want.float()).abs().max().item())
                if ids is bad and got[:4].abs().sum().item() != 0:
                    raise AssertionError(f"tier {t.name}: out-of-range ids must "
                                         f"give zero rows ({name})")
    return worst["gather_rows"], max(v for k, v in worst.items()
                                     if k.startswith("gather_rows_grouped"))


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
        err_g, err_gg = check_tier_gathers(model_u, idx_t)
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
    log(f"phase 4 model1 full rows: {cfg.num_tables} tables, "
        f"{table_bytes / 1e9:.3f} GB of packed buffers on {dev}; pm1/ones "
        f"B={B_TIME} bit-equal to the oracle; uniform within rtol 1e-3 / "
        f"atol 2e-3 (max abs err {err_u:.3g}); launches per forward: "
        f"gather_rows {per_fwd[0]}, fused_mlp {per_fwd[1]}; bad ids -> NaN "
        f"rows {nan_rows}; gather_rows and gather_rows_grouped (defaults and "
        f"{GB_FLAGS}) kernels bit-equal to the plain version on the 7 tiers' "
        f"inputs (uniform tables, with -1 / out-of-range ids; max_abs_err "
        f"{err_g} / {err_gg}) "
        f"({time.time() - t0:.1f}s)")
    return cfg, model, tabs, ws, err_g, err_gg


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
    log(f"phase 5 serve: {s['wire_batches']} batches x {B_SERVE} served over "
        f"loopback, replies bit-equal to the oracle; launches in the run: "
        f"{launches}; latency_ms_p50 {s.get('latency_ms_p50')} (host clock, "
        f"first batch excluded)")
    return launches


KERNELS = (gather_rows, gather_rows_grouped, fused_mlp)


def _counted(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    return its result and the counts read just after."""
    for k in KERNELS:
        k.launches = 0
    out = fn()
    return out, {k.__name__: k.launches for k in KERNELS}


def _cli(argv, need):
    """``cli.main(argv)`` with its output echoed; returns its last JSON line
    and the launch counts of the run.  Fails if a kernel named in ``need``
    (the kernels of that command's path) never launched."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, launches = _counted(lambda: cli.main(argv))
    text = buf.getvalue().strip()
    for line in text.splitlines():
        log(line)
    missing = [k for k in need if launches[k] < 1]
    if missing:
        raise AssertionError(f"`{' '.join(argv)}`: {missing} never launched ({launches})")
    log(f"  launches in `{' '.join(argv)}`: {launches}")
    return json.loads(text.splitlines()[-1]), launches


def _finite_pos(*xs) -> bool:
    return all(np.isfinite(x) and x > 0 for x in xs)


def phase_tools(model, dev):
    """The measurement and checkpoint entry points on the card, through
    ``cli.main`` as a user calls them, at model1's full rows: gatherbench
    at its defaults; export of the pm1 model1 -> load_npz, whose buffers
    and scores must equal the phase-3 model's (which was built from the
    same tables and weights); bench e2e / lookup / mlp at B = 4096 from
    that checkpoint (--ckpt); servebench at B = 1024 for 2 s.  Returns the
    gatherbench launch counts and the bench results."""
    t0 = time.time()
    gb, gb_launches = _cli(["gatherbench", "--device", "cuda"],
                           ("gather_rows", "gather_rows_grouped"))
    if not _finite_pos(gb["plain_ns_per_row"], gb["kernel_ns_per_row"],
                       gb["grouped_ns_per_row"]):
        raise AssertionError(f"gatherbench: bad times {gb}")
    cfg = C.fleetrec_model1(batch_size=B_TIME)
    common = ["--config", cfg.name, "--batch", str(B_TIME), "--device", "cuda"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, "model1.npz")
        ex, _ = _cli(["export", *common, "--out", path], ())
        loaded = fio.load_npz(path, cfg, dev)
        for (name, a), (_, b) in zip(model.named_buffers(), loaded.named_buffers()):
            if not torch.equal(a, b):
                raise AssertionError(f"checkpoint round trip changed buffer {name}")
        idx = torch.from_numpy(_rand_ids(cfg, B_TIME, np.random.default_rng(7))).to(dev)
        with torch.inference_mode():
            if not torch.equal(model(idx), loaded(idx)):
                raise AssertionError("scores from the checkpoint differ from the model's")
        del loaded
        benches = {}
        for stage, need in (("e2e", ("gather_rows", "fused_mlp")),
                            ("lookup", ("gather_rows",)), ("mlp", ("fused_mlp",))):
            r, _ = _cli(["bench", *common, "--ckpt", path, "--stage", stage], need)
            if not _finite_pos(r["ms_per_batch"], r["inferences_per_sec"]):
                raise AssertionError(f"bench {stage}: bad times {r}")
            benches[stage] = r
    finally:
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    qps = SERVE_SHARE * benches["e2e"]["inferences_per_sec"]
    log(f"servebench offered rate: {qps:.0f} q/s = {SERVE_SHARE} x the e2e "
        f"bench's device rate at B={B_TIME}")
    sb, _ = _cli(["servebench", "--config", cfg.name, "--batch", str(B_SERVE),
                  "--device", "cuda", "--qps", f"{qps:.0f}", "--duration", "2",
                  "--device-pool"], ("gather_rows", "fused_mlp"))
    if not (sb["n_queries"] > 0 and 0.5 * qps < sb["achieved_qps"] < 2 * qps
            and 0 < sb["latency_ms_p50"] <= sb["latency_ms_p99"] <= sb["latency_ms_max"]):
        raise AssertionError(f"servebench: {sb}")
    log(f"phase 6 tools: gatherbench, export -> load_npz (buffers and scores "
        f"bit-equal, {ex['bytes']} B), bench e2e/lookup/mlp --ckpt, "
        f"servebench ({time.time() - t0:.1f}s)")
    return gb_launches, benches


def phase_feature(dev):
    """Feature mode: ServingEngine.mlp_only on parity_synthetic(3968) fed
    by three senders over loopback (64 + 1952 + 1952 floats a query,
    model3's wire); every score must be the closed form, and fused_mlp
    must launch once a batch."""
    widths = (64, 1952, 1952)
    F, B, NB = sum(widths), B_SERVE, 4
    cfg = C.parity_synthetic(F, batch_size=B)
    eng = ServingEngine.mlp_only(init_model(cfg, device=dev), batch_size=B)
    nbytes = [B * w * 4 for w in widths]
    outs = {}
    for _ in range(20):  # three consecutive free ports
        base = _free_port()
        try:
            ing = IngestServer(nbytes, n_slots=2, port_base=base)
            break
        except OSError:
            continue
    else:
        raise AssertionError("no three free ports for the feature-mode phase")
    with ing:
        Loadgen("127.0.0.1", base, nbytes, NB, fill=1.0).start()
        summary, launches = _counted(lambda: eng.run_from_ingest(
            ing, NB, mode="feature", feature_dim=F,
            on_done=lambda bid, scores: outs.__setitem__(bid, scores)))
    want = np.full(B, ref.closed_form_all_ones_score(F), np.float32)
    if sorted(outs) != list(range(NB)) or not all(np.array_equal(v, want)
                                                  for v in outs.values()):
        raise AssertionError("feature-mode scores differ from the closed form")
    if launches != {"gather_rows": 0, "gather_rows_grouped": 0, "fused_mlp": NB}:
        raise AssertionError(f"feature mode launches {launches}, want fused_mlp {NB}")
    log(f"phase 7 feature mode: {summary['batches']} batches x {B} of "
        f"{widths} floats over loopback, scores == closed form "
        f"{ref.closed_form_all_ones_score(F):.0f}; launches {launches}")


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


# the kernels of one fused_mlp call, by the names the profiler gives them
MLP_KERNELS = ("ffma_product<", "wgmma_product<", "rowdot<")


def phase_report(cfg, model, dev, gb):
    """Kernel-against-plain and forward times; kernel (b) and kernel (a) at
    gatherbench's table and ids ``gb``, (b) with gatherbench's flags.
    CUDA-event timings come
    first: once torch.profiler has attached to the device it adds host cost
    to every later launch, so the profiled pass runs last."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(_rand_ids(cfg, B_TIME, rng)).to(dev)
    with torch.inference_mode():
        cases = []  # (label, kernel, plain, note)
        for t in tier_gathers(model.packed, model.plan_indices(idx)):
            nbytes = 2 * t.ids.numel() * t.dim * t.table.element_size()
            cases.append((f"gather_rows {t.name}",
                          functools.partial(gather_rows, t.table, t.ids),
                          functools.partial(gather_rows_plain, t.table, t.ids),
                          f"{t.ids.numel()} rows of {t.dim} x {t.table.dtype}, "
                          f"{nbytes} B read+written"))
        tier_labels = [c[0] for c in cases]
        table_gb, idx_gb = gb
        for kernel, kw in ((gather_rows, {}), (gather_rows_grouped, GB_FLAGS)):
            cases.append((f"{kernel.__name__} gatherbench shape",
                          functools.partial(kernel, table_gb, idx_gb, **kw),
                          functools.partial(gather_rows_plain, table_gb, idx_gb),
                          f"{GB_N} rows of 128 x float32 from a [{GB_ROWS}, 128] "
                          f"table, {2 * GB_N * 128 * 4} B read+written {kw}"))
        flops = {}
        for name in ("model1", "model3"):
            widths = MLP_WIDTHS[name]
            ws = model.mlp_weights if name == "model1" else _mlp_weights(widths, dev)
            x = torch.from_numpy(np.random.default_rng(5).uniform(
                -1, 1, (B_TIME, widths[0])).astype(np.float32)).to(dev)
            for B in (B_TIME, 1024):
                for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    w_ = [w.to(dtype) for w in ws]
                    x_ = x[:B].to(dtype)
                    label = f"fused_mlp {tag} {name} B={B}"
                    flops[label] = 2 * B * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
                    cases.append((label, functools.partial(fused_mlp, w_, x_),
                                  functools.partial(fused_mlp_plain, w_, x_),
                                  f"widths {widths}, {flops[label]} FLOP, "
                                  f"{len(widths) - 1} launches"))
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
            kd, _, krows = _profile(k)
            pd = _profile(p)[0]
            ke, pe = events[label]
            kg, pg = graphed[label]
            rate = ""
            if label in flops:
                rate = f" = {flops[label] / kg / 1e9:.2f} TFLOP/s"
            log(f"time {label if label in flops else f'{label} B={B_TIME}'}: "
                f"kernel {kg:.4f} ms{rate}, plain "
                f"{pg:.4f} ms (CUDA events over graph replays); eager "
                f"back-to-back calls incl. host dispatch: kernel {ke:.4f} ms, "
                f"plain {pe:.4f} ms; device time kernel {_fmt(kd)}, plain "
                f"{_fmt(pd)} (profiler); {note}")
            if label in flops:  # one row per kernel name (layers of one tile add up)
                for name, ms in krows:
                    log(f"  device time per call: {ms:.4f} ms  {name[:70]}")
        g_ms = sum(graphed[k][0] for k in tier_labels)
        g_plain = sum(graphed[k][1] for k in tier_labels)
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
            mlp_ms = sum(ms for name, ms in rows if any(k in name for k in MLP_KERNELS))
            log(f"  fused_mlp kernels per forward B={B}: {mlp_ms:.4f} ms (profiler; "
                f"alone over graph replays: {graphed[f'fused_mlp fp32 model1 B={B}'][0]:.4f} ms)")
    return {"gather_rows": (g_ms, g_plain),
            "fused_mlp": graphed[f"fused_mlp fp32 model1 B={B_TIME}"],
            "fused_mlp_bf16": graphed[f"fused_mlp bf16 model1 B={B_TIME}"],
            "gather_rows_grouped": graphed["gather_rows_grouped gatherbench shape"]}


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
    t0 = time.perf_counter()
    _build.kernels()
    log(f"build: {len(_build.kernel_sources())} kernel sources, one nvcc each, "
        f"all started together, then one link: {time.perf_counter() - t0:.1f} s")
    gb = gatherbench_inputs(dev)
    err_g = phase_gather(dev)
    err_gg = phase_grouped(dev, gb)
    err_m, err_mb = phase_mlp(dev)
    cfg, model, tabs, ws, err_tiers, err_tiers_gg = phase_model1(dev)
    err_g = max(err_g, err_tiers)
    err_gg = max(err_gg, err_tiers_gg)
    launches = phase_serve(model, tabs, ws)
    gb_launches, _ = phase_tools(model, dev)
    phase_feature(dev)
    times = phase_report(cfg, model, dev, gb)
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
         "ms": times["fused_mlp"][0], "plain_ms": times["fused_mlp"][1],
         "max_abs_err_bf16": err_mb, "ms_bf16": times["fused_mlp_bf16"][0],
         "plain_ms_bf16": times["fused_mlp_bf16"][1]},
        {"name": "gather_rows_grouped", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/gather_grouped.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:139",
         "launches": gb_launches["gather_rows_grouped"], "max_abs_err": err_gg,
         "ms": times["gather_rows_grouped"][0],
         "plain_ms": times["gather_rows_grouped"][1]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
