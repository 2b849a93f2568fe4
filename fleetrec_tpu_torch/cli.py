"""Command-line entry points, the port of ``fleetrec_tpu/cli.py``:

  python -m fleetrec_tpu_torch.cli serve   --config fleetrec_model1 --batch 1024 --reply
  python -m fleetrec_tpu_torch.cli loadgen --config fleetrec_model1 --batch 1024 --read-scores
  python -m fleetrec_tpu_torch.cli bench   --config fleetrec_model1 --batch 4096 --stage e2e
  python -m fleetrec_tpu_torch.cli gatherbench
  python -m fleetrec_tpu_torch.cli autotune --config fleetrec_model1 --batch 4096
  python -m fleetrec_tpu_torch.cli servebench --config fleetrec_model1 --qps 200000
  python -m fleetrec_tpu_torch.cli netbench
  python -m fleetrec_tpu_torch.cli export  --config fleetrec_model1 --out m.npz
  python -m fleetrec_tpu_torch.cli bench   --config dlrm_terabyte --max-rows 1000000 --batch 4096
  python -m fleetrec_tpu_torch.cli serve   --config fleetrec_model1 --batch 1024 --reply --bag-l 8
  python -m fleetrec_tpu_torch.cli loadgen --config fleetrec_model1 --batch 1024 --read-scores --bag-l 8
  python -m fleetrec_tpu_torch.cli serve   --config fleetrec_model1 --batch 1024 --reply \
      --mesh 1,2 --procs 2 --proc-id I --coordinator host:port --backend gloo   # each rank I
  python -m fleetrec_tpu_torch.cli plan    --config criteo_terabyte --dtype int8 --recommend 4
  python -m fleetrec_tpu_torch.cli icibench --model-axis 4 --procs 4 --proc-id I \
      --coordinator host:port                                                  # each rank I

Every command that builds a model or times a kernel runs on ``--device``
(default ``cuda``; nothing moves to the CPU when no card is found — pass
``--device cpu`` for the plain-PyTorch path), and ``--ckpt`` loads the
model from an npz checkpoint (``export``'s, or the JAX package's) instead
of synthesizing it.  ``bench``, ``gatherbench`` and ``autotune`` time
through ``utils/timing.py::DeviceBench`` (CUDA graphs and CUDA events on
the card).  Every JSON result names the device it ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import queue as queue_mod
import socket
import sys
import threading
import time

import numpy as np


def _make_cfg(args):
    """Config construction shared by both commands."""
    from . import config as C

    cfg = C.get_config(args.config, batch_size=args.batch)
    if args.max_rows:
        cfg = dataclasses.replace(
            cfg, tables=tuple(dataclasses.replace(t, rows=min(t.rows, args.max_rows))
                              for t in cfg.tables))
    if args.take_lanes:
        cfg = dataclasses.replace(cfg, take_lanes=args.take_lanes)
    if args.onehot_max is not None:
        cfg = dataclasses.replace(cfg, onehot_max=args.onehot_max)
    if args.onehot_factor_max is not None:
        cfg = dataclasses.replace(cfg, onehot_factor_max=args.onehot_factor_max)
    if args.onehot_r2 is not None:
        cfg = dataclasses.replace(cfg, onehot_r2=args.onehot_r2)
    if args.take_stripes:
        cfg = dataclasses.replace(cfg, take_stripes=args.take_stripes)
    if args.qr_rem:
        # applied after --max-rows so the threshold acts on the capped rows
        cfg = dataclasses.replace(
            cfg, qr_threshold=args.qr_threshold or 1_000_000, qr_rem=args.qr_rem)
        cfg.validate()
    elif args.qr_threshold:
        raise SystemExit("--qr-threshold requires --qr-rem > 0")
    if args.dtype:
        if args.dtype == "int8":
            # int8 quantizes table storage only; the MLP stays fp32
            cfg = dataclasses.replace(cfg, table_dtype="int8")
        else:
            cfg = dataclasses.replace(cfg, dtype=args.dtype, table_dtype=args.dtype)
    return cfg


def _build(args, device=None):
    """The config and the model on ``device`` (default --device): loaded
    from --ckpt (its fingerprint and array shapes checked) or
    synthesized."""
    cfg = _make_cfg(args)
    device = device or args.device
    if args.ckpt:
        from .io import load_npz

        return cfg, load_npz(args.ckpt, cfg, device)
    from .models import init_model

    return cfg, init_model(cfg, table_scheme=args.table_scheme,
                           mlp_scheme=args.mlp_scheme, device=device)


def _device_name(dev) -> str:
    """What a JSON result names as the device it ran on."""
    import torch

    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _index_inputs(cfg, K, B, dev):
    """K batches of uniform ids [K, B, T] (int32) and dense features
    [K, B, dense_dim] (or None) on ``dev``, from numpy seed 0 as in the JAX
    package's bench."""
    import torch

    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, t.rows, (K, B)) for t in cfg.tables],
                   2).astype(np.int32)
    dense = (rng.uniform(-1, 1, (K, B, cfg.dense_dim)).astype(np.float32)
             if cfg.dense_dim else None)
    return (torch.from_numpy(idx).to(dev),
            None if dense is None else torch.from_numpy(dense).to(dev))


def _forward_step(model, x):
    return model(x[0], x[1])


def cmd_serve(args):
    """Start the ingest server + serving loop (index mode) on one device.

    --senders 1 (default): one sender ships int32 ids [B, T] then float32
    dense [B, dense_dim].  --senders N > 1: the reference 3-node topology
    (serving/wire.py): sender 0 ships the dense slice, the others int32 ids
    for contiguous config-order table ranges, on ports base..base+N-1.
    --bag-l L: the ids are pooled bags, int32 [B, T, L] with -1 padding
    (models/pooled.py), sum-pooled, or mean-pooled with --bag-mean; one
    sender only, and no interaction head.

    --mesh D,M: serve through the sharded engine (parallel/sharded.py:
    tables over M model shards, the batch over D data rows) on D*M ranks,
    one device a rank, so --procs must be D*M.  Every rank runs this
    command with its --proc-id over one torch.distributed world
    (--coordinator host:port or a file:// URL; --backend nccl needs a card a
    rank, gloo carries several ranks on one card through host memory).  The
    model is built on the host and each rank moves only its shard to
    --device.  Each data row's leader (model rank 0) binds its own --port,
    takes --batch rows a batch and replies its own rows' scores; the row's
    other ranks follow it.  --fuse K scores K batches a call through the
    pipelined sharded forward; --peer-timeout bounds the lockstep wait
    (serving/engine.PeerWatchdog)."""
    from .serving.compose import ServeSpec, serve

    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    if mesh is None and args.procs > 1:
        raise SystemExit("--procs requires --mesh D,M")
    if mesh is not None and (len(mesh) != 2 or mesh[0] * mesh[1] != args.procs):
        raise SystemExit(f"--mesh {args.mesh} needs --procs equal to D*M (one device a "
                         f"rank), got --procs {args.procs}")
    multiproc = args.procs > 1
    if multiproc:
        from .parallel import init_distributed

        init_distributed(args.coordinator, args.procs, args.proc_id, args.backend,
                         device=args.device)
    try:
        # a sharded engine packs the model on the host and moves its shard
        cfg, model = _build(args, device="cpu" if mesh else None)
        spec = ServeSpec(
            batch=args.batch, batches=args.batches, port=args.port,
            slots=args.slots, senders=args.senders, mesh=mesh, multiprocess=multiproc,
            device=args.device, peer_timeout_s=args.peer_timeout or None, fuse=args.fuse,
            bg_drain=args.bg_drain, reply=args.reply,
            scatter=tuple(args.scatter.split(",")) if args.scatter else (),
            warm=args.warm, bag_L=args.bag_l, bag_mean=args.bag_mean,
        )
        print(json.dumps(serve(cfg, model, spec)))
    finally:
        if multiproc:
            import torch.distributed as dist

            dist.destroy_process_group()


def cmd_loadgen(args):
    """Send synthetic index batches to a serve instance.  --senders N > 1
    emulates the reference's N-node sender fleet from one process: one TCP
    connection per role, each streaming only its slice of every batch.
    --bag-l L sends pooled bags [B, T, L] (match serve --bag-l): a prefix
    of 1 .. L ids a bag, -1 after it; one sender only (the multi-sender
    wire frames single ids)."""
    from .serving.wire import IndexWireFormat

    if args.bag_l and args.senders > 1:
        raise SystemExit("--bag-l: pooled bags go over a single-sender wire "
                         "(--senders 1)")
    cfg = _make_cfg(args)
    B = args.batch
    rng = np.random.default_rng(args.seed)

    def draw(rows):
        if args.dist == "zipf":
            # bounded Zipf(1.1) — hot-item skew typical of production traffic
            z = rng.zipf(1.1, size=B)
            return np.minimum(z - 1, rows - 1).astype(np.int64)
        return rng.integers(0, rows, B)

    def gen_batch():
        if args.bag_l:
            # pooled bags: random valid prefix lengths in [1, L], -1 padding
            L = args.bag_l
            idx = np.full((B, cfg.num_tables, L), -1, np.int32)
            for j, t in enumerate(cfg.tables):
                lens = rng.integers(1, L + 1, B)
                for l in range(L):
                    rowv = draw(t.rows)
                    take = lens > l
                    idx[take, j, l] = rowv[take]
        else:
            idx = np.stack([draw(t.rows) for t in cfg.tables], 1).astype(np.int32)
        dense = (rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)
                 if cfg.dense_dim else None)
        return idx, dense

    def connect(port, tries=100):
        # the server may still be building the model / binding
        while True:
            try:
                return socket.create_connection((args.ip, port), timeout=30)
            except OSError:
                tries -= 1
                if tries == 0:
                    raise
                time.sleep(0.1)

    n_senders = args.senders
    socks = [connect(args.port + s) for s in range(n_senders)]
    reader = None
    scores_read = [0]
    if args.read_scores:
        # scores stream back on sender 0's connection (serve --reply)
        def _read():
            want = args.batches * B * 4
            got = 0
            while got < want:
                chunk = socks[0].recv(min(1 << 16, want - got))
                if not chunk:
                    break
                got += len(chunk)
            scores_read[0] = got // 4

        reader = threading.Thread(target=_read, daemon=True)
        reader.start()

    t0 = time.time()
    # offered-load pacing: --qps Q paces batch k to start at t0 + k*B/Q
    interval = B / args.qps if args.qps else 0.0

    def pace(k):
        if interval:
            lag = t0 + k * interval - time.time()
            if lag > 0:
                time.sleep(lag)

    try:
        if n_senders == 1:
            for k in range(args.batches):
                idx, dense = gen_batch()
                payload = idx.tobytes()
                if dense is not None:
                    payload += dense.tobytes()
                pace(k)
                socks[0].sendall(payload)
        else:
            wire = IndexWireFormat.plan(cfg, B, n_senders)
            qs = [queue_mod.Queue(maxsize=4) for _ in range(n_senders)]

            def pump(s):
                while True:
                    payload = qs[s].get()
                    if payload is None:
                        return
                    socks[s].sendall(payload)

            pumps = [threading.Thread(target=pump, args=(s,), daemon=True)
                     for s in range(n_senders)]
            for t in pumps:
                t.start()
            for k in range(args.batches):
                idx, dense = gen_batch()
                pace(k)
                for s, payload in enumerate(wire.payloads(idx, dense)):
                    qs[s].put(payload)
            for q in qs:
                q.put(None)
            for t in pumps:
                t.join(timeout=60)
        if reader is not None:
            reader.join(timeout=60)
    finally:
        for sock in socks:
            sock.close()
    dt = time.time() - t0
    msg = (f"sent {args.batches} x {B} queries over {n_senders} sender(s) "
           f"in {dt:.2f}s ({args.batches * B / dt:.0f} q/s)")
    if args.qps:
        msg += f" [offered {args.qps:.0f} q/s]"
    if args.read_scores:
        msg += f"; scores received: {scores_read[0]}"
    print(msg)


def cmd_bench(args):
    """Device time per batch for a config: one CUDA graph of K steps, its
    best replay over K (DeviceBench, as autotune times).

    --stage picks the slice of the pipeline, the analog of the reference's
    measurement variants that disable the matmuls to isolate the data
    path: e2e (default) | lookup (``FleetRecModel.lookup``: features and
    bad-row flags; a DLRM config's lookup reads no dense features, which
    feed its bottom tower) | mlp (the top tower only, ``feature_dim`` wide,
    with the config's activation).
    ms_per_batch and inferences_per_sec come from the K-step
    graph.  ms_per_batch_two_k and percall_const_ms are the two-K split
    (a second graph of 4K steps), side fields that no metric reads: on the
    H100 the split is noise (PERF.md)."""
    import torch

    from .models.embedding import TORCH_DTYPES
    from .models.mlp import mlp_apply
    from .utils.timing import DeviceBench

    cfg, model = _build(args)
    dev = model.device
    K, B = args.iters, args.batch
    if args.stage == "mlp":
        x = np.random.default_rng(0).uniform(-1, 1, (K, B, cfg.feature_dim))
        xs = torch.from_numpy(x.astype(np.float32)).to(dev, TORCH_DTYPES[cfg.dtype])
        bench = DeviceBench(lambda m, xb: mlp_apply(
            m.mlp_weights, xb, activation=cfg.mlp.activation))
    else:
        xs = _index_inputs(cfg, K, B, dev)
        if args.stage == "lookup":
            def step(m, x):  # the features (the same launch writes the flags)
                return m.lookup(x[0], x[1])[0]
        else:
            step = _forward_step
        bench = DeviceBench(step)
    with torch.inference_mode():
        r = bench.measure_corrected(model, xs)
    print(json.dumps({
        "config": cfg.name, "stage": args.stage, "batch": B,
        "dtype": cfg.dtype, "device": _device_name(dev),
        "ms_per_batch": round(r["raw_per_iter_ms"], 4),
        "inferences_per_sec": round(B / (r["raw_per_iter_ms"] / 1e3), 1),
        "ms_per_batch_two_k": round(r["per_iter_ms"], 4),
        "percall_const_ms": round(r["percall_const_ms"], 4),
    }))


def cmd_gatherbench(args):
    """Row-gather shootout on one [rows, 128] float32 table, ns per
    gathered row apiece: the plain version (``gather_rows_plain``:
    index_select with the zero-row rule), the row-gather kernel
    (``gather_rows``) and the grouped kernel (``gather_rows_grouped``,
    whose --chunk / --group / --window these are).  Each is one
    CUDA graph of --iters steps, its best replay over the steps
    (DeviceBench); each step's time includes one sum over its [n_rows, 128]
    output, the same for all three.

    Given several values of the grouped kernel's flags, it times every
    combination and lists them under ``sweep``; the top-level grouped
    fields are then the fastest one's.  ``grouped_chunk`` /
    ``grouped_group`` / ``grouped_window`` are what the kernel ran after
    its clamps, ``grouped_smem_bytes`` its shared memory a block."""
    import itertools

    import torch

    from .ops.gather import (gather_rows, gather_rows_grouped,
                             gather_rows_plain, grouped_launch_params,
                             grouped_smem_bytes)
    from .utils.timing import DeviceBench

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    R, L, N, K = args.rows, 128, args.n_rows, args.iters
    table = torch.from_numpy(rng.standard_normal((R, L)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, R, (K, N))).to(dev)  # int64, as the model passes
    row_bytes = L * table.element_size()

    def ns_per_row(fn):
        return DeviceBench(fn).measure(table, idx)["per_iter_ms"] * 1e6 / N

    res = {"plain_ns_per_row": ns_per_row(gather_rows_plain),
           "kernel_ns_per_row": ns_per_row(gather_rows)}
    sweep = []
    for chunk, group, window in itertools.product(args.chunk, args.group,
                                                  args.window):
        c, g, w, seg, page = grouped_launch_params(row_bytes, chunk, group, window)
        fn = functools.partial(gather_rows_grouped, chunk=chunk, group=group,
                               window=window)
        sweep.append({"grouped_ns_per_row": ns_per_row(fn), "chunk": chunk,
                      "group": group, "window": window, "grouped_chunk": c, "grouped_group": g,
                      "grouped_window": w,
                      "grouped_smem_bytes": grouped_smem_bytes(g, w, seg, page)})
    res.update(min(sweep, key=lambda r: r["grouped_ns_per_row"]))
    res.update(rows=R, gathered_rows=N, device=_device_name(dev))
    if len(sweep) > 1:
        res["sweep"] = [{k: round(v, 2) if isinstance(v, float) else v
                         for k, v in r.items()} for r in sweep]
    print(json.dumps({k: round(v, 2) if isinstance(v, float) else v
                      for k, v in res.items()}))


def cmd_autotune(args):
    """Sweep the plain-class threshold (onehot_max) and report the forward's
    ms/batch per candidate (DeviceBench, one graph of --iters steps).  On
    the port every tier is the same row gather, so the sweep shows what
    the tier split costs on the card."""
    import torch

    from .utils.timing import DeviceBench

    results = []
    best = None
    for th in args.thresholds:
        args.onehot_max = th
        cfg, model = _build(args)
        xs = _index_inputs(cfg, args.iters, args.batch, model.device)
        with torch.inference_mode():
            r = DeviceBench(_forward_step).measure(model, xs)
        row = {"onehot_max": th, "onehot_tables": model.layout.n_onehot,
               "take_tables": model.layout.n_take,
               "ms_per_batch": round(r["per_iter_ms"], 4)}
        dev = model.device
        del model, xs  # one model on the device at a time
        results.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        if best is None or row["ms_per_batch"] < best["ms_per_batch"]:
            best = row
    print(json.dumps({"config": args.config, "batch": args.batch,
                      "device": _device_name(dev), "best": best,
                      "sweep": results}))


def cmd_servebench(args):
    """Latency-bounded serving bench: Poisson arrivals, a batching window,
    per-query p50/p99 (serving/servebench.py)."""
    from .serving.servebench import run_servebench

    cfg, model = _build(args)
    r = run_servebench(
        model, batch_size=args.batch, offered_qps=args.qps,
        duration_s=args.duration, max_wait_ms=args.max_wait_ms,
        device_pool=args.device_pool, fuse=args.fuse,
    )
    print(json.dumps({"config": cfg.name, "fuse": args.fuse,
                      "device": _device_name(model.device), **r.to_json()}))


def cmd_netbench(args):
    """Ingest-tier TCP throughput and batch-assembly latency over
    localhost (no device): the analog of the reference's network bring-up
    kernels and its sender-side GB/s printouts."""
    from .serving import IngestServer, Loadgen

    nbytes = [args.bytes_per_batch] * args.senders
    t_first = None
    with IngestServer(nbytes, n_slots=args.slots, port_base=args.port,
                      n_conns=args.conns, pkg_bytes=args.pkg_bytes) as ing:
        Loadgen("127.0.0.1", args.port, nbytes, args.batches, fill=1.0,
                n_conns=args.conns, pkg_bytes=args.pkg_bytes).start()
        lat = []
        for _ in range(args.batches):
            r = ing.acquire(30_000)
            if r is None:
                raise TimeoutError("netbench: no batch within 30 s")
            slot, _view, t_fb, t_done = r
            if t_first is None:
                t_first = t_fb
            lat.append((t_done - t_fb) / 1e6)
            t_last = t_done
            ing.release(slot)
        total = ing.bytes_received
        dt = (t_last - t_first) / 1e9
        lat = np.asarray(lat[1:] or lat)
        print(json.dumps({
            "senders": args.senders, "conns": args.conns,
            "pkg_bytes": args.pkg_bytes, "batches": args.batches,
            "GB_s": round(total / dt / 1e9, 3),
            "batch_assembly_ms_p50": round(float(np.percentile(lat, 50)), 3),
            "batch_assembly_ms_p99": round(float(np.percentile(lat, 99)), 3),
            "per_sender": ing.sender_stats(),
        }))


def cmd_export(args):
    """Build (or load with --ckpt) a model and write an npz checkpoint with
    its config fingerprint, readable by this package and the JAX package.

    --quantize-int8: quantize the float table buffers per table with
    power-of-two scales before saving; the checkpoint is fingerprinted for
    table_dtype="int8" and loads into the int8 config of the same
    geometry."""
    import os

    from . import io as fio

    cfg, model = _build(args)
    if args.quantize_int8:
        if cfg.table_dtype == "int8":
            raise SystemExit("--quantize-int8: config already stores int8 "
                             "(build with --dtype float32/bfloat16)")
        model = fio.quantize_tables(model)
        cfg = model.cfg
    fio.save_npz(args.out, model)
    print(json.dumps({"path": args.out, "bytes": os.path.getsize(args.out),
                      "config": cfg.name, "table_dtype": cfg.table_dtype,
                      "fingerprint": fio.config_fingerprint(cfg)[:12]}))


def cmd_plan(args):
    """Placement plan: per-card byte accounting and shard load balance of a
    config on an n_model-way mesh (the analog of the reference's
    config_sp_*.txt bank-pinning files, computed instead of hand-written).
    Runs on the host and touches no device.

    --recommend N: pick the (data, model) split of N cards: model axis = the
    smallest that fits the memory budget (the model axis divides table
    bytes; the data axis divides the batch), data axis = N / model."""
    from .parallel import H100_HBM_BYTES, plan, recommend

    cfg = _make_cfg(args)
    budget = H100_HBM_BYTES if args.hbm_gb is None else int(args.hbm_gb * 2**30)
    if args.recommend:
        N = args.recommend
        m, p = recommend(cfg, N, hbm_budget_bytes=budget, batch_size=args.batch)
        if m is None:
            print(json.dumps({"recommend": None,
                              "reason": f"does not fit {N} cards at {budget} bytes each; "
                              f"min_model_shards={p.min_model_shards}"}))
            return
        print(json.dumps({
            "chips": N, "data_axis": N // m, "model_axis": m,
            "table_dtype": cfg.table_dtype,
            "per_chip_bytes": p.per_chip_bytes,
            "hbm_budget_bytes": p.hbm_budget_bytes,
            "note": "model axis = min that fits (divides table bytes); "
                    "data axis divides the batch",
        }, indent=2))
        return
    p = plan(cfg, n_model=args.model_axis, hbm_budget_bytes=budget, batch_size=args.batch)
    out = p.to_json()
    if not args.shards:
        out.pop("shards")
    print(json.dumps(out, indent=2))


def cmd_icibench(args):
    """Collective bandwidth over the mesh's model group (iperf_krnl's
    analog): every rank of a --procs world runs this command with its
    --proc-id (serve --mesh's convention for worlds); rank 0 prints the
    JSON."""
    import torch.distributed as dist

    from .benchmarks import ici_bench
    from .parallel import global_mesh, init_distributed

    n = args.procs
    model_ax = args.model_axis or max(n // args.data, 1)
    if args.data * model_ax != n:
        raise SystemExit(f"--data {args.data} x --model-axis {model_ax} needs --procs "
                         f"{args.data * model_ax} (one device a rank), got {n}")
    if n > 1:
        init_distributed(args.coordinator, n, args.proc_id, args.backend, device=args.device)
    try:
        mesh = global_mesh(args.data, model_ax, device=args.device)
        res = ici_bench(mesh, mbytes=args.mbytes, iters=args.iters)
        if mesh.rank == 0:
            res["device"] = _device_name(mesh.device)
            res["backend"] = dist.get_backend() if dist.is_initialized() else None
            print(json.dumps(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fleetrec_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", default="fleetrec_model1")
    common.add_argument("--batch", type=int, default=1024)
    common.add_argument("--max-rows", type=int, default=0,
                        help="cap table rows (dev/testing)")
    common.add_argument("--dtype", default="",
                        help="override compute dtype (float32|bfloat16), or "
                        "int8 for quantized table storage")
    common.add_argument("--table-scheme", default="pm1")
    common.add_argument("--mlp-scheme", default="ones")
    common.add_argument("--take-lanes", type=int, default=0,
                        help="take-buffer row width (multiple of 128)")
    common.add_argument("--onehot-max", type=int, default=None,
                        help="rows at or below which tables form plain classes")
    common.add_argument("--onehot-factor-max", type=int, default=None,
                        help="rows at or below which tables form factored "
                        "classes (0 = off)")
    common.add_argument("--onehot-r2", type=int, default=None,
                        help="lo-level width of the factored classes")
    common.add_argument("--take-stripes", type=int, default=0,
                        help="striped take layout; 0 = config default")
    common.add_argument("--qr-rem", type=int, default=0,
                        help="QR compressed embeddings: remainder table "
                        "size (0 = off; emb = Q[id//rem] + R[id%%rem])")
    common.add_argument("--qr-threshold", type=int, default=0,
                        help="rows above which tables QR-decompose "
                        "(default 1M when --qr-rem is set)")
    common.add_argument("--ckpt", default="",
                        help="load the model from an npz checkpoint "
                        "(fingerprint and shapes checked) instead of "
                        "synthesizing it")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device for tables, weights and the "
                        "timed work (no move to the CPU without a card)")

    s = sub.add_parser("serve", parents=[common, device])
    s.add_argument("--port", type=int, default=7080)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--batches", type=int, default=100)
    s.add_argument("--senders", type=int, default=1,
                   help="index-mode senders: 1 = single wire; N>1 = the "
                   "reference 3-node topology (ports base..base+N-1)")
    s.add_argument("--bg-drain", action="store_true",
                   help="readbacks on a background thread")
    s.add_argument("--reply", action="store_true",
                   help="stream fp32 scores back to sender 0 after each "
                   "batch (client must read them)")
    s.add_argument("--scatter", default="",
                   help="comma-separated host:port consumers to fan scores "
                   "out to round-robin")
    s.add_argument("--fuse", type=int, default=1,
                   help="wire batches per device call; --batches must "
                   "divide by it")
    s.add_argument("--warm", action="store_true",
                   help="run the scoring path once on dummy data before "
                   "accepting traffic (kernel builds stay out of the "
                   "latency records)")
    s.add_argument("--bag-l", type=int, default=0,
                   help="pooled bag serving: slots carry int32 [B, T, L] "
                   "multi-hot bags (-1 padding) pooled on the device "
                   "(models/pooled.py; single sender, no interaction head)")
    s.add_argument("--bag-mean", action="store_true",
                   help="mean pooling instead of sum (with --bag-l)")
    s.add_argument("--mesh", default="",
                   help="D,M: serve through the sharded engine on a (data=D, "
                   "model=M) mesh of D*M ranks, one device a rank")
    s.add_argument("--procs", type=int, default=1,
                   help="ranks of the torch.distributed world: D*M with --mesh "
                   "(each runs its own serve; --batch is a data row's rows)")
    s.add_argument("--proc-id", type=int, default=0, help="this process's rank")
    s.add_argument("--coordinator", default=None,
                   help="rendezvous: host:port, or a tcp:// or file:// URL "
                   "(default: MASTER_ADDR / MASTER_PORT)")
    s.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default nccl on a CUDA "
                   "device, gloo on the CPU); nccl needs a card a rank, gloo "
                   "lets several ranks share one card")
    s.add_argument("--peer-timeout", type=float, default=0,
                   help="abort this process (exit 124) with a diagnostic when "
                   "a collective dispatch / readback stalls past this many "
                   "seconds (0 = no bound)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("loadgen", parents=[common])
    s.add_argument("--ip", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7080)
    s.add_argument("--batches", type=int, default=100)
    s.add_argument("--senders", type=int, default=1,
                   help="emulate N sender nodes (must match serve --senders)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--dist", default="uniform", choices=["uniform", "zipf"])
    s.add_argument("--read-scores", action="store_true",
                   help="read the fp32 scores the server streams back "
                   "(pair with serve --reply)")
    s.add_argument("--qps", type=float, default=0,
                   help="offered load in queries/s (paced open-loop); "
                   "0 = send as fast as TCP accepts")
    s.add_argument("--bag-l", type=int, default=0,
                   help="send pooled [B, T, L] bags (match serve --bag-l; "
                   "single sender only)")
    s.set_defaults(fn=cmd_loadgen)

    s = sub.add_parser("bench", parents=[common, device])
    s.add_argument("--iters", type=int, default=32)
    s.add_argument("--stage", default="e2e", choices=["e2e", "lookup", "mlp"])
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("servebench", parents=[common, device])
    s.add_argument("--qps", type=float, default=500_000)
    s.add_argument("--duration", type=float, default=5.0)
    s.add_argument("--max-wait-ms", type=float, default=2.0)
    s.add_argument("--device-pool", action="store_true",
                   help="keep the query pool on the device (no per-batch "
                   "host-to-device copy)")
    s.add_argument("--fuse", type=int, default=1,
                   help="batches per dispatch, scored as one forward; "
                   "implies --device-pool")
    s.set_defaults(fn=cmd_servebench)

    s = sub.add_parser("netbench")
    s.add_argument("--senders", type=int, default=3)
    s.add_argument("--bytes-per-batch", type=int, default=1024 * 1952 * 4)
    s.add_argument("--batches", type=int, default=50)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--port", type=int, default=27080)
    s.add_argument("--conns", type=int, default=1,
                   help="parallel connections per sender (the reference's "
                   "useConn knob)")
    s.add_argument("--pkg-bytes", type=int, default=64 * 1024,
                   help="stripe packet size when --conns > 1")
    s.set_defaults(fn=cmd_netbench)

    s = sub.add_parser("export", parents=[common, device],
                       help="write an npz checkpoint (+config fingerprint)")
    s.add_argument("--out", required=True)
    s.add_argument("--quantize-int8", action="store_true",
                   help="per-table pow2 quantization of the float table "
                   "buffers before saving")
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("autotune", parents=[common, device],
                       help="sweep the plain-class threshold on the device")
    s.add_argument("--iters", type=int, default=16)
    s.add_argument("--thresholds", type=int, nargs="+",
                   default=[512, 1024, 2048, 4096, 8192])
    s.set_defaults(fn=cmd_autotune)

    s = sub.add_parser("gatherbench", parents=[device],
                       help="plain gather vs the two gather kernels, ns/row")
    s.add_argument("--rows", type=int, default=1 << 20)
    s.add_argument("--n-rows", type=int, default=4096 * 30,
                   help="gathered rows per iteration (model1-like)")
    s.add_argument("--iters", type=int, default=16)
    s.add_argument("--chunk", type=int, nargs="+", default=[512],
                   help="rows per block of the grouped kernel")
    s.add_argument("--window", type=int, nargs="+", default=[8],
                   help="groups in flight in the grouped kernel")
    s.add_argument("--group", type=int, nargs="+", default=[8],
                   help="rows per barrier in the grouped kernel")
    s.set_defaults(fn=cmd_gatherbench)

    s = sub.add_parser("plan", parents=[common],
                       help="placement plan: per-card bytes + load balance (host only)")
    s.add_argument("--model-axis", type=int, default=8)
    s.add_argument("--hbm-gb", type=float, default=None,
                   help="per-card memory budget in GiB (default: one H100's, "
                   "parallel/planner.py::H100_HBM_BYTES)")
    s.add_argument("--shards", action="store_true",
                   help="include the per-shard row-range table")
    s.add_argument("--recommend", type=int, default=0,
                   help="recommend the (data, model) split of N cards (0 = off)")
    s.set_defaults(fn=cmd_plan)

    s = sub.add_parser("icibench", parents=[device],
                       help="collective bandwidth over the mesh (iperf analog)")
    s.add_argument("--data", type=int, default=1)
    s.add_argument("--model-axis", type=int, default=0,
                   help="model axis size; 0 = every rank of a data row")
    s.add_argument("--mbytes", type=int, default=64, help="MiB of float32 a rank")
    s.add_argument("--iters", type=int, default=16)
    s.add_argument("--procs", type=int, default=1,
                   help="ranks of the torch.distributed world, one device a rank")
    s.add_argument("--proc-id", type=int, default=0, help="this process's rank")
    s.add_argument("--coordinator", default=None,
                   help="rendezvous: host:port, or a tcp:// or file:// URL "
                   "(default: MASTER_ADDR / MASTER_PORT)")
    s.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default nccl on a CUDA "
                   "device, gloo on the CPU)")
    s.set_defaults(fn=cmd_icibench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
