"""Command-line entry points, the port of ``serve`` and ``loadgen`` from
``fleetrec_tpu/cli.py``:

  python -m fleetrec_tpu_torch.cli serve   --config fleetrec_model1 --batch 1024 --reply
  python -m fleetrec_tpu_torch.cli loadgen --config fleetrec_model1 --batch 1024 --read-scores

``serve`` builds the model on ``--device`` (default ``cuda``; nothing
moves to the CPU when no card is found — pass ``--device cpu`` for the
plain-PyTorch path) and serves index-mode batches from the native ingest
ring; ``loadgen`` sends synthetic index batches to it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue as queue_mod
import socket
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


def cmd_serve(args):
    """Start the ingest server + serving loop (index mode) on one device.

    --senders 1 (default): one sender ships int32 ids [B, T] then float32
    dense [B, dense_dim].  --senders N > 1: the reference 3-node topology
    (serving/wire.py): sender 0 ships the dense slice, the others int32 ids
    for contiguous config-order table ranges, on ports base..base+N-1."""
    from .models import init_model
    from .serving.compose import ServeSpec, serve

    cfg = _make_cfg(args)
    model = init_model(cfg, table_scheme=args.table_scheme,
                       mlp_scheme=args.mlp_scheme, device=args.device)
    spec = ServeSpec(
        batch=args.batch, batches=args.batches, port=args.port,
        slots=args.slots, senders=args.senders, fuse=args.fuse,
        bg_drain=args.bg_drain, reply=args.reply,
        scatter=tuple(args.scatter.split(",")) if args.scatter else (),
        warm=args.warm,
    )
    print(json.dumps(serve(cfg, model, spec)))


def cmd_loadgen(args):
    """Send synthetic index batches to a serve instance.  --senders N > 1
    emulates the reference's N-node sender fleet from one process: one TCP
    connection per role, each streaming only its slice of every batch."""
    from .serving.wire import IndexWireFormat

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

    s = sub.add_parser("serve", parents=[common])
    s.add_argument("--device", default="cuda",
                   help="torch device for tables, weights and the forward")
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
    s.set_defaults(fn=cmd_loadgen)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
