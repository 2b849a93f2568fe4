"""Worlds of ``torch.distributed`` ranks for the port's sharded tests
(tests/test_torch_sharded.py, tests/test_torch_multiprocess.py).

``spawn_world`` starts one process a rank with the ``spawn`` method (no
inherited state, no CUDA context), joins them over gloo on the CPU through a
``file://`` rendezvous under the test's own directory, runs ``target(rank,
*args)`` in each and returns what each rank returned.  A rank that raises
fails the world at once; a world that passes its deadline is killed and
fails: a rank stuck in a collective never hangs the test run.

``run_cases`` is the target that runs a list of cases (dicts, built by the
test module) on one rank: build the case's model on the host, shard it on
this rank's mesh, feed its data row's rows of the case's inputs (the parent
writes them to an npz) through ``host_local_batch_to_global`` and run the
sharded forward, recording every ``_pre`` (lookup), ``_exchange`` (shape,
dtype) and ``_finish`` (post) call in order.  A "train" case takes
``steps`` sharded SGD steps (``ShardedFleetRec.train_step``) and returns
the losses, this rank's updated shard and weights, and the sharded forward's
scores after them; an "engine" case with ``fuse`` scores its batches K at a
time through ``ServingEngine.from_sharded``.

This module imports neither JAX nor the JAX package, so the ranks import
only the port.
"""

import dataclasses
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np

from torch_variants import cap, mixed, variant

# deadline of one world, from its start: spawning 8 ranks that import torch
# on a shared CPU takes ~10-20 s of it
DEADLINE_S = 240.0


def spawn_world(n, target, args, tmp, deadline_s=DEADLINE_S):
    """Run ``target(rank, *args)`` on ``n`` spawned ranks of a gloo world
    (rendezvous ``file://<tmp>/rendezvous``); return the ranks' results in
    rank order.  Raises AssertionError naming the rank that failed, or the
    ranks missing at the deadline."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{os.path.join(str(tmp), 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, args=(r, n, init, target, args, q), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    t_end = time.monotonic() + deadline_s
    try:
        while len(results) < n:
            left = t_end - time.monotonic()
            if left <= 0:
                raise AssertionError(f"world of {n} ranks passed its {deadline_s:.0f} s "
                                     f"deadline; ranks done: {sorted(results)}")
            try:
                rank, ok, payload = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise AssertionError(f"rank(s) {dead} of a world of {n} died "
                                         f"(exit {[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise AssertionError(f"rank {rank} of a world of {n} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def _rank_main(rank, n, init, target, args, q):
    try:
        import torch
        import torch.distributed as dist

        from fleetrec_tpu_torch.parallel import init_distributed

        torch.set_num_threads(1)  # n ranks share the CPU
        init_distributed(init, n, rank, "gloo", device="cpu")
        try:
            out = target(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        q.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the world
        q.put((rank, False, traceback.format_exc()))


def case_config(C, key, dtype=None):
    """The config of a case from the config module ``C`` (either
    package's): a name of ``torch_variants.variant`` or one of the JAX
    sharding tests' configs below; ``dtype``: the tables' and the
    activations' dtype in place of the config's."""
    if dtype is not None:
        return dataclasses.replace(case_config(C, key), table_dtype=dtype, dtype=dtype)
    micro = C.micro_test(batch_size=32)
    extra = {
        "micro32": lambda: micro,
        "micro_int8": lambda: dataclasses.replace(micro, table_dtype="int8"),
        # every table in the take tier (tests/test_sharding.py:181)
        "micro_take": lambda: dataclasses.replace(C.micro_test(batch_size=16), onehot_max=8),
        "micro_take_int8": lambda: dataclasses.replace(C.micro_test(batch_size=16), onehot_max=8,
                                                       table_dtype="int8"),
        "model3_128": lambda: cap(C.fleetrec_model3(batch_size=16), 128),
        "model3_128_f32": lambda: dataclasses.replace(cap(C.fleetrec_model3(batch_size=16), 128),
                                                      table_dtype="float32"),
        "criteo_20265": lambda: cap(C.criteo_terabyte(batch_size=32, dtype="float32"), 20265),
        "criteo_4096": lambda: cap(C.criteo_terabyte(batch_size=32, dtype="float32"), 4096),
        "tiny_dlrm": lambda: cap(C.tiny_dlrm(batch_size=32), 4096),
        "micro_dlrm70": lambda: C.micro_dlrm(batch_size=32, onehot_max=70),
        "micro_cross70": lambda: dataclasses.replace(C.micro_cross(batch_size=32), onehot_max=70),
        "mixed": lambda: mixed(C),
        "mixed_int8": lambda: mixed(C, table_dtype="int8"),
    }
    return extra[key]() if key in extra else variant(key, C)


def rows_of(arr, d, D, axis=0):
    """Data row d's rows of a batch (axis 0, or 1 for [K, B, ...])."""
    B = arr.shape[axis] // D
    return np.take(arr, np.arange(d * B, (d + 1) * B), axis=axis)


def instrument(sh):
    """Record the sharded forward's parts in order on ``sh``: ("lookup",),
    ("exchange", shape, dtype, async) and ("post",)."""
    log = []

    def wrap(fn, entry):
        def f(*a, **k):
            log.append(entry(*a, **k))
            return fn(*a, **k)
        return f

    sh._pre = wrap(sh._pre, lambda *a, **k: ("lookup",))
    sh._exchange = wrap(sh._exchange, lambda part, async_op=False: (
        "exchange", tuple(part.shape), str(part.dtype).replace("torch.", ""), async_op))
    sh._finish = wrap(sh._finish, lambda *a, **k: ("post",))
    return log


def run_cases(rank, D, M, cases, inputs_path):
    """Every case of ``cases`` on this rank; returns {case name: result}."""
    from fleetrec_tpu_torch.parallel import global_mesh

    mesh = global_mesh(D, M, device="cpu")
    data = dict(np.load(inputs_path))
    return {c["name"]: _run_case(mesh, c, data) for c in cases}


def _run_case(mesh, case, data):
    import torch

    from fleetrec_tpu_torch import config as TC
    from fleetrec_tpu_torch.models import init_model
    from fleetrec_tpu_torch.parallel import (ShardedFleetRec, global_scores_to_host_local,
                                             host_local_batch_to_global)
    from fleetrec_tpu_torch.serving import ServingEngine

    name, kind = case["name"], case["kind"]
    idx = data.get(f"{name}/idx")
    dense = data.get(f"{name}/dense")
    if kind == "helpers":  # the leader's rows reach every rank of its row
        arr = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
        mine = rows_of(arr, mesh.d, mesh.data)
        got = host_local_batch_to_global(mesh, mine if mesh.is_leader else np.zeros_like(mine))
        return {"received": got.numpy(), "want": mine,
                "host_local": global_scores_to_host_local(mesh, got)}
    cfg = case_config(TC, case["cfg"], case.get("dtype"))
    model = init_model(cfg, table_scheme=case["tables"], mlp_scheme=case["mlp"], device="cpu")
    sh = ShardedFleetRec(model, mesh)
    del model
    out = {"fold": sh._use_w1_fold,
           "class_tables": [b.shape[0] for b in sh.operands["bufs"][:len(sh.layout.onehot_classes)]]}
    K = case.get("fuse", 1)
    axis = 1 if kind == "pipelined" or K > 1 else 0
    ids = rows_of(idx, mesh.d, mesh.data, axis)
    dns = None if dense is None else rows_of(dense, mesh.d, mesh.data, axis)
    if kind == "engine":
        eng = ServingEngine.from_sharded(sh, batch_size=ids.shape[-2], fuse=K,
                                         multiprocess=True)
        if eng.is_follower:
            out["follow"] = eng.follow()
            return out
        got = {}
        groups = [(ids, dns)] if K == 1 else [
            (ids[g:g + K], None if dns is None else dns[g:g + K])
            for g in range(0, ids.shape[0], K)]
        for i, d in groups:
            eng.submit(i, d, on_done=lambda bid, s: got.__setitem__(bid, s))
        out["summary"] = eng.drain()
        eng.close()
        out["scores"] = got[0] if K == 1 else np.concatenate([got[g] for g in sorted(got)])
        return out

    def fan_out(arr):
        if arr is None:
            return None
        return host_local_batch_to_global(mesh, arr if mesh.is_leader else np.zeros_like(arr))

    i, d = fan_out(ids), fan_out(dns)
    log = instrument(sh)
    if kind == "train":
        return _train(sh, case, i, d, fan_out(rows_of(data[f"{name}/labels"], mesh.d, mesh.data)),
                      out, log)
    with torch.inference_mode():
        if kind == "forward":
            s = sh.forward(i, d)
        elif kind == "pooled":
            s = sh.forward_pooled(i, d, mean=case.get("mean", False))
        elif kind == "pipelined":
            s = sh.forward_pipelined(i, d)
            out["pipelined_log"] = list(log)
            out["sequential"] = torch.stack([
                sh.forward(i[k], None if d is None else d[k]) for k in range(i.shape[0])]).numpy()
        else:
            raise KeyError(kind)
    out["scores"] = s.numpy()
    out["log"] = log
    return out


def _train(sh, case, ids, dense, labels, out, log):
    """``case["steps"]`` train_steps at ``case["lr"]``; an int8 model must
    refuse the first (out["refused"]: its message)."""
    import torch

    try:
        out["losses"] = [float(sh.train_step(ids, dense, labels, case["lr"]))
                         for _ in range(case.get("steps", 1))]
    except ValueError as e:
        out["refused"] = str(e)
        return out
    out["log"] = list(log)
    # float32 holds every bfloat16 value exactly
    out["tensors"] = {k: v.float().numpy() for k, v in sh.trainable_tensors().items()}
    with torch.inference_mode():
        out["scores_after"] = sh.forward(ids, dense).numpy()
    return out
