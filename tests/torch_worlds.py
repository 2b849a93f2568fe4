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
time through ``ServingEngine.from_sharded``.  ``run_generated`` builds each
rank's shard from its generated pm1 window (``ShardedFleetRec.from_packed``)
and from a whole model; ``run_planner_cases``, ``run_ici_bench`` and
``run_dryrun`` serve tests/test_torch_planner.py and
tests/test_torch_collectives.py.

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
        # criteo with every tier: take tables in 16 stripes, factored and
        # one-hot classes (tests/test_torch_biginit.py)
        "criteo_30000": lambda: cap(C.criteo_terabyte(batch_size=32, dtype="float32"), 30000),
        "criteo_30000_int8": lambda: dataclasses.replace(
            cap(C.criteo_terabyte(batch_size=32, dtype="float32"), 30000), table_dtype="int8"),
        "tiny_dlrm": lambda: cap(C.tiny_dlrm(batch_size=32), 4096),
        "micro_dlrm70": lambda: C.micro_dlrm(batch_size=32, onehot_max=70),
        "micro_cross70": lambda: dataclasses.replace(C.micro_cross(batch_size=32), onehot_max=70),
        "mixed": lambda: mixed(C),
        "mixed_int8": lambda: mixed(C, table_dtype="int8"),
    }
    return extra[key]() if key in extra else variant(key, C)


def run_generated(rank, D, M, names, inputs_path):
    """For each config key of ``names``: this rank's shard built twice, from
    generated pm1 buffers (``pack_pm1_sharded`` with the mesh, then
    ``ShardedFleetRec.from_packed``) and from a whole pm1 model
    (``ShardedFleetRec(init_model(...))``), and the data row's scores of
    each on the parent's ids and dense (``<name>/idx``, ``<name>/dense``);
    the generated take window's shape and bytes."""
    import torch

    from fleetrec_tpu_torch import config as TC
    from fleetrec_tpu_torch.models import init_model, pack_pm1_sharded
    from fleetrec_tpu_torch.models.fleetrec import ModelPlan
    from fleetrec_tpu_torch.models.mlp import init_mlp_params
    from fleetrec_tpu_torch.parallel import ShardedFleetRec, global_mesh

    mesh = global_mesh(D, M, device="cpu")
    data = dict(np.load(inputs_path))
    out = {}
    for name in names:
        cfg = case_config(TC, name)
        plan = ModelPlan.create(cfg)
        packed = pack_pm1_sharded(cfg, plan.layout, mesh, chunk_rows=1000)
        gen = ShardedFleetRec.from_packed(plan, packed, mesh,
                                          init_mlp_params(cfg.mlp, "ones", device="cpu"))
        whole = ShardedFleetRec(init_model(cfg, device="cpu"), mesh)
        ids = torch.from_numpy(rows_of(data[f"{name}/idx"], mesh.d, D))
        dense = torch.from_numpy(rows_of(data[f"{name}/dense"], mesh.d, D))
        with torch.inference_mode():
            out[name] = {"generated": gen.forward(ids, dense).numpy(),
                         "whole": whole.forward(ids, dense).numpy(),
                         "take_shape": tuple(packed.take_buffer.shape),
                         "take_bytes": packed.take_buffer.nbytes}
    return out


def checkpoint_arrays(target):
    """{name: uint8 [rows, row bytes]} of the arrays a sharded checkpoint
    holds of ``target`` (``io.checkpoint_tensors``: a FleetRecModel's, or
    the valid rows of a rank's ShardedFleetRec), as bytes, so that arrays
    compare bit for bit."""
    import torch

    from fleetrec_tpu_torch import io as tio

    out = {}
    for name, t in tio.checkpoint_tensors(target).items():
        t = t.detach().cpu().contiguous()
        row_bytes = int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()
        out[name] = t.reshape(-1).view(torch.uint8).numpy().reshape(t.shape[0], row_bytes)
    return out


def shard_padding_ok(sh):
    """Whether the padding of a rank's shard is as ``packed_operands``
    makes it: tables and take rows past the real ones 0, their int8 scales
    1.0."""
    from fleetrec_tpu_torch.models.embedding import class_tables

    lay, m, M = sh.layout, sh.mesh.m, sh.mesh.model
    ops = sh.operands
    counts = [c.num_tables for c in lay.onehot_classes]
    if lay.take_phys_total:
        counts.append(lay.take_phys_total)
    for i, n in enumerate(counts):
        lo, hi = class_tables(n, m, M)
        if ops["bufs"][i][hi - lo:].any():
            return False
        if ops["scales"] is not None and i < len(lay.onehot_classes):
            if not (ops["scales"][i][hi - lo:] == 1.0).all():
                return False
    return True


def run_checkpoints(rank, cases, tmp, inputs_path):
    """The sharded checkpoints' cases (tests/test_torch_checkpoint.py) on
    this rank of a world of 4, which holds two meshes, (2, 2) and (1, 4).
    For each case: the one-device checkpoint ``<tmp>/<name>.one`` the parent
    wrote, restored onto (2, 2) and forwarded (a "train" case then takes one
    SGD step, ``ShardedFleetRec.train_step``, on the global batch, and
    forwards again); saved from (2, 2) to ``<name>.2x2``, restored onto
    (2, 2) again and onto (1, 4), each forwarded (the (1, 4) mesh's one data
    row takes the whole batch); saved from (1, 4) to ``<name>.1x4``, which
    the parent restores onto one device.  Returns, by case, the scores, the
    shards' valid arrays (``checkpoint_arrays``) and whether each restored
    shard's padding is as ``packed_operands`` makes it."""
    import torch

    from fleetrec_tpu_torch import config as TC
    from fleetrec_tpu_torch import io as tio
    from fleetrec_tpu_torch.parallel import global_mesh, make_mesh

    m22 = global_mesh(2, 2, device="cpu")
    m14 = make_mesh(1, 4, device="cpu")
    data = dict(np.load(inputs_path))
    out = {}
    for c in cases:
        name = c["name"]
        cfg = case_config(TC, c["cfg"], c.get("dtype"))
        if "table_dtype" in c:
            cfg = dataclasses.replace(cfg, table_dtype=c["table_dtype"])
        glob = [data.get(f"{name}/{k}") for k in ("idx", "dense", "labels")]
        row = [None if a is None else torch.from_numpy(rows_of(a, m22.d, 2)) for a in glob]
        whole = [None if a is None else torch.from_numpy(a) for a in glob]
        path = os.path.join(tmp, name)
        res = {}
        sh = tio.load_sharded(f"{path}.one", cfg, mesh=m22)
        res["pads_one_22"] = shard_padding_ok(sh)
        with torch.inference_mode():
            res["scores_one_22"] = sh.forward(*row[:2]).numpy()
        if c["kind"] == "train":
            res["loss"] = float(sh.train_step(*row, c["lr"]))
            with torch.inference_mode():
                res["scores_trained_22"] = sh.forward(*row[:2]).numpy()
        res["arrays_22"] = checkpoint_arrays(sh)
        tio.save_sharded(f"{path}.2x2", sh)
        again = tio.load_sharded(f"{path}.2x2", cfg, mesh=m22)
        sh14 = tio.load_sharded(f"{path}.2x2", cfg, mesh=m14)
        res["pads_22_22"], res["pads_22_14"] = shard_padding_ok(again), shard_padding_ok(sh14)
        with torch.inference_mode():
            res["scores_22_22"] = again.forward(*row[:2]).numpy()
            res["scores_22_14"] = sh14.forward(*whole[:2]).numpy()
        res["arrays_22_22"] = checkpoint_arrays(again)
        res["arrays_22_14"] = checkpoint_arrays(sh14)
        tio.save_sharded(f"{path}.1x4", sh14)
        out[name] = res
    return out


def run_planner_cases(rank, D, M, inputs_path):
    """The planner tests' sharded forwards on this rank: micro_test (512
    rows) with its dim-32 table split into 2 column parts, and with a
    4-stripe take layout, on the parent's uniform tables (the port's
    seeded reference) and weights; the data row's scores of each."""
    import torch

    from fleetrec_tpu_torch import config as TC
    from fleetrec_tpu_torch import reference as ref
    from fleetrec_tpu_torch.models import init_model
    from fleetrec_tpu_torch.parallel import (ShardedFleetRec, global_mesh, split_table_columns,
                                             split_table_data)

    mesh = global_mesh(D, M, device="cpu")
    data = dict(np.load(inputs_path))
    cfg = TC.micro_test(batch_size=16, rows=512)
    tables = ref.init_tables(cfg, scheme="uniform")
    ws = ref.init_mlp_weights(cfg, scheme="uniform")
    tid = next(t.table_id for t in cfg.tables if t.dim == 32)
    split_cfg, imap = split_table_columns(cfg, tid, 2)
    models = {
        "split": (init_model(split_cfg, tables_np=split_table_data(tables, cfg, tid, 2),
                             mlp_np=ws, device="cpu"), imap),
        "striped": (init_model(dataclasses.replace(cfg, take_stripes=4), tables_np=tables,
                               mlp_np=ws, device="cpu"), np.arange(cfg.num_tables)),
    }
    ids = rows_of(data["idx"], mesh.d, D)
    dense = torch.from_numpy(rows_of(data["dense"], mesh.d, D))
    out = {}
    with torch.inference_mode():
        for name, (model, cols) in models.items():
            sh = ShardedFleetRec(model, mesh)
            out[name] = sh.forward(torch.from_numpy(np.ascontiguousarray(ids[:, cols])),
                                   dense).numpy()
    return out


def run_ici_bench(rank, D, M, mbytes):
    """``ici_bench`` on this rank of a (D, M) gloo world."""
    from fleetrec_tpu_torch.benchmarks import ici_bench
    from fleetrec_tpu_torch.parallel import global_mesh

    return ici_bench(global_mesh(D, M, device="cpu"), mbytes=mbytes, iters=2)


def run_dryrun(rank, D, M):
    """The multi-device dry run (``parallel/dryrun.py``) on this rank."""
    from fleetrec_tpu_torch.parallel import dryrun_multichip, global_mesh

    return dryrun_multichip(global_mesh(D, M, device="cpu"))


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


def run_criteo_mesh(rank, D, M, table_dtype, rows, batches):
    """``chip_smoke.criteo_mesh_rank`` (chip_mesh.py's step 4) on this CPU
    rank, on criteo with every table capped at ``rows`` and the batch sizes
    ``batches`` (the first also the addressing batch): the card calls
    stubbed, ``global_mesh`` on the CPU, the kernel wrappers counted (the
    CPU runs their plain versions), the forward's timing (the card's)
    skipped, no ici_bench.  Returns its results."""
    import torch

    import chip_smoke as cs
    from fleetrec_tpu_torch import config as TC
    from fleetrec_tpu_torch import parallel
    from fleetrec_tpu_torch.models import mlp as mlp_mod
    from fleetrec_tpu_torch.ops.lookup import lookup_fused_plain
    from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp_plain
    from fleetrec_tpu_torch.parallel import sharded

    def counted(kernel, plain):
        def call(*a, **kw):
            kernel.launches += 1
            return plain(*a, **kw)
        return call

    real_mesh, real_criteo = parallel.global_mesh, TC.criteo_terabyte
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.get_device_name = lambda *a: "cpu"
    torch.cuda.memory_allocated = lambda *a: 0
    parallel.global_mesh = lambda D, M, device="cuda": real_mesh(D, M, device="cpu")
    TC.criteo_terabyte = lambda **kw: cap(real_criteo(**kw), rows)
    sharded.lookup_fused = counted(cs.lookup_fused, lookup_fused_plain)
    mlp_mod.fused_mlp = counted(cs.fused_mlp, fused_mlp_plain)
    cs._split_forward = lambda *a, **k: {}
    cs.FULL_BATCHES, cs.B_TIME = batches, batches[0]
    return cs.criteo_mesh_rank(rank, D, M, 15, None, table_dtype)
