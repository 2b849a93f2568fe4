"""chip_smoke.py's phases 14 and 16 (``full_rows_rank``: a configuration
at full rows, built on the card in a process of its own) and its N-sender
``serve_loopback``, rehearsed on the CPU with the take tables capped at
TAKE_CAP rows (just above ``onehot_factor_max``, so every take table stays
in the take tier and every class table stays whole) and the card calls
stubbed (``torch.cuda.synchronize`` and the memory reads; the timings, which
need the card, skipped; the kernel wrappers counted, the CPU running their
plain versions):

* the rank on every run of ``FULL_ROWS`` (model2 float32, model3 int8 served
  on three senders, model2 bfloat16, tiny_dlrm), the checkpoint candidates
  checkpointed: its own checks pass (bytes against the planner, forwards
  and served replies against the pm1 oracle, launches, the addressing of
  every take segment, a checkpoint restored bit-equal), and its forwards
  equal the JAX package's forward over JAX's ``pack_pm1_sharded`` on the same
  ids: bit-equal in float32 towers (the hard gate of bfloat16 tables
  included), the bfloat16 tower within rtol 2e-2 / atol 2e-2 x max|JAX|
  (PERF.md section 2's bf16 tolerance), NaN on the same rows;
* ``serve_loopback`` on capped model3 over three senders (dense on sender
  0, 188 + 188 tables): the replies bit-equal to the JAX package's
  three-sender engine (tests/test_multisender.py:60) fed the same payloads,
  and to the pm1 oracle;
* ``check_addressing`` over float32 and bfloat16 take rows holding the row
  pattern: passes, and a pattern written one row off is caught;
* chip_mesh.py's step 4 (``criteo_mesh_rank``) in int8 and in bfloat16 on a
  (1, 4) gloo world of spawned CPU ranks at capped rows;
* phase 16's pick of the configuration it checkpoints from the free disk."""

import dataclasses
import shutil
import socket
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from fleetrec_tpu import config as JC
from fleetrec_tpu.models import FleetRecModel as JModel
from fleetrec_tpu.models.biginit import pack_pm1_sharded as j_pack_pm1_sharded
from fleetrec_tpu.models.mlp import init_mlp_params as j_init_mlp_params
from fleetrec_tpu.serving import IndexWireFormat as JWire
from fleetrec_tpu.serving import IngestServer as JIngest
from fleetrec_tpu.serving import ServingEngine as JEngine
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import fleetrec as fr_mod
from fleetrec_tpu_torch.models import mlp as mlp_mod
from fleetrec_tpu_torch.models import pack_pm1_sharded
from fleetrec_tpu_torch.models.fleetrec import FleetRecModel, ModelPlan
from fleetrec_tpu_torch.models.mlp import init_mlp_params
from fleetrec_tpu_torch.ops.lookup import lookup_fused_plain
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp_plain
from torch_variants import CPU, cap
from torch_worlds import run_criteo_mesh, spawn_world

# the take tables' rows: onehot_factor_max (131072) is the largest class table
TAKE_CAP = 131_200
# (addressed and timed, served): the first holds model3's 416 edge targets
BATCHES = (512, 64)
SEED = 16
RUNS = {run.tag: run for run in cs.FULL_ROWS}
# PERF.md section 2's bf16 tolerance: rtol 2e-2, atol 2e-2 x max|reference|
BF16_RTOL = BF16_ATOL_OF_MAX = 2e-2


def _counted(kernel, plain):
    """A kernel wrapper that counts a launch and runs the plain version."""
    def call(*a, **kw):
        kernel.launches += 1
        return plain(*a, **kw)
    return call


@pytest.fixture
def capped_cpu(monkeypatch, tmp_path):
    """The card calls stubbed, the wrappers counted, every config's take
    tables capped at TAKE_CAP, the batches BATCHES, the temporary directory
    under tmp_path."""
    for name, fn in (("synchronize", lambda *a, **k: None), ("mem_get_info", lambda *a: (0, 0)),
                     ("memory_allocated", lambda *a: 0), ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(cs, "time_full_rows", lambda *a, **k: None)
    monkeypatch.setattr(cs, "FULL_BATCHES", BATCHES)
    monkeypatch.setattr(fr_mod, "lookup_fused", _counted(cs.lookup_fused, lookup_fused_plain))
    monkeypatch.setattr(mlp_mod, "fused_mlp", _counted(cs.fused_mlp, fused_mlp_plain))
    real = TC.get_config
    monkeypatch.setattr(TC, "get_config", lambda name, **kw: cap(real(name, **kw), TAKE_CAP))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _jax_scores(jcfg, batches):
    """JAX's forward over its pack_pm1_sharded tables and all-ones
    weights."""
    jm = JModel.create(jcfg)
    params = {"tables": j_pack_pm1_sharded(jcfg, jm.layout),
              "mlp": j_init_mlp_params(jcfg.mlp, "ones", dtype=jnp.dtype(jcfg.dtype))}
    # a bfloat16 tower runs op by op: XLA's CPU backend compiles no jitted
    # bf16 x bf16 -> f32 dot
    fwd = jax.jit(jm.forward) if jcfg.dtype == "float32" else jm.forward
    return [np.asarray(fwd(params, jnp.asarray(idx), None if dense is None else jnp.asarray(dense)))
            for idx, dense in batches]


@pytest.mark.parametrize("tag", list(RUNS))
def test_full_rows_rank_capped_against_jax(capped_cpu, tag):
    run = dataclasses.replace(RUNS[tag], checkpoint=tag in cs.CKPT_CANDIDATES)
    out = cs.full_rows_rank(0, run, SEED, device=CPU)
    cfg = run.config(BATCHES[0])
    lay = ModelPlan.create(cfg).layout
    assert max(t.rows for t in cfg.tables) == TAKE_CAP and lay.n_take
    assert out["launches"] == cs._launches(len(BATCHES), len(BATCHES))
    assert out["serve_launches"] == cs._launches(cs.N_SERVE, cs.N_SERVE)
    assert out["targets"] == len(cs.edge_targets(cfg, lay, [(0, lay.take_phys_total)]))
    assert out["max_abs_err"] == 0
    assert ("checkpoint" in out) == run.checkpoint
    if run.checkpoint:
        assert out["checkpoint"]["bytes_on_disk"] >= out["checkpoint"]["array_bytes"] > 0
    # the same ids as the rank's (its rng's first draws)
    rng = np.random.default_rng(SEED)
    batches = [(cs.ids_with_bad(cfg, B, rng), cs.pm1_dense(cfg, B, rng)) for B in BATCHES]
    jcfg = cap(JC.get_config(run.name, batch_size=BATCHES[0], **dict(run.kw)), TAKE_CAP)
    assert set(out["scores"]) == ({"float32"} if cfg.dtype == "float32"
                                  else {cfg.dtype, "float32"})
    for tower, scores in out["scores"].items():
        want = _jax_scores(dataclasses.replace(jcfg, dtype=tower), batches)
        for got, w, (idx, _) in zip(scores, want, batches):
            nan = cs.bad_rows_np(cfg, idx)
            assert nan.any()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(w))
            np.testing.assert_array_equal(np.isnan(got), nan)
            if tower == "float32":
                np.testing.assert_array_equal(got, w)
            else:
                np.testing.assert_allclose(got[~nan], w[~nan], rtol=BF16_RTOL,
                                           atol=BF16_ATOL_OF_MAX * np.abs(w[~nan]).max())


def _pm1_model(cfg):
    """The port's pm1 model of ``cfg`` on the CPU, built as the rank builds it."""
    plan = ModelPlan.create(cfg)
    return FleetRecModel(plan, pack_pm1_sharded(cfg, plan.layout, device=CPU),
                         init_mlp_params(cfg.mlp, "ones", device=CPU))


def test_serve_loopback_three_senders_equals_jax_engine(capped_cpu):
    B, NB = 16, 3
    cfg = TC.get_config("fleetrec_model3", batch_size=B)
    assert max(t.rows for t in cfg.tables) == TAKE_CAP
    jcfg = cap(JC.fleetrec_model3(batch_size=B), TAKE_CAP)
    rng = np.random.default_rng(7)
    batches = [(cs._rand_ids(cfg, B, rng), cs.pm1_dense(cfg, B, rng)) for _ in range(NB)]
    replies, launches, summary = cs.serve_loopback(cfg, _pm1_model(cfg), batches, senders=3)
    assert launches == cs._launches(NB, NB)
    assert [p["bytes"] for p in summary["per_sender"]] == [
        NB * n for n in (B * 64 * 4, B * 188 * 4, B * 188 * 4)]

    # the JAX package's three-sender engine on the same payloads
    jm = JModel.create(jcfg)
    params = {"tables": j_pack_pm1_sharded(jcfg, jm.layout),
              "mlp": j_init_mlp_params(jcfg.mlp, "ones")}
    eng = JEngine.from_model(jm, params, batch_size=B)
    wire = JWire.plan(jcfg, B, 3)
    assert wire.table_splits == (188, 188) and wire.dense_dim == 64
    streams = [b"".join(p) for p in zip(*(wire.payloads(i, d) for i, d in batches))]
    port = cs._free_port(3)
    outs = {}
    with JIngest(wire.bytes_per_sender(), n_slots=4, port_base=port) as ing:
        def send(s):
            with socket.create_connection(("127.0.0.1", port + s), timeout=10) as sock:
                sock.sendall(streams[s])

        ths = [threading.Thread(target=send, args=(s,), daemon=True) for s in range(3)]
        for t in ths:
            t.start()
        eng.run_from_ingest(ing, NB, mode="index", wire=wire,
                            row_limits=[t.rows for t in jcfg.tables],
                            on_done=lambda bid, sc: outs.__setitem__(bid, np.asarray(sc)))
        for t in ths:
            t.join(10)
    for k, (idx, dense) in enumerate(batches):
        np.testing.assert_array_equal(replies[k], outs[k].astype(np.float32))
        np.testing.assert_array_equal(replies[k], cs.pm1_scores(cfg, idx, dense).astype(np.float32))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_addressing_check_on_float_take_rows(table_dtype):
    """check_addressing over float take rows holding the row pattern (the
    integers -128..127, exact in both dtypes): criteo with rows capped at
    30000, 16 stripes; a pattern one row off raises."""
    cfg = dataclasses.replace(cap(TC.criteo_terabyte(batch_size=16, dtype="float32"), 30000),
                              table_dtype=table_dtype)
    plan = ModelPlan.create(cfg)
    lay = plan.layout
    model = FleetRecModel(plan, pack_pm1_sharded(cfg, lay, device=CPU),
                          init_mlp_params(cfg.mlp, "ones", device=CPU))
    targets = cs.edge_targets(cfg, lay, [(0, lay.take_phys_total)])
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(cs.pattern_ids(cfg, targets, 1024, rng))
    dense = torch.from_numpy(cs.pm1_dense(cfg, 1024, rng))
    cs.fill_row_pattern(model.take, 0, chunk_rows=777)
    inside, err = cs.check_addressing(cfg, lay, model.lookup_operands(), ids, dense, targets)
    assert inside == len(targets) and err == 0
    cs.fill_row_pattern(model.take, 1, chunk_rows=777)
    with pytest.raises(AssertionError, match="pattern of its row"):
        cs.check_addressing(cfg, lay, model.lookup_operands(), ids, dense, targets)


@pytest.mark.parametrize("table_dtype", ["int8", "bfloat16"])
def test_criteo_mesh_rank_capped_on_a_gloo_world_of_four(tmp_path, table_dtype):
    """chip_mesh.py's step 4 (``criteo_mesh_rank``) in a (1, 4) gloo world of
    spawned CPU ranks, criteo capped at 30000 rows a table: every rank's
    window bytes equal the planner's, its forwards pass its checks against
    the pm1 oracle (bfloat16: the bf16 tower within the bf16 tolerance, the
    float32-tower gate bit-equal), 1 ``lookup_fused`` and 1 ``fused_mlp``
    call a forward, and the windows hold every edge target once."""
    res = spawn_world(4, run_criteo_mesh, (1, 4, table_dtype, 30000, (1024, 64)), tmp_path)
    assert sum(r["targets_inside"] for r in res) == res[0]["targets"] > 0
    for r in res:
        assert r["launches"] == cs._launches(2, 2)
        assert r["take_bytes"] == res[0]["take_bytes"] > 0
        assert "ici" not in r
    if table_dtype == "bfloat16":
        assert len({r["max_abs_err_bf16"] for r in res}) == 1


@pytest.mark.parametrize("free_gb,pick", [(80, "model3_int8"), (20, "model2_bf16"), (10, None)])
def test_phase_16_checkpoints_the_first_candidate_that_fits_twice(monkeypatch, free_gb, pick):
    """Phase 16 checkpoints model3 (~15.8 GB of arrays) where twice its bytes
    are free, else model2 in bf16 (~7.6 GB), and raises with the numbers
    where neither fits; every run of FULL_ROWS goes through phase_full."""
    free = free_gb * 10**9
    monkeypatch.setattr(cs.shutil, "disk_usage",
                        lambda path: shutil._ntuple_diskusage(free, 0, free))
    calls = []
    monkeypatch.setattr(cs, "phase_full", lambda run, phase, tmp: calls.append(run) or {})
    if pick is None:
        with pytest.raises(AssertionError, match=f"has {free} B free"):
            cs.phase_full_rows("unused")
        assert not calls
        return
    out = cs.phase_full_rows("unused")
    assert list(out) == [run.tag for run in calls] == list(RUNS)
    assert [run.tag for run in calls if run.checkpoint] == [pick]
    assert [dataclasses.replace(run, checkpoint=False) for run in calls] == list(cs.FULL_ROWS)
