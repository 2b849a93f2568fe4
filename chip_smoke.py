#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``fleetrec_tpu_torch``) on one
NVIDIA GPU (written for the H100).

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --phase 17  # the build and phase 17 alone

Builds the port's CUDA kernels from the sources in this checkout (and
prints the seconds the build took) and runs, on cuda:0, with TF32 off:

1. gather: the ``gather_rows`` kernel against its plain PyTorch version,
   bit-equal (float32 / bfloat16 / int8, L in 4..128, N in 512 / 700, ids
   including -1 and R);
2. grouped gather: the ``gather_rows_grouped`` kernel (a ring of
   ``window`` slots of ``group`` rows a block) against the same plain
   version, bit-equal, on that matrix (plus L = 3 and 5, which take its
   4-, 2- and 1-byte copy paths), the clamping cases of tests/test_ops.py,
   three ragged rings at gatherbench's flags (N not a multiple of the
   group, a last block of fewer groups than the window, whole groups of
   -1 and out-of-range ids) and a chunk of three pages of ids on every
   copy path, a 4-byte aligned table,
   rows wider than shared memory, and gatherbench's own shape and flags (a
   [2^20, 128] float32 table, 122880 int64 ids with -1 and out-of-range
   ids among them, chunk 512, group 8, window 8: 240 blocks of 64 groups
   on a ring of 8 slots, 36 KB a block) as well as the kernel's defaults;
3. fused MLP: bf16 ``wgmma`` tiles (m64n128k16, widths 16-128 at
   B = 8192) equal to ``torch.matmul``, then the ``fused_mlp`` kernels
   (one launch a layer) against their plain version at the model1,
   model2, model3, criteo (input padded 845 -> 848) and two ragged towers
   (45-40-24-1, and 45-40-10, which ends in a product) and dlrm_terabyte's
   bottom (13-512-256-128, input padded to 16, ends in a 128-wide product)
   and top (479-1024-1024-512-256-1) towers, B in 1, 77, 700,
   1000, 1024, 4000, 4096, float32 and bfloat16, ReLU off and on, every
   block tile planned on a ragged batch among them (float32 rtol/atol
   1e-5; bfloat16 rtol 2e-2 with atol 2e-2 * max|plain|); the all-ones
   closed forms 68719476736
   (512 wide) and 532575944704 (3968 wide) exactly in both dtypes; ReLU on
   all-positive data equal to no ReLU;
4. fleetrec_model1 at full rows (47 tables, 1.41 GB of float32 tables on
   the device): pm1 tables + all-ones MLP bit-equal to the numpy oracle at
   B = 4096, uniform tables + weights within rtol 1e-3 / atol 2e-3, bad
   take ids NaN-poisoned (rows [5, 9]), launches per forward: 1
   ``lookup_fused``, 0 ``gather_rows``, 1 fused-MLP; both gather kernels
   bit-equal to the plain version on each of the 7 tiers' real inputs
   (packed-buffer views and flat ids at B = 4096, with a few -1 and
   out-of-range ids added), the grouped kernel at its defaults and at
   gatherbench's flags;
5. fused lookup: the ``lookup_fused`` kernel (one launch a call) bit-equal
   to its plain version, features and flags, int32 and int64 ids with -1,
   rows, 2^31 - 1 and -rows - 5 among them, and to the tier-by-tier path
   (``lookup_concat(plan_indices(ids))`` and ``bad_take_rows``) on: phase
   4's model1 at B = 1024 (the served batch: 2 rows a tile) and 4096 (10
   rows a tile); fleetrec_model3 (int8 tables, dense 64, 3968
   wide) with its take tables capped at 1M rows (every tier kept: a plain
   class, four factored classes, two take groups), B = 4096; a
   criteo-shaped config (bf16, 16 stripes, 845 wide, dense 13) with rows
   capped at 100000; the QR variant of micro_test; dlrm_terabyte's
   dense-free dot layout (fp32, 26 x 128 wide, 10 one-hot tables and 16
   take tables in 16 stripes) at 1M rows a table, B = 1024 and 4096;
6. serve: ``serving.compose.serve`` for model1 (B = 1024, replies on) in a
   thread, 4 index batches sent over loopback, the replied scores equal to
   the oracle, one ``lookup_fused`` and one ``fused_mlp`` launch a batch;
7. tools, through ``cli.main`` at model1's full rows: ``gatherbench`` at
   its defaults, ``export`` -> ``io.load_npz`` (buffers and scores
   bit-equal to phase 4's model), ``bench --stage e2e|lookup|mlp --ckpt``
   at B = 4096, ``servebench`` at B = 1024 for 2 s;
8. feature mode: ``ServingEngine.mlp_only`` on parity_synthetic(3968) fed
   by three senders over loopback, every score the closed form;
9. interaction heads: micro_dlrm (also onehot_max=70 with 4 stripes) and
   micro_cross (two full-rank layers; one layer at rank 4) on pm1 tables
   and all-ones weights bit-equal to the oracle; dlrm_terabyte at full
   widths with every table capped at 1M rows (3.64 GB of fp32 tables on
   the device), uniform tables, weights and dense, B = 4096: within rtol
   1e-3 / atol 2e-3 of the oracle and rtol / atol 1e-5 of the same forward
   composed from the plain versions, bad take ids NaN-poisoned (rows
   [5, 9]), launches per forward 1 ``lookup_fused``, 2 ``fused_mlp`` (bottom
   and top tower), 0 gathers; bf16 at 100000 rows a table within rtol 2e-2
   / atol 2e-2 * max|oracle|; served at B = 1024 over loopback with replies
   bit-equal to direct forwards; ``cli bench --stage e2e|lookup|mlp`` at 1M
   rows, and ``cli export`` -> ``io.load_npz`` of micro_dlrm and
   micro_cross bit-equal;
10. bags: ``lookup_fused_bags`` (the bag form of the fused lookup, one
   launch a call) bit-equal to its plain version, features and flags, and
   within the stated tolerance of the path it replaces
   (``pooled_lookup_concat(plan_bags(ids))`` and ``pooled_bad_rows``) on
   model1 at full rows (B = 4096 and 1024, L = 8 and 1), model3 (int8), the
   criteo-shaped config (bf16, the element path) and the QR variant at
   L = 4, model1 and the criteo-shaped config at L = 3 (tiles of ids that
   start and end off 16-byte lines), sum and mean pooling, int32 and int64
   ids with padding, empty bags, ids below -1 and out-of-range ids; bags
   whose only members are out of range (+0, their rows flagged) and bags
   whose first member reads -0.0 (micro_test, float32 and bfloat16: the
   sign kept); L = 1 bit-equal to ``lookup_fused``; model1's pooled forward at B = 4096, L = 8 bit-equal
   to the float64 oracle (sum; mean within rtol 1e-5 and atol 352 * 2^-24 *
   max|oracle|), NaN on exactly the
   rows with a bad take id, 1 ``lookup_fused_bags``, 0 ``lookup_fused``, 0
   gathers and 1 ``fused_mlp`` a forward; served with ``bag_L = 8`` over
   loopback (4 batches x 1024, also with fuse = 2, and ``cli serve --bag-l``
   against ``cli loadgen --bag-l``), replies bit-equal to direct
   ``forward_pooled`` calls; a dot config refused;
11. training: ``lookup_fused_backward`` (the lookup's backward kernel)
   against its plain version on phase 4's model1 and on dlrm_terabyte's
   dense-free layout at B = 4096 and on micro_test's striped, QR and bf16
   layouts, int32 and int64 ids with bad ones: integer cotangents
   bit-equal, uniform ones within rtol 1e-5 / atol 1e-4 (bf16: rtol 2^-7);
   ``Trainer`` (Adagrad 1e-2) on model1 at full rows (uniform fp32 tables
   and weights) for 10 steps and on dlrm_terabyte at 1M rows a table for
   3, each on one seeded batch of 4096: the loss falls, every step
   launches 1 ``lookup_fused`` and 1 ``lookup_fused_backward`` and calls no
   plain version, and the first step matches the same step through the
   plain lookup and backward (loss bit-equal, every tensor within rtol
   1e-5 / atol 1e-6); the trained model1 served over loopback, replies
   bit-equal to direct forwards, ``forward_train`` within rtol / atol 1e-5
   of ``forward``; then each step's wall time and its device time by part
   (lookup fwd, towers and heads fwd, loss, towers and heads bwd, gradient
   zeroing, lookup bwd, Adagrad), the backward kernel against its plain
   version, ``index_add_`` and its byte bound; the step's device busy time,
   idle share and split from the profiler after the report's timings;
12. sharded serving (``parallel/``): (1) ``lookup_fused`` and
   ``lookup_fused_bags`` (bags of 8) in their row-window form, on every
   model shard m of M = 2 and 4 (``shard_operands``: the shard's class
   tables, take rows and descriptors), bit-equal to their plain versions,
   features and flags, the flags the unsharded ones and the shards'
   features summing to the unsharded lookup, on phase 4's model1 at B =
   4096 and phase 5's model3 (int8, take tables at 1M rows); (2) a (data=1,
   model=2) world of two spawned ranks on this one card over gloo (the
   exchange staged through host memory): model1 at full rows from an npz
   checkpoint, pm1 / ones, B = 4096, both ranks bit-equal to the float64
   oracle and to the single-device forward (the feature exchange:
   H1 = 1024 > F = 352), ``forward_pipelined`` of 4 batches bit-equal to
   ``forward``, ``forward_pooled`` with bags of 8 equal to one device's,
   bad ids NaN on rows [5, 9], 1 ``lookup_fused`` and 1 ``fused_mlp`` launch
   a sharded forward (1 ``lookup_fused_bags`` pooled); (3) the same world on
   model3 pm1 / ones (the W1-partial exchange, [B, 2048]), bit-equal to the
   oracle; (4) ``cli serve --mesh 1,2 --procs 2 --backend gloo`` on full-row
   model1 (``--ckpt``) and ``--mesh 2,2 --procs 4 --fuse 2`` on model1 at
   100000 rows a table, 4 batches x 1024 rows a data row sent to each
   leader's port over loopback, the replies bit-equal to the oracle; (5) an
   ``nccl`` world of one rank, (1, 1), whose sharded forward is bit-equal to
   the single-device forward; then rank 0's time split of a sharded forward
   (window lookup, W1-partial matmul, the exchange's wall time and bytes,
   tower) for model1 and model3, and ``forward_pipelined`` of 4 batches
   against 4 forwards.  The sharded training step: (1b)
   ``lookup_fused_backward`` in its row-window form on every shard m of M =
   2 and 4 of model1 (full rows) and dlrm_terabyte (1M rows a table), B =
   4096, integer cotangents: bit-equal to its plain version, the shards'
   gradients placed at their windows bit-equal to the unsharded backward's;
   in the same (1, 2) world ``ShardedFleetRec.train_step`` (SGD) on model1
   at full rows (the feature exchange) and model3 in float32 with take
   tables at 1M rows (the fold path), uniform tables and weights, B = 4096,
   then (6) a (2, 2) world of model1 at 100000 rows a table (the gradient
   sums over the model column): each rank's step launches 1
   ``lookup_fused`` and 1 ``lookup_fused_backward`` and calls no plain
   version, and matches the same step of ``Trainer(model, optimizer=SGD)``
   on one device (the loss bit-equal on the one-row feature exchange, else
   within rtol 1e-6; every tensor of the shard within rtol 1e-5 / atol
   1e-6, pad tables and rows 0); then 2 more steps and rank 0's step split
   (window lookup forward and backward, W1-partial, the exchange, the
   post's forward and backward, each gradient all_reduce's bytes and time,
   SGD).  Every rank is a spawned process with a deadline; a rank that
   fails fails the phase;
13. report: the card's name and power limit, each kernel's median time
   against its plain version at the model1 shapes and at gatherbench's
   shape and flags, ``fused_mlp`` in both dtypes at model1 and model3
   widths, B = 4096 and 1024, and at dlrm's bottom and top towers (ReLU)
   at B = 4096, ``lookup_fused`` at model1 B = 1024 and 4096, model3 and
   dlrm B = 4096, and ``lookup_fused_bags`` at model1 B = 4096 and 1024 for
   L = 1, 4, 8 and model3 L = 4, each beside the path it replaced and the
   kernel on the id draws every id 0 and skewed (``draw_bags``), and
   both in their window form on phase 12's shard 0 of 2 (bound at the
   shard's bytes; the backward's window form too, beside ``index_add_``
   into the shard's sums) (CUDA events over
   CUDA-graph replays, so host
   dispatch is out of the kernel-against-plain comparison; eager
   back-to-back calls and the profiler's device time beside them), each
   beside its bound (the larger of its bytes, each counted once, over 3.35
   TB/s and its FLOPs over the dtype's peak: the H100 SXM data sheet) and
   one PyTorch call computing the same function, timed as a yardstick only
   (``index_select`` for the gathers, ``torch.linalg.multi_dot`` for the
   towers, which run with no activation, as model1's does, and without
   the ReLU of dlrm's, so there only a yardstick; none computes the fused
   lookup), and the model1 and dlrm forwards' ms/batch at B = 1024 and
   4096, eager and replayed from a CUDA graph, with their kernel launches,
   the fused-MLP kernels' share of model1's device time and dlrm's device
   time split into the lookup, the bottom tower, the interaction's torch
   ops, the top tower and the poison;
14. criteo_terabyte at full cardinality (``full_rows_rank`` of
   ``CRITEO_FULL``): every
   earlier model dropped and the allocator's cache emptied, then a process
   of its own on the card (so the card holds nothing else and the peak
   host memory read is this phase's): 26 tables of int8 pm1 rows
   (1,655,169,127 rows, one of 1e9; 9 take tables in 16 stripes, 7
   factored, 10 one-hot) generated on the card by ``pack_pm1_sharded``, the
   build timed; the take buffer's bytes equal to ``plan(cfg,
   1).take_bytes_total`` (52,962,791,424), the class bytes to its
   ``onehot_bytes``, ``memory_allocated`` at most its ``per_chip_bytes``;
   forwards at B = 4096 and 1024 (uniform ids over every table, bad ids on
   rows 1-4) bit-equal to the pm1 oracle with NaN on exactly the rows with
   a bad take id, 1 ``lookup_fused`` and 1 ``fused_mlp`` launch each;
   4 batches of 1024 served over loopback bit-equal to the oracle; then
   the take rows overwritten with a pattern that spells each row's buffer
   index (``fill_row_pattern``: pm1 rows are alike, so they cannot show
   which row was read) and ``lookup_fused`` held bit-equal to
   ``lookup_fused_plain`` and to the pattern of the rows the layout's own
   map names, on ids that reach the first and last rows of every (stripe,
   table) segment, the last buffer row and the 1e9-row table's last id
   past 4 GiB of offset (``edge_targets``); the peak host RSS at most
   16 GiB; the lookup's time at random ids, every id 0 and take ids
   inside a 1 GiB footprint, beside its bound and (random ids) its plain
   version, and the forward's device time by part (lookup, tower, poison);
15. sharded checkpoints (``io.save_sharded`` / ``io.load_sharded`` on
   ``torch.distributed.checkpoint``; it runs after phase 13, before phase 14
   takes the card to itself): phase 4's model1 (full rows, pm1 / ones) saved
   from the card and restored onto it, every array bit-equal and the
   forwards at B = 4096 and 1024 bit-equal to the float64 oracle and to the
   scores before the save, 1 ``lookup_fused`` and 1 ``fused_mlp`` launch a
   restored forward; its int8 form (``quantize_tables``) the same, tables
   and scales; a (data=1, model=2) world of two ranks on this card over
   gloo restoring the one-device checkpoint onto the mesh (twice: the first
   load carries the ranks' first use of DCP) with both ranks' scores
   bit-equal, then saving from the mesh, that checkpoint restored onto one
   device bit-equal; each save's and load's seconds, GB/s and bytes on disk
   beside the card's name and power limit (loads read what was just
   written: page-cache warm);
16. the paper's geometries and tiny_dlrm at full rows and full widths
   (``FULL_ROWS``, after phase 14), each in a process of its own as phase
   14 (``full_rows_rank``): fleetrec_model2 (98 tables, 880 wide, float32,
   15.05 GB of take rows), fleetrec_model3 (377 = 376 tables + 64 dense,
   3968 wide, int8 tables with the float32 tower, 15.68 GB), model2 in
   bfloat16 (bf16 tables and a bf16 tower, 7.52 GB) and tiny_dlrm (8 x 1M
   rows x 16); pm1 tables generated on the card, bytes against the
   planner, forwards at B = 4096 and 1024 bit-equal to the pm1 oracle with
   NaN on exactly the bad rows (model2 bf16: the hard gate, the same
   tables under a float32 tower, bit-equal, and the bf16 tower within rtol
   2e-2 / atol 2e-2 * max|oracle|, its error printed), 1 ``lookup_fused``
   and 1 ``fused_mlp`` call a forward and no plain call; 4 batches of 1024
   served over loopback, model3 on the paper's three-sender wire (64 dense
   floats on sender 0, two senders of 188 tables), replies bit-equal to the
   oracle (bf16: the gate's; the bf16 tower's equal to its direct
   forwards); the addressing check of phase 14 over float32, int8 and bf16
   take rows; the lookup against its plain version and its bound, each
   forward's time (graph and eager) and device split; the first of
   ``CKPT_CANDIDATES`` (model3, else model2 in bf16) whose arrays fit
   twice in the temporary directory saved with ``io.save_sharded`` (~15.8
   GB, pieces past 4 GiB of offset) and restored on the card, every array
   bit-equal (its take rows holding the index pattern), the restored
   forward bit-equal to the saved model's and, the take rows written back
   as pm1, to the oracle; save and load seconds and GB/s;
17. MLPerf DLRM-DCNv2 at full rows (``dcnv2_rank``, after phase 16, in a
   process of its own): the configuration of the benchmark's cell
   ``dcnv2_bf16.b2048.stream`` (26 bf16 tables, 204,184,588 rows x 128,
   52.27 GB; 214-id ragged bags; the bottom tower 13-512-256-128 with its
   last ReLU; 3 cross layers of rank 512 over 3456; the top tower
   3456-1024-1024-512-256-1; biases; float32) built on the card as the
   benchmark builds it, at B = 2048 on the benchmark's inputs:
   ``lookup_fused_ragged`` bit-equal to ``lookup_fused_ragged_plain``
   (features and flags) on the pool's ids, every id 0 and ids with
   padding, last rows and out-of-range members; ``fused_mlp`` with biases
   (bottom with ``last_activation``, top) bit-equal to ``fused_mlp_plain``
   on small-integer data and within 1e-4 of it on the model's weights;
   ``cross_tail`` bit-equal to ``cross_tail_plain`` at [2048, 3456]; the
   forward's launches (1 ``lookup_fused_ragged``, 2 ``fused_mlp``, 3
   ``cross_tail``, no plain call), within 1e-4 of its plain composition
   and within the cell's ``max_err`` of the benchmark's float64 reference,
   a bad take member NaN on its row only; 4 batches served over loopback
   with ``ServeSpec.bag_sizes`` (graph replays), replies bit-equal to
   direct forwards, launches 1, 2 and 3 a batch; each kernel's time
   against its plain version, its bound and a library yardstick (the ragged
   kernel also on every id 0 and beside the bag kernel on the bags padded
   to 100), and the forward's ms a batch, eager and from a CUDA graph.

In phases 6-12 and 14-17 the kernels' launch counters are zeroed just before
each path runs and read just after (in phases 12 and 15 inside each rank);
each kernel of the path must have launched.
A counter counts wrapper calls that launched a kernel: eager calls, and
the calls recorded while a CUDA graph is captured.  Replays of a graph
add nothing, so ``gather_rows``' and ``gather_rows_grouped``'s counts from
``gatherbench`` (one graph of 16 steps: 16 warm-up calls plus 16 captured)
say nothing of the replays it timed.
Every phase raises on failure.  The second-to-last line is the kernels'
JSON record, the last line ``{"ok": true, "device": {...}}``.  Exits
nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from fleetrec_tpu_torch.models import init_model, pack_pm1_sharded
from fleetrec_tpu_torch.models.biginit import fill_pm1_take, take_segments
from fleetrec_tpu_torch.models.embedding import TORCH_DTYPES, lookup_concat, tier_gathers
from fleetrec_tpu_torch.models.fleetrec import FleetRecModel, ModelPlan, trainable_tensors
from fleetrec_tpu_torch.models.pooled import (plan_bags, pooled_bad_rows,
                                              pooled_lookup_concat)
from fleetrec_tpu_torch.ops import _build
from fleetrec_tpu_torch.ops.gather import (gather_rows, gather_rows_grouped,
                                          gather_rows_plain)
from fleetrec_tpu_torch.models.mlp import init_mlp_params
from fleetrec_tpu_torch.models.train import Trainer, bce_with_logits
from fleetrec_tpu_torch.ops import lookup as lookup_mod
from fleetrec_tpu_torch.ops.cross import cross_tail, cross_tail_plain
from fleetrec_tpu_torch.ops.lookup import (LOOKUP_COL_FIELDS, lookup_fused,
                                          lookup_fused_backward, lookup_fused_backward_plain,
                                          lookup_fused_bags, lookup_fused_bags_plain,
                                          lookup_fused_plain, lookup_fused_ragged,
                                          lookup_fused_ragged_plain, lookup_offsets_plain,
                                          lookup_out_dtype, pad_ragged)
from fleetrec_tpu_torch.ops.mlp_fused import (PRODUCT, TILES, fused_mlp,
                                             fused_mlp_plain, mlp_plan)
from fleetrec_tpu_torch.parallel import planner
from fleetrec_tpu_torch.serving import (IndexWireFormat, IngestServer, Loadgen, ServeSpec,
                                        ServingEngine, serve)

B_TIME = 4096
B_SERVE = 1024
N_SERVE = 4
# the bag phase: slots a bag at model1 (served and timed) and at the other
# layouts, and the lengths the report times
BAG_L, BAG_L_SMALL, BAG_LS = 8, 4, (1, 4, 8)
# servebench offers this share of the e2e bench's device rate: the served
# path runs eager forwards, several times the device time (PERF.md)
SERVE_SHARE = 0.02
# gatherbench's default shape: a [2^20, 128] float32 table, 122880 rows,
# and its default flags for the grouped kernel
GB_ROWS, GB_N = 1 << 20, 4096 * 30
GB_FLAGS = {"chunk": 512, "group": 8, "window": 8}
# row caps of the fused-lookup phase: model3's take tables at bench.py's
# model3 operating point (its class tables stay whole), criteo's tables
LOOKUP_CAPS = {"fleetrec_model3": 1_000_000, "criteo_terabyte": 100_000}
# dlrm_terabyte's row caps for one card: every table at 1M rows (3.64 GB of
# fp32 tables; the full 882.8M rows would be 452 GB), and 100000 in bf16
DLRM_ROWS, DLRM_BF16_ROWS = 1_000_000, 100_000


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


def ragged_rings(R, rng):
    """Ids that leave the ring ragged at gatherbench's flags: N not a
    multiple of the group (701 = 87 groups + 5 rows), a last block holding
    fewer groups than the window (536 = one block + 3 groups), and whole
    groups of -1 and of out-of-range ids (rows 8-15 and 520-527)."""
    cases = {"N % group": rng.integers(0, R, 701),
             "last block < window": rng.integers(0, R, 536)}
    ids = rng.integers(0, R, 700)
    ids[8:16] = -1
    ids[520:528] = R
    cases["a group of bad ids"] = ids
    return cases


def gatherbench_inputs(dev):
    """gatherbench's default table and one step's ids (int64, as the
    command passes them)."""
    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.standard_normal((GB_ROWS, 128)).astype(np.float32)).to(dev)
    return table, torch.from_numpy(rng.integers(0, GB_ROWS, GB_N)).to(dev)


def phase_grouped(dev, gb) -> float:
    """gather_rows_grouped kernel == plain version, bit for bit: the phase-1
    matrix (plus L = 3 and 5, whose rows take the 4-, 2- and 1-byte copy
    paths), the ragged rings at gatherbench's flags and a chunk of three
    pages of ids on every copy path, the clamping cases of
    tests/test_ops.py, a table whose base is only 4-byte aligned, rows
    wider than shared memory, and gatherbench's table and ids ``gb`` (with
    -1 and out-of-range ids at block edges) at gatherbench's flags and at
    the kernel's defaults."""
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
    for dtype, L in ((torch.float32, 128), (torch.float32, 5), (torch.bfloat16, 3),
                     (torch.int8, 3)):  # bulk, 4-, 2- and 1-byte copies
        vals = np.clip(np.rint(rng.standard_normal((R, L)) * 40), -127, 127)
        table = torch.from_numpy(vals.astype(np.float32)).to(dev, dtype)
        for what, ids in ragged_rings(R, rng).items():
            idx = torch.from_numpy(ids).to(dev)
            worst = max(worst, _check_grouped(table, idx, f"{what} {dtype} L={L}", **GB_FLAGS))
            if what == "a group of bad ids" and gather_rows_grouped(
                    table, idx, **GB_FLAGS)[[*range(8, 16), *range(520, 528)]].any():
                raise AssertionError("a group of bad ids must give zero rows")
            n_cases += 1
        # a chunk of three pages of ids (1024 + 1024 + 952 rows)
        idx = torch.from_numpy(rng.integers(-1, R + 1, 3000)).to(dev)
        worst = max(worst, _check_grouped(table, idx, f"pages {dtype} L={L}", chunk=4096,
                                          group=16, window=8))
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
    bad_at = torch.tensor([0, 511, 512, 4095, 61443, GB_N - 1], device=dev)  # block edges
    idx_bad = idx_gb.clone()
    idx_bad[bad_at] = torch.tensor([-1, GB_ROWS, GB_ROWS + 7, -GB_ROWS, 1 << 40, -1],
                                   device=dev)
    for ids in (idx_gb, idx_bad):
        for kw in (GB_FLAGS, {}):
            worst = max(worst, _check_grouped(table_gb, ids, f"gatherbench shape {kw}", **kw))
    if gather_rows_grouped(table_gb, idx_bad, **GB_FLAGS)[bad_at].abs().sum().item() != 0:
        raise AssertionError("gatherbench shape: out-of-range ids must give zero rows")
    log(f"phase 2 grouped gather: {n_cases + 6} cases bit-equal to the plain "
        f"version, the ragged rings, three pages of ids, and gatherbench's "
        f"[{GB_ROWS}, 128] table and {GB_N} ids at {GB_FLAGS} and at the "
        f"defaults among them (max_abs_err {worst}); out-of-range ids give "
        f"zero rows")
    return worst


# the towers of the repo's configs and two ragged ones (every width padded;
# ragged_wide ends in a 10-wide product, not a row-dot, as dlrm's bottom
# tower ends in a 128-wide one)
MLP_WIDTHS = {"model1": (352, 1024, 512, 256, 1), "model2": (880, 1024, 512, 256, 1),
              "model3": (3968, 2048, 512, 256, 1),
              "criteo": (845, 1024, 1024, 512, 256, 1), "ragged": (45, 40, 24, 1),
              "ragged_wide": (45, 40, 10),
              "dlrm_bottom": (13, 512, 256, 128), "dlrm_top": (479, 1024, 1024, 512, 256, 1)}
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
    Returns the worst float32 and bfloat16 errors, and each tower's as
    {(name, dtype): error}."""
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
    by_tower = {}
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
                    by_tower[name, dtype] = max(by_tower.get((name, dtype), 0.0), err)
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
        f"relu == none on positive data; dlrm towers fp32 max_abs_err "
        f"{by_tower['dlrm_bottom', torch.float32]} / {by_tower['dlrm_top', torch.float32]}, "
        f"bf16 {by_tower['dlrm_bottom', bf]} / {by_tower['dlrm_top', bf]}")
    return worst[torch.float32], worst[bf], by_tower


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
    its tables and weights, the worst gather error on the tiers and the
    model of uniform tables and weights (which the training phase trains)."""
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
    del tabs_u

    tabs = ref.init_tables(cfg, "pm1")
    ws = ref.init_mlp_weights(cfg, "ones")
    model = init_model(cfg, tables_np=tabs, mlp_np=ws, device=dev)
    packed = model.packed
    table_bytes = sum(b.numel() * b.element_size()
                      for b in packed.onehot_buffers + [packed.take_buffer])
    gather_rows.launches = fused_mlp.launches = lookup_fused.launches = 0
    with torch.inference_mode():
        s = model(idx_t).cpu().numpy()
    per_fwd = (lookup_fused.launches, gather_rows.launches, fused_mlp.launches)
    if per_fwd != (1, 0, 1):
        raise AssertionError(f"launches per forward (lookup_fused, gather_rows, "
                             f"fused_mlp) {per_fwd}, want (1, 0, 1)")
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
        f"lookup_fused {per_fwd[0]}, gather_rows {per_fwd[1]}, fused_mlp "
        f"{per_fwd[2]}; bad ids -> NaN "
        f"rows {nan_rows}; gather_rows and gather_rows_grouped (defaults and "
        f"{GB_FLAGS}) kernels bit-equal to the plain version on the 7 tiers' "
        f"inputs (uniform tables, with -1 / out-of-range ids; max_abs_err "
        f"{err_g} / {err_gg}) "
        f"({time.time() - t0:.1f}s)")
    return cfg, model, tabs, ws, err_g, err_gg, model_u


def _cap(cfg, rows):
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, rows=min(t.rows, rows)) for t in cfg.tables))


def ids_with_bad(cfg, B, rng):
    """Uniform in-range ids [B, T] (int32) with bad ones at rows 1-4: -1,
    the table's rows and 2^31 - 1 each in every third column, -rows - 5 in
    every column of row 4."""
    ids = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1)
    for j, t in enumerate(cfg.tables):
        ids[1 + j % 3, j] = (-1, t.rows, 2**31 - 1)[j % 3]
        ids[4, j] = -t.rows - 5
    return ids.astype(np.int32)


# the backward's id draws: uniform, every id 0 (the most adds on one row),
# skewed
ID_DRAWS = ("uniform", "ids0", "skew")


def draw_ids(cfg, B: int, rng, draw: str) -> np.ndarray:
    """In-range ids [B, T] int32 of one draw of ID_DRAWS: ``uniform`` in
    [0, rows), ``ids0`` every id 0, ``skew`` a Zipf draw ``(zipf(1.1) - 1) %
    rows`` per table (about a tenth of the batch on row 0, as click logs
    skew)."""
    if draw == "uniform":
        return np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    if draw == "ids0":
        return np.zeros((B, cfg.num_tables), np.int32)
    if draw == "skew":
        return np.stack([(rng.zipf(1.1, B) - 1) % t.rows for t in cfg.tables],
                        1).astype(np.int32)
    raise KeyError(draw)


def bags_with_bad(cfg, B, L, rng):
    """Bags [B, T, L] (int32) of uniform in-range ids in random prefix
    lengths of 0 .. L (0: an empty bag), -1 after the prefix.  Row 0 is
    empty in every table.  In every third column in turn, slot 0 of rows
    1-3 holds an id below -1 (padding too), the table's rows (out of
    range: a take table's flags the row) and 2^31 - 1; row 4 has a hole
    (-1) in slot 0 of every bag, before its members.  Needs B >= 5."""
    T = cfg.num_tables
    rows = np.asarray([t.rows for t in cfg.tables])
    ids = (rng.random((B, T, L)) * rows[None, :, None]).astype(np.int64)
    lens = rng.integers(0, L + 1, (B, T))
    ids[np.arange(L)[None, None, :] >= lens[:, :, None]] = -1
    ids[0] = -1
    for j, t in enumerate(cfg.tables):
        ids[1 + j % 3, j, 0] = (-t.rows - 5, t.rows, 2**31 - 1)[j % 3]
    ids[4, :, 0] = -1
    return ids.astype(np.int32)


def make_bags(cfg, B, L, seed=0, all_empty_row=None):
    """(bags [B, T, L] int32, dense [B, dense_dim] of -1 / 1 or None): a
    random prefix of 1 .. L in-range ids a bag, -1 after it (what ``loadgen
    --bag-l`` sends); ``all_empty_row``: a batch row whose bags are all
    empty."""
    rng = np.random.default_rng(seed)
    rows = np.asarray([t.rows for t in cfg.tables])
    idx = (rng.random((B, cfg.num_tables, L)) * rows[None, :, None]).astype(np.int32)
    lens = rng.integers(1, L + 1, (B, cfg.num_tables))
    idx[np.arange(L)[None, None, :] >= lens[:, :, None]] = -1
    if all_empty_row is not None:
        idx[all_empty_row] = -1
    dense = (rng.choice([-1.0, 1.0], (B, cfg.dense_dim)).astype(np.float32)
             if cfg.dense_dim else None)
    return idx, dense


# the bag lookup's id draws: loadgen's prefixes of uniform ids, every id 0
# (every slot a member reading row 0), loadgen's prefixes of skewed ids
BAG_DRAWS = ("loadgen", "ids0", "skew")


def draw_bags(cfg, B: int, L: int, draw: str, seed: int = 0) -> np.ndarray:
    """Bags [B, T, L] int32 of one draw of BAG_DRAWS: ``loadgen`` is
    ``make_bags``' ids, ``ids0`` every id 0, ``skew`` the same prefixes as
    ``loadgen`` holding ``(zipf(1.1) - 1) % rows`` draws per table (as
    ``draw_ids``' skew)."""
    idx = make_bags(cfg, B, L, seed)[0]
    if draw == "loadgen":
        return idx
    if draw == "ids0":
        return np.zeros_like(idx)
    if draw == "skew":
        rng = np.random.default_rng(seed + 1)
        rows = np.asarray([t.rows for t in cfg.tables])
        zipf = ((rng.zipf(1.1, idx.shape) - 1) % rows[None, :, None]).astype(np.int32)
        return np.where(idx >= 0, zipf, idx)
    raise KeyError(draw)


def pooled_oracle(cfg, tables, weights, idx, dense, mean=False):
    """float64 scores of bags [B, T, L] (a negative id is padding): per
    table the sum (mean: over its members) of the rows its bag reads at the
    table's out_offset, the dense tail, the MLP chain."""
    B, _T, L = idx.shape
    feats = np.zeros((B, cfg.feature_dim), np.float64)
    for j, t in enumerate(cfg.tables):
        pooled = np.zeros((B, t.dim), np.float64)
        cnt = np.zeros(B)
        for l in range(L):
            v = idx[:, j, l] >= 0
            pooled[v] += tables[j][idx[v, j, l]]
            cnt += v
        if mean:
            nz = cnt > 0
            pooled[nz] /= cnt[nz, None]
        feats[:, t.out_offset : t.out_offset + t.dim] = pooled
    if cfg.dense_dim:
        feats[:, cfg.feature_dim - cfg.dense_dim :] = dense
    return ref.mlp_chain(feats, weights, cfg.mlp.activation)[:, 0]


def _dense(width, B, rng, dev):
    """Uniform dense features [B, width] on ``dev``, or None for width 0."""
    if not width:
        return None
    return torch.from_numpy(rng.uniform(-1, 1, (B, width)).astype(np.float32)).to(dev)


def bits(t):
    """A tensor's bits, for bit-for-bit comparison (NaN and -0 included)."""
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def check_lookup(model, idx, dense, what) -> float:
    """model.lookup (one lookup_fused launch) == lookup_fused_plain on the
    same operands and == the tier-by-tier path (lookup_concat(plan_indices)
    through gather_rows, and bad_take_rows), bit for bit: features and
    flags.  Returns the max abs error of the features (0)."""
    before = lookup_fused.launches
    got, bad = model.lookup(idx, dense)
    if lookup_fused.launches != before + 1:
        raise AssertionError(f"lookup_fused did not launch once: {what}")
    want, want_bad = lookup_fused_plain(idx, dense, **model.lookup_operands())
    gi = model.plan_indices(idx)
    tiers, tiers_bad = lookup_concat(model.packed, gi, dense), model.bad_take_rows(gi)
    torch.cuda.synchronize()
    for name, f, b in (("plain", want, want_bad), ("tiers", tiers, tiers_bad)):
        if got.dtype != f.dtype or not torch.equal(bits(got), bits(f)):
            raise AssertionError(f"lookup_fused features differ from the {name} path: {what}")
        if (bad is None) != (b is None) or (bad is not None and not torch.equal(bad, b)):
            raise AssertionError(f"lookup_fused flags differ from the {name} path: {what}")
    return (got.float() - want.float()).abs().max().item()


def lookup_models(dev):
    """{name: (cfg, model)} of the fused-lookup phase besides model1:
    model3 (int8, dense 64) and criteo (bf16, 16 stripes) at LOOKUP_CAPS,
    and the QR variant of micro_test; uniform tables."""
    cfgs = {name: _cap(C.get_config(name, batch_size=B_TIME), rows)
            for name, rows in LOOKUP_CAPS.items()}
    cfgs["qr"] = dataclasses.replace(C.micro_test(batch_size=B_TIME), onehot_max=8,
                                     qr_threshold=80, qr_rem=16)
    return {name: (cfg, init_model(cfg, table_scheme="uniform", mlp_scheme="uniform",
                                   device=dev))
            for name, cfg in cfgs.items()}


def phase_lookup(dev, model1, dlrm):
    """lookup_fused == plain == the tier-by-tier path on phase 4's model1 and
    the fp32 dlrm_terabyte model ``dlrm`` (the dense-free dot layout) at
    B = 1024 (the served batch) and 4096, and on lookup_models at B = 4096,
    int32 and int64 ids with bad ones.  Returns the worst error
    and every model's (cfg, model), which the bag phase checks and the
    report times."""
    t0 = time.time()
    rng = np.random.default_rng(10)
    models = {"fleetrec_model1": (model1.cfg, model1), **lookup_models(dev),
              "dlrm_terabyte": dlrm[:2]}
    worst, notes = 0.0, []
    with torch.inference_mode():
        for name, (cfg, model) in models.items():
            served = name in ("fleetrec_model1", "dlrm_terabyte")
            for B in (B_SERVE, B_TIME) if served else (B_TIME,):
                ids = ids_with_bad(cfg, B, rng)
                # the lookup's dense tail (the dot layout has none)
                dense = _dense(model.layout.dense_dim, B, rng, dev)
                for idt in (torch.int32, torch.int64):
                    idx = torch.from_numpy(ids).to(dev, idt)
                    worst = max(worst, check_lookup(model, idx, dense, f"{name} B={B} {idt}"))
            lay = model.layout
            notes.append(f"{name} ({cfg.table_dtype}, {lay.feature_dim} wide, "
                         f"{len(lay.onehot_classes)} classes, {len(lay.take_groups)} "
                         f"take groups, {lay.take_stripes} stripes, dense {lay.dense_dim})")
    log(f"phase 5 fused lookup: lookup_fused bit-equal to its plain version and to "
        f"the tier-by-tier path, features and flags, int32 and int64 ids with bad "
        f"ones, B={B_TIME} (model1 and dlrm also B={B_SERVE}): {'; '.join(notes)} (max_abs_err {worst}; "
        f"{time.time() - t0:.1f}s)")
    return worst, models


def _free_port(n: int = 1) -> int:
    """A port p with p .. p + n - 1 free on the loopback."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + n > 65536:
            continue
        try:
            with contextlib.ExitStack() as stack:
                for q in range(p + 1, p + n):
                    stack.enter_context(socket.socket()).bind(("127.0.0.1", q))
            return p
        except OSError:
            continue


def serve_loopback(cfg, model, batches, senders=1, **spec_kw):
    """serve() in a thread with replies on, ``batches`` [(ids, dense or
    None)] sent over loopback on ``senders`` wires (ports ``port + s``; with
    several, ``IndexWireFormat.payloads``: the dense on sender 0, the
    tables split over the others, each sender's stream from a thread of its
    own); returns the scores replied to sender 0 [n, B], the launch counts
    of the run (every count set to 0 just before serve() starts) and
    serve()'s summary.  ``spec_kw``: further ServeSpec fields (``bag_L``,
    ``fuse``)."""
    B = batches[0][0].shape[0]
    port = _free_port(senders)
    spec = ServeSpec(batch=B, batches=len(batches), port=port, slots=4, reply=True,
                     senders=senders, **spec_kw)
    if senders > 1:
        wire = IndexWireFormat.plan(cfg, B, senders)
        streams = [b"".join(parts) for parts in
                   zip(*(wire.payloads(idx, dense) for idx, dense in batches))]
    else:
        streams = [b"".join(idx.tobytes() + (b"" if dense is None else dense.tobytes())
                            for idx, dense in batches)]
    out = {}

    def run():
        out["summary"] = serve(cfg, model, spec)

    for k in KERNELS:
        k.launches = 0
    th = threading.Thread(target=run, daemon=True)
    th.start()
    socks = []
    try:
        for s in range(senders):
            for _ in range(200):
                try:
                    socks.append(socket.create_connection(("127.0.0.1", port + s), timeout=30))
                    break
                except OSError:
                    time.sleep(0.05)
            else:
                raise AssertionError(f"serve() never bound port {port + s}")
        sends = [threading.Thread(target=sock.sendall, args=(stream,), daemon=True)
                 for sock, stream in zip(socks, streams)]
        for t in sends:
            t.start()
        want = len(batches) * B * 4
        buf = b""
        while len(buf) < want:
            chunk = socks[0].recv(want - len(buf))
            if not chunk:
                break
            buf += chunk
        for t in sends:
            t.join(60)
    finally:
        for sock in socks:
            sock.close()
    th.join(120)
    if th.is_alive() or "summary" not in out:
        raise AssertionError("serve() did not finish")
    launches = {k.__name__: k.launches for k in KERNELS}
    if len(buf) != want:
        raise AssertionError(f"got {len(buf)} reply bytes, want {want}")
    return np.frombuffer(buf, np.float32).reshape(len(batches), B), launches, out["summary"]


def phase_serve(model, tabs, ws):
    """serve() over loopback; returns the launch counts of this run."""
    cfg = C.fleetrec_model1(batch_size=B_SERVE)
    rng = np.random.default_rng(3)
    batches = [(_rand_ids(cfg, B_SERVE, rng), None) for _ in range(N_SERVE)]
    scores, launches, s = serve_loopback(cfg, model, batches)
    for k, (idx, _) in enumerate(batches):
        golden = ref.forward(cfg, tabs, ws, idx).astype(np.float32)
        if not np.array_equal(scores[k], golden):
            raise AssertionError(f"served batch {k} differs from the oracle")
    if launches["lookup_fused"] < 1 or launches["fused_mlp"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if launches != _launches(N_SERVE, N_SERVE):
        raise AssertionError(f"unexpected launch counts {launches}")
    log(f"phase 6 serve: {s['wire_batches']} batches x {B_SERVE} served over "
        f"loopback, replies bit-equal to the oracle; launches in the run: "
        f"{launches}; latency_ms_p50 {s.get('latency_ms_p50')} (host clock, "
        f"first batch excluded)")
    return launches


KERNELS = (gather_rows, gather_rows_grouped, fused_mlp, lookup_fused, lookup_fused_bags,
           lookup_fused_backward, lookup_fused_ragged, cross_tail)


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
    and scores must equal the phase-4 model's (which was built from the
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
        for stage, need in (("e2e", ("lookup_fused", "fused_mlp")),
                            ("lookup", ("lookup_fused",)), ("mlp", ("fused_mlp",))):
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
                  "--device-pool"], ("lookup_fused", "fused_mlp"))
    if not (sb["n_queries"] > 0 and 0.5 * qps < sb["achieved_qps"] < 2 * qps
            and 0 < sb["latency_ms_p50"] <= sb["latency_ms_p99"] <= sb["latency_ms_max"]):
        raise AssertionError(f"servebench: {sb}")
    log(f"phase 7 tools: gatherbench, export -> load_npz (buffers and scores "
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
    if launches != _launches(mlp=NB):
        raise AssertionError(f"feature mode launches {launches}, want fused_mlp {NB}")
    log(f"phase 8 feature mode: {summary['batches']} batches x {B} of "
        f"{widths} floats over loopback, scores == closed form "
        f"{ref.closed_form_all_ones_score(F):.0f}; launches {launches}")


def dlrm_fp32(dev):
    """dlrm_terabyte at full widths, every table capped at DLRM_ROWS,
    uniform tables and weights from seed 0 on ``dev``: (cfg, model, the
    host tables the oracle reads)."""
    cfg = _cap(C.dlrm_terabyte(batch_size=B_TIME), DLRM_ROWS)
    tables = ref.init_tables(cfg, "uniform")
    return cfg, init_model(cfg, tables_np=tables, mlp_scheme="uniform", device=dev), tables


def heads_oracle(cfg, tables, idx, dense, scheme):
    """The float64 oracle of a dot or cross config with ``scheme`` weights
    (as init_model draws them from seed 0)."""
    heads = {}
    if cfg.bottom_mlp is not None:
        heads["bottom_weights"] = ref.init_bottom_weights(cfg, scheme)
    if cfg.interaction == "cross":
        heads["cross_weights"] = ref.init_cross_weights(cfg, scheme)
    return ref.forward(cfg, tables, ref.init_mlp_weights(cfg, scheme), idx, dense, **heads)


@contextlib.contextmanager
def plain_kernels():
    """The model's wrappers swapped for their plain versions
    (``lookup_fused_plain``, ``lookup_fused_bags_plain``,
    ``lookup_fused_ragged_plain``, ``fused_mlp_plain``, ``cross_tail_plain``,
    and in ``LookupFunction`` ``lookup_fused_plain`` and
    ``lookup_fused_backward_plain``): inside, a forward or a training step
    is the same one composed from the plain versions, and launches
    nothing."""
    from fleetrec_tpu_torch.models import fleetrec as fr_mod
    from fleetrec_tpu_torch.models import interaction as interaction_mod
    from fleetrec_tpu_torch.models import mlp as mlp_mod

    saved = (fr_mod.lookup_fused, fr_mod.lookup_fused_bags, fr_mod.lookup_fused_ragged,
             mlp_mod.fused_mlp, interaction_mod.cross_tail, lookup_mod.lookup_fused,
             lookup_mod.lookup_fused_backward)
    fr_mod.lookup_fused, fr_mod.lookup_fused_bags = lookup_fused_plain, lookup_fused_bags_plain
    fr_mod.lookup_fused_ragged = lookup_fused_ragged_plain
    mlp_mod.fused_mlp = fused_mlp_plain
    interaction_mod.cross_tail = cross_tail_plain
    lookup_mod.lookup_fused = lookup_fused_plain
    lookup_mod.lookup_fused_backward = lookup_fused_backward_plain
    try:
        yield
    finally:
        (fr_mod.lookup_fused, fr_mod.lookup_fused_bags, fr_mod.lookup_fused_ragged,
         mlp_mod.fused_mlp, interaction_mod.cross_tail, lookup_mod.lookup_fused,
         lookup_mod.lookup_fused_backward) = saved


def _launches(lookup=0, mlp=0, bags=0, backward=0, ragged=0, tail=0):
    return {"gather_rows": 0, "gather_rows_grouped": 0, "fused_mlp": mlp,
            "lookup_fused": lookup, "lookup_fused_bags": bags,
            "lookup_fused_backward": backward, "lookup_fused_ragged": ragged,
            "cross_tail": tail}


def micro_heads():
    """{name: (cfg, dense values drawn from 0..hi-1)} of the micro heads,
    B = B_SERVE: integer sums below 2^24, so exact in fp32."""
    dlrm, cross = C.micro_dlrm, C.micro_cross
    return {"micro_dlrm": (dlrm(batch_size=B_SERVE), 4),
            "micro_dlrm onehot_max=70 take_stripes=4": (dataclasses.replace(
                dlrm(batch_size=B_SERVE, onehot_max=70), take_stripes=4), 4),
            "micro_cross": (cross(batch_size=B_SERVE), 2),
            "micro_cross rank 4": (cross(batch_size=B_SERVE, cross_layers=1, cross_rank=4), 2)}


def phase_heads(dev, dlrm):
    """The interaction heads on the card.  (1) the micro heads, pm1 tables
    and all-ones weights: bit-equal to the oracle, 1 lookup_fused and 2
    (dot) or 1 (cross) fused_mlp calls a forward.  (2) ``dlrm`` (fp32, full
    widths, DLRM_ROWS a table) at B = B_TIME: within rtol 1e-3 / atol 2e-3
    of the oracle and rtol / atol 1e-5 of the same forward composed from
    the plain versions; bad take ids NaN-poison exactly their rows; 1
    lookup_fused, 2 fused_mlp, 0 gather launches a forward.  (3) the bf16
    model at DLRM_BF16_ROWS: rtol 2e-2, atol 2e-2 * max|oracle|.  (4) serve()
    of ``dlrm`` at B = B_SERVE over loopback: replies bit-equal to direct
    forwards.  (5) ``cli bench`` of dlrm_terabyte at DLRM_ROWS, every stage;
    ``cli export`` -> ``load_npz`` of micro_dlrm and micro_cross, scores
    bit-equal.  Returns the worst fp32 error against the plain composition
    and the served run's launch counts."""
    t0 = time.time()
    rng = np.random.default_rng(11)
    notes = []
    with torch.inference_mode():
        for name, (cfg, hi) in micro_heads().items():
            model = init_model(cfg, device=dev)
            idx = _rand_ids(cfg, B_SERVE, rng)
            dense = rng.integers(0, hi, (B_SERVE, cfg.dense_dim)).astype(np.float32)
            scores, launches = _counted(lambda: model(torch.from_numpy(idx).to(dev),
                                                      torch.from_numpy(dense).to(dev)))
            want = heads_oracle(cfg, ref.init_tables(cfg), idx, dense, "ones")
            if not np.array_equal(scores.cpu().numpy(), want.astype(np.float32)):
                raise AssertionError(f"{name}: scores are not bit-equal to the oracle")
            cross = cfg.interaction == "cross"
            if launches != _launches(1, 1 if cross else 2, tail=cfg.cross_layers if cross else 0):
                raise AssertionError(f"{name}: launches {launches}")
        notes.append(f"(1) {', '.join(micro_heads())} at B={B_SERVE}: pm1 / all-ones "
                     f"bit-equal to the oracle, launches 1 lookup_fused and 2 (dot) or "
                     f"1 (cross) fused_mlp a forward, and a cross_tail a cross layer")

        cfg, model, tables = dlrm
        idx = _rand_ids(cfg, B_TIME, rng)
        dense_np = rng.uniform(-1, 1, (B_TIME, cfg.dense_dim)).astype(np.float32)
        idx_t, dense = torch.from_numpy(idx).to(dev), torch.from_numpy(dense_np).to(dev)
        scores, launches = _counted(lambda: model(idx_t, dense))
        if launches != _launches(1, 2):
            raise AssertionError(f"dlrm launches per forward {launches}, want 1 "
                                 f"lookup_fused, 2 fused_mlp")
        with plain_kernels():
            plain, plain_launches = _counted(lambda: model(idx_t, dense))
        if plain_launches != _launches():
            raise AssertionError(f"the plain composition launched {plain_launches}")
        torch.testing.assert_close(scores, plain, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"dlrm against its plain composition: {m}")
        err_plain = (scores - plain).abs().max().item()
        got = scores.cpu().numpy()
        golden = heads_oracle(cfg, tables, idx, dense_np, "uniform")
        np.testing.assert_allclose(got, golden, rtol=1e-3, atol=2e-3)
        err_oracle = float(np.abs(got - golden).max())
        bad = idx.copy()
        take_cols = [j for j, t in enumerate(cfg.tables) if t.rows > cfg.onehot_max]
        bad[5, take_cols[-1]] = cfg.tables[take_cols[-1]].rows
        bad[9, take_cols[0]] = -1
        sb = model(torch.from_numpy(bad).to(dev), dense).cpu().numpy()
        nan_rows = np.flatnonzero(np.isnan(sb)).tolist()
        if nan_rows != [5, 9] or not np.array_equal(np.delete(sb, [5, 9]), np.delete(got, [5, 9])):
            raise AssertionError(f"dlrm bad-id poison rows {nan_rows}, want [5, 9]")
        lay = model.layout
        table_bytes = sum(b.numel() * b.element_size() for b in model.lookup_operands()["bufs"])
        notes.append(f"(2) dlrm_terabyte fp32, {cfg.num_tables} tables capped at {DLRM_ROWS} "
                     f"rows ({table_bytes / 1e9:.3f} GB of packed buffers; {lay.n_onehot} "
                     f"one-hot, {lay.n_take} take tables in {lay.take_stripes} stripes, "
                     f"{lay.feature_dim} wide, no dense tail), B={B_TIME}: within rtol 1e-3 / "
                     f"atol 2e-3 of the oracle (max abs err {err_oracle:.3g}) and rtol / atol "
                     f"1e-5 of its plain composition (max abs err {err_plain:.3g}); bad ids -> "
                     f"NaN rows {nan_rows}; launches a forward {launches}")

        cfg16 = _cap(C.dlrm_terabyte(batch_size=B_TIME, dtype="bfloat16"), DLRM_BF16_ROWS)
        tabs16 = ref.init_tables(cfg16, "uniform")
        m16 = init_model(cfg16, tables_np=tabs16, mlp_scheme="uniform", device=dev)
        idx16 = _rand_ids(cfg16, B_TIME, rng)
        s16, launches16 = _counted(lambda: m16(torch.from_numpy(idx16).to(dev), dense))
        want16 = heads_oracle(cfg16, tabs16, idx16, dense_np, "uniform")
        s16 = s16.cpu().numpy()
        np.testing.assert_allclose(s16, want16, rtol=2e-2, atol=2e-2 * np.abs(want16).max())
        if launches16 != _launches(1, 2):
            raise AssertionError(f"dlrm bf16 launches per forward {launches16}")
        notes.append(f"(3) dlrm_terabyte bf16 at {DLRM_BF16_ROWS} rows a table, B={B_TIME}: "
                     f"within rtol 2e-2 / atol 2e-2 * max|oracle| (max abs err "
                     f"{float(np.abs(s16 - want16).max()):.3g} of max|oracle| "
                     f"{float(np.abs(want16).max()):.3g})")
        del m16, tabs16

    batches = [(_rand_ids(cfg, B_SERVE, rng),
                rng.uniform(-1, 1, (B_SERVE, cfg.dense_dim)).astype(np.float32))
               for _ in range(N_SERVE)]
    served, serve_launches, summary = serve_loopback(cfg, model, batches)
    with torch.inference_mode():
        for k, (i, d) in enumerate(batches):
            direct = model(torch.from_numpy(i).to(dev), torch.from_numpy(d).to(dev))
            if not np.array_equal(served[k], direct.cpu().numpy()):
                raise AssertionError(f"served dlrm batch {k} differs from a direct forward")
    if serve_launches != _launches(N_SERVE, 2 * N_SERVE):
        raise AssertionError(f"dlrm serve launches {serve_launches}")
    notes.append(f"(4) serve() of the fp32 model: {summary['wire_batches']} batches x "
                 f"{B_SERVE} (ids and dense) over loopback, replies bit-equal to direct "
                 f"forwards; launches in the run {serve_launches}")

    common = ["--config", "dlrm_terabyte", "--max-rows", str(DLRM_ROWS), "--batch",
              str(B_TIME), "--device", "cuda"]
    for stage, need in (("e2e", ("lookup_fused", "fused_mlp")),
                        ("lookup", ("lookup_fused",)), ("mlp", ("fused_mlp",))):
        r, _ = _cli(["bench", *common, "--stage", stage], need)
        if not _finite_pos(r["ms_per_batch"], r["inferences_per_sec"]):
            raise AssertionError(f"dlrm bench {stage}: bad times {r}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name in ("micro_dlrm", "micro_cross"):
            hcfg = C.get_config(name, batch_size=B_SERVE)
            path = os.path.join(tmp, f"{name}.npz")
            _cli(["export", "--config", name, "--batch", str(B_SERVE), "--device", "cuda",
                  "--table-scheme", "uniform", "--mlp-scheme", "uniform", "--out", path], ())
            loaded = fio.load_npz(path, hcfg, dev)
            built = init_model(hcfg, table_scheme="uniform", mlp_scheme="uniform", device=dev)
            i = torch.from_numpy(_rand_ids(hcfg, B_SERVE, rng)).to(dev)
            d = _dense(hcfg.dense_dim, B_SERVE, rng, dev)
            with torch.inference_mode():
                if not torch.equal(loaded(i, d), built(i, d)):
                    raise AssertionError(f"{name}: scores from the export differ")
    finally:
        shutil.rmtree(tmp)
    notes.append(f"(5) cli bench --config dlrm_terabyte --max-rows {DLRM_ROWS} --batch "
                 f"{B_TIME} --stage e2e|lookup|mlp finite and positive; cli export -> "
                 f"load_npz of micro_dlrm and micro_cross scores bit-equal")
    log(f"phase 9 interaction heads ({time.time() - t0:.1f}s): " + "; ".join(notes))
    return err_plain, serve_launches


def check_bags(model, idx, dense, mean, what) -> float:
    """model.lookup_pooled (one lookup_fused_bags launch) == its plain
    version, bit for bit, features and flags; and against the path it
    replaces (pooled_lookup_concat(plan_bags(ids)) through gather_rows, and
    pooled_bad_rows): the flags equal, the features bit-equal for int8 sums
    (exact in int32), else within rtol 2e-6 / atol 1e-6 (float32 and the
    int8 mean: the same L terms, torch.sum in its own order) or rtol 2e-2 /
    atol L * 2^-7 (bfloat16: the replaced path rounds a factored class after
    each of its L adds and multiplies the mean in bfloat16; one bfloat16 ulp
    of the largest possible sum).  Returns the max abs error against the
    plain version (0)."""
    before = lookup_fused_bags.launches
    got, bad = model.lookup_pooled(idx, dense, mean)
    if lookup_fused_bags.launches != before + 1:
        raise AssertionError(f"lookup_fused_bags did not launch once: {what}")
    want, want_bad = lookup_fused_bags_plain(idx, dense, mean=mean, **model.lookup_operands())
    gi = plan_bags(model, idx)
    tiers, tiers_bad = pooled_lookup_concat(model.packed, gi, dense, mean), pooled_bad_rows(
        model, gi)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"lookup_fused_bags features differ from the plain version: {what}")
    for name, b in (("plain", want_bad), ("replaced", tiers_bad)):
        if (bad is None) != (b is None) or (bad is not None and not torch.equal(bad, b)):
            raise AssertionError(f"lookup_fused_bags flags differ from the {name} path: {what}")
    store = model.lookup_operands()["bufs"][0].dtype
    if store == torch.int8 and not mean:
        if not torch.equal(got, tiers):
            raise AssertionError(f"int8 bag sums differ from the replaced path: {what}")
    else:
        tol = ({"rtol": 2e-2, "atol": idx.shape[2] * 2.0 ** -7} if store == torch.bfloat16
               else {"rtol": 2e-6, "atol": 1e-6})
        torch.testing.assert_close(got.float(), tiers.float(), **tol,
                                   msg=lambda m: f"bags against the replaced path, {what}: {m}")
    return (got.float() - want.float()).abs().max().item()


def check_bag_edges(model1, dev) -> float:
    """Two bag cases by check_bags.  (a) On model1 (full rows), B_SERVE bags
    of BAG_L from bags_with_bad, with every bag of row 6 holding only
    out-of-range ids and row 7 one such bag, the rest empty: those bags give
    +0 (every bit 0) and, through the take tables, flag their rows; sum and
    mean, int32 and int64.  (b) micro_test in float32 and bfloat16 with one
    class row set to -0.0: a bag whose only member reads it, one with a hole
    before it, one of two such members and one of -0.0 after +0.0; the
    kernel keeps -0.0 where the sum starts from it (+0.0 for the last), sum
    and mean.  Returns the worst error against the plain version (0)."""
    rng = np.random.default_rng(17)
    cfg = model1.cfg
    rows = np.asarray([t.rows for t in cfg.tables])
    ids = bags_with_bad(cfg, B_SERVE, BAG_L, rng)
    ids[6] = rows[:, None]
    ids[7] = -1
    ids[7, _take_columns(cfg)[0], :] = rows[_take_columns(cfg)[0]]
    worst = 0.0
    for idt in (torch.int32, torch.int64):
        idx = torch.from_numpy(ids).to(dev, idt)
        for mean in (False, True):
            worst = max(worst, check_bags(model1, idx, None, mean,
                                          f"out-of-range-only bags {idt} mean={mean}"))
            got, bad = model1.lookup_pooled(idx, None, mean)
            if bits(got[6:8]).any() or not bool(bad[6]) or not bool(bad[7]):
                raise AssertionError("bags of only out-of-range members: not +0 and flagged")
    for table_dtype in ("float32", "bfloat16"):
        mcfg = dataclasses.replace(C.micro_test(batch_size=8), table_dtype=table_dtype)
        micro = init_model(mcfg, table_scheme="uniform", device=dev)
        ops = micro.lookup_operands()
        c0 = ops["cols"][0].tolist()
        f = {name: c0[i] for i, name in enumerate(LOOKUP_COL_FIELDS)}
        if f["kind"] != lookup_mod.KIND_CLASS:
            raise AssertionError("micro_test's plan column 0 is not a class column")
        buf = ops["bufs"][f["buf"]].view(-1)
        buf[(f["base"] + 2) * f["dim"]:(f["base"] + 3) * f["dim"]] = 0.0
        buf[(f["base"] + 1) * f["dim"]:(f["base"] + 2) * f["dim"]] = -0.0
        ids = np.full((8, mcfg.num_tables, 3), -1, np.int32)
        ids[0, f["src"], 0] = 1
        ids[1, f["src"], 1] = 1
        ids[2, f["src"], :2] = 1
        ids[3, f["src"], :2] = (2, 1)
        dense = _dense(micro.layout.dense_dim, 8, rng, dev)
        col = ((ops["pos"][:, 0] & 0xFFFF) ^ 0x8000) - 0x8000
        outs = torch.nonzero(col == 0).flatten()
        for mean in (False, True):
            idx = torch.from_numpy(ids).to(dev)
            worst = max(worst, check_bags(micro, idx, dense, mean,
                                          f"-0.0 first member {table_dtype} mean={mean}"))
            got, _ = micro.lookup_pooled(idx, dense, mean)
            sign = torch.signbit(got[:4][:, outs].float()).all(dim=1).tolist()
            if sign != [True, True, True, False]:
                raise AssertionError(f"-0.0 first members: signs {sign} ({table_dtype})")
    return worst


def _take_columns(cfg):
    """The config-order columns of the take tier's tables."""
    return [j for j, t in enumerate(cfg.tables)
            if t.rows > max(cfg.onehot_max, cfg.onehot_factor_max)]


def _cli_serve_bags(cfg, L, n_batches):
    """``cli serve --bag-l`` in a thread and ``cli loadgen --bag-l
    --read-scores`` against it over loopback, both through ``cli.main``;
    returns their output and the launch counts of the run."""
    port = _free_port()
    common = ["--config", cfg.name, "--batch", str(B_SERVE), "--bag-l", str(L),
              "--batches", str(n_batches), "--port", str(port)]
    buf = io.StringIO()
    errors = []

    def run():
        try:
            cli.main(["serve", *common, "--device", "cuda", "--reply", "--slots", "4"])
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    with contextlib.redirect_stdout(buf):
        for k in KERNELS:
            k.launches = 0
        th = threading.Thread(target=run, daemon=True)
        th.start()
        # the server builds the model first: wait for its banner, as a
        # client that keys its connect off it
        deadline = time.time() + 300
        while "serving " not in buf.getvalue() and th.is_alive() and time.time() < deadline:
            time.sleep(0.1)
        if "serving " in buf.getvalue():
            cli.main(["loadgen", *common, "--read-scores"])
        th.join(300)
    launches = {k.__name__: k.launches for k in KERNELS}
    if th.is_alive() or errors:
        raise AssertionError(f"cli serve --bag-l did not finish: {errors}")
    return buf.getvalue(), launches


def phase_bags(dev, model1, tabs, ws, models):
    """Pooled bags on the card.  (1) ``lookup_fused_bags`` by check_bags on
    phase 4's model1 (full rows, pm1), B = B_TIME and B_SERVE, L = BAG_L
    and 1, sum and mean, int32 and int64 ids; on model3 (int8, take tables
    at 1M rows), the criteo-shaped config (bfloat16, the element path) and
    micro_test's QR variant at L = BAG_L_SMALL; bags_with_bad's ids: random
    prefixes with empty bags, an empty row, ids below -1, out-of-range take
    and class ids, a hole before a bag's members.  L = 1 on non-negative
    ids bit-equal to ``lookup_fused``, features and flags.  (2) model1's
    pooled forward at B = B_TIME, L = BAG_L: sum pooling bit-equal to the
    float64 oracle (pm1 sums through the all-ones tower are integers times a
    power of two); mean within rtol 1e-5 and atol feature_dim * 2^-24 *
    max|oracle| (the tower's first layer adds feature_dim non-integer
    features in float32, one rounding an add, and the layers after it
    multiply that sum by 2^27, so the absolute term follows the scores);
    NaN on exactly the rows with a bad take id, a negative id
    poisoning nothing; 1 lookup_fused_bags, 0 lookup_fused, 0 gathers and 1
    fused_mlp a forward; bit-equal to the same forward composed from the
    plain versions.  (3) served: ``serve()`` with bag_L = BAG_L, N_SERVE
    batches x B_SERVE over loopback, and once with fuse = 2, replies
    bit-equal to direct ``forward_pooled`` calls; ``cli serve --bag-l`` and
    ``cli loadgen --bag-l`` against each other; a dot config refused.
    Returns the worst error against the plain version and the served run's
    launch counts."""
    t0 = time.time()
    rng = np.random.default_rng(12)
    worst, notes = 0.0, []
    cfg1 = model1.cfg
    with torch.inference_mode():
        cases = [("fleetrec_model1", (cfg1, model1), B, L) for B in (B_TIME, B_SERVE)
                 for L in (BAG_L, 1)]
        cases += [(name, models[name], B_TIME, BAG_L_SMALL)
                  for name in ("fleetrec_model3", "criteo_terabyte", "qr")]
        # L = 3: a tile's ids start and end off 16-byte lines (the ring's
        # unaligned ends)
        cases += [("fleetrec_model1", (cfg1, model1), B_TIME, 3),
                  ("criteo_terabyte", models["criteo_terabyte"], B_TIME, 3)]
        n_checks = 0
        for name, (cfg, model), B, L in cases:
            ids = bags_with_bad(cfg, B, L, rng)
            dense = _dense(model.layout.dense_dim, B, rng, dev)
            for idt in (torch.int32, torch.int64):
                idx = torch.from_numpy(ids).to(dev, idt)
                for mean in (False, True):
                    worst = max(worst, check_bags(model, idx, dense, mean,
                                                  f"{name} B={B} L={L} {idt} mean={mean}"))
                    n_checks += 1
            if L != 1:
                continue
            single = torch.from_numpy(ids_with_bad(cfg, B, rng)).clamp(min=0).to(dev)
            one, one_bad = model.lookup(single, dense)
            for mean in (False, True):
                got, bad = model.lookup_pooled(single[:, :, None].contiguous(), dense, mean)
                same_bad = (bad is None and one_bad is None) or torch.equal(bad, one_bad)
                if not torch.equal(bits(got), bits(one)) or not same_bad:
                    raise AssertionError(f"L = 1 differs from lookup_fused: {name} B={B}")
        worst = max(worst, check_bag_edges(model1, dev))
        notes.append(f"(1) lookup_fused_bags bit-equal to its plain version and within "
                     f"tolerance of the replaced path in {n_checks} checks: model1 full rows "
                     f"B={B_TIME} / {B_SERVE} x L={BAG_L} / 1, model3 (int8), criteo-shaped "
                     f"(bf16, element path) and the QR variant at B={B_TIME} L={BAG_L_SMALL}, "
                     f"model1 and criteo-shaped at L=3 (unaligned id runs), each int32 / int64 "
                     f"ids x sum / mean, with padding, empty bags, ids below -1 and "
                     f"out-of-range ids; bags of only out-of-range members (+0, take rows "
                     f"flagged) and a first member of -0.0 (the sign kept); L=1 == "
                     f"lookup_fused (max_abs_err {worst})")

        idx, _ = make_bags(cfg1, B_TIME, BAG_L, seed=13, all_empty_row=3)
        idx_t = torch.from_numpy(idx).to(dev)
        scores, launches = _counted(lambda: model1.forward_pooled(idx_t))
        if launches != _launches(mlp=1, bags=1):
            raise AssertionError(f"launches a pooled forward {launches}, want 1 "
                                 f"lookup_fused_bags, 1 fused_mlp")
        golden = pooled_oracle(cfg1, tabs, ws, idx, None)
        if not np.array_equal(scores.cpu().numpy(), golden.astype(np.float32)):
            raise AssertionError("pooled model1 pm1/ones scores are not bit-equal to the oracle")
        with plain_kernels():
            plain, plain_launches = _counted(lambda: model1.forward_pooled(idx_t))
        if plain_launches != _launches() or not torch.equal(scores, plain):
            raise AssertionError(f"the pooled forward differs from its plain composition "
                                 f"(which launched {plain_launches})")
        s_mean = model1.forward_pooled(idx_t, mean=True).cpu().numpy()
        g_mean = pooled_oracle(cfg1, tabs, ws, idx, None, mean=True)
        np.testing.assert_allclose(s_mean, g_mean, rtol=1e-5,
                                   atol=cfg1.feature_dim * 2.0 ** -24 * np.abs(g_mean).max())
        err_mean = float(np.abs(s_mean - g_mean).max() / np.abs(g_mean).max())
        bad = idx.copy()
        take_cols = _take_columns(cfg1)
        bad[5, take_cols[-1], 2] = cfg1.tables[take_cols[-1]].rows
        bad[9, take_cols[0], 0] = 2**31 - 1
        bad[11, take_cols[0], 0] = -7  # padding: one member fewer, no poison
        sb = model1.forward_pooled(torch.from_numpy(bad).to(dev)).cpu().numpy()
        nan_rows = np.flatnonzero(np.isnan(sb)).tolist()
        keep = np.delete(np.arange(B_TIME), [5, 9, 11])
        if nan_rows != [5, 9] or not np.array_equal(sb[keep], scores.cpu().numpy()[keep]):
            raise AssertionError(f"pooled bad-id poison rows {nan_rows}, want [5, 9]")
        notes.append(f"(2) model1 pooled forward, full rows, pm1 / all-ones, B={B_TIME} "
                     f"L={BAG_L}: sum bit-equal to the float64 oracle and to its plain "
                     f"composition; mean within rtol 1e-5 / atol {cfg1.feature_dim} * 2^-24 * "
                     f"max|oracle| (max err "
                     f"{err_mean:.3g} of max|oracle|); bad take ids -> NaN rows {nan_rows}, a "
                     f"negative id none; launches a forward {launches}")

    cfg = C.fleetrec_model1(batch_size=B_SERVE)
    batches = [make_bags(cfg, B_SERVE, BAG_L, seed=14 + k) for k in range(N_SERVE)]
    runs = {}
    for fuse in (1, 2):
        served, runs[fuse], summary = serve_loopback(cfg, model1, batches, bag_L=BAG_L,
                                                     fuse=fuse)
        with torch.inference_mode():
            for k, (i, _) in enumerate(batches):
                direct = model1.forward_pooled(torch.from_numpy(i).to(dev))
                if not np.array_equal(served[k], direct.cpu().numpy()):
                    raise AssertionError(f"served bag batch {k} (fuse {fuse}) differs from a "
                                         f"direct forward_pooled")
        if runs[fuse] != _launches(mlp=N_SERVE // fuse, bags=N_SERVE // fuse):
            raise AssertionError(f"bag serve launches (fuse {fuse}) {runs[fuse]}")
        if summary["wire_batches"] != N_SERVE or summary["fuse"] != fuse:
            raise AssertionError(f"bag serve summary {summary}")
    text, cli_launches = _cli_serve_bags(cfg, BAG_L, N_SERVE)
    for line in text.strip().splitlines():
        log(line)
    if (f"scores received: {N_SERVE * B_SERVE}" not in text
            or f'"wire_batches": {N_SERVE}' not in text
            or cli_launches != _launches(mlp=N_SERVE, bags=N_SERVE)):
        raise AssertionError(f"cli serve / loadgen --bag-l: launches {cli_launches}")
    dcfg, dmodel = models["dlrm_terabyte"]
    for refused in (lambda: ServingEngine.from_model(dmodel, batch_size=B_SERVE, bag_L=BAG_L),
                    lambda: dmodel.forward_pooled(torch.zeros(
                        (8, dcfg.num_tables, BAG_L), dtype=torch.int32, device=dev))):
        try:
            refused()
        except ValueError as e:
            if "interaction" not in str(e):
                raise
        else:
            raise AssertionError("a dot config was not refused pooled bags")
    notes.append(f"(3) serve() with bag_L={BAG_L}: {N_SERVE} batches x {B_SERVE} of bags over "
                 f"loopback, replies bit-equal to direct forward_pooled calls, launches "
                 f"{runs[1]}; with fuse=2 {runs[2]}; cli serve --bag-l {BAG_L} against cli "
                 f"loadgen --bag-l {BAG_L} --read-scores: {N_SERVE * B_SERVE} scores, launches "
                 f"{cli_launches}; dlrm_terabyte (dot) refused")
    log(f"phase 10 bags ({time.time() - t0:.1f}s): " + "; ".join(notes))
    return worst, runs[1]


# the training phase: Adagrad steps of model1 and of dlrm_terabyte on one
# seeded batch each, and the steps each timing averages
TRAIN_STEPS, DLRM_TRAIN_STEPS, TIME_STEPS = 10, 3, 5
# lookup_fused_backward against its plain version on uniform cotangents:
# float32 sums of up to B terms of |x| <= 1 in another order; bfloat16: one
# bfloat16 rounding of those sums
BACKWARD_TOL = {torch.float32: {"rtol": 1e-5, "atol": 1e-4},
                torch.bfloat16: {"rtol": 2.0 ** -7, "atol": 1e-4}}
# a training step against the same step through the plain lookup and
# backward: the tables' float32 gradients differ in the order of their sums
STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of ``lookup_fused_plain``,
    ``lookup_fused_bags_plain``, ``lookup_fused_backward_plain``,
    ``lookup_fused_ragged_plain``, ``fused_mlp_plain`` and
    ``cross_tail_plain`` made through the kernels' wrappers (which call them
    only for CPU tensors) inside the block."""
    from fleetrec_tpu_torch.ops import cross as cross_mod
    from fleetrec_tpu_torch.ops import mlp_fused as mlp_fused_mod

    where = {"lookup_fused_plain": lookup_mod, "lookup_fused_bags_plain": lookup_mod,
             "lookup_fused_backward_plain": lookup_mod, "lookup_fused_ragged_plain": lookup_mod,
             "fused_mlp_plain": mlp_fused_mod, "cross_tail_plain": cross_mod}
    counts = dict.fromkeys(where, 0)
    saved = {n: getattr(mod, n) for n, mod in where.items()}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    for n, mod in where.items():
        setattr(mod, n, counted(n))
    try:
        yield counts
    finally:
        for n, mod in where.items():
            setattr(mod, n, saved[n])


def train_batch(cfg, B, seed, dev):
    """(ids [B, T] int32, dense [B, dense_dim] or None, labels [B] of 0 / 1)
    on ``dev``, from ``seed``."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(_rand_ids(cfg, B, rng)).to(dev)
    dense = _dense(cfg.dense_dim, B, rng, dev)
    return idx, dense, torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)).to(dev)


def order_bound(ct, idx, bufs, cols, pos, stripes, stripe_height, window=None):
    """Per element of each gradient buffer (in its shape), 2 (n - 1) 2^-24
    sum|x| over the n cotangents x it sums: how far two float32 sums of the
    same terms in two orders can lie apart (each lies within (n - 1) 2^-24
    sum|x| of the exact sum, whatever its order).  BACKWARD_TOL holds for the
    few terms an element of a uniform draw sums; every id 0 puts B terms on
    one element, and there the sums of kernel and plain, each in an order of
    its own, may differ by more than it allows.  From the plain backward of
    |ct| and of ones, in float32."""
    def sums(x):
        return lookup_fused_backward_plain(
            x, idx, bufs, cols, pos, stripes, stripe_height,
            out=[torch.zeros(b.numel(), device=b.device) for b in bufs], window=window)

    total = sums(ct.float().abs())
    count = sums(torch.ones(ct.shape, device=ct.device))
    return [(2.0 ** -23 * (n - 1).clamp(min=0) * t).view(b.shape)
            for t, n, b in zip(total, count, bufs)]


def within(a, b, tol, bound=None) -> bool:
    """|a - b| <= atol + rtol |b| (+ ``bound``, order_bound's) everywhere."""
    allowed = tol["atol"] + tol["rtol"] * b.float().abs()
    if bound is not None:
        allowed = allowed + bound
    return bool(((a.float() - b.float()).abs() <= allowed).all())


def check_backward(model, idx, ct, exact, what, draw="uniform") -> float:
    """lookup_fused_backward (one launch) against lookup_fused_backward_plain
    on the same operands and cotangents ``ct``: bit-equal when ``exact``
    (integer cotangents: every float32 sum exact in any order), else within
    BACKWARD_TOL, plus order_bound on the draws other than ``uniform``.
    When ``exact``, also ``out=`` float32 sums that already hold integers,
    which the kernel adds into: bit-equal to the plain version's into the
    same sums.  Returns the max abs error."""
    ops = model.lookup_operands()
    args = (ops["bufs"], ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
    before = lookup_fused_backward.launches
    got = lookup_fused_backward(ct, idx, *args)
    if lookup_fused_backward.launches != before + 1:
        raise AssertionError(f"lookup_fused_backward did not launch once: {what}")
    want = lookup_fused_backward_plain(ct, idx, *args)
    bounds = (order_bound(ct, idx, *args) if not exact and draw != "uniform"
              else [None] * len(got))
    torch.cuda.synchronize()
    worst = 0.0
    for a, b, bound in zip(got, want, bounds):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"backward gradients of another dtype or shape: {what}")
        if exact and not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"backward kernel differs from its plain version: {what}")
        if not exact and bound is None:
            torch.testing.assert_close(a.float(), b.float(), **BACKWARD_TOL[a.dtype],
                                       msg=lambda m: f"backward kernel, {what}: {m}")
        if bound is not None and not within(a, b, BACKWARD_TOL[a.dtype], bound):
            raise AssertionError(f"backward kernel, {what}: beyond BACKWARD_TOL plus the "
                                 f"summation-order bound")
        worst = max(worst, (a.float() - b.float()).abs().max().item())
    if exact:
        gen = torch.Generator(device=idx.device).manual_seed(13)
        prior = [torch.randint(-50, 51, (b.numel(),), generator=gen, device=idx.device,
                               dtype=torch.float32) for b in ops["bufs"]]
        into = lookup_fused_backward(ct, idx, *args, out=[p.clone() for p in prior])
        plain = lookup_fused_backward_plain(ct, idx, *args, out=prior)
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(into, plain)):
            raise AssertionError(f"backward kernel with out= non-zero sums differs from its "
                                 f"plain version: {what}")
        del into, plain, prior
    return worst


def train_and_check(name, model, batch, steps, dev):
    """``steps`` Trainer steps of ``model`` (Adagrad 1e-2) on ``batch``:
    first one step through the plain lookup and plain backward from the same
    start, then the kernel steps; each must launch 1 lookup_fused and 1
    lookup_fused_backward and call no plain version, the first must match
    the plain step (its loss bit-equal, every tensor within STEP_TOL) and
    the loss must fall.  Returns the losses, the launch counts of the run
    and the Trainer."""
    tensors = trainable_tensors(model)
    start = {k: v.clone() for k, v in tensors.items()}
    with plain_kernels():
        plain_loss, plain_launches = _counted(
            lambda: Trainer(model, device=dev).step(*batch))
    if plain_launches != _launches():
        raise AssertionError(f"{name}: the plain step launched {plain_launches}")
    after_plain = {k: v.clone() for k, v in tensors.items()}
    for k, v in tensors.items():
        v.copy_(start[k])
    del start
    trainer = Trainer(model, device=dev)
    losses, run = [], _launches()
    for step in range(steps):
        with plain_calls() as plain:
            loss, launches = _counted(lambda: trainer.step(*batch))
        if launches != _launches(lookup=1, backward=1) or any(plain.values()):
            raise AssertionError(f"{name} step {step}: launches {launches}, plain calls {plain}")
        run = {k: run[k] + launches[k] for k in run}
        losses.append(loss.item())
        if step == 0:
            if loss.item() != plain_loss.item():
                raise AssertionError(f"{name}: loss {loss.item()} against the plain step's "
                                     f"{plain_loss.item()}")
            for k, v in tensors.items():
                torch.testing.assert_close(v, after_plain[k], **STEP_TOL, msg=lambda m: (
                    f"{name}: {k} after a step against the plain step: {m}"))
            del after_plain
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    return losses, run, trainer


def phase_train(dev, model1_pm1, model1, dlrm):
    """Training on the card.  (1) lookup_fused_backward against its plain
    version: phase 4's pm1 model1 (full rows) and the fp32 dlrm_terabyte
    model ``dlrm`` (the dense-free layout) at B = B_TIME, integer cotangents
    bit-equal and uniform ones within BACKWARD_TOL, ids with bad ones; the
    same on micro_test's striped and QR variants and a bf16 one.  (2)
    ``model1`` (full rows, uniform fp32 tables and weights) trained
    TRAIN_STEPS Adagrad steps and (3) ``dlrm`` DLRM_TRAIN_STEPS, by
    train_and_check.  (4) the trained model1 served over loopback, replies
    bit-equal to direct forwards; forward_train's scores within rtol / atol
    1e-5 of forward's (a matmul chain against the fused_mlp kernels).
    Returns the backward's worst errors (fp32, bf16), the model1 run's
    launch counts and the two Trainers (which the timing reuses)."""
    t0 = time.time()
    rng = np.random.default_rng(17)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [("fleetrec_model1 pm1", model1_pm1), ("dlrm_terabyte", dlrm)]
    for tag, cfg in (("striped", dataclasses.replace(C.micro_test(batch_size=B_TIME),
                                                     onehot_max=70, take_stripes=4)),
                     ("qr", dataclasses.replace(C.micro_test(batch_size=B_TIME), onehot_max=8,
                                                qr_threshold=80, qr_rem=16)),
                     ("bf16", dataclasses.replace(C.micro_test(batch_size=B_TIME),
                                                  onehot_max=70, table_dtype="bfloat16"))):
        cases.append((f"micro_test {tag}", init_model(cfg, table_scheme="uniform", device=dev)))
    n_checks = 0
    for name, m in cases:
        dtype = m.lookup_operands()["bufs"][0].dtype
        F = m.layout.feature_dim
        for draw in ID_DRAWS:
            ids = (ids_with_bad(m.cfg, B_TIME, rng) if draw == "uniform"
                   else draw_ids(m.cfg, B_TIME, rng, draw))
            for idt in (torch.int32, torch.int64) if draw == "uniform" else (torch.int32,):
                idx = torch.from_numpy(ids).to(dev, idt)
                for exact in (True, False):
                    ct = (rng.integers(-3, 4, (B_TIME, F)) if exact
                          else rng.uniform(-1, 1, (B_TIME, F))).astype(np.float32)
                    err = check_backward(m, idx, torch.from_numpy(ct).to(dev, dtype), exact,
                                         f"{name} {draw} {idt} "
                                         f"{'integer' if exact else 'uniform'}", draw)
                    worst[dtype] = max(worst[dtype], err)
                    n_checks += 1
    del cases
    notes = [f"(1) lookup_fused_backward against its plain version in {n_checks} checks "
             f"(model1 pm1 full rows, dlrm_terabyte at {DLRM_ROWS} rows, micro_test striped / "
             f"QR / bf16; B={B_TIME}, int32 / int64 uniform ids with bad ones, int32 ids of "
             f"the draws {ID_DRAWS[1:]}, whose uniform cotangents also get order_bound): "
             f"integer cotangents bit-equal, also added with out= into non-zero integer sums, "
             f"uniform ones within {BACKWARD_TOL[torch.float32]} (fp32 max_abs_err "
             f"{worst[torch.float32]:.3g}) and {BACKWARD_TOL[torch.bfloat16]} (bf16 "
             f"{worst[torch.bfloat16]:.3g})"]

    cfg1 = model1.cfg
    batch1 = train_batch(cfg1, B_TIME, 18, dev)
    losses1, run1, trainer1 = train_and_check("fleetrec_model1", model1, batch1, TRAIN_STEPS, dev)
    dcfg = dlrm.cfg
    batch_d = train_batch(dcfg, B_TIME, 19, dev)
    losses_d, run_d, trainer_d = train_and_check("dlrm_terabyte", dlrm, batch_d,
                                                 DLRM_TRAIN_STEPS, dev)
    for tag, cfg, m, losses, run in (("(2)", cfg1, model1, losses1, run1),
                                     ("(3)", dcfg, dlrm, losses_d, run_d)):
        nbytes = sum(t.numel() * t.element_size() for t in trainable_tensors(m).values())
        notes.append(f"{tag} {cfg.name} trained at full widths ({nbytes / 1e9:.3f} GB of fp32 "
                     f"tables and weights), B={B_TIME}, Adagrad 1e-2, {len(losses)} steps on "
                     f"one batch: loss {losses[0]:.6f} -> {losses[-1]:.6f} ({losses}); a step "
                     f"launches 1 lookup_fused and 1 lookup_fused_backward and calls no plain "
                     f"version (run: {run}); the first step's loss bit-equal to the plain "
                     f"step's, its tensors within {STEP_TOL}")

    cfg_s = C.fleetrec_model1(batch_size=B_SERVE)
    batches = [(_rand_ids(cfg_s, B_SERVE, rng), None) for _ in range(N_SERVE)]
    served, serve_launches, _ = serve_loopback(cfg_s, model1, batches)
    with torch.inference_mode():
        for k, (i, _) in enumerate(batches):
            if not np.array_equal(served[k], model1(torch.from_numpy(i).to(dev)).cpu().numpy()):
                raise AssertionError(f"served trained batch {k} differs from a direct forward")
    if serve_launches != _launches(N_SERVE, N_SERVE):
        raise AssertionError(f"trained model1 serve launches {serve_launches}")
    idx1 = batch1[0]
    with torch.no_grad():
        s_train, s_fwd = model1.forward_train(idx1), model1(idx1)
    torch.testing.assert_close(s_train, s_fwd, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"forward_train against forward: {m}")
    notes.append(f"(4) the trained model1 served ({N_SERVE} batches x {B_SERVE} over loopback), "
                 f"replies bit-equal to direct forwards, launches {serve_launches}; "
                 f"forward_train's scores within rtol / atol 1e-5 of forward's (max abs err "
                 f"{(s_train - s_fwd).abs().max().item():.3g})")
    log(f"phase 11 training ({time.time() - t0:.1f}s): " + "; ".join(notes))
    return worst, run1, {"fleetrec_model1": (model1, trainer1, batch1),
                         "dlrm_terabyte": (dlrm, trainer_d, batch_d)}


# ---- phase 12: the sharded path, serving and training -------------------------

# the model shards of the window-kernel checks, and of the sharded worlds
WINDOW_MS = (2, 4)
# the (2, 2) serve world's row cap (every model1 table at most 100000 rows)
SHARD_SERVE_ROWS = 100_000
# a world's deadline: its ranks are killed and the phase fails past it
WORLD_DEADLINE_S = 420
# forwards timed per part on a rank of the (1, 2) world
SPLIT_ITERS = 20
# the sharded training step: SGD's learning rate, the steps a world takes on
# its one batch, and the staged steps whose parts are timed (their median)
SHARD_LR, SHARD_STEPS, SPLIT_STEPS = 0.1, 3, 5
# the configs a sharded world trains (train_config)
TRAIN_TAGS = ("model1", "model3", "model1_100k")
# forward_pipelined's batches against as many forwards, timed in turns
OVERLAP_K, OVERLAP_REPS = 4, 5


def pm1_scores(cfg, idx, dense):
    """The float64 oracle of pm1 tables (row r of every table: +1 when r is
    even, -1 when odd, every column) and all-ones weights, without the
    tables: each table's columns are its id's parity sign."""
    feats = np.zeros((idx.shape[0], cfg.feature_dim))
    for j, t in enumerate(cfg.tables):
        feats[:, t.out_offset:t.out_offset + t.dim] = np.where(idx[:, j] % 2 == 0, 1.0, -1.0)[:, None]
    if cfg.dense_dim:
        feats[:, cfg.feature_dim - cfg.dense_dim:] = dense
    return ref.mlp_chain(feats, ref.init_mlp_weights(cfg, "ones"), cfg.mlp.activation)[:, 0]


def _same_flags(a, b) -> bool:
    return (a is None) == (b is None) and (a is None or torch.equal(a, b))


def check_windows(model1, model3, dev):
    """The row-window form of both lookup kernels against their plain
    versions on each model shard m of M in WINDOW_MS (shard_operands: the
    shard's class tables, take rows and descriptors): model1 at full rows
    (B = B_TIME, single ids and bags of BAG_L) and model3 (int8, take tables
    at 1M rows; single ids), int32 ids with bad ones; kernel and plain
    bit-equal, features and flags, every shard's flags the unsharded ones,
    and the M shards' single-id features summed the unsharded lookup's bit
    for bit.  Returns the worst error and the ((model, ids, dense, bags),
    shard 0 of 2's operands) the report times."""
    from fleetrec_tpu_torch.parallel import shard_operands

    rng = np.random.default_rng(21)
    worst, n = 0.0, 0
    timed = {}
    with torch.inference_mode():
        for name, model in (("fleetrec_model1", model1), ("fleetrec_model3", model3)):
            cfg = model.cfg
            ids = torch.from_numpy(ids_with_bad(cfg, B_TIME, rng)).to(dev)
            dense = _dense(model.layout.dense_dim, B_TIME, rng, dev)
            bags = (torch.from_numpy(bags_with_bad(cfg, B_TIME, BAG_L, rng)).to(dev)
                    if name == "fleetrec_model1" else None)
            whole, whole_bad = model.lookup(ids, dense)
            for M in WINDOW_MS:
                total = None
                for m in range(M):
                    ops = shard_operands(model, m, M, dev)
                    d = dense if ops["dense_dim"] else None
                    if M == 2 and m == 0:
                        timed[name] = (ops, ids, d, bags)
                    for kernel, plain, x in ((lookup_fused, lookup_fused_plain, ids),
                                             (lookup_fused_bags, lookup_fused_bags_plain, bags)):
                        if x is None:
                            continue
                        before = kernel.launches
                        got, bad = kernel(x, d, **ops)
                        want, want_bad = plain(x, d, **ops)
                        torch.cuda.synchronize()
                        what = f"{kernel.__name__} {name} shard {m} of {M}"
                        if kernel.launches != before + 1:
                            raise AssertionError(f"{what}: the kernel did not launch once")
                        if not (torch.equal(bits(got), bits(want)) and _same_flags(bad, want_bad)):
                            raise AssertionError(f"{what}: kernel and plain differ")
                        worst = max(worst, (got.float() - want.float()).abs().max().item())
                        n += 1
                        if kernel is lookup_fused:
                            if not _same_flags(bad, whole_bad):
                                raise AssertionError(f"{what}: flags differ from one device's")
                            total = got if total is None else total + got
                    del ops
                if not torch.equal(total, whole):
                    raise AssertionError(f"{name}: the {M} shards' features do not sum to "
                                         f"the unsharded lookup")
    return worst, n, timed


def check_backward_windows(model1, dlrm, dev):
    """The row-window form of the backward kernel against its plain version
    on each model shard m of M in WINDOW_MS (shard_operands: the shard's
    class tables, take rows and descriptors; the gradient buffers are the
    shard's): model1 at full rows and dlrm_terabyte at DLRM_ROWS rows a
    table, B = B_TIME, int32 ids of each draw of ID_DRAWS (uniform with bad
    ones, every id 0, skewed), integer cotangents: kernel and plain
    bit-equal, and the M shards' gradients, placed at their tables and rows,
    bit-equal to the unsharded kernel's, pad tables and rows 0.  Returns the
    worst error, the checks made and (shard 0 of 2's operands, the uniform
    ids, the config) of model1 for the report."""
    from fleetrec_tpu_torch.parallel import shard_operands

    rng = np.random.default_rng(26)
    worst, n, timed = 0.0, 0, None
    for name, model, draw in [(name, model, draw) for name, model in (
            ("fleetrec_model1", model1), ("dlrm_terabyte", dlrm)) for draw in ID_DRAWS]:
        ids = torch.from_numpy(ids_with_bad(model.cfg, B_TIME, rng) if draw == "uniform"
                               else draw_ids(model.cfg, B_TIME, rng, draw)).to(dev)
        F = model.layout.feature_dim
        ct = torch.from_numpy(rng.integers(-3, 4, (B_TIME, F)).astype(np.float32)).to(dev)
        ops = model.lookup_operands()
        whole = lookup_fused_backward(ct, ids, ops["bufs"], ops["cols"], ops["pos"],
                                      ops["stripes"], ops["stripe_height"])
        for M in WINDOW_MS:
            placed = [[] for _ in whole]
            for m in range(M):
                s = shard_operands(model, m, M, dev)
                args = (ct, ids, s["bufs"], s["cols"], s["pos"], s["stripes"], s["stripe_height"])
                before = lookup_fused_backward.launches
                got = lookup_fused_backward(*args, window=s["window"])
                want = lookup_fused_backward_plain(*args, window=s["window"])
                torch.cuda.synchronize()
                what = f"lookup_fused_backward window {name} {draw} shard {m} of {M}"
                if lookup_fused_backward.launches != before + 1:
                    raise AssertionError(f"{what}: the kernel did not launch once")
                for i, (a, b) in enumerate(zip(got, want)):
                    if not torch.equal(bits(a), bits(b)):
                        raise AssertionError(f"{what}: kernel and plain differ (buffer {i})")
                    worst = max(worst, (a - b).abs().max().item())
                    placed[i].append(a)
                n += 1
                if name == "fleetrec_model1" and M == 2 and m == 0 and draw == "uniform":
                    timed = (s, ids, model.cfg)
                del s, got, want
            for i, (w, parts) in enumerate(zip(whole, placed)):
                cat = torch.cat(parts)
                if not (torch.equal(bits(cat[:w.shape[0]]), bits(w))
                        and not cat[w.shape[0]:].any()):
                    raise AssertionError(f"{name} {draw}: the {M} shards' gradients (buffer "
                                         f"{i}) placed at their windows differ from the "
                                         f"unsharded one's")
            del placed
        del whole
        torch.cuda.empty_cache()
    return worst, n, timed


def _split_forward(sh, ids, dense, iters=SPLIT_ITERS):
    """A sharded forward's time by part, median of ``iters`` (every rank of
    the row runs the same loop): the window lookup, the W1-partial matmul
    (CUDA events), the exchange (host clock around the all_reduce and a
    synchronize) and the tower and poison (CUDA events); each part closed
    by a synchronize.  Also the whole forward's wall time."""
    parts = {k: [] for k in ("lookup", "W1-partial matmul", "exchange", "tower", "forward")}
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        feats, bad = lookup_fused(ids, sh._lookup_dense(dense), **sh.operands)
        ev[1].record()
        part = sh._partial(feats)
        ev[2].record()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sh._exchange(part)
        torch.cuda.synchronize()
        parts["exchange"].append((time.perf_counter() - t) * 1e3)
        ev[3].record()
        sh._finish(part, None, bad, dense)
        ev[4].record()
        torch.cuda.synchronize()
        parts["lookup"].append(ev[0].elapsed_time(ev[1]))
        parts["W1-partial matmul"].append(ev[1].elapsed_time(ev[2]))
        parts["tower"].append(ev[3].elapsed_time(ev[4]))
        t = time.perf_counter()
        sh.forward(ids, dense)
        torch.cuda.synchronize()
        parts["forward"].append((time.perf_counter() - t) * 1e3)
    out = {k: float(np.median(v)) for k, v in parts.items()}
    out["exchange_bytes"] = part.numel() * part.element_size()
    out["exchange_shape"] = list(part.shape)
    return out


def _overlap(sh, pip, dense=None, reps=OVERLAP_REPS):
    """forward_pipelined of the K batches of ``pip`` against K forwards,
    timed in turns (pipelined, sequential, sequential, pipelined, ...; host
    clock, each ending in a synchronize; every rank of the row runs the same
    loop): the medians in ms."""
    K = pip.shape[0]

    def pipelined():
        return sh.forward_pipelined(pip, dense)

    def sequential():
        return [sh.forward(pip[k], None if dense is None else dense[k]) for k in range(K)]

    times = {"pipelined": [], "sequential": []}
    order = [("pipelined", pipelined), ("sequential", sequential)]
    for _, fn in order:
        fn()
    for r in range(reps):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def _world_main(rank, n, init, backend, target, args, log_path, q):
    """A rank of a spawned world: its standard output and errors go to
    ``log_path``; it joins the world over ``backend`` (``init_distributed``,
    which makes the rank's card current: cuda:0 for every rank on one card,
    one card a rank over NCCL; a world of one rank binds its card and joins
    its group itself; None: ``target`` joins it), runs ``target(rank,
    *args)`` and puts (rank, ok, result or traceback) on ``q``."""
    import traceback

    import torch.distributed as dist

    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = sys.stdout
    try:
        from fleetrec_tpu_torch.parallel import init_distributed
        from fleetrec_tpu_torch.parallel.multihost import bind_device, check_backend

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if backend is not None and n > 1:
            init_distributed(init, n, rank, backend, device="cuda")
        elif backend is not None:
            check_backend(backend, "cuda", 1)
            bind_device("cuda", rank)
            dist.init_process_group(backend, init_method=init, world_size=1, rank=0)
        try:
            out = target(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        q.put((rank, True, out))
    except BaseException:  # the parent fails the phase with it
        q.put((rank, False, traceback.format_exc()))


def run_world(n, target, args, tmp, tag, backend="gloo", on_started=None, method="spawn"):
    """``target(rank, *args)`` on ``n`` ranks, spawned processes (on this
    card, or one card a rank), joined over ``backend`` through a file://
    rendezvous in ``tmp`` (None: no process group for one rank launched by
    ``target`` itself).
    ``on_started()`` runs in this process while the ranks work (a loopback
    client).  Raises on the first rank that fails, a rank that dies, or the
    deadline; kills every rank it started.  Returns the ranks' results in
    rank order and what ``on_started`` returned.  ``method``: the
    multiprocessing start method ("forkserver": forked from the server
    ``main`` starts first, which has touched no card)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context(method)
    q = ctx.Queue()
    init = f"file://{os.path.join(tmp, f'{tag}.rendezvous')}" if backend else None
    logs = [os.path.join(tmp, f"{tag}.rank{r}.log") for r in range(n)]
    procs = [ctx.Process(target=_world_main, daemon=True,
                         args=(r, n, init, backend, target, args, logs[r], q))
             for r in range(n)]
    for p in procs:
        p.start()
    results, side = {}, {}
    t_end = time.monotonic() + WORLD_DEADLINE_S

    def tail(r):
        if not os.path.exists(logs[r]):
            return "(no log)"
        with open(logs[r]) as f:
            return f.read()[-3000:]

    def client():
        try:
            side["out"] = on_started()
        except BaseException as e:  # re-raised below, after the ranks are done
            side["err"] = e

    th = threading.Thread(target=client, daemon=True) if on_started else None
    if th:
        th.start()
    try:
        while len(results) < n:
            left = t_end - time.monotonic()
            if left <= 0:
                raise AssertionError(f"{tag}: past the {WORLD_DEADLINE_S} s deadline, ranks "
                                     f"done {sorted(results)}")
            try:
                r, ok, payload = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in results]
                if dead:
                    raise AssertionError(f"{tag}: rank {dead[0]} died (exit "
                                         f"{procs[dead[0]].exitcode}):\n{tail(dead[0])}")
                continue
            if not ok:
                raise AssertionError(f"{tag}: rank {r} failed:\n{payload}\n{tail(r)}")
            results[r] = payload
        if th:
            th.join(max(1.0, t_end - time.monotonic()))
            if th.is_alive():
                raise AssertionError(f"{tag}: the loopback client did not finish")
            if "err" in side:
                raise side["err"]
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)], side.get("out")


def serving_checks(mesh, paths, data):
    """The serving forwards on this rank of a one-row mesh (D = 1): model1 at
    full rows from its checkpoint, then model3 (int8, take tables at 1M
    rows), each built on the host and sharded; the leader feeds the row's
    batches to the others (host_local_batch_to_global).  Returns the scores,
    the launch counts of one sharded forward (every count set to 0 just
    before), the time splits and forward_pipelined's overlap."""
    from fleetrec_tpu_torch.parallel import ShardedFleetRec, host_local_batch_to_global

    def fan_out(key):
        arr = data[key]
        return host_local_batch_to_global(mesh, arr if mesh.is_leader else np.zeros_like(arr))

    out = {}
    with torch.inference_mode():
        cfg1 = C.fleetrec_model1(batch_size=B_TIME)
        sh = ShardedFleetRec(fio.load_npz(paths["model1"], cfg1, "cpu"), mesh)
        ids = fan_out("m1/idx")
        out["m1"], out["launches_forward"] = _counted(lambda: sh.forward(ids).cpu().numpy())
        out["m1_bad"] = sh.forward(fan_out("m1/bad")).cpu().numpy()
        pip = fan_out("m1/pip")
        out["m1_pipelined"] = sh.forward_pipelined(pip).cpu().numpy()
        out["m1_sequential"] = np.stack([sh.forward(pip[k]).cpu().numpy()
                                         for k in range(pip.shape[0])])
        bags = fan_out("m1/bags")
        out["m1_pooled"], out["launches_pooled"] = _counted(
            lambda: sh.forward_pooled(bags).cpu().numpy())
        out["fold1"] = sh._use_w1_fold
        out["split1"] = _split_forward(sh, ids, None)
        out["overlap1"] = _overlap(sh, fan_out("m1/pip_time"))
        del sh
        torch.cuda.empty_cache()
        cfg3 = _cap(C.fleetrec_model3(batch_size=B_TIME), LOOKUP_CAPS["fleetrec_model3"])
        sh = ShardedFleetRec(fio.load_npz(paths["model3"], cfg3, "cpu"), mesh)
        ids3, dense3 = fan_out("m3/idx"), fan_out("m3/dense")
        out["m3"], out["launches_forward3"] = _counted(
            lambda: sh.forward(ids3, dense3).cpu().numpy())
        out["fold3"] = sh._use_w1_fold
        out["split3"] = _split_forward(sh, ids3, dense3)
        out["overlap3"] = _overlap(sh, fan_out("m3/pip_time"), fan_out("m3/pip_dense"))
        del sh
        torch.cuda.empty_cache()
    return out


def serving_inputs(rng):
    """{key: array} of the serving checks' batches (serving_checks), int32
    ids: model1's B_TIME rows, the same with a bad take id on rows 5 and 9,
    4 batches of B_SERVE for the pipelined check, OVERLAP_K of B_TIME for its
    timing, bags of BAG_L; model3's B_TIME rows with dense of +-1 and
    OVERLAP_K batches of them."""
    cfg1 = C.fleetrec_model1(batch_size=B_TIME)
    cfg3 = _cap(C.fleetrec_model3(batch_size=B_TIME), LOOKUP_CAPS["fleetrec_model3"])
    ids1 = _rand_ids(cfg1, B_TIME, rng)
    bad1 = ids1.copy()
    take_cols = [j for j, t in enumerate(cfg1.tables) if t.rows > cfg1.onehot_factor_max]
    bad1[5, take_cols[-1]] = cfg1.tables[take_cols[-1]].rows
    bad1[9, take_cols[0]] = -1

    def dense3(*lead):
        return rng.choice([-1.0, 1.0], (*lead, cfg3.dense_dim)).astype(np.float32)

    return {"m1/idx": ids1, "m1/bad": bad1,
            "m1/pip": np.stack([_rand_ids(cfg1, B_SERVE, rng) for _ in range(4)]),
            "m1/pip_time": np.stack([_rand_ids(cfg1, B_TIME, rng) for _ in range(OVERLAP_K)]),
            "m1/bags": make_bags(cfg1, B_TIME, BAG_L, seed=25)[0],
            "m3/idx": _rand_ids(cfg3, B_TIME, rng), "m3/dense": dense3(B_TIME),
            "m3/pip_time": np.stack([_rand_ids(cfg3, B_TIME, rng) for _ in range(OVERLAP_K)]),
            "m3/pip_dense": dense3(OVERLAP_K, B_TIME)}


def train_config(tag):
    """The config of a sharded training run: "model1" at full rows,
    "model3" in float32 with its take tables capped at 1M rows (the fold
    path: H1 2048 < F 3968), "model1_100k" at SHARD_SERVE_ROWS rows a
    table."""
    if tag == "model1":
        return C.fleetrec_model1(batch_size=B_TIME)
    if tag == "model3":
        return dataclasses.replace(_cap(C.fleetrec_model3(batch_size=B_TIME),
                                        LOOKUP_CAPS["fleetrec_model3"]), table_dtype="float32")
    if tag == "model1_100k":
        return _cap(C.fleetrec_model1(batch_size=B_TIME), SHARD_SERVE_ROWS)
    raise KeyError(tag)


def train_inputs(rng):
    """{key: array} of each training config's global batch: B_TIME rows of
    int32 ids, dense in [-1, 1) (model3) and labels of 0 / 1."""
    out = {}
    for tag in TRAIN_TAGS:
        cfg = train_config(tag)
        out[f"t/{tag}/idx"] = _rand_ids(cfg, B_TIME, rng)
        if cfg.dense_dim:
            out[f"t/{tag}/dense"] = rng.uniform(-1, 1, (B_TIME, cfg.dense_dim)).astype(np.float32)
        out[f"t/{tag}/labels"] = rng.integers(0, 2, B_TIME).astype(np.float32)
    return out


def _check_shard(what, got, want, table, m, M) -> float:
    """A shard's tensor ``got`` against shard m of M of one device's
    ``want`` (a table's: its tables or rows [m * n, (m + 1) * n), the rest
    of ``got`` pad that must be 0; a weight: whole), within STEP_TOL.
    Returns the max abs error."""
    if table:
        n = got.shape[0]
        want = want[m * n:(m + 1) * n]
        if got[want.shape[0]:].any():
            raise AssertionError(f"{what}: a pad table or row is not 0 after the step")
        got = got[:want.shape[0]]
    torch.testing.assert_close(got, want, **STEP_TOL,
                               msg=lambda e: f"{what} against one device's step: {e}")
    return (got.float() - want.float()).abs().max().item() if got.numel() else 0.0


def train_check(mesh, tag, data):
    """This rank's part of the sharded SGD step on ``tag``'s config
    (train_config: uniform tables and weights built on the host, the shard
    moved to the card): one ``train_step`` on the data row's part of the
    global batch in ``data``, every launch count at 0 just before (it must
    launch 1 lookup_fused and 1 lookup_fused_backward and call no plain
    version); then the same step of ``Trainer(model, optimizer=SGD)`` on one
    device (this rank's card, the ranks in turn, the global batch): the loss
    bit-equal on a one-row mesh that exchanges features (the same
    arithmetic), else within rtol 1e-6; every tensor of the shard within
    STEP_TOL of its slice, its pad tables and rows 0.  Then SHARD_STEPS - 1
    more steps (finite losses) and the split of SPLIT_STEPS staged steps."""
    import torch.distributed as dist

    from fleetrec_tpu_torch.models.train import SGD
    from fleetrec_tpu_torch.parallel import ShardedFleetRec

    cfg, dev = train_config(tag), mesh.device
    host = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device="cpu")
    sh = ShardedFleetRec(host, mesh)
    glob = [data.get(f"t/{tag}/{k}") for k in ("idx", "dense", "labels")]
    B = glob[0].shape[0] // mesh.data
    row = [None if a is None else torch.from_numpy(a[mesh.d * B:(mesh.d + 1) * B]).to(dev)
           for a in glob]
    with plain_calls() as plain:
        loss, launches = _counted(lambda: sh.train_step(*row, SHARD_LR).item())
    if launches != _launches(lookup=1, backward=1) or any(plain.values()):
        raise AssertionError(f"{tag}: a sharded step launched {launches}, plain calls {plain}")
    got = sh.trainable_tensors()
    tables = set(sh._table_names())
    worst = 0.0
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            ref = host.to(dev)
            del host
            ref_loss = Trainer(ref, optimizer=SGD(SHARD_LR), device=dev).step(
                *[None if a is None else torch.from_numpy(a).to(dev) for a in glob]).item()
            for k, want in trainable_tensors(ref).items():
                worst = max(worst, _check_shard(f"{tag} {k} (rank {mesh.rank})", got[k], want,
                                                k in tables, mesh.m, mesh.model))
            del ref, want
            torch.cuda.empty_cache()
        dist.barrier()
    exact = mesh.data == 1 and not sh._use_w1_fold
    if not (loss == ref_loss if exact else abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)):
        raise AssertionError(f"{tag}: loss {loss!r} against one device's {ref_loss!r}")
    losses = [loss] + [sh.train_step(*row, SHARD_LR).item() for _ in range(SHARD_STEPS - 1)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses {losses}")
    nbytes = sum(t.numel() * t.element_size() for t in got.values())
    return {"loss": loss, "ref_loss": ref_loss, "exact": exact, "losses": losses,
            "launches": launches, "max_abs_err": worst, "fold": sh._use_w1_fold,
            "shard_bytes": nbytes, "split": _split_step(sh, *row)}


def _split_step(sh, ids, dense, labels, iters=SPLIT_STEPS):
    """A sharded step's time by part, the median of ``iters`` staged steps
    (every rank runs the same loop): the same functions on the same tensors
    as ``train_step``, split where autograd would run them together, each
    part closed by a synchronize; the window lookup forward and backward,
    the W1-partial forward and backward (fold), the post's forward (with
    the loss) and backward (CUDA events); the exchange, each gradient's
    all_reduce over each of its groups and the loss's (host clock around the
    collective and a synchronize, with its bytes); SGD (CUDA events)."""
    from fleetrec_tpu_torch.models.train import SGD
    from fleetrec_tpu_torch.parallel.sharded import _all_reduce

    parts, reduces = {}, {}

    @contextlib.contextmanager
    def mark(part):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        yield
        ev[1].record()
        ev[1].synchronize()
        parts.setdefault(part, []).append(ev[0].elapsed_time(ev[1]))

    def collective(label, t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _all_reduce(t, group)
        torch.cuda.synchronize()
        reduces.setdefault(label, [t.numel() * t.element_size(), []])[1].append(
            (time.perf_counter() - t0) * 1e3)

    opt = SGD(SHARD_LR)
    fold = sh._use_w1_fold
    names = sh._table_names()
    for _ in range(iters):
        tensors = sh.trainable_tensors()
        leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
        with mark("lookup fwd"):
            feats, bad = sh.lookup_train(ids, dense, leaves)
        feats_in = feats.detach().requires_grad_()
        with mark("W1-partial fwd"):
            part = sh._partial(feats_in, leaves["mlp_0"])
        h = part.detach()
        collective("exchange", h, sh.mesh.group)
        h_in = h.requires_grad_()
        with mark("post fwd and loss"):
            loss = sh.row_loss(sh.post_train(h_in, bad, dense, leaves), labels)
        post = [k for k in leaves if k not in names and not (fold and k == "mlp_0")]
        with mark("post bwd"):
            g_h, *g_post = torch.autograd.grad(loss, [h_in, *[leaves[k] for k in post]])
        grads = dict(zip(post, g_post))
        with mark("W1-partial bwd"):
            if fold:
                g_feats, grads["mlp_0"] = torch.autograd.grad(
                    part, [feats_in, leaves["mlp_0"]], g_h)
            else:
                g_feats = g_h
        with mark("lookup bwd"):
            grads.update(zip(names, torch.autograd.grad(
                feats, [leaves[k] for k in names], g_feats)))
        for k in tensors:
            g = grads[k] = grads[k].contiguous()
            for group in sh.gradient_groups(k):
                collective(f"{k} over the {'row' if group is sh.mesh.group else 'column'}",
                           g, group)
        if sh.mesh.col_group is not None:
            collective("loss over the column", loss.detach().reshape(1), sh.mesh.col_group)
        with mark("SGD"):
            opt.update(list(tensors.values()), [grads[k] for k in tensors])
    return {"parts_ms": {k: float(np.median(v)) for k, v in parts.items()},
            "collectives": {k: {"bytes": n, "ms": float(np.median(v))}
                            for k, (n, v) in reduces.items()}}


def sharded_rank(rank, D, M, paths, inputs_path, train_tags):
    """A rank of a (D, M) world: the serving checks (serving_checks, with
    ``paths``' checkpoints; one-row meshes only) and the sharded training
    step on each config of ``train_tags`` (train_check).  Returns their
    results by name."""
    from fleetrec_tpu_torch.parallel import global_mesh

    mesh = global_mesh(D, M, device="cuda")
    data = dict(np.load(inputs_path))
    out = serving_checks(mesh, paths, data) if paths else {}
    for tag in train_tags:
        out[f"train_{tag}"] = train_check(mesh, tag, data)
        torch.cuda.empty_cache()
    return out


def nccl_rank(rank, rows):
    """The NCCL world of one rank, (1, 1): model1 at ``rows`` rows a table,
    uniform tables and weights, sharded onto this rank's card from the host
    and forwarded through the exchange on the NCCL group, against the
    single-device forward of the same model on the card."""
    import torch.distributed as dist

    from fleetrec_tpu_torch.parallel import ShardedFleetRec, make_mesh

    cfg = _cap(C.fleetrec_model1(batch_size=B_SERVE), rows)
    mesh = make_mesh(1, 1, "cuda")
    sh = ShardedFleetRec(init_model(cfg, table_scheme="uniform", mlp_scheme="uniform",
                                    device="cpu"), mesh)
    single = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device="cuda")
    ids = torch.from_numpy(_rand_ids(cfg, B_SERVE, np.random.default_rng(23))).to(mesh.device)
    with torch.inference_mode():
        got, want = sh.forward(ids).cpu().numpy(), single(ids).cpu().numpy()
    return {"backend": dist.get_backend(mesh.group), "equal": bool(np.array_equal(got, want)),
            "max_abs_err": float(np.abs(got - want).max())}


def _serve_client(ports, batches, B):
    """Send ``batches`` [(ids [D * B, T], None)] over loopback, data row d's
    rows to ``ports[d]`` (retrying each connect while the world builds its
    model), and read every row's replies: [n, D * B] scores."""
    def one(d, out):
        sock = None
        for _ in range(2400):
            try:
                sock = socket.create_connection(("127.0.0.1", ports[d]), timeout=60)
                break
            except OSError:
                time.sleep(0.1)
        if sock is None:
            raise AssertionError(f"the leader of data row {d} never bound port {ports[d]}")
        want, buf = len(batches) * B * 4, b""
        with sock:
            for idx, _ in batches:
                sock.sendall(idx[d * B:(d + 1) * B].tobytes())
            while len(buf) < want:
                chunk = sock.recv(want - len(buf))
                if not chunk:
                    break
                buf += chunk
        if len(buf) != want:
            raise AssertionError(f"data row {d}: {len(buf)} reply bytes, want {want}")
        out[d] = np.frombuffer(buf, np.float32).reshape(len(batches), B)

    out, errs = {}, []

    def run(d):
        try:
            one(d, out)
        except BaseException as e:  # re-raised below
            errs.append(e)

    ths = [threading.Thread(target=run, args=(d,), daemon=True) for d in range(len(ports))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(WORLD_DEADLINE_S)
    if errs:
        raise errs[0]
    return np.concatenate([out[d] for d in range(len(ports))], axis=1)


def serve_world(tmp, tag, D, M, B, n_batches, cfg, extra, golden, backend="gloo"):
    """``cli serve --mesh D,M --procs D*M --backend <backend> --reply`` on
    D*M spawned ranks (gloo: all on this card; nccl: one card a rank); data
    row d's leader on its own port gets rows [d * B, (d + 1) * B) of each
    batch from the loopback sender (loadgen's single-sender wire, the
    replies read back); the replies must equal ``golden(ids)`` bit for bit.
    Returns the ranks' results."""
    rng = np.random.default_rng(24)
    batches = [(_rand_ids(cfg, D * B, rng), None) for _ in range(n_batches)]
    ports = [_free_port() for _ in range(D)]
    argvs = [["serve", "--config", "fleetrec_model1", "--batch", str(B), "--batches",
              str(n_batches), "--mesh", f"{D},{M}", "--procs", str(D * M), "--backend", backend,
              "--coordinator", f"file://{os.path.join(tmp, tag + '.serve.rendezvous')}",
              "--port", str(ports[r // M]), "--slots", "4", "--reply", "--device", "cuda",
              *extra] for r in range(D * M)]
    res, scores = run_world(D * M, cli_rank, (argvs,), tmp, tag, backend=None,
                            on_started=lambda: _serve_client(ports, batches, B))
    for k, (idx, _) in enumerate(batches):
        if not np.array_equal(scores[k], golden(idx)):
            raise AssertionError(f"{tag}: served batch {k} differs from the oracle")
    for r, rr in enumerate(res):
        if rr["launches"]["lookup_fused"] < 1 or rr["launches"]["fused_mlp"] < 1:
            raise AssertionError(f"{tag}: rank {r}: a kernel of the path never launched: "
                                 f"{rr['launches']}")
    return res


def cli_rank(rank, argvs):
    """A rank of a ``cli serve --mesh`` world: ``cli.main(argvs[rank] +
    [--proc-id rank])`` (the CLI joins the world itself); returns its
    summary line and the launch counts of the run (every count set to 0
    just before)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, launches = _counted(lambda: cli.main([*argvs[rank], "--proc-id", str(rank)]))
    return {"summary": json.loads(buf.getvalue().strip().splitlines()[-1]),
            "launches": launches}


def log_step_split(tag, world, r):
    """The log line of a rank's sharded step split (train_check)."""
    sp = r["split"]
    parts = ", ".join(f"{k} {v:.4f} ms" for k, v in sp["parts_ms"].items())
    colls = ", ".join(f"{k} {v['ms']:.4f} ms for {v['bytes']} B "
                      f"({v['bytes'] / v['ms'] / 1e6:.3f} GB/s)"
                      for k, v in sp["collectives"].items() if v["ms"] > 0) or "none"
    log(f"time sharded step {tag} B={B_TIME} on {world}, rank 0, median of {SPLIT_STEPS} "
        f"staged steps (each part closed by a synchronize): {parts} (CUDA events); "
        f"collectives (host clock around the all_reduce and a synchronize): {colls}")


def phase_sharded(dev, model1, tabs, ws, model3, dlrm):
    """The sharded path on this card (phase 12); see the module docstring.
    Returns the window checks' worst errors (forward, backward), rank 0's
    results of the (1, 2) world (the sharded forward's and step's launch
    counts, the splits), and the window operands the report times."""
    t0 = time.time()
    err_w, n_w, timed = check_windows(model1, model3, dev)
    log(f"phase 12 (1) window kernels: lookup_fused and lookup_fused_bags with shard "
        f"descriptors and take windows, M in {WINDOW_MS}, bit-equal to their plain versions in "
        f"{n_w} checks (model1 full rows B={B_TIME}, bags of {BAG_L}; model3 int8 at 1M-row "
        f"take tables), flags the unsharded ones, shards summing to the unsharded lookup "
        f"(max_abs_err {err_w}; {time.time() - t0:.1f}s)")
    t1 = time.time()
    err_b, n_b, timed_b = check_backward_windows(model1, dlrm, dev)
    log(f"phase 12 (1b) lookup_fused_backward with shard descriptors and take windows, M in "
        f"{WINDOW_MS}: bit-equal to its plain version on integer cotangents in {n_b} checks "
        f"(model1 full rows and dlrm_terabyte at {DLRM_ROWS} rows a table, B={B_TIME}, int32 "
        f"ids of each draw {ID_DRAWS}, uniform with bad ones), the shards' gradients placed at "
        f"their windows bit-equal to the "
        f"unsharded backward's, pad tables and rows 0 (max_abs_err {err_b}; "
        f"{time.time() - t1:.1f}s)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        t1 = time.time()
        cfg1 = model1.cfg
        paths = {"model1": os.path.join(tmp, "model1.npz"),
                 "model3": os.path.join(tmp, "model3.npz")}
        fio.save_npz(paths["model1"], model1)
        cfg3 = _cap(C.fleetrec_model3(batch_size=B_TIME), LOOKUP_CAPS["fleetrec_model3"])
        m3 = init_model(cfg3, table_scheme="pm1", mlp_scheme="ones", device="cpu")
        fio.save_npz(paths["model3"], m3)
        del m3
        rng = np.random.default_rng(22)
        data = {**serving_inputs(rng), **train_inputs(rng)}
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **data)
        ids1, bad1, bags1 = data["m1/idx"], data["m1/bad"], data["m1/bags"]
        golden1 = ref.forward(cfg1, tabs, ws, ids1).astype(np.float32)
        if not np.array_equal(pm1_scores(cfg1, ids1, None).astype(np.float32), golden1):
            raise AssertionError("the pm1 closed form differs from the oracle on model1")
        golden3 = pm1_scores(cfg3, data["m3/idx"], data["m3/dense"]).astype(np.float32)
        with torch.inference_mode():
            single1 = model1(torch.from_numpy(ids1).to(dev)).cpu().numpy()
            single_bad = model1(torch.from_numpy(bad1).to(dev)).cpu().numpy()
            single_pooled = model1.forward_pooled(torch.from_numpy(bags1).to(dev)).cpu().numpy()
        setup = time.time() - t1

        t2 = time.time()
        (r0, r1), _ = run_world(2, sharded_rank, (1, 2, paths, inputs, ("model1", "model3")),
                                tmp, "sharded_1x2")
        check_serving((r0, r1), golden1, single1, single_bad, single_pooled, golden3, "(1, 2)")
        log(f"phase 12 (2, 3) a (data=1, model=2) world of 2 ranks on this card over gloo "
            f"(set-up: checkpoints and oracles {setup:.1f}s; the world {time.time() - t2:.1f}s): "
            f"model1 at full rows, pm1 / ones, B={B_TIME}: both ranks' scores bit-equal to the "
            f"oracle and to the single-device forward (feature exchange "
            f"{r0['split1']['exchange_shape']}); forward_pipelined K=4 x {B_SERVE} bit-equal to "
            f"forward; forward_pooled L={BAG_L} equal to one device's; bad ids -> NaN rows [5, 9]; "
            f"model3 (int8, take tables at 1M rows, dense 64) pm1 / ones bit-equal to the oracle "
            f"(W1-partial exchange {r0['split3']['exchange_shape']}); launches per sharded "
            f"forward {r0['launches_forward']}, pooled {r0['launches_pooled']}")
        log_training("(1, 2) gloo world", (r0, r1))

        t3 = time.time()
        r22t, _ = run_world(4, sharded_rank, (2, 2, None, inputs, ("model1_100k",)), tmp,
                            "train_2x2")
        log_training("(2, 2) gloo world", r22t)
        log(f"phase 12 (6) the sharded step on a (2, 2) world of 4 ranks on this card over gloo: "
            f"model1 at {SHARD_SERVE_ROWS} rows a table ({time.time() - t3:.1f}s)")

        t3 = time.time()
        ckpt = ["--ckpt", paths["model1"]]
        r12 = serve_world(tmp, "serve_1x2", 1, 2, B_SERVE, N_SERVE, C.fleetrec_model1(), ckpt,
                          lambda idx: ref.forward(cfg1, tabs, ws, idx).astype(np.float32))
        cfg_c = _cap(C.fleetrec_model1(), SHARD_SERVE_ROWS)
        r22 = serve_world(tmp, "serve_2x2", 2, 2, B_SERVE, N_SERVE, cfg_c,
                          ["--max-rows", str(SHARD_SERVE_ROWS), "--fuse", "2"],
                          lambda idx: pm1_scores(cfg_c, idx, None).astype(np.float32))
        log(f"phase 12 (4) cli serve --mesh 1,2 --procs 2 --backend gloo (model1 full rows "
            f"from its checkpoint) and --mesh 2,2 --procs 4 --fuse 2 (rows capped at "
            f"{SHARD_SERVE_ROWS}): {N_SERVE} batches x {B_SERVE} rows a data row over loopback, "
            f"replies bit-equal to the oracle; summaries {[r['summary'] for r in r12]} / "
            f"{[r['summary'] for r in r22]}; launches of the leaders' runs "
            f"{r12[0]['launches']} / {r22[0]['launches']} ({time.time() - t3:.1f}s)")

        t4 = time.time()
        (rn,), _ = run_world(1, nccl_rank, (SHARD_SERVE_ROWS,), tmp, "nccl_1x1", backend="nccl")
        if rn["backend"] != "nccl" or not rn["equal"]:
            raise AssertionError(f"the NCCL world of one rank: {rn}")
        log(f"phase 12 (5) an nccl world of one rank, (1, 1): model1 at {SHARD_SERVE_ROWS} rows, "
            f"uniform data, the sharded forward through the NCCL exchange bit-equal to the "
            f"single-device forward ({time.time() - t4:.1f}s)")
    finally:
        shutil.rmtree(tmp)
    log_forward_splits(r0, "(1, 2) on one card (the other rank's kernels share it)",
                       "gloo all_reduce staged through host memory between two ranks on one "
                       "card: not an interconnect number")
    for tag, world, res in (("model1", "(1, 2)", r0), ("model3", "(1, 2)", r0),
                            ("model1_100k", "(2, 2)", r22t[0])):
        log_step_split(tag, f"a {world} gloo world on one card", res[f"train_{tag}"])
    log(f"phase 12 sharded serving and training: all passed ({time.time() - t0:.1f}s)")
    return (err_w, err_b), r0, timed, timed_b


def check_serving(res, golden1, single1, single_bad, single_pooled, golden3, world):
    """serving_checks' results ``res`` of every rank of a one-row world against
    the oracle and one device: model1 bit-equal to both, forward_pipelined
    to forward, forward_pooled to one device's, NaN on exactly rows [5, 9]
    of the bad batch, model3 to the oracle; one lookup_fused and one
    fused_mlp launch a forward (lookup_fused_bags a pooled one); model1
    exchanges features, model3 the W1-partial."""
    for rank, r in enumerate(res):
        checks = ((r["m1"], golden1, "model1 against the oracle"),
                  (r["m1"], single1, "model1 against the single-device forward"),
                  (r["m1_pipelined"], r["m1_sequential"], "forward_pipelined against forward"),
                  (r["m1_pooled"], single_pooled, "forward_pooled against one device's"),
                  (r["m3"], golden3, "model3 against the oracle"))
        for got, want, what in checks:
            if not np.array_equal(got, want):
                raise AssertionError(f"{world} world rank {rank}: {what} differ")
        nan_rows = np.flatnonzero(np.isnan(r["m1_bad"])).tolist()
        if nan_rows != [5, 9] or not np.array_equal(np.isnan(single_bad), np.isnan(r["m1_bad"])):
            raise AssertionError(f"{world} world rank {rank}: bad-id NaN rows {nan_rows}")
        if (r["launches_forward"] != _launches(lookup=1, mlp=1)
                or r["launches_pooled"] != _launches(bags=1, mlp=1)
                or r["launches_forward3"] != _launches(lookup=1, mlp=1)):
            raise AssertionError(f"{world} world rank {rank}: launches per sharded forward "
                                 f"{r['launches_forward']}, pooled {r['launches_pooled']}, "
                                 f"model3 {r['launches_forward3']}")
    if res[0]["fold1"] or not res[0]["fold3"]:
        raise AssertionError("model1 must exchange features, model3 the W1-partial")


def log_training(world, res):
    """The log line of a world's sharded steps (train_check's results of
    every rank; each rank checked its shard itself)."""
    for key in [k for k in res[0] if k.startswith("train_")]:
        r = res[0][key]
        log(f"sharded step {key[6:]} on the {world}: every rank launched "
            f"{r['launches']} in a train_step and called no plain version; the loss "
            f"{r['loss']!r} against one device's SGD step {r['ref_loss']!r} "
            f"({'bit-equal' if r['exact'] else 'within rtol 1e-6'}); every rank's shard and "
            f"weights within {STEP_TOL} of one device's (max abs err "
            f"{max(x[key]['max_abs_err'] for x in res):.3g}), pad tables and rows 0; "
            f"{'the W1-partial' if r['fold'] else 'the feature'} exchange; losses of "
            f"{SHARD_STEPS} steps {r['losses']}; {r['shard_bytes']} B of shard and weights on "
            f"rank 0")


def log_forward_splits(r0, where, note):
    """The log lines of rank 0's sharded forward splits (serving_checks)
    and forward_pipelined's overlap."""
    for tag, key, fold, ov in (("model1 (feature exchange)", "split1", r0["fold1"], "overlap1"),
                               ("model3 (W1-partial exchange)", "split3", r0["fold3"],
                                "overlap3")):
        sp = r0[key]
        matmul = (f"{sp['W1-partial matmul']:.4f} ms (a cuBLAS product)" if fold
                  else "none (the features are exchanged)")
        o = r0[ov]
        log(f"time sharded forward {tag} B={B_TIME}, rank 0 of {where}, median of {SPLIT_ITERS} "
            f"(each part closed by a synchronize): window lookup {sp['lookup']:.4f} ms, "
            f"W1-partial matmul {matmul} (CUDA events), exchange {sp['exchange']:.4f} ms wall "
            f"for {sp['exchange_bytes']} B {sp['exchange_shape']} "
            f"({sp['exchange_bytes'] / sp['exchange'] / 1e6:.3f} GB/s; {note}), tower and poison "
            f"{sp['tower']:.4f} ms (CUDA events); whole forward {sp['forward']:.4f} ms wall; "
            f"forward_pipelined of {OVERLAP_K} batches {o['pipelined']:.4f} ms against "
            f"{OVERLAP_K} forwards {o['sequential']:.4f} ms (host clock, median of "
            f"{OVERLAP_REPS} in turns)")


# ---- phase 15: sharded checkpoints (io.save_sharded / io.load_sharded) --------

# the batches a restored model1 is scored at
CKPT_BATCHES = (B_TIME, B_SERVE)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def disk_bytes(path) -> int:
    """The bytes of every file under the directory ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def synced(fn):
    """``fn()`` between two device synchronizes; returns its result and its
    seconds on the host clock."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def same_checkpoint_tensors(a, b) -> bool:
    """Whether two targets hold the same checkpoint arrays
    (``io.checkpoint_tensors``), bit for bit."""
    ta, tb = fio.checkpoint_tensors(a), fio.checkpoint_tensors(b)
    return ta.keys() == tb.keys() and all(
        ta[k].shape == tb[k].shape and torch.equal(bits(ta[k]), bits(tb[k])) for k in ta)


def checkpoint_rank(rank, paths, inputs_path):
    """A rank of phase 15's (data=1, model=2) world on this card: model1
    restored from the one-device checkpoint onto the mesh (``load_sharded``
    with the mesh; twice, each timed), scored at CKPT_BATCHES with every
    launch count at 0 just before, then saved from the mesh.  Returns the
    scores, the launches and the loads' and the save's seconds (each
    between barriers)."""
    import torch.distributed as dist

    from fleetrec_tpu_torch.parallel import global_mesh

    mesh = global_mesh(1, 2, device="cuda")
    data = dict(np.load(inputs_path))
    cfg = C.fleetrec_model1(batch_size=B_TIME)
    dist.barrier()
    sh, load_s = synced(lambda: fio.load_sharded(paths["one"], cfg, mesh=mesh))
    # the same load again: the first carries the process's first use of DCP,
    # DTensor and the groups
    dist.barrier()
    sh, again_s = synced(lambda: fio.load_sharded(paths["one"], cfg, mesh=mesh))
    ids = {B: torch.from_numpy(data[f"ck/{B}"]).to(mesh.device) for B in CKPT_BATCHES}
    with torch.inference_mode():
        scores, launches = _counted(lambda: {B: sh.forward(ids[B]).cpu().numpy()
                                             for B in CKPT_BATCHES})
    dist.barrier()
    _, save_s = synced(lambda: fio.save_sharded(paths["mesh"], sh))
    return {"scores": scores, "launches": launches, "load_s": load_s, "again_s": again_s,
            "save_s": save_s, "shard_bytes": sum(t.numel() * t.element_size()
                               for t in fio.checkpoint_tensors(sh).values())}


def phase_checkpoint(dev, model):
    """Phase 15: phase 4's pm1 model1 (full rows) through sharded
    checkpoints; see the module docstring.  Returns the launch counts of the
    restored one-device forwards."""
    t0 = time.time()
    cfg = model.cfg
    rng = np.random.default_rng(15)
    idx = {B: _rand_ids(cfg, B, rng) for B in CKPT_BATCHES}
    golden = {B: pm1_scores(cfg, idx[B], None).astype(np.float32) for B in CKPT_BATCHES}
    ids = {B: torch.from_numpy(idx[B]).to(dev) for B in CKPT_BATCHES}

    def scores(m):
        with torch.inference_mode():
            return {B: m(ids[B]).cpu().numpy() for B in CKPT_BATCHES}

    def check(got, what, want=None):
        for B in CKPT_BATCHES:
            if not np.array_equal(got[B], golden[B]):
                raise AssertionError(f"phase 15 {what}: B={B} scores differ from the oracle")
            if want is not None and not np.array_equal(got[B], want[B]):
                raise AssertionError(f"phase 15 {what}: B={B} scores differ from the saved "
                                     f"model's")

    before = scores(model)
    check(before, "model1 before the save")
    notes, rows = [], {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        paths = {k: os.path.join(tmp, k) for k in ("one", "mesh", "int8")}
        _, save_s = synced(lambda: fio.save_sharded(paths["one"], model))
        restored, load_s = synced(lambda: fio.load_sharded(paths["one"], cfg))
        if restored.device != dev or not same_checkpoint_tensors(restored, model):
            raise AssertionError("phase 15: the restored model1 is not the saved one on the card")
        got, launches = _counted(lambda: scores(restored))
        if launches != _launches(lookup=len(CKPT_BATCHES), mlp=len(CKPT_BATCHES)):
            raise AssertionError(f"phase 15: the restored forwards launched {launches}")
        check(got, "one device -> one device", before)
        del restored
        rows["model1 float32, one device -> one device"] = (disk_bytes(paths["one"]), save_s,
                                                           load_s)

        q = fio.quantize_tables(model)
        q_before = scores(q)
        check(q_before, "model1 int8 before the save")
        _, qsave_s = synced(lambda: fio.save_sharded(paths["int8"], q))
        q_restored, qload_s = synced(lambda: fio.load_sharded(paths["int8"], q.cfg))
        if not same_checkpoint_tensors(q_restored, q):
            raise AssertionError("phase 15: the restored int8 model1 (tables and scales) is not "
                                 "the saved one")
        check(scores(q_restored), "int8, one device -> one device", q_before)
        n_scales = len(q.packed.onehot_scales) + (q.packed.take_scales is not None)
        del q, q_restored
        torch.cuda.empty_cache()
        rows["model1 int8, one device -> one device"] = (disk_bytes(paths["int8"]), qsave_s,
                                                        qload_s)

        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **{f"ck/{B}": idx[B] for B in CKPT_BATCHES})
        t1 = time.time()
        res, _ = run_world(2, checkpoint_rank, (paths, inputs), tmp, "ckpt_1x2")
        for r, out in enumerate(res):
            check(out["scores"], f"one device -> (1, 2), rank {r}", before)
            if out["launches"] != _launches(lookup=len(CKPT_BATCHES), mlp=len(CKPT_BATCHES)):
                raise AssertionError(f"phase 15: rank {r}'s restored sharded forwards launched "
                                     f"{out['launches']}")
        world_s = time.time() - t1
        mesh_restored, mload_s = synced(lambda: fio.load_sharded(paths["mesh"], cfg))
        if not same_checkpoint_tensors(mesh_restored, model):
            raise AssertionError("phase 15: the (1, 2) save restored onto one device is not "
                                 "model1")
        check(scores(mesh_restored), "(1, 2) -> one device", before)
        del mesh_restored
        torch.cuda.empty_cache()
        for what, key in (("", "load_s"), (", again", "again_s")):
            rows[f"model1 float32, one device -> (1, 2) gloo{what}"] = (
                rows["model1 float32, one device -> one device"][0], None,
                max(r[key] for r in res))
        rows["model1 float32, (1, 2) gloo -> one device"] = (
            disk_bytes(paths["mesh"]), max(r["save_s"] for r in res), mload_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = card_line()
    for what, (nbytes, save, load) in rows.items():
        save_txt = (f"save {save:.3f} s ({nbytes / save / 1e9:.3f} GB/s)" if save is not None
                    else "save: the row above")
        log(f"time phase 15 checkpoint {what} on {card}: {nbytes} B on disk, {save_txt}, "
            f"load {load:.3f} s ({nbytes / load / 1e9:.3f} GB/s; page-cache warm: read "
            f"just after it was written); host clock between synchronizes")
    log(f"phase 15 sharded checkpoints: model1 at full rows (pm1 / ones) saved with "
        f"io.save_sharded and restored with io.load_sharded: one device -> one device, every "
        f"array bit-equal and the forwards at B={CKPT_BATCHES} bit-equal to the float64 oracle "
        f"and to the scores before the save, launches of the restored forwards {launches}; the "
        f"int8 form (quantize_tables, {n_scales} scale arrays) the same; a (1, 2) gloo world on "
        f"this card ({world_s:.1f}s): one device -> (1, 2) and (1, 2) -> one device, scores "
        f"bit-equal on both ranks and one device, launches a rank "
        f"{res[0]['launches']}, {res[0]['shard_bytes']} B of shard on rank 0 "
        f"({time.time() - t0:.1f}s)")
    return {"launches": launches, "rows": rows, "card": card}


def gathered_tensors(sh, group):
    """The global arrays of a mesh, on every rank of one of its data rows:
    each split array's valid rows, padded to ``ceil(rows / M)`` (the same
    size on every rank), all_gathered over the row's model ``group`` and cut
    to its global rows; each replicated array this rank's."""
    import torch.distributed as dist

    out = {}
    for name, t in fio.checkpoint_tensors(sh).items():
        rows = fio.split_rows(name, sh.plan)
        if rows is None:
            out[name] = t
            continue
        full = t.new_zeros((-(-rows // sh.mesh.model),) + tuple(t.shape[1:]))
        full[:t.shape[0]] = t
        parts = [torch.empty_like(full) for _ in range(sh.mesh.model)]
        dist.all_gather(parts, full, group=group)
        out[name] = torch.cat(parts)[:rows]
    return out


def same_tensors(a, b) -> bool:
    """Whether two {name: tensor} hold the same names and bits."""
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and torch.equal(bits(a[k]), bits(b[k])) for k in a)


def checkpoint_mesh_rank(rank, paths, inputs_path):
    """A rank of chip_mesh.py's step 5, a world of 4 ranks (one card a rank,
    NCCL) holding a (2, 2) and a (1, 4) mesh: model1 at full rows from the
    one-device checkpoint of uniform tables and weights (``paths["one"]``)
    restored onto (2, 2) (twice, each timed); one ``train_step`` (SGD) on the global batch (its
    data row's half on each row), every launch count at 0 just before; the
    trained mesh's scores; saved (``paths["trained"]``) and restored onto
    (2, 2), its arrays and scores bit-equal to the trained mesh's, and onto
    (1, 4), its arrays gathered over each mesh's model group byte-equal to
    the (2, 2) mesh's gathered, scored on the whole batch.  Then model1's pm1
    windows generated on the cards (``pack_pm1_sharded`` with the (2, 2)
    mesh, ``ShardedFleetRec.from_packed``) saved (``paths["packed"]``) and
    restored onto (2, 2), scored and checked against the windows' arrays.
    Returns the scores, launches, and each load's and save's seconds
    (between barriers)."""
    import torch.distributed as dist

    from fleetrec_tpu_torch.parallel import ShardedFleetRec, global_mesh, make_mesh

    m22 = global_mesh(2, 2, device="cuda")
    m14 = make_mesh(1, 4, device="cuda")
    dev = m22.device
    data = dict(np.load(inputs_path))
    cfg = C.fleetrec_model1(batch_size=B_TIME)
    half = data["ck/idx"].shape[0] // 2
    row = slice(m22.d * half, (m22.d + 1) * half)
    ids, labels = (torch.from_numpy(data[k][row]).to(dev) for k in ("ck/idx", "ck/labels"))
    ids_all = torch.from_numpy(data["ck/idx"]).to(dev)
    out = {"rank": rank, "card": str(dev)}

    def timed(key, fn):
        dist.barrier()
        res, out[key] = synced(fn)
        return res

    sh = timed("load_one_22_s", lambda: fio.load_sharded(paths["one"], cfg, mesh=m22))
    # the same load again: the first carries the process's first use of DCP,
    # DTensor and the groups
    del sh
    sh = timed("load_one_22_again_s", lambda: fio.load_sharded(paths["one"], cfg, mesh=m22))
    out["loss"], out["launches_step"] = _counted(
        lambda: sh.train_step(ids, None, labels, SHARD_LR).item())
    with torch.inference_mode():
        out["trained_22"], out["launches_forward"] = _counted(lambda: sh.forward(ids).cpu().numpy())
    timed("save_22_s", lambda: fio.save_sharded(paths["trained"], sh))
    again = timed("load_22_22_s", lambda: fio.load_sharded(paths["trained"], cfg, mesh=m22))
    if not same_checkpoint_tensors(again, sh):
        raise AssertionError(f"rank {rank}: the (2, 2) restore of the trained mesh differs")
    with torch.inference_mode():
        out["again_22"] = again.forward(ids).cpu().numpy()
    del again
    want = gathered_tensors(sh, m22.group)
    del sh
    torch.cuda.empty_cache()
    sh14 = timed("load_22_14_s", lambda: fio.load_sharded(paths["trained"], cfg, mesh=m14))
    if not same_tensors(gathered_tensors(sh14, m14.group), want):
        raise AssertionError(f"rank {rank}: the (1, 4) restore, gathered, differs from the "
                             f"trained (2, 2) mesh's arrays")
    out["arrays"] = len(want)
    with torch.inference_mode():
        out["scores_14"] = sh14.forward(ids_all).cpu().numpy()
    out["shard_bytes_14"] = sum(t.numel() * t.element_size()
                                for t in fio.checkpoint_tensors(sh14).values())
    del sh14, want
    torch.cuda.empty_cache()

    plan = ModelPlan.create(cfg)
    packed = pack_pm1_sharded(cfg, plan.layout, m22)
    gen = ShardedFleetRec.from_packed(plan, packed, m22, init_mlp_params(cfg.mlp, "ones",
                                                                          device=dev))
    del packed
    timed("save_packed_s", lambda: fio.save_sharded(paths["packed"], gen))
    restored = timed("load_packed_s", lambda: fio.load_sharded(paths["packed"], cfg, mesh=m22))
    if not same_checkpoint_tensors(restored, gen):
        raise AssertionError(f"rank {rank}: the restored from_packed windows differ")
    del gen
    with torch.inference_mode():
        out["packed_22"], out["launches_packed"] = _counted(
            lambda: restored.forward(ids).cpu().numpy())
    return out


# phases 14 and 16: configurations at full rows, each built on the card in a
# process of its own; the peak resident host memory its build may take (a
# host build of criteo's 52.96 GB take buffer could not stay under it)
FULL_RSS_LIMIT = 16 << 30
# the timed lookup's third criteo draw: every take id inside a footprint this size
CRITEO_WINDOW_BYTES = 1 << 30
# the batch sizes of a config at full rows: both scored, the first timed and
# addressed, the second served
FULL_BATCHES = (B_TIME, B_SERVE)
# the bf16 tower against the float64 oracle: rtol 2e-2, atol 2e-2 * max|oracle|
# (PERF.md section 2, tests/test_parity.py:107)
BF16_RTOL = BF16_ATOL_OF_MAX = 2e-2


@dataclasses.dataclass(frozen=True)
class FullRun:
    """One configuration at full rows in a process of its own
    (``full_rows_rank``): ``name`` and its config function's keyword
    arguments ``kw`` ((key, value) pairs), the senders of its served wire,
    the lookup's timed id draws (``random``, ``ids0``, ``window_1gib``),
    and whether the process checkpoints it."""

    tag: str
    name: str
    kw: tuple = ()
    senders: int = 1
    draws: tuple = ("random",)
    checkpoint: bool = False

    def config(self, B):
        return C.get_config(self.name, batch_size=B, **dict(self.kw))


# phase 14: criteo_terabyte at full cardinality, int8 tables, float32 tower
CRITEO_FULL = FullRun("criteo_int8", "criteo_terabyte",
                      (("dtype", "float32"), ("table_dtype", "int8")),
                      draws=("random", "ids0", "window_1gib"))
# phase 16: the paper's geometries and tiny_dlrm at full rows, in this order;
# model3 in its default int8 storage with the float32 tower, served over the
# paper's three-sender wire; model2 in bfloat16 (tables and tower)
FULL_ROWS = (FullRun("model2_fp32", "fleetrec_model2"),
             FullRun("model3_int8", "fleetrec_model3", senders=3),
             FullRun("model2_bf16", "fleetrec_model2", (("dtype", "bfloat16"),)),
             FullRun("tiny_dlrm", "tiny_dlrm"))
# the run phase 16 checkpoints: the first whose arrays fit twice in the free
# space of the temporary directory
CKPT_CANDIDATES = ("model3_int8", "model2_bf16")


def peak_rss() -> int:
    """This process's peak resident host memory in bytes,
    ``resource.getrusage``'s ``ru_maxrss``.  Linux carries the forking
    process's high-water mark into a child across its exec, so for a spawned
    process it is at least its parent's peak at the spawn; phase 14's
    process is forked from the forkserver ``main`` starts before any phase,
    so its value is its own (or the small server's)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def criteo_full_config(B, table_dtype="int8"):
    """criteo_terabyte at its real cardinalities (26 tables, 1,655,169,127
    rows, one of 1e9; 9 take tables in 16 stripes, 7 factored and 10
    one-hot): int8 tables with the float32 tower (phase 14, chip_mesh.py
    step 4), or ``table_dtype="bfloat16"``, the config's default: bf16
    tables and a bf16 tower (step 4's second run, on 4 cards)."""
    if table_dtype == "int8":
        return C.criteo_terabyte(batch_size=B, dtype="float32", table_dtype="int8")
    return C.criteo_terabyte(batch_size=B, dtype=table_dtype)


def take_columns(cfg):
    """The config-order columns of the take tables."""
    cut = max(cfg.onehot_max, cfg.onehot_factor_max)
    return [j for j, t in enumerate(cfg.tables) if t.rows > cut]


def bad_rows_np(cfg, idx):
    """[B] bool: rows with a take id outside its table's [0, rows)."""
    cols = take_columns(cfg)
    rows = np.asarray([cfg.tables[j].rows for j in cols])
    return ((idx[:, cols] < 0) | (idx[:, cols] >= rows)).any(1)


def window_ids(cfg, B, rng, nbytes=CRITEO_WINDOW_BYTES):
    """Ids [B, T] whose take rows all lie in a footprint of at most
    ``nbytes`` of the take buffer: each take table's ids drawn from its first
    n logical rows (n * dim bytes of int8 rows, spread over its stripes),
    n the same for every take table (or the table's rows); class ids
    uniform."""
    ids = _rand_ids(cfg, B, rng)
    cols = take_columns(cfg)
    n = nbytes // (len(cols) * cfg.tables[cols[0]].dim)
    for j in cols:
        ids[:, j] = rng.integers(0, min(n, cfg.tables[j].rows), B)
    return ids


def row_pattern(P: torch.Tensor, lanes: int) -> torch.Tensor:
    """int8 [n, lanes]: the checking pattern of take buffer rows ``P``
    (int64 [n]): lane l holds byte l % 4 of P xor ((l // 4) * 37) & 0xFF,
    so every 4 lanes of a row spell its index and each 4-lane group of it
    differs from the others: a read of another row (below 2^32 rows) or of
    another sub-row's lanes gives other bytes."""
    lane = torch.arange(lanes, device=P.device)
    shifts = torch.arange(0, 32, 8, device=P.device)
    by = ((P[:, None] >> shifts) & 0xFF).to(torch.uint8)  # [n, 4]
    mask = ((lane >> 2) * 37 & 0xFF).to(torch.uint8)
    return (by.index_select(1, lane % 4) ^ mask).view(torch.int8)


def fill_row_pattern(buf: torch.Tensor, lo: int, chunk_rows: int = 1 << 22) -> None:
    """Overwrite take rows ``buf`` (buffer rows ``[lo, lo + len(buf))``, a
    whole buffer or a shard's window) with ``row_pattern``, ``chunk_rows``
    rows a step: int8 as it is, in a float buffer the same integers
    (-128..127, exact in float32 and bfloat16)."""
    for c0 in range(0, buf.shape[0], chunk_rows):
        c1 = min(c0 + chunk_rows, buf.shape[0])
        P = torch.arange(lo + c0, lo + c1, device=buf.device)
        buf[c0:c1].copy_(row_pattern(P, buf.shape[1]))


def edge_targets(cfg, lay, windows):
    """[(config column, id, buffer row, sub-row)]: for every (stripe,
    table) segment of ``take_segments`` and every window [lo, hi) of
    buffer rows, the first and last rows of the segment inside the window
    that hold a physical row of the table, each read at its first and its
    last live sub-row.  Inverts the packing map on its own: segment row P
    -> physical row pr = (P - start) * S + k -> logical id pr * s + j.  The
    windows cover the buffer, so the last row of every table (its last id)
    is among them."""
    S = lay.take_stripes
    col_of = {t.table_id: j for j, t in enumerate(cfg.tables)}
    rows_of = {t.table_id: t.rows for t in cfg.tables}
    s_of = {tid: g.rows_per_phys for g in lay.take_groups for tid in g.table_ids}
    out = set()
    for tid, start, span, k in take_segments(lay, cfg):
        s, rows = s_of[tid], rows_of[tid]
        pr_t = -(-rows // s)
        if k >= pr_t:
            continue
        live_end = start + (pr_t - 1 - k) // S + 1  # past the segment's last live row
        for lo, hi in windows:
            a, b = max(start, lo), min(start + span, live_end, hi)
            for P in ({a, b - 1} if a < b else ()):
                pr = (P - start) * S + k
                for j in {0, min(s, rows - pr * s) - 1}:
                    out.add((col_of[tid], pr * s + j, P, j))
    return sorted(out)


def pattern_ids(cfg, targets, B, rng):
    """Ids [B, T]: uniform over every table, with target i's id in row i
    (its column)."""
    if len(targets) > B:
        raise ValueError(f"{len(targets)} targets for a batch of {B}")
    ids = _rand_ids(cfg, B, rng)
    for i, (j, r, _P, _sub) in enumerate(targets):
        ids[i, j] = r
    return ids


def check_addressing(cfg, lay, ops, ids, dense, targets, window=(0, None)):
    """``lookup_fused`` over take rows that hold ``row_pattern`` (the whole
    buffer, or the window of rows ``[window[0], window[0] + window[1])``)
    against ``lookup_fused_plain`` on the same operands, bit for bit, and
    each target's feature block against the pattern of its buffer row
    (zero outside the window), read at its sub-row's lanes and, in int8,
    scaled by its table's scale.  Raises on a mismatch; returns the number
    of targets inside the window and the features' max abs error against
    the plain version (0)."""
    dev = ids.device
    with torch.inference_mode():
        got, bad = lookup_fused(ids, dense, **ops)
        want, want_bad = lookup_fused_plain(ids, dense, **ops)
    if not (torch.equal(bits(got), bits(want)) and torch.equal(bad, want_bad)):
        raise AssertionError(f"lookup_fused differs from lookup_fused_plain over the patterned "
                             f"take rows ({int((bits(got) != bits(want)).sum())} elements)")
    err = (got.float() - want.float()).abs().max().item()
    lo, n = window
    scale = None if ops["scales"] is None else ops["scales"][-1].cpu()
    take_of = {tid: i for i, tid in enumerate(t for g in lay.take_groups for t in g.table_ids)}
    got = got.float().cpu()
    inside = 0
    for i, (j, r, P, sub) in enumerate(targets):
        t = cfg.tables[j]
        pat = row_pattern(torch.tensor([P]), lay.take_lanes)[0, sub * t.dim:(sub + 1) * t.dim]
        live = P >= lo and (n is None or P < lo + n)
        inside += live
        want = pat.float() if scale is None else pat.float() * scale[take_of[t.table_id]]
        want = want if live else torch.zeros(t.dim)
        if not torch.equal(got[i, t.out_offset:t.out_offset + t.dim], want):
            raise AssertionError(f"target {i}: table {j} id {r} (buffer row {P}, sub-row {sub}) "
                                 f"read {got[i, t.out_offset:t.out_offset + 4].tolist()}..., "
                                 f"the pattern of its row is {want[:4].tolist()}...")
    return inside, err


def on_device(dev, *arrays):
    """The numpy ``arrays`` as tensors on ``dev`` (None stays None)."""
    return [None if a is None else torch.from_numpy(a).to(dev) for a in arrays]


def pm1_dense(cfg, B, rng):
    """Dense features [B, dense_dim] of -1 / 1 (exact in every storage
    dtype), or None for a config without them."""
    return (rng.choice([-1.0, 1.0], (B, cfg.dense_dim)).astype(np.float32)
            if cfg.dense_dim else None)


def fp32_tower(model):
    """The hard gate's model: ``model``'s tables as they are (its table
    dtype kept, the same buffers) under a float32 tower of all-ones
    weights: with float32 activations the pm1 forward is exact integer
    arithmetic in every storage dtype.  ``model`` is a FleetRecModel or a
    rank's ShardedFleetRec, whose twin shares its operands."""
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    plan = ModelPlan.create(cfg)
    if isinstance(model, FleetRecModel):
        return FleetRecModel(plan, model.packed,
                             init_mlp_params(cfg.mlp, "ones", device=model.device))
    from fleetrec_tpu_torch.parallel import ShardedFleetRec

    return ShardedFleetRec.from_operands(plan, model.mesh, model.operands,
                                         init_mlp_params(cfg.mlp, "ones", device=model.mesh.device))


def pm1_towers(model, batches, dev, what=""):
    """The pm1 forwards of ``batches`` ([(ids, dense)] on the host, each
    with a bad take id) through ``model`` and, for a tower not in float32,
    through its hard gate ``fp32_tower(model)``: NaN on exactly the bad
    rows, a float32 tower's scores bit-equal to the pm1 oracle, a bf16
    tower's within the bf16 tolerance; 1 ``lookup_fused`` and 1
    ``fused_mlp`` launch a forward and no plain call.  Returns ({tower
    dtype: model}, {tower dtype: scores}, ``model``'s launches, the largest
    bf16 error (0.0 without a bf16 tower)).  Raises on a failed check."""
    cfg = model.cfg
    towers = {cfg.dtype: model}
    if cfg.dtype != "float32":
        towers["float32"] = fp32_tower(model)
    if not all(bad_rows_np(cfg, idx).any() for idx, _ in batches):
        raise AssertionError(f"{what}a batch has no row with a bad take id")
    golden = [pm1_scores(cfg, idx, dense) for idx, dense in batches]
    scores, err_bf16 = {}, 0.0
    for tower, m in towers.items():
        with plain_calls() as plain, torch.inference_mode():
            scores[tower], launches = _counted(
                lambda: [m.forward(*on_device(dev, *b)).cpu().numpy() for b in batches])
        if launches != _launches(len(batches), len(batches)) or any(plain.values()):
            raise AssertionError(f"{what}{tower} tower: launches of {len(batches)} forwards "
                                 f"{launches}, plain calls {plain}")
        if m is model:
            model_launches = launches
        for (idx, _dense), want, got in zip(batches, golden, scores[tower]):
            err = check_pm1(cfg, idx, got, want, tower == "float32",
                            f"{what}{tower} tower B={len(idx)}")
            if tower != "float32":
                err_bf16 = max(err_bf16, err)
    return towers, scores, model_launches, err_bf16


def full_rows_rank(rank, run, seed, device="cuda:0"):
    """One configuration at full rows (``run``, a FullRun) in a process of
    its own on ``device`` (``run_world`` with no process group), so that the
    card holds nothing of the earlier phases and the peak host memory read
    is this build's (phase 14: criteo_terabyte; phase 16: model2, model3,
    model2 in bf16, tiny_dlrm).  pm1 tables generated on the card by
    ``pack_pm1_sharded``, no table on the host, all-ones weights in the
    config's dtype; the take and class bytes held to ``plan(cfg, 1)`` and
    ``memory_allocated`` to its ``per_chip_bytes``; forwards at both batch
    sizes on ``ids_with_bad`` ids (and ±1 dense) bit-equal to the pm1 oracle
    with NaN on exactly the bad rows, 1 ``lookup_fused`` and 1 ``fused_mlp``
    call each and no plain call (a bf16 tower: within the bf16 tolerance,
    and the hard gate, the float32 tower over the same tables, bit-equal);
    N_SERVE batches served over ``run.senders`` wires, replies bit-equal to
    the oracle (bf16: the gate's replies; the bf16 tower's equal to its
    direct forwards and within the tolerance); the take rows overwritten
    with ``row_pattern`` and ``check_addressing`` on the edge targets of
    every (stripe, table) segment; the timings of ``time_full_rows``; with
    ``run.checkpoint`` the model saved with ``io.save_sharded`` and restored
    on the card (``checkpoint_full_rows``).  Raises on a failed check;
    returns the results and the log lines."""
    dev = torch.device(device)
    lines, out = [], {"tag": run.tag, "card": card_line() if dev.type == "cuda" else "cpu"}

    def note(msg):
        lines.append(msg)
        print(msg, flush=True)

    B_big, B_srv = FULL_BATCHES
    cfg = run.config(B_big)
    plan = ModelPlan.create(cfg)
    lay = plan.layout
    pl = planner.plan(cfg, 1, batch_size=B_big)
    free, total = torch.cuda.mem_get_info(dev)
    out["allocated_before"] = torch.cuda.memory_allocated(dev)
    note(f"{cfg.name} ({cfg.table_dtype} tables, {cfg.dtype} tower, {cfg.num_tables} tables, "
         f"{sum(t.rows for t in cfg.tables)} rows, {lay.feature_dim} wide, MLP "
         f"{'-'.join(map(str, cfg.mlp.widths))}) before the build: memory_allocated "
         f"{out['allocated_before']} B; the card has {free} of {total} B free; the plan: take "
         f"{pl.take_bytes_total} B, classes {pl.onehot_bytes} B, per card {pl.per_chip_bytes} B "
         f"of {pl.hbm_budget_bytes}")
    out["rss_before_build"] = peak_rss()  # the CUDA context made, no table yet
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = pack_pm1_sharded(cfg, lay, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    dtype = TORCH_DTYPES[cfg.dtype]
    model = FleetRecModel(plan, packed, init_mlp_params(cfg.mlp, "ones", dtype=dtype, device=dev))
    del packed
    out["allocated"] = torch.cuda.memory_allocated(dev)
    take = model.take
    out["take_bytes"] = take.nbytes
    out["class_bytes"] = sum(b.nbytes for b in model.packed.onehot_buffers)
    out["rss_after_build"] = peak_rss()
    if out["take_bytes"] != pl.take_bytes_total:
        raise AssertionError(f"take buffer {out['take_bytes']} B, the planner says "
                             f"{pl.take_bytes_total}")
    if out["class_bytes"] != pl.onehot_bytes:
        raise AssertionError(f"class buffers {out['class_bytes']} B, the planner says "
                             f"{pl.onehot_bytes}")
    if out["allocated"] > pl.per_chip_bytes:
        raise AssertionError(f"memory_allocated {out['allocated']} B after the build, over the "
                             f"planner's {pl.per_chip_bytes}")
    n_class = [c.num_tables for c in lay.onehot_classes]
    note(f"built in {out['build_s']:.2f} s on the card: take buffer "
         f"{tuple(take.shape)} {cfg.table_dtype} = {out['take_bytes']} B = plan(cfg, "
         f"1).take_bytes_total ({take.numel()} elements); {len(n_class)} class buffers "
         f"({sum(c.r2 > 0 for c in lay.onehot_classes)} factored; {sum(n_class)} tables) = "
         f"{out['class_bytes']} B = onehot_bytes; {lay.n_take} take tables in "
         f"{lay.take_stripes} stripes; memory_allocated {out['allocated']} B <= per_chip_bytes "
         f"{pl.per_chip_bytes}; peak host RSS {out['rss_before_build']} B before the build (the "
         f"CUDA context made), {out['rss_after_build']} B after it")

    exact = cfg.dtype == "float32"
    rng = np.random.default_rng(seed)
    batches = [(ids_with_bad(cfg, B, rng), pm1_dense(cfg, B, rng)) for B in FULL_BATCHES]
    towers, out["scores"], out["launches"], out["max_abs_err_bf16"] = pm1_towers(
        model, batches, dev)
    bad = np.flatnonzero(bad_rows_np(cfg, batches[0][0]))
    note(f"forwards at B={FULL_BATCHES} (uniform ids over every table, bad take ids on rows "
         f"{bad}): " + ("scores bit-equal to the pm1 oracle" if exact else
                        f"the hard gate (the {cfg.table_dtype} tables under a float32 tower) "
                        f"bit-equal to the pm1 oracle, the {cfg.dtype} tower within rtol "
                        f"{BF16_RTOL} / atol {BF16_ATOL_OF_MAX} x max|oracle| of it (max abs "
                        f"err {out['max_abs_err_bf16']!r})")
         + f", TF32 off, NaN on exactly the bad rows; launches {out['launches']} a tower, no "
           f"plain call")

    cfg_s = run.config(B_srv)
    served = [(_rand_ids(cfg_s, B_srv, rng), pm1_dense(cfg_s, B_srv, rng))
              for _ in range(N_SERVE)]
    golden_s = [pm1_scores(cfg_s, idx, dense) for idx, dense in served]
    out["serve"] = {}
    for tower, m in towers.items():
        replies, launches, summary = serve_loopback(cfg_s, m, served, senders=run.senders)
        if launches != _launches(N_SERVE, N_SERVE):
            raise AssertionError(f"{tower} tower: launches of the served run {launches}")
        with torch.inference_mode():
            for k, ((idx, dense), want) in enumerate(zip(served, golden_s)):
                what = f"{tower} tower: served batch {k}"
                check_pm1(cfg_s, idx, replies[k], want, tower == "float32", what)
                if tower != "float32":
                    direct = m(*on_device(dev, idx, dense)).cpu().numpy()
                    if not np.array_equal(replies[k], direct):
                        raise AssertionError(f"{what} differs from its direct forward")
        out["serve"][tower] = {"launches": launches,
                               **{k: summary.get(k) for k in ("latency_ms_p50", "latency_ms_p99")}}
        if m is model:
            out["serve_launches"] = launches
        note(f"ServingEngine.from_model ({tower} tower) served {N_SERVE} batches x {B_srv} over "
             f"loopback on {run.senders} sender(s) (bytes a sender "
             f"{[p['bytes'] for p in summary['per_sender']]}), "
             + ("replies bit-equal to the pm1 oracle" if tower == "float32" else
                "replies bit-equal to its direct forwards and within the bf16 tolerance of the "
                "oracle")
             + f"; launches {launches}; latency_ms p50 {summary.get('latency_ms_p50')} p99 "
               f"{summary.get('latency_ms_p99')} (host clock)")

    # pm1 rows are alike (row r holds r's parity), so the lookup's
    # addressing is held on rows that spell their own index
    t0 = time.perf_counter()
    fill_row_pattern(take, 0)
    torch.cuda.synchronize()
    targets = edge_targets(cfg, lay, [(0, lay.take_phys_total)])
    idx_t, dense_t = on_device(dev, pattern_ids(cfg, targets, B_big, rng), batches[0][1])
    ops = model.lookup_operands()
    _inside, out["max_abs_err"] = check_addressing(cfg, lay, ops, idx_t, dense_t, targets)
    row_bytes = lay.take_lanes * take.element_size()
    last = max(P for _j, _r, P, _s in targets)
    past = sum(P * row_bytes >= 1 << 32 for _j, _r, P, _s in targets)
    big = max(range(cfg.num_tables), key=lambda j: cfg.tables[j].rows)
    if last < (lay.take_stripes - 1) * lay.stripe_height or (
            take.nbytes - row_bytes >= 1 << 32 and not past):
        raise AssertionError(f"the targets stop at buffer row {last}, short of the last stripe "
                             f"or of 4 GiB")
    if not any(j == big and r == cfg.tables[big].rows - 1 for j, r, _P, _s in targets):
        raise AssertionError(f"no target reads the largest table's last id")
    out["targets"], out["targets_past_4gib"] = len(targets), past
    note(f"take rows overwritten with their index pattern in "
         f"{time.perf_counter() - t0:.2f} s; lookup_fused bit-equal to lookup_fused_plain at "
         f"B={B_big} (features and flags) and every one of {len(targets)} targets (the first "
         f"and last rows of each of the {len(take_segments(lay, cfg))} (stripe, table) "
         f"segments, at the first and last sub-row) equal to its row's pattern; targets reach "
         f"buffer row {last} of {lay.take_phys_total} (byte offset {last * row_bytes}), "
         f"{past} of them past 4 GiB, table {big}'s last id {cfg.tables[big].rows - 1} among "
         f"them; peak allocated {torch.cuda.max_memory_allocated(dev)} B")

    time_full_rows(run, cfg, model, dense_t, rng, out, note)
    out["rss"] = peak_rss()
    if out["rss"] > FULL_RSS_LIMIT:
        raise AssertionError(f"peak host RSS {out['rss']} B, over {FULL_RSS_LIMIT}")
    note(f"peak host RSS of the process {out['rss']} B <= {FULL_RSS_LIMIT} (getrusage; the "
         f"process forked from the forkserver started before phase 1)")
    if run.checkpoint:
        out["checkpoint"] = checkpoint_full_rows(cfg, model, idx_t, batches[0], out["card"],
                                                 note)
    out["lines"] = lines
    return out


def check_pm1(cfg, idx, got, want, exact, what) -> float:
    """Scores ``got`` of ids ``idx`` against their float64 pm1 oracle
    ``want``: NaN on exactly the rows with a bad take id, the others
    bit-equal to it in float32 (``exact``) or within rtol BF16_RTOL and
    atol BF16_ATOL_OF_MAX * max|oracle|.  Returns the max abs error."""
    nan = bad_rows_np(cfg, idx)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{what}: NaN rows {np.flatnonzero(np.isnan(got))}, want "
                             f"{np.flatnonzero(nan)}")
    got, want = got[~nan].astype(np.float64), want[~nan]
    err = float(np.abs(got - want).max()) if len(got) else 0.0
    if exact:
        if not np.array_equal(got, want.astype(np.float32)):
            raise AssertionError(f"{what}: scores differ from the pm1 oracle (max abs err {err})")
    elif not np.allclose(got, want, rtol=BF16_RTOL,
                         atol=BF16_ATOL_OF_MAX * float(np.abs(want).max())):
        raise AssertionError(f"{what}: scores past the bf16 tolerance of the pm1 oracle (max "
                             f"abs err {err})")
    return err


def checkpoint_bytes(cfg) -> int:
    """The arrays a checkpoint of ``cfg`` holds, in bytes, from the planner:
    take and class buffers and the tower's weights (the scales aside)."""
    pl = planner.plan(cfg, 1, batch_size=B_TIME)
    w = cfg.mlp.widths
    return (pl.take_bytes_total + pl.onehot_bytes
            + sum(a * b for a, b in zip(w[:-1], w[1:])) * TORCH_DTYPES[cfg.dtype].itemsize)


def checkpoint_full_rows(cfg, model, idx_t, batch, card, note):
    """``model`` (its take rows holding ``row_pattern``: every row differs,
    so a block stored or read at another offset shows) saved with
    ``io.save_sharded`` into a new directory of the temporary directory,
    restored onto its device with ``load_sharded``: every array bit-equal,
    the restored forward on ``idx_t`` bit-equal to the saved model's, and,
    with the take rows written back as pm1, the restored forward on
    ``batch`` bit-equal to the pm1 oracle (a bf16 tower: its hard gate).
    Raises first when the free space is under twice the arrays' bytes.
    Returns the bytes on disk and the save's and load's seconds."""
    dev = model.device
    need = sum(t.nbytes for t in fio.checkpoint_tensors(model).values())
    free = shutil.disk_usage(tempfile.gettempdir()).free
    if free < 2 * need:
        raise AssertionError(f"{tempfile.gettempdir()} has {free} B free, the checkpoint needs "
                             f"twice its {need} B")
    path = tempfile.mkdtemp(prefix=f"chip_smoke_{cfg.name}_")
    try:
        _, save_s = synced(lambda: fio.save_sharded(path, model))
        nbytes = disk_bytes(path)
        restored, load_s = synced(lambda: fio.load_sharded(path, cfg, device=dev))
        if restored.device != dev or not same_checkpoint_tensors(restored, model):
            raise AssertionError("the restored model is not the saved one")
        dense_t = on_device(dev, batch[1])[0]
        with torch.inference_mode():
            if not torch.equal(bits(restored(idx_t, dense_t)), bits(model(idx_t, dense_t))):
                raise AssertionError("the restored forward differs from the saved model's")
        restored.take.zero_()
        fill_pm1_take(restored.take, restored.layout, cfg)
        gate = restored if cfg.dtype == "float32" else fp32_tower(restored)
        idx, dense = batch
        with torch.inference_mode():
            got = gate(*on_device(dev, idx, dense)).cpu().numpy()
        check_pm1(cfg, idx, got, pm1_scores(cfg, idx, dense), True, "the restored model")
        del restored, gate
    finally:
        shutil.rmtree(path, ignore_errors=True)
    note(f"time checkpoint {cfg.name} {cfg.table_dtype} at full rows, one device -> one "
         f"device, on {card}: {nbytes} B on disk ({need} B of arrays, the take rows one piece "
         f"in 256 MiB row blocks, its offsets {'past' if nbytes > 1 << 32 else 'below'} 4 GiB), "
         f"save {save_s:.3f} s "
         f"({nbytes / save_s / 1e9:.3f} GB/s), load {load_s:.3f} s ({nbytes / load_s / 1e9:.3f} "
         f"GB/s; page-cache warm: read just after it was written); host clock between "
         f"synchronizes; every array bit-equal (take rows holding their index pattern), the "
         f"restored forward bit-equal to the saved model's and, its take rows written back as "
         f"pm1, to the pm1 oracle; {free} B were free")
    return {"bytes_on_disk": nbytes, "array_bytes": need, "save_s": save_s, "load_s": load_s,
            "free_bytes": free}


def time_full_rows(run, cfg, model, dense_t, rng, out, note):
    """The timings of ``full_rows_rank`` (CUDA events first: the profiler,
    once attached, slows every launch): ``lookup_fused`` at B = the first
    batch on each of ``run.draws`` (random ids: against its plain version
    over graph replays, ``_pair_graph``) beside its byte bound; the forward
    at both batch sizes replayed from a CUDA graph and eager back to back;
    then each forward's device time by part (profiler: lookup, tower,
    poison and the rest)."""
    dev = model.device
    B_big = FULL_BATCHES[0]
    ops = model.lookup_operands()
    card = out["card"]
    out["lookup"] = {}
    draws = {"random": lambda: _rand_ids(cfg, B_big, rng),
             "ids0": lambda: np.zeros((B_big, cfg.num_tables), np.int32),
             "window_1gib": lambda: window_ids(cfg, B_big, rng)}
    with torch.inference_mode():
        for name in run.draws:
            ids_c = torch.from_numpy(draws[name]()).to(dev)
            kernel = functools.partial(lookup_fused, ids_c, dense_t, **ops)
            nbytes = lookup_bytes(ops, ids_c, dense_t)
            b_ms, b_by = bound(nbytes)
            r = {"bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by}
            if name == "random":
                r["ms"], r["plain_ms"] = _pair_graph(
                    kernel, functools.partial(lookup_fused_plain, ids_c, dense_t, **ops))
            else:
                r["ms"] = _graph_ms(kernel)
            out["lookup"][name] = r
            note(f"time lookup_fused {run.tag} at full rows B={B_big} {name} on {card}: "
                 f"{r['ms']:.4f} ms" + (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r
                                        else "")
                 + f"; bound {b_ms:.4f} ms ({b_by}: {nbytes} B counted once), at "
                   f"{b_ms / r['ms']:.3f} (CUDA events over graph replays of 20 calls)")
        out["forward"] = {}
        fwds = {}
        for B in FULL_BATCHES:
            ids_b = torch.from_numpy(_rand_ids(cfg, B, rng)).to(dev)
            dense_b = None if dense_t is None else dense_t[:B]
            fwds[B] = functools.partial(model, ids_b, dense_b)
            out["forward"][B] = {"graph_ms": _graph_ms(fwds[B]), "eager_ms": _ms(fwds[B])}
        for B, fwd in fwds.items():
            r = out["forward"][B]
            split = _tower_split(fwd)
            if split is not None:
                r["split"], r["profiled_forwards"] = split
            parts = ("not measured" if split is None else ", ".join(
                f"{p} {ms:.4f} ms ({k} launches)" for p, (ms, k) in split[0].items()))
            note(f"time {run.tag} forward at full rows B={B} on {card}: graph replay "
                 f"{r['graph_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms; device time by part "
                 f"(profiler): {parts}")


def criteo_mesh_rank(rank, D, M, seed, mbytes=64, table_dtype="int8"):
    """A rank of ``chip_mesh.py``'s criteo world, a one-row (1, M) mesh:
    its take window of full-cardinality criteo (``criteo_full_config`` of
    ``table_dtype``) generated on its card (``pack_pm1_sharded`` with the
    mesh), its shard from it (``ShardedFleetRec.from_packed``: no whole
    model anywhere), the take bytes held to ``plan(cfg,
    M).take_bytes_per_chip``; sharded forwards at B = 4096 and 1024 with NaN
    on the bad rows, one ``lookup_fused`` and one ``fused_mlp`` launch each,
    bit-equal to the pm1 oracle (bfloat16: the bf16 tower within the bf16
    tolerance, and the hard gate, the same window under a float32 tower,
    bit-equal); then the window's rows overwritten with ``row_pattern`` and
    ``lookup_fused`` over it held to ``lookup_fused_plain`` and to the
    pattern on ids at the edges of every rank's window
    (``check_addressing``); the forward's time by part with the exchange's
    bytes; then ``ici_bench`` at ``mbytes`` MiB over the row (None: not
    run).  Raises on a failed check."""
    from fleetrec_tpu_torch.benchmarks import ici_bench
    from fleetrec_tpu_torch.parallel import ShardedFleetRec, global_mesh

    if D != 1:
        raise ValueError("the criteo world is one data row")
    mesh = global_mesh(D, M, device="cuda")
    dev = mesh.device
    cfg = criteo_full_config(B_TIME, table_dtype)
    plan = ModelPlan.create(cfg)
    pl = planner.plan(cfg, M, batch_size=B_TIME)
    out = {"card": torch.cuda.get_device_name(dev), "rank": rank}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    packed = pack_pm1_sharded(cfg, plan.layout, mesh)
    torch.cuda.synchronize(dev)
    out["build_s"] = time.perf_counter() - t0
    sh = ShardedFleetRec.from_packed(plan, packed, mesh, init_mlp_params(
        cfg.mlp, "ones", dtype=TORCH_DTYPES[cfg.dtype], device=dev))
    del packed
    out["take_bytes"] = sh.operands["bufs"][-1].nbytes
    out["allocated"] = torch.cuda.memory_allocated(dev)
    out["rss"] = peak_rss()
    if out["take_bytes"] != pl.take_bytes_per_chip:
        raise AssertionError(f"rank {rank}: take window {out['take_bytes']} B, the planner "
                             f"says {pl.take_bytes_per_chip}")
    if out["allocated"] > pl.per_chip_bytes:
        raise AssertionError(f"rank {rank}: memory_allocated {out['allocated']} B over the "
                             f"planner's {pl.per_chip_bytes}")
    rng = np.random.default_rng(seed)  # the same ids on every rank of the row
    batches = [(ids_with_bad(cfg, B, rng), pm1_dense(cfg, B, rng)) for B in FULL_BATCHES]
    towers, _scores, out["launches"], out["max_abs_err_bf16"] = pm1_towers(
        sh, batches, dev, f"rank {rank}: ")
    # the window's addressing, on rows that spell their own index: every
    # rank targets the edges of all M windows, and reads zeros outside its own
    lo, n = sh.operands["window"]
    fill_row_pattern(sh.operands["bufs"][-1], lo)
    rows_local = -(-plan.layout.take_phys_total // M)
    targets = edge_targets(cfg, plan.layout, [(w * rows_local, min((w + 1) * rows_local,
                                                                   plan.layout.take_phys_total))
                                              for w in range(M)])
    ids = torch.from_numpy(pattern_ids(cfg, targets, B_TIME, rng)).to(dev)
    dense = torch.from_numpy(batches[0][1]).to(dev)
    out["targets"] = len(targets)
    out["targets_inside"], _err = check_addressing(cfg, plan.layout, sh.operands, ids,
                                                   sh._lookup_dense(dense), targets, (lo, n))
    out["window"] = (lo, n)
    ids = torch.from_numpy(_rand_ids(cfg, B_TIME, rng)).to(dev)
    with torch.inference_mode():
        out["split"] = _split_forward(sh, ids, dense)
    del sh, towers
    torch.cuda.empty_cache()
    if mbytes is not None:
        out["ici"] = ici_bench(mesh, mbytes=mbytes)
    return out


def dryrun_rank(rank, D, M):
    """A rank of ``chip_mesh.py``'s dry-run world: ``parallel/dryrun.py``'s
    ``dryrun_multichip`` on this rank's card; its loss and score shapes."""
    from fleetrec_tpu_torch.parallel import dryrun_multichip, global_mesh

    res = dryrun_multichip(global_mesh(D, M, device="cuda"))
    return {"loss": res["loss"], "mesh": res["mesh"],
            **{k: list(v.shape) for k, v in res.items() if k.startswith("scores")}}


def phase_full(run, phase, tmp):
    """``full_rows_rank(run)``, seeded with the phase's number, in a process
    forked from the forkserver ``main`` starts first; its log lines are
    printed here.  Returns its results."""
    t0 = time.time()
    (res,), _ = run_world(1, full_rows_rank, (run, phase), tmp, f"full_{run.tag}", backend=None,
                          method="forkserver")
    for line in res.pop("lines"):
        log(f"phase {phase} {run.tag} {line}")
    log(f"phase {phase} {run.tag}: {run.name} at full rows on one card, built there with no "
        f"table on the host: passed ({time.time() - t0:.1f}s)")
    return res


def phase_full_rows(tmp):
    """Phase 16: every run of FULL_ROWS in a process of its own
    (``phase_full``), the first of CKPT_CANDIDATES whose checkpoint fits
    twice in the temporary directory's free space checkpointed (none:
    raises with the numbers).  Returns {tag: results}."""
    t0 = time.time()
    runs = {run.tag: run for run in FULL_ROWS}
    free = shutil.disk_usage(tempfile.gettempdir()).free
    need = {tag: checkpoint_bytes(runs[tag].config(B_TIME)) for tag in CKPT_CANDIDATES}
    pick = next((tag for tag in CKPT_CANDIDATES if free >= 2 * need[tag]), None)
    if pick is None or need[pick] <= 1 << 32:
        raise AssertionError(f"phase 16: {tempfile.gettempdir()} has {free} B free; a checkpoint "
                             f"past 4 GiB needs twice its arrays' bytes: {need}")
    log(f"phase 16: {tempfile.gettempdir()} has {free} B free; checkpointing {pick} "
        f"({need[pick]} B of arrays; the candidates {need})")
    out = {}
    for tag, run in runs.items():
        out[tag] = phase_full(dataclasses.replace(run, checkpoint=tag == pick), 16, tmp)
    log(f"phase 16 the paper's model2 (float32 and bfloat16) and model3 (int8, served on three "
        f"senders) and tiny_dlrm at full rows, one process each: passed "
        f"({time.time() - t0:.1f}s)")
    return out


# ---- phase 17: MLPerf DLRM-DCNv2 at full rows (the benchmark's DCNv2 cell) ----

# the benchmark's cell whose configuration, batch and inputs phase 17 takes
DCNV2_CELL = "dcnv2_bf16.b2048.stream"
DCNV2_SEED = 2_147_483_917
# the towers' tolerance against their plain chain on the model's weights
# (float32 sums in another order over K up to 3456); a dropped bias, a lost
# last ReLU or a wrong column is off by orders of magnitude more
DCNV2_TOWER_TOL = 1e-4


def _exact_tower(widths, B, dev, seed):
    """Weights, biases and an input of small integers (weights 1 in 16
    nonzero), so that every float32 sum of the tower is exact and its
    kernels must equal the plain chain to the bit."""
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randint(-1, 2, (a, b), generator=g).float()
           * (torch.rand(a, b, generator=g) < 1 / 16)).to(dev)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.randint(-3, 4, (b,), generator=g).float().to(dev) for b in widths[1:]]
    x = torch.randint(-1, 2, (B, widths[0]), generator=g).float().to(dev)
    return ws, bs, x


def ragged_lookup_bytes(ops, ids, bag_sizes) -> int:
    """``lookup_bytes`` of ragged bags: the padded bags' count, less the id
    bytes of the padding, which the ragged kernel never reads."""
    padded = pad_ragged(ids, bag_sizes)
    return (lookup_bytes(ops, padded, None)
            - (padded.numel() - ids.numel()) * ids.element_size())


def dcnv2_rank(rank, seed, device="cuda:0"):
    """Phase 17 in a process of its own (the card holds nothing else):
    ``DCNV2_CELL``'s configuration (MLPerf DLRM-DCNv2: 26 bf16 tables of
    204,184,588 rows x 128, 214-id ragged bags, the bottom tower 13-512-256-128
    with its last ReLU, 3 cross layers of rank 512 over 3456, the top tower
    3456-1024-1024-512-256-1, biases, float32) built on the card as the
    benchmark builds it (``portbench.model.build_model``), at its batch of
    2048 on its inputs (``portbench.inputs.pools``).  (1) the ragged bag
    kernel bit-equal to its plain twin, features and flags, on the pool's
    ids, every id 0, and ids with padding (-1, -5), last rows and
    out-of-range members; (2) the biased towers (bottom with its last ReLU,
    top) equal to their plain chain to the bit on exact small-integer data
    and within ``DCNV2_TOWER_TOL`` on the model's weights; (3) the cross
    layers' tail bit-equal to its torch expression at [2048, 3456]; (4) the
    forward: 1 ``lookup_fused_ragged``, 2 ``fused_mlp`` and 3 ``cross_tail``
    launches and no plain call, within ``DCNV2_TOWER_TOL`` of the same
    forward composed from the plain versions (which launches nothing), both
    within the cell's ``max_err`` of the benchmark's float64 reference, a bad
    take member NaN on its row only; (5) N_SERVE batches served over
    loopback with ``bag_sizes`` (graph replays), the launch counts zeroed
    just before and read after, replies bit-equal to direct forwards; (6)
    each kernel's time against its plain version, its bound and a library
    yardstick, and the forward's ms a batch, eager and from a CUDA graph.
    Returns the results and the log lines."""
    from portbench import inputs, loader, reference
    from portbench import tables as ptables
    from portbench.model import build_model, port_config

    dev = torch.device(device)
    lines, out = [], {"card": card_line()}

    def note(msg):
        lines.append(msg)
        print(msg, flush=True)

    cell = loader.cell(DCNV2_CELL)
    m, B, limit = cell.model, cell.serve["batch"], cell.check["max_err"]
    hot = inputs.hot_of(m)
    t0 = time.perf_counter()
    cfg = port_config(cell.config, m, cell.serve)
    model = build_model(cfg, m, seed, dev)
    torch.cuda.synchronize()
    ops = model.lookup_operands()
    table_bytes = sum(b.numel() * b.element_size() for b in ops["bufs"])
    note(f"{cfg.name}: {cfg.num_tables} tables, {sum(t.rows for t in cfg.tables)} rows "
         f"({table_bytes} B of {cfg.table_dtype} buffers), {sum(hot)} ids a query, built on "
         f"{dev} in {time.perf_counter() - t0:.1f} s; memory_allocated "
         f"{torch.cuda.memory_allocated(dev)} B")
    ids_np, dense_np = inputs.pools(seed, m, B, N_SERVE)
    ids, dense = (torch.from_numpy(a[0]).to(dev) for a in (ids_np, dense_np))
    starts = np.concatenate([[0], np.cumsum(hot)])
    big = max(range(cfg.num_tables), key=lambda t: cfg.tables[t].rows)  # a take table
    rng = np.random.default_rng(seed % (1 << 32))
    edges = ids_np[0].copy()
    for t, spec in enumerate(cfg.tables):
        cols = np.arange(starts[t], starts[t + 1])
        rows = rng.choice(B, 4, replace=False)
        edges[rows[0], cols] = -1                  # a bag of padding only
        edges[rows[1], cols[-1]] = -5              # below -1: padding too
        edges[rows[2], cols[0]] = spec.rows - 1    # the table's last row
        edges[rows[3], cols[-1]] = spec.rows       # one past it
    draws = {"pool": ids, "ids0": torch.zeros_like(ids),
             "edges": torch.from_numpy(edges).to(dev)}

    # (1) the ragged bag kernel against its plain twin
    with torch.inference_mode():
        for name, i in draws.items():
            before = lookup_fused_ragged.launches
            got = lookup_fused_ragged(i, None, bag_sizes=hot, **ops)
            if lookup_fused_ragged.launches != before + 1:
                raise AssertionError("phase 17: lookup_fused_ragged launched no kernel")
            want = lookup_fused_ragged_plain(i, None, bag_sizes=hot, **ops)
            if not (torch.equal(bits(got[0]), bits(want[0])) and _same_flags(got[1], want[1])):
                raise AssertionError(f"phase 17: lookup_fused_ragged on {name} ids differs "
                                     f"from its plain twin")
    note(f"(1) lookup_fused_ragged at B={B} over {sum(hot)} ids a query (bags of "
         f"{min(hot)}..{max(hot)}): features and flags bit-equal to lookup_fused_ragged_plain "
         f"on {', '.join(draws)} ids")

    # (2) the biased towers against their plain chain
    towers = {"bottom": (cfg.bottom_mlp, model.bottom_weights, model.bottom_biases,
                         dense),
              "top": (cfg.mlp, model.mlp_weights, model.mlp_biases,
                      torch.rand(B, cfg.feature_dim, generator=torch.Generator(
                          device=dev).manual_seed(17), device=dev) * 2 - 1)}
    err_towers = {}
    with torch.inference_mode():
        for name, (spec, ws, bs, x) in towers.items():
            last = spec.last_activation
            ew, eb, ex = _exact_tower(spec.widths, B, dev, 17 + len(name))
            if not torch.equal(fused_mlp(ew, ex, spec.activation, eb, last),
                               fused_mlp_plain(ew, ex, spec.activation, eb, last)):
                raise AssertionError(f"phase 17: the {name} tower on exact data differs "
                                     f"from its plain chain")
            got = fused_mlp(ws, x, spec.activation, bs, last)
            want = fused_mlp_plain(ws, x, spec.activation, bs, last)
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=DCNV2_TOWER_TOL,
                                       atol=DCNV2_TOWER_TOL * scale,
                                       msg=lambda s: f"phase 17 {name} tower: {s}")
            err_towers[name] = (got - want).abs().max().item() / scale
    note(f"(2) fused_mlp with biases at B={B}: bottom {cfg.bottom_mlp.widths} (ReLU after "
         f"every layer, the last too) and top {cfg.mlp.widths} bit-equal to fused_mlp_plain on "
         f"small-integer data; on the model's weights max|diff| / max|plain| bottom "
         f"{err_towers['bottom']:.3g}, top {err_towers['top']:.3g} (limit {DCNV2_TOWER_TOL})")

    # (3) the cross layers' tail
    g = torch.Generator(device=dev).manual_seed(19)
    F = cfg.feature_dim
    x0, xl, xw = (torch.randn(B, F, generator=g, device=dev) for _ in range(3))
    b = model.cross_weights[0][-1]
    with torch.inference_mode():
        if not torch.equal(cross_tail(x0, xw, b, xl), cross_tail_plain(x0, xw, b, xl)):
            raise AssertionError("phase 17: cross_tail differs from its torch expression")
    note(f"(3) cross_tail at [{B}, {F}] float32 bit-equal to cross_tail_plain")

    # (4) the forward
    with torch.inference_mode():
        with plain_calls() as plain:
            scores, launches = _counted(lambda: model.forward_ragged(ids, hot, dense))
        want_launches = _launches(mlp=2, ragged=1, tail=cfg.cross_layers)
        if launches != want_launches or any(plain.values()):
            raise AssertionError(f"phase 17: a forward launched {launches} (want "
                                 f"{want_launches}) and called {plain}")
        with plain_kernels():
            composed, plain_launches = _counted(lambda: model.forward_ragged(ids, hot, dense))
        if plain_launches != _launches():
            raise AssertionError(f"phase 17: the plain composition launched {plain_launches}")
        scale = composed.abs().max().item()
        torch.testing.assert_close(scores, composed, rtol=DCNV2_TOWER_TOL,
                                   atol=DCNV2_TOWER_TOL * scale,
                                   msg=lambda s: f"phase 17 forward against its plain "
                                                 f"composition: {s}")
        w = ptables.head_weights(seed, m, dev)
        golden = reference.pool_scores(m, ptables.seed_key(seed), ids_np[:1], dense_np[:1], w)
        err_ref = reference.max_err(scores.cpu().numpy()[None], golden)
        err_plain_ref = reference.max_err(composed.cpu().numpy()[None], golden)
        if not err_ref <= limit or not err_plain_ref <= limit:
            raise AssertionError(f"phase 17: max_err against the reference {err_ref} (plain "
                                 f"composition {err_plain_ref}), limit {limit}")
        bad = ids_np[0].copy()
        bad[5, starts[big]] = cfg.tables[big].rows
        sb = model.forward_ragged(torch.from_numpy(bad).to(dev), hot, dense).cpu().numpy()
        nan_rows = np.flatnonzero(np.isnan(sb)).tolist()
        if nan_rows != [5]:
            raise AssertionError(f"phase 17: a bad take member poisons rows {nan_rows}, want [5]")
    out["max_err_reference"], out["max_err_towers"] = err_ref, err_towers
    note(f"(4) forward_ragged at B={B}: launches {launches}, no plain call; within "
         f"{DCNV2_TOWER_TOL} of its plain composition (max|diff| / max|plain| "
         f"{(scores - composed).abs().max().item() / scale:.3g}), which launched nothing; "
         f"max_err against the float64 reference {err_ref:.4g} (plain composition "
         f"{err_plain_ref:.4g}; the cell's limit {limit}); a bad take member NaN on row 5 only")

    # (5) served over loopback
    batches = [(ids_np[p], dense_np[p]) for p in range(N_SERVE)]
    served, serve_launches, summary = serve_loopback(cfg, model, batches, bag_sizes=tuple(hot))
    with torch.inference_mode():
        for k, (i, d) in enumerate(batches):
            direct = model.forward_ragged(torch.from_numpy(i).to(dev), hot,
                                          torch.from_numpy(d).to(dev)).cpu().numpy()
            if not np.array_equal(served[k], direct):
                raise AssertionError(f"phase 17: served batch {k} differs from a direct forward")
    want_serve = _launches(mlp=2 * N_SERVE, ragged=N_SERVE, tail=cfg.cross_layers * N_SERVE)
    if serve_launches != want_serve:
        raise AssertionError(f"phase 17: the served run launched {serve_launches}, want "
                             f"{want_serve}")
    out["launches"], out["serve_launches"] = launches, serve_launches
    note(f"(5) serve() with bag_sizes: {summary['wire_batches']} batches x {B} ([{B}, "
         f"{sum(hot)}] int32 ids and {cfg.dense_dim} dense floats a query) over loopback, "
         f"replies bit-equal to direct forwards; launches in the run {serve_launches}")

    # (6) times: CUDA events over graph replays, each beside its bound
    stats = {}
    with torch.inference_mode():
        nbytes = ragged_lookup_bytes(ops, ids, hot)
        padded = pad_ragged(ids, hot)
        # the plain twin timed without its padding gather (pad_ragged builds
        # its index on the host, which a graph capture cannot hold)
        cases = [(f"lookup_fused_ragged dcnv2 B={B}",
                  functools.partial(lookup_fused_ragged, ids, None, bag_sizes=hot, **ops),
                  functools.partial(lookup_fused_bags_plain, padded, None, **ops),
                  None, bound(nbytes),
                  {"ms_ids0": functools.partial(lookup_fused_ragged, draws["ids0"], None,
                                                bag_sizes=hot, **ops),
                   # the bag kernel on the bags padded to the longest, the
                   # path ragged bags would take without the ragged kernel
                   "padded_ms": functools.partial(lookup_fused_bags, padded, None, **ops)},
                  f"{nbytes} B counted once; plain: lookup_fused_bags_plain on the bags "
                  f"padded to {max(hot)}")]
        for name, (spec, ws, bs, x) in towers.items():
            flops = 2 * B * sum(a * c for a, c in zip(spec.widths[:-1], spec.widths[1:]))
            tb = 4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + B * spec.widths[-1])
            cases.append((f"fused_mlp fp32 dcnv2_{name} B={B}",
                          functools.partial(fused_mlp, ws, x, spec.activation, bs,
                                            spec.last_activation),
                          functools.partial(fused_mlp_plain, ws, x, spec.activation, bs,
                                            spec.last_activation),
                          multi_dot_call(ws, x), bound(tb, flops), {},
                          f"widths {spec.widths}, biases, {flops} FLOP; multi_dot without "
                          f"the biases and ReLUs"))
        tb = 4 * (4 * B * F + F)
        cases.append((f"cross_tail dcnv2 B={B}", functools.partial(cross_tail, x0, xw, b, xl),
                      functools.partial(cross_tail_plain, x0, xw, b, xl),
                      ("addcmul", functools.partial(torch.addcmul, xl, x0, xw)), bound(tb), {},
                      f"[{B}, {F}] float32, {tb} B; addcmul x + x0 * xw without the bias"))
        for label, k, p, lib, (bound_ms, bound_by), extra, what in cases:
            kg, pg = _pair_graph(k, p)
            stats[label] = {"ms": kg, "plain_ms": pg, "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": None if lib is None else _graph_ms(lib[1])}
            stats[label].update({key: _graph_ms(fn) for key, fn in extra.items()})
            lib_txt = ("no one PyTorch call computes it" if lib is None
                       else f"{lib[0]} {stats[label]['library_ms']:.4f} ms")
            more = "".join(f", {key} {v:.4f}" for key, v in stats[label].items()
                           if key in extra)
            note(f"time {label}: kernel {kg:.4f} ms, plain {pg:.4f} ms, {lib_txt}{more} "
                 f"(CUDA events over graph replays); bound {bound_ms:.4f} ms ({bound_by}), "
                 f"kernel at {bound_ms / kg:.3f} of it; {what}")
        fwd = functools.partial(model.forward_ragged, ids, hot, dense)
        for _ in range(5):
            fwd()
        torch.cuda.synchronize()
        eager = float(np.median([_ms(fwd) for _ in range(5)]))
        graphed = _graph_ms(fwd, 10)
    out["forward_ms"], out["forward_graph_ms"] = eager, graphed
    note(f"time dcnv2 forward_ragged B={B}: eager {eager:.4f} ms, from a CUDA graph "
         f"{graphed:.4f} ms a batch on {out['card']}")
    out["stats"], out["lines"], out["batch"] = stats, lines, B
    return out


def phase_dcnv2(tmp):
    """Phase 17: ``dcnv2_rank`` in a process forked from the forkserver
    ``main`` starts first; its log lines are printed here.  Returns its
    results."""
    t0 = time.time()
    (res,), _ = run_world(1, dcnv2_rank, (DCNV2_SEED,), tmp, "dcnv2", backend=None,
                          method="forkserver")
    for line in res["lines"]:
        log(f"phase 17 {line}")
    log(f"phase 17 DLRM-DCNv2 ({DCNV2_CELL}'s configuration) at full rows on one card: "
        f"passed ({time.time() - t0:.1f}s)")
    return res


def dcnv2_kernels(res) -> list:
    """The kernels' record entries of phase 17: the ragged bag kernel and
    the cross layers' tail (times at the cell's batch, launches of its
    served run), and the biased towers' times under ``fused_mlp_dcnv2``."""
    stats, sl, B = res["stats"], res["serve_launches"], res["batch"]
    return [
        {"name": "lookup_fused_ragged", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/lookup_fused.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:182",
         "launches": sl["lookup_fused_ragged"], "max_abs_err": 0.0,
         **stats[f"lookup_fused_ragged dcnv2 B={B}"]},
        {"name": "cross_tail", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/cross_tail.cu",
         "replaces": "fleetrec_tpu/models/interaction.py:90",
         "launches": sl["cross_tail"], "max_abs_err": 0.0, **stats[f"cross_tail dcnv2 B={B}"]},
        {"name": "fused_mlp_dcnv2", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/fused_mlp.cu",
         "replaces": "fleetrec_tpu/ops/mlp_fused.py:84",
         "launches": sl["fused_mlp"],
         **{f"max_abs_err_{t}": e for t, e in res["max_err_towers"].items()},
         **{f"{k}_{t}": stats[f"fused_mlp fp32 dcnv2_{t} B={B}"][k]
            for t in ("bottom", "top") for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")}},
    ]


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
    ms per call)], device kernel launches per call).  Device ms is None when
    the profiler reports no device time."""
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
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters) for e in events),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return (busy if rows else None), wall, rows, sum(e.count for e in events) / iters


def _profiled_forwards(fn, iters: int = 20):
    """The profiler's device events of ``iters`` calls of a forward, in
    launch order, one list a forward (each starting at its
    ``lookup_fused``), kept only for the forwards whose events all arrived
    (the profiler can drop a few): those with the most common count.  None
    when the profiler reports no device event."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    forwards = []
    for e in events:
        if "lookup_fused" in e.name:
            forwards.append([])
        if forwards:
            forwards[-1].append(e)
    if not forwards:
        return None
    n = Counter(len(f) for f in forwards).most_common(1)[0][0]
    return [f for f in forwards if len(f) == n]


def _split_parts(whole, names, part_of):
    """({part: (device ms, launches) per forward}, forwards averaged) of the
    forwards ``whole``, each event put in a part by ``part_of(event,
    state)`` -> (part, state), ``state`` starting at "start" each forward."""
    parts = {p: [0.0, 0] for p in names}
    for f in whole:
        state = "start"
        for e in f:
            part, state = part_of(e, state)
            parts[part][0] += e.time_range.elapsed_us() / 1e3 / len(whole)
            parts[part][1] += 1
    return {p: (ms, k // len(whole)) for p, (ms, k) in parts.items()}, len(whole)


def _forward_split(fn, iters: int = 20):
    """Device ms and kernel launches per call of a DLRM forward by part,
    from the profiler's device events in launch order (``_profiled_forwards``):
    ``lookup_fused``; the bottom tower (the fused-MLP kernels before the
    first other kernel that follows them); the top tower (the fused-MLP
    kernels after it); the poison (what runs after the top tower); the
    interaction's torch ops (everything else: pads, cats, casts, the Gram
    ``bmm``, the triangle gather).  Returns ({part: (ms, launches)},
    forwards averaged), or None when the profiler reports no device
    event."""
    whole = _profiled_forwards(fn, iters)
    if whole is None:
        return None

    def part_of(e, state):
        if "lookup_fused" in e.name:
            return "lookup_fused", state
        if any(k in e.name for k in MLP_KERNELS):
            part = "bottom tower" if state in ("start", "bottom") else "top tower"
            return part, "bottom" if part == "bottom tower" else "top"
        if state == "top":
            return "poison", state
        return "interaction ops", "interaction" if state == "bottom" else state

    return _split_parts(whole, ("lookup_fused", "bottom tower", "interaction ops", "top tower",
                                "poison"), part_of)


def _tower_split(fn, iters: int = 20):
    """The same for a forward with the plain tower: ``lookup_fused``, the
    tower (the fused-MLP kernels), the poison and the rest (casts)."""
    whole = _profiled_forwards(fn, iters)
    if whole is None:
        return None

    def part_of(e, state):
        if "lookup_fused" in e.name:
            return "lookup_fused", state
        if any(k in e.name for k in MLP_KERNELS):
            return "tower", state
        return "poison and the rest", state

    return _split_parts(whole, ("lookup_fused", "tower", "poison and the rest"), part_of)


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median ms per call of ``fn`` from CUDA events around replays of a
    graph of ``iters`` calls."""
    g = _graph(fn, iters)
    return float(np.median([_ms(g.replay, 1) / iters for _ in range(reps)]))


# the kernels of one fused_mlp call, by the names the profiler gives them
MLP_KERNELS = ("ffma_product<", "wgmma_product<", "rowdot<")
# published peaks of one H100 SXM (NVIDIA's data sheet: dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def gather_bytes(table, idx) -> int:
    """Bytes a gather must move, each counted once: its ids, the distinct
    in-range rows it reads, and its output."""
    row = table.shape[1] * table.element_size()
    ok = idx[(idx >= 0) & (idx < table.shape[0])]
    return idx.numel() * idx.element_size() + (torch.unique(ok).numel() + idx.numel()) * row


def lookup_bytes(ops, idx, dense) -> int:
    """Bytes the fused lookup over ``ops`` (a model's lookup_operands, or a
    shard's: only the rows of its tables and window count) must move, each
    counted once: its ids ([B, T], or bags [B, T, L]) and descriptors, the
    distinct table rows these ids read (a (buffer, row) pair once), the
    dense features, the features and the flags it writes."""
    cols = ops["cols"]
    off, _ = lookup_offsets_plain(idx, cols, ops["stripes"], ops["stripe_height"],
                                  ops.get("window"))
    read = off >= 0
    per_col = (-1, 1) if idx.dim() == 3 else (-1,)  # a plan column's field, over its slots
    buf = cols[:, LOOKUP_COL_FIELDS.index("buf")].view(per_col).expand_as(off)[read]
    dim = cols[:, LOOKUP_COL_FIELDS.index("dim")].view(per_col).expand_as(off)[read]
    rows = torch.unique(torch.stack([buf, off[read], dim], 1), dim=0)
    B, F = idx.shape[0], ops["pos"].shape[0]
    out = torch.empty((), dtype=lookup_out_dtype(ops["bufs"])).element_size()
    return (idx.numel() * idx.element_size() + cols.numel() * 8 + ops["pos"].numel() * 4
            + int(rows[:, 2].sum()) * ops["bufs"][0].element_size()
            + (0 if dense is None else dense.numel() * 4)
            + B * F * out + (B if ops["with_bad"] else 0))


def index_select_call(table, ids):
    """("index_select", ``table.index_select(0, ids)``): the one PyTorch
    call that computes a gather whose ids are all in range (checked here:
    index_select has no zero-row rule)."""
    if not bool(((ids >= 0) & (ids < table.shape[0])).all()):
        raise AssertionError("index_select is timed on in-range ids only")
    return "index_select", functools.partial(table.index_select, 0, ids)


def multi_dot_call(weights, x):
    """("multi_dot", ``torch.linalg.multi_dot([x, *weights])``): the one
    PyTorch call that computes a tower with no activation, x @ W1 @ .. @ Wn.
    It picks the cheapest order of the products (for a 1-wide score, right
    to left: the weights collapse to one vector), so it does far fewer FLOPs
    than the chain; in bfloat16 it returns bfloat16 and rounds between
    products, where the kernel returns float32."""
    return "multi_dot", functools.partial(torch.linalg.multi_dot, [x, *weights])


def bound(nbytes: int, flops: int = 0, dtype=torch.float32):
    """(ms, what sets it): the larger of bytes over the memory rate and
    FLOPs over the dtype's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_report(cfg, model, dev, gb, lookups, windows):
    """Kernel-against-plain and forward times, each kernel beside its bound
    and one library call (index_select, multi_dot; none computes the fused
    lookup, which is timed beside the path it replaced: lookup_concat of
    plan_indices through gather_rows, and bad_take_rows); kernel (b) and
    kernel (a) at gatherbench's table and ids ``gb``, (b) with gatherbench's
    flags; ``lookup_fused`` on model1 and on ``lookups``' model3 and
    dlrm_terabyte; ``fused_mlp`` at model1's, model3's and dlrm's towers;
    the model1 and dlrm forwards; the window forms of the lookup kernels on
    ``windows`` (phase 12's shard 0 of 2 of model1 and model3).  CUDA-event
    timings come first: once
    torch.profiler has attached to the device it adds host cost to every
    later launch, so the profiled pass runs last.  Returns each label's
    numbers for the kernels' record."""
    log(f"card: {card_line()}")
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(_rand_ids(cfg, B_TIME, rng)).to(dev)
    with torch.inference_mode():
        # (label, kernel, plain, note, (library name, call) or None, (ms,
        # bound_by), replaced path or None); the towers are timed with no
        # activation, as model1 runs them
        cases = []
        for t in tier_gathers(model.packed, model.plan_indices(idx)):
            nbytes = gather_bytes(t.table, t.ids)
            cases.append((f"gather_rows {t.name}",
                          functools.partial(gather_rows, t.table, t.ids),
                          functools.partial(gather_rows_plain, t.table, t.ids),
                          f"{t.ids.numel()} rows of {t.dim} x {t.table.dtype}, "
                          f"{nbytes} B counted once",
                          index_select_call(t.table, t.ids), bound(nbytes), None))
        tier_labels = [c[0] for c in cases]
        table_gb, idx_gb = gb
        nbytes = gather_bytes(table_gb, idx_gb)
        for label, kernel in (
                ("gather_rows gatherbench shape", gather_rows),
                ("gather_rows_grouped gatherbench shape",
                 functools.partial(gather_rows_grouped, **GB_FLAGS))):
            cases.append((label, functools.partial(kernel, table_gb, idx_gb),
                          functools.partial(gather_rows_plain, table_gb, idx_gb),
                          f"{GB_N} rows of 128 x float32 from a [{GB_ROWS}, 128] "
                          f"table, {nbytes} B counted once",
                          index_select_call(table_gb, idx_gb), bound(nbytes), None))
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
                    # x and the weights read once, the float32 scores written once
                    nbytes = (x_.element_size() * (x_.numel() + sum(w.numel() for w in w_))
                              + 4 * B * widths[-1])
                    cases.append((label, functools.partial(fused_mlp, w_, x_),
                                  functools.partial(fused_mlp_plain, w_, x_),
                                  f"widths {widths}, {flops[label]} FLOP, "
                                  f"{len(widths) - 1} launches", multi_dot_call(w_, x_),
                                  bound(nbytes, flops[label], dtype), None))
        # dlrm's towers with their ReLU, as its forward runs them (multi_dot
        # runs the chain without it: a yardstick, not the same function)
        dcfg, dmodel = lookups["dlrm_terabyte"]
        for name, ws, spec in (("dlrm_bottom", dmodel.bottom_weights, dcfg.bottom_mlp),
                               ("dlrm_top", dmodel.mlp_weights, dcfg.mlp)):
            widths = spec.widths
            x = torch.from_numpy(np.random.default_rng(6).uniform(
                -1, 1, (B_TIME, widths[0])).astype(np.float32)).to(dev)
            for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                w_ = [w.to(dtype) for w in ws]
                x_ = x.to(dtype)
                label = f"fused_mlp {tag} {name} B={B_TIME}"
                flops[label] = 2 * B_TIME * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
                nbytes = (x_.element_size() * (x_.numel() + sum(w.numel() for w in w_))
                          + 4 * B_TIME * widths[-1])
                cases.append((label, functools.partial(fused_mlp, w_, x_, spec.activation),
                              functools.partial(fused_mlp_plain, w_, x_, spec.activation),
                              f"widths {widths}, ReLU, {flops[label]} FLOP, "
                              f"{len(widths) - 1} launches; multi_dot without the ReLU",
                              multi_dot_call(w_, x_), bound(nbytes, flops[label], dtype), None))
        # the lookups at B_TIME again with every id 0: every row a cached one,
        # so the gap to random ids is what the random row reads cost
        ids0 = {}
        for name, B in (("fleetrec_model1", 1024), ("fleetrec_model1", B_TIME),
                        ("fleetrec_model3", B_TIME), ("dlrm_terabyte", B_TIME)):
            lcfg, m = lookups[name]
            ids = torch.from_numpy(_rand_ids(lcfg, B, rng)).to(dev)  # int32, as served
            dense = _dense(m.layout.dense_dim, B, rng, dev)
            nbytes = lookup_bytes(m.lookup_operands(), ids, dense)

            def replaced(m=m, ids=ids, dense=dense):
                gi = m.plan_indices(ids)
                return lookup_concat(m.packed, gi, dense), m.bad_take_rows(gi)

            if B == B_TIME:
                ids0[f"lookup_fused {name} B={B}"] = functools.partial(
                    m.lookup, torch.zeros_like(ids), dense)
            cases.append((f"lookup_fused {name} B={B}", functools.partial(m.lookup, ids, dense),
                          functools.partial(lookup_fused_plain, ids, dense,
                                            **m.lookup_operands()),
                          f"{lcfg.num_tables} tables ({lcfg.table_dtype}), "
                          f"{m.layout.feature_dim} wide, dense {m.layout.dense_dim}, int32 ids, "
                          f"{nbytes} B counted once", None, bound(nbytes), replaced))
        # the bag lookups: bags as loadgen --bag-l draws them (a prefix of
        # 1 .. L members), beside the path the kernel replaced, the same
        # kernel with every id 0 (every slot a member reading one cached row)
        # and on loadgen's prefixes of skewed ids (draw_bags)
        skew = {}
        for name, B, L in [("fleetrec_model1", B, L) for B in (B_TIME, 1024) for L in BAG_LS
                           ] + [("fleetrec_model3", B_TIME, BAG_L_SMALL)]:
            lcfg, m = lookups[name]
            ids = torch.from_numpy(draw_bags(lcfg, B, L, "loadgen", seed=15 + L)).to(dev)
            dense = _dense(m.layout.dense_dim, B, rng, dev)
            nbytes = lookup_bytes(m.lookup_operands(), ids, dense)
            members = int((ids >= 0).sum())

            def replaced(m=m, ids=ids, dense=dense):
                gi = plan_bags(m, ids)
                return pooled_lookup_concat(m.packed, gi, dense), pooled_bad_rows(m, gi)

            label = f"lookup_fused_bags {name} B={B} L={L}"
            ids0[label] = functools.partial(m.lookup_pooled, torch.zeros_like(ids), dense)
            skew[label] = functools.partial(m.lookup_pooled, torch.from_numpy(
                draw_bags(lcfg, B, L, "skew", seed=15 + L)).to(dev), dense)
            cases.append((label, functools.partial(m.lookup_pooled, ids, dense),
                          functools.partial(lookup_fused_bags_plain, ids, dense,
                                            **m.lookup_operands()),
                          f"{lcfg.num_tables} tables ({lcfg.table_dtype}), "
                          f"{m.layout.feature_dim} wide, dense {m.layout.dense_dim}, int32 ids, "
                          f"sum pooling, {members} members in {B * lcfg.num_tables} bags, "
                          f"{nbytes} B counted once", None, bound(nbytes), replaced))
        # the window forms on shard 0 of 2 (phase 12's operands): bound at the
        # shard's bytes (its rows, its dense); no PyTorch call computes them
        for name, (ops, ids, d, bags) in windows.items():
            for kernel, plain, x, tag in ((lookup_fused, lookup_fused_plain, ids, ""),
                                          (lookup_fused_bags, lookup_fused_bags_plain, bags,
                                           f" L={BAG_L}")):
                if x is None:
                    continue
                nbytes = lookup_bytes(ops, x, d)
                if kernel is lookup_fused_bags:  # its draws: every id 0, loadgen's skew
                    label = f"{kernel.__name__} window {name}{tag} B={B_TIME}"
                    ids0[label] = functools.partial(kernel, torch.zeros_like(x), d, **ops)
                    skew[label] = functools.partial(kernel, torch.from_numpy(draw_bags(
                        model.cfg, B_TIME, BAG_L, "skew", seed=15 + BAG_L)).to(dev), d, **ops)
                cases.append((f"{kernel.__name__} window {name}{tag} B={B_TIME}",
                              functools.partial(kernel, x, d, **ops),
                              functools.partial(plain, x, d, **ops),
                              f"shard 0 of 2: {len(ops['bufs'])} buffers, take window "
                              f"{ops['window']}, int32 ids with bad ones, {nbytes} B counted once",
                              None, bound(nbytes), None))
        d_idx = torch.from_numpy(_rand_ids(dcfg, B_TIME, rng)).to(dev)
        d_dense = _dense(dcfg.dense_dim, B_TIME, rng, dev)
        bag_idx = torch.from_numpy(make_bags(cfg, B_TIME, BAG_L, seed=16)[0]).to(dev)
        fwds = {}
        for B in (1024, B_TIME):
            fwds["model1", B] = functools.partial(model, idx[:B].contiguous())
            fwds[f"model1 pooled L={BAG_L}", B] = functools.partial(
                model.forward_pooled, bag_idx[:B].contiguous())
            fwds["dlrm_terabyte", B] = functools.partial(
                dmodel, d_idx[:B].contiguous(), d_dense[:B].contiguous())

        events = {c[0]: _pair(c[1], c[2]) for c in cases}
        graphed = {c[0]: _pair_graph(c[1], c[2]) for c in cases}
        library = {c[0]: None if c[4] is None else _graph_ms(c[4][1]) for c in cases}
        replaced_ms = {c[0]: _graph_ms(c[6]) for c in cases if c[6] is not None}
        ids0_ms = {label: _graph_ms(fn) for label, fn in ids0.items()}
        skew_ms = {label: _graph_ms(fn) for label, fn in skew.items()}
        fwd_ms, fwd_graph_ms = {}, {}
        for key, fwd in fwds.items():
            for _ in range(5):
                fwd()
            torch.cuda.synchronize()
            fwd_ms[key] = float(np.median([_ms(fwd) for _ in range(5)]))
            fwd_graph_ms[key] = _graph_ms(fwd, 10)

        stats = {}
        for label, k, p, note, lib, (bound_ms, bound_by), _ in cases:
            kd, _, krows, _ = _profile(k)
            pd = _profile(p)[0]
            ke, pe = events[label]
            kg, pg = graphed[label]
            stats[label] = {"ms": kg, "plain_ms": pg, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library[label]}
            rate = ""
            if label in flops:
                rate = f" = {flops[label] / kg / 1e9:.2f} TFLOP/s"
            if lib is None and label not in replaced_ms:
                yardstick = "no one PyTorch call computes it"
            elif lib is None:
                stats[label]["replaced_ms"] = replaced_ms[label]
                yardstick = (f"no one PyTorch call computes it; the path it replaced "
                             f"{replaced_ms[label]:.4f} ms")
            else:
                yardstick = f"{lib[0]} {library[label]:.4f} ms"
            if label in ids0_ms:
                stats[label]["ms_ids0"] = ids0_ms[label]
                yardstick += f"; the kernel with every id 0 {ids0_ms[label]:.4f} ms"
            if label in skew_ms:
                stats[label]["ms_skew"] = skew_ms[label]
                yardstick += f", on skewed ids {skew_ms[label]:.4f} ms"
            log(f"time {label if ' B=' in label else f'{label} B={B_TIME}'}: "
                f"kernel {kg:.4f} ms{rate}, plain {pg:.4f} ms, {yardstick} "
                f"(CUDA events over graph replays); bound {bound_ms:.4f} ms ({bound_by}), kernel at "
                f"{bound_ms / kg:.3f} of it; eager "
                f"back-to-back calls incl. host dispatch: kernel {ke:.4f} ms, "
                f"plain {pe:.4f} ms; device time kernel {_fmt(kd)}, plain "
                f"{_fmt(pd)} (profiler); {note}")
            if label in flops:  # one row per kernel name (layers of one tile add up)
                for name, ms in krows:
                    log(f"  device time per call: {ms:.4f} ms  {name[:70]}")
        tiers = {key: sum(stats[k][key] for k in tier_labels)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        stats["gather_rows all tiers"] = {**tiers, "bound_by": "bytes"}
        log(f"time gather_rows all tiers B={B_TIME}: kernel {tiers['ms']:.4f} ms, plain "
            f"{tiers['plain_ms']:.4f} ms, index_select {tiers['library_ms']:.4f} ms, "
            f"bound {tiers['bound_ms']:.4f} ms (bytes), kernel at "
            f"{tiers['bound_ms'] / tiers['ms']:.3f} of it (CUDA events over graph "
            f"replays, summed)")
        for (name, B), fwd in fwds.items():
            busy, wall, rows, n_launch = _profile(fwd)
            idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
            log(f"time {name} forward B={B}: {fwd_ms[name, B]:.4f} ms/batch (CUDA "
                f"events, back-to-back), {B / fwd_ms[name, B] * 1e3:.0f} inf/s; "
                f"replayed from a CUDA graph {fwd_graph_ms[name, B]:.4f} ms/batch, "
                f"{B / fwd_graph_ms[name, B] * 1e3:.0f} inf/s; "
                f"profiled: host wall {wall:.4f} ms/batch, device busy "
                f"{_fmt(busy)}/batch, device idle share {idle}, "
                f"{n_launch:g} kernel launches of {len(rows)} kernels")
            for kname, ms in rows[:8]:
                log(f"  device time per forward B={B}: {ms:.4f} ms  {kname[:80]}")
            mlp_ms = sum(ms for kname, ms in rows if any(k in kname for k in MLP_KERNELS))
            if name.startswith("model1"):
                log(f"  fused_mlp kernels per forward B={B}: {mlp_ms:.4f} ms (profiler; alone "
                    f"over graph replays: {graphed[f'fused_mlp fp32 model1 B={B}'][0]:.4f} ms)")
            else:
                split = _forward_split(fwd)
                log(f"  device time per forward B={B} by part (profiler, kernels in launch "
                    f"order): " + ("not measured" if split is None else ", ".join(
                        f"{part} {ms:.4f} ms ({n} launches)" for part, (ms, n) in split[0].items())
                        + f" (the mean of {split[1]} forwards)"))
    return stats


# the parts of a training step, in order (staged_step)
TRAIN_PARTS = ("lookup fwd", "towers and heads fwd", "loss", "towers and heads bwd",
               "gradient zeroing", "lookup bwd", "Adagrad")


def staged_step(model, trainer, batch, mark):
    """One Trainer.step's work split into TRAIN_PARTS, each run inside
    ``mark(part)`` (which closes it with a synchronize): the same functions
    on the same tensors (``forward_train`` is ``head_train(*lookup_train)``;
    the lookup's backward is called as LookupFunction calls it, with its
    zeroed float32 sums made apart)."""
    idx, dense, labels = batch
    if trainer.state is None:
        trainer.init()
    tensors = trainable_tensors(model)
    leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
    with mark("lookup fwd"):
        feats, bad = model.lookup_train(idx, dense, leaves)
    feats_in = feats.detach().requires_grad_()
    with mark("towers and heads fwd"):
        scores = model.head_train(feats_in, bad, dense, leaves)
    scores_in = scores.detach().requires_grad_()
    with mark("loss"):
        (g_scores,) = torch.autograd.grad(bce_with_logits(scores_in, labels), scores_in)
    ops = model.lookup_operands()
    n_tab = len(ops["bufs"])
    weights = list(leaves.values())[n_tab:]
    with mark("towers and heads bwd"):
        g_feats, *g_weights = torch.autograd.grad(scores, [feats_in, *weights], g_scores)
    with mark("gradient zeroing"):
        sums = [torch.zeros(b.numel(), dtype=torch.float32, device=b.device) for b in ops["bufs"]]
    with mark("lookup bwd"):
        lookup_fused_backward(g_feats, idx, ops["bufs"], ops["cols"], ops["pos"], ops["stripes"],
                              ops["stripe_height"], out=sums)
        g_tables = [g.view(b.shape).to(b.dtype) for g, b in zip(sums, ops["bufs"])]
    with mark("Adagrad"):
        trainer.opt.update(list(tensors.values()), g_tables + g_weights, trainer.state)


def backward_yardstick(ops, ct, idx):
    """(``index_add_`` of the live cotangents at precomputed flat offsets into
    one float32 buffer of every packed buffer's elements: the one PyTorch
    call that computes the backward's sums, as a callable; the bytes the
    backward must move, each counted once: the cotangents, ids and
    descriptors read, the distinct touched elements read and written).
    ``ops``: a model's lookup_operands, or a shard's (shard_operands: only
    its tables and the rows of its window count)."""
    cols, pos = ops["cols"], ops["pos"]
    col, add, o = lookup_mod._decode_pos(pos)
    off, _ = lookup_offsets_plain(idx, cols, ops["stripes"], ops["stripe_height"],
                                  ops.get("window"))
    sizes = torch.tensor([0] + [b.numel() for b in ops["bufs"]], device=idx.device)
    base = sizes.cumsum(0)[cols[:, LOOKUP_COL_FIELDS.index("buf")]]
    where, vals = [], []
    for c in (col, add):
        k = c.clamp(min=0)
        at = off.index_select(1, k)
        live = (c >= 0) & (at >= 0)
        where.append((base[k] + at + o)[live])
        vals.append(ct[live])
    where, vals = torch.cat(where), torch.cat(vals)
    flat = torch.zeros(int(sizes.sum()), dtype=torch.float32, device=idx.device)
    nbytes = (ct.numel() * 4 + idx.numel() * idx.element_size() + cols.numel() * 8
              + pos.numel() * 4 + torch.unique(where).numel() * 4 * 2)
    return functools.partial(flat.index_add_, 0, where, vals), nbytes


def time_backward_draws(cfg, ops, idx, dev, rng, window=None):
    """The backward kernel at each draw of ID_DRAWS (``idx``: the uniform
    draw's ids; the others from draw_ids), uniform cotangents, preallocated
    float32 sums: the kernel over graph replays and eagerly against its
    plain version (eager, CUDA events: its boolean masks have data-dependent
    shapes, no graph), the index_add_ yardstick over graph replays, the byte
    bound of the draw.  {draw: timings}."""
    out = {}
    F = ops["pos"].shape[0]
    for draw in ID_DRAWS:
        ids = idx if draw == "uniform" else torch.from_numpy(
            draw_ids(cfg, idx.shape[0], rng, draw)).to(dev, idx.dtype)
        ct = torch.from_numpy(rng.uniform(-1, 1, (idx.shape[0], F)).astype(np.float32)).to(dev)
        args = (ct, ids, ops["bufs"], ops["cols"], ops["pos"], ops["stripes"],
                ops["stripe_height"])
        sums_k = [torch.zeros(b.numel(), device=dev) for b in ops["bufs"]]
        sums_p = [torch.zeros(b.numel(), device=dev) for b in ops["bufs"]]
        kernel = functools.partial(lookup_fused_backward, *args, out=sums_k, window=window)
        plain = functools.partial(lookup_fused_backward_plain, *args, out=sums_p, window=window)
        ke, pe = _pair(kernel, plain)
        kg = _graph_ms(kernel)
        library, nbytes = backward_yardstick(ops, ct, ids)
        lib_ms = _graph_ms(library)
        del sums_k, sums_p, library
        bound_ms, bound_by = bound(nbytes)
        out[draw] = {"ms": kg, "ms_eager": ke, "plain_ms": pe, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    return out


def _log_draws(what, draws):
    for draw, r in draws.items():
        log(f"time {what} {draw}: kernel {r['ms']:.4f} ms (CUDA events over graph replays; "
            f"eager back-to-back {r['ms_eager']:.4f} ms), plain {r['plain_ms']:.4f} ms (eager), "
            f"index_add_ {r['library_ms']:.4f} ms (graph replays, kernel at "
            f"{r['library_ms'] / r['ms']:.2f}x its speed); bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']} B counted once), kernel at "
            f"{r['bound_ms'] / r['ms']:.3f} of it")


def _draw_keys(draws, sfx=""):
    """A backward record's keys: the uniform draw's at the top level, then
    each other draw's ms, library_ms, bound_ms and plain_ms under its name;
    ``sfx`` after each key (another model's)."""
    keys = {f"{k}{sfx}": draws["uniform"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for draw in ID_DRAWS[1:]:
        keys.update({f"{k}_{draw}{sfx}": draws[draw][k]
                     for k in ("ms", "library_ms", "bound_ms", "plain_ms")})
    return keys


def time_training(runs, dev):
    """CUDA-event and host-clock timings of the training step (before any
    profiled pass), per model of ``runs`` ({name: (model, trainer, batch)}):
    the step's wall time (host clock around TIME_STEPS steps ending in a
    synchronize); each part of staged_step (CUDA events, each part closed
    by a synchronize, so a part's time includes the gaps host dispatch
    leaves in it; median of TIME_STEPS); the backward kernel over graph
    replays and eagerly against its plain version (eager, CUDA events: its
    boolean masks have data-dependent shapes, no graph), on uniform
    cotangents with preallocated sums; the index_add_ yardstick over graph
    replays; the byte bound."""
    out = {}
    rng = np.random.default_rng(20)
    for name, (model, trainer, batch) in runs.items():
        for _ in range(2):
            trainer.step(*batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIME_STEPS):
            trainer.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TIME_STEPS
        parts = {p: [] for p in TRAIN_PARTS}

        @contextlib.contextmanager
        def mark(part):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            parts[part].append(start.elapsed_time(end))

        for _ in range(TIME_STEPS):
            staged_step(model, trainer, batch, mark)
        draws = time_backward_draws(model.cfg, model.lookup_operands(), batch[0], dev, rng)
        out[name] = {"wall_ms": wall,
                     "parts_ms": {p: float(np.median(v)) for p, v in parts.items()},
                     "draws": draws, **draws["uniform"]}
        r = out[name]
        log(f"time training step {name} B={B_TIME}: {wall:.4f} ms a step (host clock over "
            f"{TIME_STEPS} steps, synchronized); by part (CUDA events, each part closed by a "
            f"synchronize): " + ", ".join(f"{p} {ms:.4f} ms" for p, ms in r["parts_ms"].items()))
        _log_draws(f"lookup_fused_backward {name} B={B_TIME}", draws)
    return out


def time_window_backward(timed_b, dev):
    """The backward kernel's row-window form on phase 12's shard 0 of 2 of
    model1 (B = B_TIME), by time_backward_draws: ``index_add_`` into the
    shard's sums, the bound at the shard's bytes."""
    ops, idx, cfg = timed_b
    draws = time_backward_draws(cfg, ops, idx, dev, np.random.default_rng(27), ops["window"])
    _log_draws(f"lookup_fused_backward window fleetrec_model1 B={B_TIME}, shard 0 of 2 (take "
               f"window {ops['window']})", draws)
    return {"draws": draws, **draws["uniform"]}


def profile_training(runs, timed):
    """Profiled passes of the training step (after every CUDA-event timing):
    the device busy time of a Trainer.step (device events summed over
    TIME_STEPS steps) and its idle share against the wall time of
    ``timed``; the device time of each part of staged_step (each device
    event in the last part that began before it), their launches, and the
    backward kernel's time inside the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for name, (model, trainer, batch) in runs.items():
        busy, _, rows, n_launch = _profile(lambda: trainer.step(*batch), TIME_STEPS)

        @contextlib.contextmanager
        def mark(part):
            with record_function(f"train: {part}"):
                yield
                torch.cuda.synchronize()

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TIME_STEPS):
                staged_step(model, trainer, batch, mark)
        events = prof.events()
        # the parts' host ranges (the profiler may mirror them on the device
        # timeline as annotations: those are no device work)
        starts = sorted((e.time_range.start, e.name[len("train: "):]) for e in events
                        if e.name.startswith("train: ") and e.device_type == DeviceType.CPU)
        parts = {p: [0.0, 0] for p in TRAIN_PARTS}
        for e in events:
            if e.device_type != DeviceType.CUDA or e.name.startswith("train: "):
                continue
            before = [p for t, p in starts if t <= e.time_range.start]
            if before:
                parts[before[-1]][0] += e.time_range.elapsed_us() / 1e3 / TIME_STEPS
                parts[before[-1]][1] += 1
        wall = timed[name]["wall_ms"]
        idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
        timed[name]["busy_ms"] = busy
        timed[name]["device_parts_ms"] = {p: ms for p, (ms, _) in parts.items()}
        bwd = sum(ms for k, ms in rows if "lookup_backward" in k)
        log(f"time training step {name} B={B_TIME} (profiled): device busy {_fmt(busy)} a step, "
            f"wall {wall:.4f} ms, device idle share {idle}, {n_launch:g} kernel launches; "
            f"lookup_backward_kernel {bwd:.4f} ms of it; device time by part (profiler, staged "
            f"step): " + ", ".join(f"{p} {ms:.4f} ms ({n / TIME_STEPS:g} launches)"
                                   for p, (ms, n) in parts.items()))
        for kname, ms in rows[:10]:
            log(f"  device time per training step: {ms:.4f} ms  {kname[:80]}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's smoke test on one CUDA card")
    ap.add_argument("--phase", type=int, choices=(17,),
                    help="run the build and this phase alone (17: DLRM-DCNv2 at full rows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda:0")
    # phase 14's process is forked from this server, started while this
    # process is small: it inherits the server's peak host memory, not ours
    import multiprocessing.forkserver

    multiprocessing.forkserver.ensure_running()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    if args.phase == 17:
        return main_dcnv2()
    t0 = t_start = time.perf_counter()
    _build.kernels()
    log(f"build: {len(_build.kernel_sources())} kernel sources, one nvcc each, "
        f"all started together, then one link: {time.perf_counter() - t0:.1f} s")
    gb = gatherbench_inputs(dev)
    err_g = phase_gather(dev)
    err_gg = phase_grouped(dev, gb)
    err_m, err_mb, err_towers = phase_mlp(dev)
    cfg, model, tabs, ws, err_tiers, err_tiers_gg, model_u = phase_model1(dev)
    err_g = max(err_g, err_tiers)
    err_gg = max(err_gg, err_tiers_gg)
    t_dlrm = time.perf_counter()
    dlrm = dlrm_fp32(dev)
    log(f"dlrm_terabyte fp32 at {DLRM_ROWS} rows a table built on the host and moved to "
        f"{dev}: {time.perf_counter() - t_dlrm:.1f} s")
    err_lk, lookups = phase_lookup(dev, model, dlrm)
    launches = phase_serve(model, tabs, ws)
    gb_launches, _ = phase_tools(model, dev)
    phase_feature(dev)
    err_dlrm, dlrm_launches = phase_heads(dev, dlrm)
    del dlrm  # the host tables; the model stays in lookups
    err_bags, bag_launches = phase_bags(dev, model, tabs, ws, lookups)
    err_bwd, train_launches, runs = phase_train(dev, model, model_u,
                                                lookups["dlrm_terabyte"][1])
    trained = time_training(runs, dev)
    (err_w, err_wb), sharded, windows, timed_wb = phase_sharded(
        dev, model, tabs, ws, lookups["fleetrec_model3"][1], lookups["dlrm_terabyte"][1])
    window_bwd = time_window_backward(timed_wb, dev)
    del timed_wb
    ckpt = phase_checkpoint(dev, model)
    stats = phase_report(cfg, model, dev, gb, lookups, windows)
    profile_training(runs, trained)
    # phases 14 and 16 need the card to themselves: 52.96 GB of tables, then
    # each of phase 16's configs in turn
    del model, model_u, tabs, ws, lookups, runs, windows, gb
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 14 and 16: this process holds {torch.cuda.memory_allocated(dev)} B allocated, "
        f"{torch.cuda.memory_reserved(dev)} B reserved on the card after dropping every model; "
        f"its peak host RSS so far {peak_rss()} B")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_full_")
    try:
        crit = phase_full(CRITEO_FULL, 14, tmp)
        full = phase_full_rows(tmp)
        dcnv2 = phase_dcnv2(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    crit_lk = crit["lookup"]
    tiers, gb_a = stats["gather_rows all tiers"], stats["gather_rows gatherbench shape"]
    mlp, mlp_bf = stats[f"fused_mlp fp32 model1 B={B_TIME}"], stats[f"fused_mlp bf16 model1 B={B_TIME}"]
    lk = stats[f"lookup_fused fleetrec_model1 B={B_TIME}"]
    record = {"kernels": [
        {"name": "gather_rows", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/gather_rows.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:182",
         "launches": gb_launches["gather_rows"], "max_abs_err": err_g, **tiers,
         **{f"{k}_gatherbench": gb_a[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}},
        {"name": "fused_mlp", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/fused_mlp.cu",
         "replaces": "fleetrec_tpu/ops/mlp_fused.py:84",
         "launches": launches["fused_mlp"], "max_abs_err": err_m, **mlp,
         "max_abs_err_bf16": err_mb,
         **{f"{k}_bf16": mlp_bf[k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         # dlrm_terabyte: two calls a forward (bottom and top tower, with ReLU;
         # multi_dot runs the chain without it), launches of its served run
         "launches_dlrm_serve": dlrm_launches["fused_mlp"], "max_abs_err_dlrm": err_dlrm,
         "launches_criteo_full": crit["launches"]["fused_mlp"],
         "launches_criteo_full_serve": crit["serve_launches"]["fused_mlp"],
         "launches_checkpoint": ckpt["launches"]["fused_mlp"],
         # phase 16: each config's two forwards (B_TIME, B_SERVE) and its served run
         "launches_full_rows": {tag: r["launches"]["fused_mlp"] for tag, r in full.items()},
         "launches_full_rows_serve": {tag: r["serve_launches"]["fused_mlp"]
                                      for tag, r in full.items()},
         "max_abs_err_bf16_model2_full": full["model2_bf16"]["max_abs_err_bf16"],
         # each tower against fused_mlp_plain in phase 3, every B, ReLU off and on
         **{f"max_abs_err_{tower}{sfx}": err_towers[tower, dtype]
            for tower in ("dlrm_bottom", "dlrm_top")
            for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16"))},
         **{f"{k if k != 'library_ms' else 'multi_dot_ms'}_{tower}{sfx}":
            stats[f"fused_mlp {tag} {tower} B={B_TIME}"][k]
            for tower in ("dlrm_bottom", "dlrm_top")
            for tag, sfx in (("fp32", ""), ("bf16", "_bf16"))
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "gather_rows_grouped", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/gather_grouped.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:139",
         "launches": gb_launches["gather_rows_grouped"], "max_abs_err": err_gg,
         **stats["gather_rows_grouped gatherbench shape"]},
        {"name": "lookup_fused", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/lookup_fused.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:182",
         "launches": launches["lookup_fused"], "max_abs_err": err_lk, **lk,
         **{f"{k}_{tag}": stats[label][k]
            for tag, label in (("b1024", "lookup_fused fleetrec_model1 B=1024"),
                               ("model3", f"lookup_fused fleetrec_model3 B={B_TIME}"))
            for k in ("ms", "plain_ms", "bound_ms", "replaced_ms")},
         "ms_ids0_model3": stats[f"lookup_fused fleetrec_model3 B={B_TIME}"]["ms_ids0"],
         "launches_dlrm_serve": dlrm_launches["lookup_fused"],
         # the row-window form (phase 12): launches of one sharded forward on
         # rank 0 of the (1, 2) world; times on shard 0 of 2, bound at the
         # shard's bytes
         "launches_sharded": sharded["launches_forward"]["lookup_fused"],
         # phase 15: the forwards of model1 restored from its sharded checkpoint
         "launches_checkpoint": ckpt["launches"]["lookup_fused"],
         "max_abs_err_window": err_w,
         **{f"{k}_window_{tag}": stats[f"lookup_fused window fleetrec_{tag} B={B_TIME}"][k]
            for tag in ("model1", "model3") for k in ("ms", "plain_ms", "bound_ms")},
         **{f"{k}_dlrm": stats[f"lookup_fused dlrm_terabyte B={B_TIME}"][k]
            for k in ("ms", "plain_ms", "bound_ms", "replaced_ms", "ms_ids0")},
         # phase 14: criteo_terabyte at full cardinality (int8, 52.96 GB take
         # buffer), B_TIME: launches of its two forwards and its served run
         "launches_criteo_full": crit["launches"]["lookup_fused"],
         "launches_criteo_full_serve": crit["serve_launches"]["lookup_fused"],
         "max_abs_err_criteo_full": crit["max_abs_err"],
         "ms_criteo_full": crit_lk["random"]["ms"], "plain_ms_criteo_full": crit_lk["random"][
             "plain_ms"], "bound_ms_criteo_full": crit_lk["random"]["bound_ms"],
         "ms_ids0_criteo_full": crit_lk["ids0"]["ms"],
         "ms_window_1gib_criteo_full": crit_lk["window_1gib"]["ms"],
         # phase 16: the paper's geometries and tiny_dlrm at full rows, B_TIME
         "launches_full_rows": {tag: r["launches"]["lookup_fused"] for tag, r in full.items()},
         "launches_full_rows_serve": {tag: r["serve_launches"]["lookup_fused"]
                                      for tag, r in full.items()},
         "max_abs_err_full_rows": max(r["max_abs_err"] for r in full.values()),
         **{f"{k}_{tag}_full": r["lookup"]["random"][k] for tag, r in full.items()
            for k in ("ms", "plain_ms", "bound_ms")}},
        # the bag form of the fused lookup: launches of the served pooled run
        # (bag_L = BAG_L, one a batch); the top-level times are model1's at
        # B_TIME and BAG_L; no one PyTorch call computes it (embedding_bag
        # pools one table of one dtype, with no QR, int8, stripes or layout)
        {"name": "lookup_fused_bags", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/lookup_fused.cu",
         "replaces": "fleetrec_tpu/ops/gather_pallas.py:182",
         "launches": bag_launches["lookup_fused_bags"], "max_abs_err": err_bags,
         **stats[f"lookup_fused_bags fleetrec_model1 B={B_TIME} L={BAG_L}"],
         **{f"{k}_{tag}": stats[label][k]
            for tag, label in [(f"b{B}_l{L}", f"lookup_fused_bags fleetrec_model1 B={B} L={L}")
                               for B in (B_TIME, 1024) for L in BAG_LS]
            + [("model3", f"lookup_fused_bags fleetrec_model3 B={B_TIME} L={BAG_L_SMALL}")]
            for k in ("ms", "plain_ms", "bound_ms", "replaced_ms", "ms_ids0", "ms_skew")},
         "launches_sharded": sharded["launches_pooled"]["lookup_fused_bags"],
         **{f"{k}_window_model1": stats[f"lookup_fused_bags window fleetrec_model1 L={BAG_L} "
                                        f"B={B_TIME}"][k]
            for k in ("ms", "plain_ms", "bound_ms", "ms_ids0", "ms_skew")}},
        # the lookup's backward (training): launches of model1's training run
        # (one a step); times at model1 B_TIME (plain eager: its masks have
        # data-dependent shapes), then dlrm; library_ms one index_add_ of the
        # live cotangents at precomputed offsets; no TPU kernel: it computes
        # XLA's VJP of lookup_concat
        {"name": "lookup_fused_backward", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/lookup_fused.cu",
         "replaces": "fleetrec_tpu/models/embedding.py:531",
         "launches": train_launches["lookup_fused_backward"],
         "max_abs_err": err_bwd[torch.float32], "max_abs_err_bf16": err_bwd[torch.bfloat16],
         # each id draw: uniform (the top-level keys), every id 0, skewed
         **_draw_keys(trained["fleetrec_model1"]["draws"]),
         **_draw_keys(trained["dlrm_terabyte"]["draws"], "_dlrm"),
         **{f"step_{k}_{tag}": trained[name][k]
            for tag, name in (("model1", "fleetrec_model1"), ("dlrm", "dlrm_terabyte"))
            for k in ("wall_ms", "busy_ms")}},
        # its row-window form (the sharded training step): launches of one
        # train_step on rank 0 of the (1, 2) world on model1 (every count at 0
        # just before); times on shard 0 of 2 of model1, bound at the shard's
        # bytes; library_ms one index_add_ into the shard's sums; no TPU kernel:
        # it computes the partitioned VJP of the JAX package's GSPMD train_step
        {"name": "lookup_fused_backward_window", "route": "cuda",
         "source": "fleetrec_tpu_torch/ops/csrc/lookup_fused.cu",
         "replaces": "fleetrec_tpu/parallel/sharded.py:625",
         "launches": sharded["train_model1"]["launches"]["lookup_fused_backward"],
         "max_abs_err": err_wb,
         **_draw_keys(window_bwd["draws"]), "ms_eager": window_bwd["ms_eager"]},
        *dcnv2_kernels(dcnv2),
    ]}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, the build included")
    return finish(record)


def finish(record) -> int:
    """Print the kernels' record and the ok line; 0."""
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_dcnv2() -> int:
    """``--phase 17``: the build, then phase 17 alone; its kernels' record."""
    t0 = time.perf_counter()
    _build.kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcnv2_")
    try:
        res = phase_dcnv2(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 17 passed in {time.perf_counter() - t0:.1f} s, the build included")
    return finish({"kernels": dcnv2_kernels(res)})


if __name__ == "__main__":
    sys.exit(main())
