"""The multi-device dry run, the twin of the JAX package's
``__graft_entry__.py::dryrun_multichip``: the whole sharded path on tiny
shapes, run by every rank of a ``(data, model)`` world.

* fleetrec_model3 in float32 with 64 rows a table: one sharded SGD step
  (``ShardedFleetRec.train_step``), then a forward on the updated shard;
* fleetrec_model3 as served (int8 tables): a forward;
* ``forward_pipelined`` of K = 3 copies of that batch, each within rtol
  2e-6 / atol 1e-6 of the forward's scores;
* criteo_terabyte in float32 with rows capped at 20265 (every table in the
  one-hot / factored classes, partitioned over the model axis): a forward.

Each model is built on the host (``device="cpu"``) and each rank copies its
shard to its mesh's device.  The global batch is 8 rows a rank; a data row
scores its own rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as C
from ..models.fleetrec import init_model
from .mesh import Mesh
from .sharded import ShardedFleetRec

PIPELINE_K = 3


def _cap(cfg: C.ModelConfig, rows: int) -> C.ModelConfig:
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, rows=min(t.rows, rows)) for t in cfg.tables))


def _row_batch(mesh: Mesh, idx: np.ndarray, dense: np.ndarray):
    """This data row's rows of the global batch, on the mesh's device."""
    b = idx.shape[0] // mesh.data
    rows = slice(mesh.d * b, (mesh.d + 1) * b)
    return (torch.from_numpy(idx[rows]).to(mesh.device),
            torch.from_numpy(dense[rows]).to(mesh.device))


def dryrun_multichip(mesh: Mesh) -> dict:
    """Run the dry run on this rank of ``mesh`` (every rank of the world
    calls it); raises on a wrong shape, a non-finite score or pipelined
    scores off the forward's.  Returns the loss, this data row's scores of
    each forward, and the mesh's shape."""
    n = mesh.data * mesh.model
    B = 8 * n
    b_row = B // mesh.data
    # training needs float tables (model3's serving default is int8)
    cfg = _cap(C.fleetrec_model3(batch_size=B, table_dtype="float32"), 64)
    sh = ShardedFleetRec(init_model(cfg, table_scheme="pm1", mlp_scheme="uniform",
                                    device="cpu"), mesh)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, t.rows, size=B) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, size=(B, cfg.dense_dim)).astype(np.float32)
    labels = (np.arange(B) % 2).astype(np.float32)
    ids, dns = _row_batch(mesh, idx, dense)
    lab = torch.from_numpy(labels[mesh.d * b_row:(mesh.d + 1) * b_row]).to(mesh.device)
    out = {"mesh": [mesh.data, mesh.model]}
    loss = sh.train_step(ids, dns, lab, 0.01)
    with torch.inference_mode():
        out["scores_f32"] = sh.forward(ids, dns).cpu().numpy()
    out["loss"] = float(loss)

    # the serving default: int8 tables, float32 activations
    cfg8 = _cap(C.fleetrec_model3(batch_size=B), 64)
    sh8 = ShardedFleetRec(init_model(cfg8, table_scheme="pm1", mlp_scheme="uniform",
                                     device="cpu"), mesh)
    with torch.inference_mode():
        scores8 = sh8.forward(ids, dns)
        # K batches through the pipelined forward (batch k's exchange under
        # batch k + 1's lookup)
        scores_k = sh8.forward_pipelined(torch.stack([ids] * PIPELINE_K),
                                         torch.stack([dns] * PIPELINE_K))
    out["scores_int8"] = scores8.cpu().numpy()
    out["scores_pipelined"] = scores_k.cpu().numpy()
    if out["scores_pipelined"].shape != (PIPELINE_K, b_row):
        raise AssertionError(f"pipelined scores {out['scores_pipelined'].shape}")
    for k in range(PIPELINE_K):
        np.testing.assert_allclose(out["scores_pipelined"][k], out["scores_int8"],
                                   rtol=2e-6, atol=1e-6)

    # criteo's geometry with rows in the one-hot / factored tiers: the class
    # partition over the model axis
    cfgc = _cap(C.criteo_terabyte(batch_size=B, dtype="float32"), 20265)
    shc = ShardedFleetRec(init_model(cfgc, table_scheme="pm1", mlp_scheme="ones",
                                     device="cpu"), mesh)
    idxc = np.stack([rng.integers(0, t.rows, size=B) for t in cfgc.tables], 1).astype(np.int32)
    densec = rng.choice([-1.0, 1.0], size=(B, cfgc.dense_dim)).astype(np.float32)
    with torch.inference_mode():
        out["scores_criteo"] = shc.forward(*_row_batch(mesh, idxc, densec)).cpu().numpy()
    for k in ("scores_f32", "scores_int8", "scores_criteo"):
        if out[k].shape != (b_row,) or not np.isfinite(out[k]).all():
            raise AssertionError(f"{k}: shape {out[k].shape}, finite "
                                 f"{bool(np.isfinite(out[k]).all())}")
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"loss {out['loss']}")
    return out
