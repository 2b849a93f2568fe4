"""Multi-hot pooled embedding bags, the port of
``fleetrec_tpu/models/pooled.py``: a variable-length list of ids per
(query, table) whose embeddings are sum- or mean-pooled (DLRM's sparse
multi-hot inputs), on the same packed storage as the single-id lookup.

Bags are ``[B, T, L]`` ids with a static maximum length L.  A negative id
marks an empty slot: it contributes nothing, and mean pooling divides by
the count of non-negative slots (an empty bag gives a zero vector).  A
take-tier id ``>=`` its table's rows poisons its row's score with NaN, as
in the single-id forward; a negative id never does (the single-id contract
flags it).  L = 1 with no padding is the single-id lookup.

The functions here are the JAX functions tier by tier, with their cast
points: a plain class sums its L rows in float32 (int32 for int8) and
casts once; a factored class adds L single-id lookups in the storage
dtype; the take tier sums its rows (int32 for int8) into the storage
dtype; mean pooling multiplies by the float32 ``1 / count`` cast to the
pooled dtype.  Where the JAX package selects rows with multi-hot masks and
matmuls, each tier here gathers its ``B * n * L`` rows (``gather_rows``)
and sums over the slot axis: the same values, and no ``[B, n, L, rows]``
mask.  ``FleetRecModel.forward_pooled`` computes
``pooled_lookup_concat(packed, plan_bags(ids), dense, mean)`` and
``pooled_bad_rows`` in one ``ops/lookup.py::lookup_fused_bags`` launch;
these functions stay as what that launch is held against.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.gather import gather_rows
from .embedding import OneHotClass, PackedTables, apply_qr_sums, take_phys_sub


def _inv_count(valid: torch.Tensor) -> torch.Tensor:
    """[B, n] float32 ``1 / count`` of each bag's valid slots ([B, n, L]
    bool), 0 for an empty bag."""
    cnt = valid.sum(dim=2).float()
    return torch.where(cnt > 0, 1.0 / cnt.clamp(min=1.0), 0.0)


def pooled_class_lookup(buf: torch.Tensor, c: OneHotClass, gi: torch.Tensor,
                        gv: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        mean: bool = False) -> torch.Tensor:
    """Pooled lookup for one plain or factored class: ids [B, n, L] and
    their validity [B, n, L] -> [B, n*d] (float32 for int8 storage, with
    ``scale`` [n]).  An id outside [0, rows_pad) reads a zero row but
    counts in the mean's denominator when it is not negative."""
    B, n, L = gi.shape
    d = c.dim
    quant = buf.dtype == torch.int8
    gi = gi.long()
    live = gv & (gi >= 0) & (gi < c.rows_pad)
    base = torch.arange(n, device=gi.device)[None, :, None] * c.rows_pad
    flat = torch.where(live, gi + base, -1).reshape(-1)
    # the factored [n, R1, r2*d] buffer is the same memory as [n*rows_pad, d]
    rows = gather_rows(buf.view(n * c.rows_pad, d), flat).view(B, n, L, d)
    if c.r2 == 0:
        # one sum over the bag in float32 (exact in int32 for int8), one cast
        if quant:
            pooled = rows.int().sum(dim=2).float() * scale[None, :, None]
        else:
            pooled = rows.float().sum(dim=2).to(buf.dtype)
    else:
        # L single-id lookups added in the storage dtype (dequantized first)
        if quant:
            rows = rows.float() * scale[None, :, None, None]
        pooled = rows[:, :, 0]
        for l in range(1, L):
            pooled = pooled + rows[:, :, l]
    if mean:
        pooled = pooled * _inv_count(gv)[:, :, None].to(pooled.dtype)
    return pooled.reshape(B, n * d)


def pooled_take_extract(packed: PackedTables, tidx: torch.Tensor, tval: torch.Tensor,
                        local_start: int = 0, local_rows: Optional[int] = None,
                        mean: bool = False) -> List[torch.Tensor]:
    """Pooled take-tier gather: plan-order bag ids [B, n_take, L] and their
    validity -> one [B, n_g * d_g] a take group.  With ``local_rows`` the
    take buffer holds only the physical rows [local_start, local_start +
    local_rows) (a row-range shard): rows outside it contribute zero, while
    the mean still divides by the whole bag's count.  Padding and ids out
    of their table's range contribute zero; the caller poisons the rows
    ``pooled_bad_rows`` flags."""
    layout = packed.layout
    B, n_take, L = tidx.shape
    plan = packed.plan
    live = tval & (tidx >= 0) & (tidx < plan["take_lim"].clamp(
        max=np.iinfo(np.int32).max)[None, :, None])
    safe = torch.where(live, tidx, 0).permute(0, 2, 1)  # [B, L, n_take]
    phys, sub = take_phys_sub(layout, safe, plan["take_base"], plan["take_s"])
    phys, sub = phys.permute(0, 2, 1), sub.permute(0, 2, 1)
    if local_rows is not None:
        phys = phys - local_start
        live = live & (phys >= 0) & (phys < local_rows)
    buf = packed.take_buffer
    quant = buf.dtype == torch.int8
    inv = _inv_count(tval) if mean else None
    outs = []
    kk = 0
    for g in layout.take_groups:
        ng, s, d = g.num_tables, g.rows_per_phys, g.dim
        sl = slice(kk, kk + ng)
        flat = torch.where(live[:, sl], phys[:, sl] * s + sub[:, sl], -1).reshape(-1)
        rows = gather_rows(buf.view(-1, d), flat).view(B, ng, L, d)
        if quant:
            e = rows.int().sum(dim=2).float() * packed.take_scales[sl][None, :, None]
        else:
            e = rows.float().sum(dim=2).to(buf.dtype)
        if mean:
            e = e * inv[:, sl, None].to(e.dtype)
        outs.append(e.reshape(B, ng * d))
        kk += ng
    return outs


def pooled_lookup_concat(packed: PackedTables, indices: torch.Tensor,
                         dense: Optional[torch.Tensor] = None,
                         mean: bool = False) -> torch.Tensor:
    """Bag lookup + fixed-offset concat: plan-order ids [B, T', L] (a
    negative id is padding; see ``plan_bags``) -> pooled features [B,
    feature_dim] in the VECTOR_START_IDX layout, in the table storage dtype
    (float32 for int8 storage).  ``lookup_concat`` with a bag a table."""
    layout = packed.layout
    B = indices.shape[0]
    quant = packed.onehot_scales is not None
    valid = indices >= 0
    parts = []
    k = 0
    for i, (c, buf) in enumerate(zip(layout.onehot_classes, packed.onehot_buffers)):
        sl = slice(k, k + c.num_tables)
        parts.append(pooled_class_lookup(buf, c, indices[:, sl], valid[:, sl],
                                         packed.onehot_scales[i] if quant else None, mean))
        k += c.num_tables
    if layout.take_groups:
        sl = slice(k, k + layout.n_take)
        parts.extend(pooled_take_extract(packed, indices[:, sl], valid[:, sl], mean=mean))
    emb = (torch.cat(parts, dim=1) if parts
           else torch.zeros((B, 0), device=indices.device))
    emb = apply_qr_sums(emb, layout)
    srcs = [emb]
    if layout.dense_dim:
        assert dense is not None
        srcs.append(dense.to(emb.dtype))
    srcs.append(torch.zeros((B, 1), dtype=emb.dtype, device=emb.device))
    return torch.cat(srcs, dim=1).index_select(1, packed.plan["feature_perm"])


def pooled_bad_rows(model, plan_indices: torch.Tensor) -> Optional[torch.Tensor]:
    """[B] bool (None without a take tier): rows with a non-negative
    take-tier id ``>=`` its table's rows.  Negative ids are padding here,
    not errors."""
    lay = model.layout
    if not lay.take_groups:
        return None
    n_oh = lay.n_onehot
    tidx = plan_indices[:, n_oh : n_oh + lay.n_take]
    lim = model.plan_take_lim.clamp(max=np.iinfo(np.int32).max)
    return (tidx >= lim[None, :, None]).any(dim=2).any(dim=1)


def plan_bags(model, indices: torch.Tensor) -> torch.Tensor:
    """Config-order bag ids [B, num_tables, L] (negative = padding) ->
    plan-order [B, T', L]: ``plan_indices`` (the QR split and the column
    permutation) applied per slot, a padding slot staying -1 in every
    column derived from it (``-1 % rem`` alone would be ``rem - 1``)."""
    B, _T, L = indices.shape
    neg = (indices < 0).permute(0, 2, 1).reshape(B * L, -1)
    flat = indices.permute(0, 2, 1).reshape(B * L, -1)
    planned = model.plan_indices(torch.where(neg, 0, flat))
    negf = torch.cat([neg] + [neg[:, pos : pos + 1] for pos, _rem in model.plan.qr_positions],
                     dim=1).index_select(1, model.index_perm)
    return torch.where(negf, -1, planned).reshape(B, L, -1).permute(0, 2, 1)


def forward_pooled(model, indices: torch.Tensor, dense: Optional[torch.Tensor] = None,
                   mean: bool = False) -> torch.Tensor:
    """Bag-pooled forward of a ``FleetRecModel``: config-order ids [B,
    num_tables, L] (negative = padding) and dense [B, dense_dim] -> scores
    [B] float32 (``FleetRecModel.forward_pooled``).  A config with an
    interaction head raises: its head is not defined on pooled bags."""
    return model.forward_pooled(indices, dense, mean=mean)
