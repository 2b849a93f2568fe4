"""Packed multi-table embedding storage + lookup, the port of
``fleetrec_tpu/models/embedding.py``.

The planning half (``OneHotClass``, ``TakeGroup``, ``PackedLayout``,
``build_layout``, ``_partition_rows``, ``_pow2_scale``, ``index_columns``)
is a numpy copy of the JAX package's, and ``pack_tables`` writes the same
bytes, held as torch tensors on a device; tests/test_torch_model.py holds
both equal to the originals.  The storage tiers are:

* plain one-hot classes: tables stacked ``[n, rows_pad, dim]``;
* factored classes: ``[n, R1, r2*dim]``, row r at ``[r // r2, (r % r2)*dim]``;
* take groups: every large table of one dim inside one unified
  ``[phys_total, lanes]`` buffer, ``lanes // dim`` logical rows per
  physical row (optionally striped).

The JAX package selects from the classes with one-hot matmuls and from the
take buffer with ``jnp.take`` plus a mask-einsum.  Each of those selects
exactly one row per (query, table), so here every tier is a row read:
``lookup_concat`` views each buffer as ``[rows, dim]`` (the same memory)
and calls the ``gather_rows`` kernel once per class and once per take
group.  What follows the gathers stays in torch ops: int8 dequant,
``apply_qr_sums``, the dense tail and the ``feature_perm`` gather into the
VECTOR_START_IDX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LANES, TableSpec
from ..ops.gather import gather_rows

DEFAULT_ONEHOT_MAX = 2048

# The JAX package's bucketing constant for one-hot classes (per-op fixed
# cost against padded rows, tuned on the TPU).  Kept so that the classes,
# and so the packed bytes, match.
_BUCKET_FIXED_ROWS = 49152

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _partition_rows(rows_sorted: List[int], fixed: int = _BUCKET_FIXED_ROWS) -> List[int]:
    """Optimal contiguous partition of a sorted row-count list into buckets
    minimizing sum over buckets of (fixed + n_bucket * max_rows_bucket).
    Returns bucket end indices (exclusive).  O(k^2) DP."""
    k = len(rows_sorted)
    cost = [0.0] * (k + 1)
    back = [0] * (k + 1)
    for i in range(1, k + 1):
        best, bj = None, 0
        for j in range(i):
            c = cost[j] + fixed + (i - j) * rows_sorted[i - 1]
            if best is None or c < best:
                best, bj = c, j
        cost[i], back[i] = best, bj
    ends = []
    i = k
    while i > 0:
        ends.append(i)
        i = back[i]
    return ends[::-1]


@dataclasses.dataclass(frozen=True)
class OneHotClass:
    """Tables of one (rows_pad, dim) class, stacked.

    r2 == 0 (plain): buffer [n, rows_pad, dim].
    r2 > 0 (factored): rows_pad = R1 * r2 and the buffer is stored
    [n, R1, r2*dim] — the same memory as [n, rows_pad, dim]."""

    dim: int
    rows_pad: int
    table_ids: Tuple[int, ...]
    r2: int = 0

    @property
    def num_tables(self) -> int:
        return len(self.table_ids)

    @property
    def r1(self) -> int:
        assert self.r2 > 0
        return self.rows_pad // self.r2


@dataclasses.dataclass(frozen=True)
class TakeGroup:
    """Tables of one dim sharing the unified packed buffer.  base_phys are
    physical-row offsets: absolute for an unstriped layout, intra-stripe
    for a striped one.  ``lanes`` is the physical row width."""

    dim: int
    table_ids: Tuple[int, ...]
    base_phys: Tuple[int, ...]
    lanes: int = LANES

    @property
    def rows_per_phys(self) -> int:
        return self.lanes // self.dim

    @property
    def num_tables(self) -> int:
        return len(self.table_ids)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static lookup plan for a set of tables."""

    onehot_classes: Tuple[OneHotClass, ...]
    take_groups: Tuple[TakeGroup, ...]
    take_phys_total: int
    take_lanes: int
    # output feature position -> source position in
    # concat([class outs..., take outs..., dense, zero])
    feature_perm: Tuple[int, ...]
    feature_dim: int
    dense_dim: int
    # index-matrix column order: column k belongs to table index_table_ids[k]
    index_table_ids: Tuple[int, ...]
    # logical row count per take column (plan order): a take id outside
    # [0, rows) poisons its batch row's score with NaN
    take_rows: Tuple[int, ...] = ()
    # QR embeddings: (dst_src, src_src, dim) source-column triples,
    # emb[:, dst:+d] += emb[:, src:+d] before the feature permutation
    qr_sum_pairs: Tuple[Tuple[int, int, int], ...] = ()
    # Striped layout: physical row p of a table at intra-stripe offset base
    # lives at (p % S) * H + base + p // S.  S=1 = contiguous segments.
    take_stripes: int = 1
    stripe_height: int = 0

    @property
    def n_onehot(self) -> int:
        return sum(c.num_tables for c in self.onehot_classes)

    @property
    def n_take(self) -> int:
        return sum(g.num_tables for g in self.take_groups)


def build_layout(
    tables: Sequence[TableSpec],
    feature_dim: int,
    dense_dim: int = 0,
    onehot_max: int = DEFAULT_ONEHOT_MAX,
    take_lanes: int = LANES,
    take_stripes: int = 1,
    onehot_factor_max: int = 0,
    onehot_r2: int = 64,
    sum_pairs: Sequence[Tuple[int, int]] = (),
) -> PackedLayout:
    """Plan the packing and the static output-layout permutation (the JAX
    package's ``build_layout``, line for line).

    Positions of ``feature_dim`` covered by no table and not the dense tail
    are zero.  ``onehot_factor_max > 0`` adds the factored tier for tables
    with onehot_max < rows <= onehot_factor_max.  ``sum_pairs``:
    (dst_table_id, src_table_id) pairs for QR embeddings; src tables are
    packed and looked up but hidden from the feature permutation."""
    hidden = {src for _dst, src in sum_pairs}
    small = [t for t in tables if t.rows <= onehot_max]
    mid = [t for t in tables
           if onehot_max < t.rows <= onehot_factor_max]
    large = [t for t in tables if t.rows > max(onehot_max, onehot_factor_max)]

    by_class: Dict[int, List[TableSpec]] = {}
    for t in small:
        by_class.setdefault(t.dim, []).append(t)
    classes_list: List[OneHotClass] = []
    for d, ts in sorted(by_class.items()):
        ts = sorted(ts, key=lambda t: t.rows)
        ends = _partition_rows([t.rows for t in ts])
        start = 0
        for end in ends:
            bucket = ts[start:end]
            classes_list.append(
                OneHotClass(
                    dim=d,
                    rows_pad=_round_up(max(max(t.rows for t in bucket), 8), 8),
                    table_ids=tuple(t.table_id for t in bucket),
                )
            )
            start = end
    by_mid: Dict[int, List[TableSpec]] = {}
    for t in mid:
        by_mid.setdefault(t.dim, []).append(t)
    for d, ts in sorted(by_mid.items()):
        r2 = _round_up(max(onehot_r2, 1), max(LANES // d, 1))
        ts = sorted(ts, key=lambda t: t.rows)
        ends = _partition_rows([t.rows for t in ts])
        start = 0
        for end in ends:
            bucket = ts[start:end]
            classes_list.append(
                OneHotClass(
                    dim=d,
                    rows_pad=_round_up(max(t.rows for t in bucket), r2),
                    table_ids=tuple(t.table_id for t in bucket),
                    r2=r2,
                )
            )
            start = end
    classes = tuple(classes_list)

    by_dim: Dict[int, List[TableSpec]] = {}
    for t in large:
        by_dim.setdefault(t.dim, []).append(t)
    if large:
        take_lanes = max(take_lanes, max(t.dim for t in large))
    S = max(take_stripes, 1)
    groups: List[TakeGroup] = []
    phys = 0  # S=1: absolute rows; S>1: intra-stripe rows (stripe height)
    for d in sorted(by_dim):
        ts = by_dim[d]
        s_rows = take_lanes // d
        bases = []
        for t in ts:
            bases.append(phys)
            pr = -(-t.rows // s_rows)
            phys += -(-pr // S) if S > 1 else pr
        groups.append(
            TakeGroup(dim=d, table_ids=tuple(t.table_id for t in ts),
                      base_phys=tuple(bases), lanes=take_lanes)
        )
    stripe_height = phys if S > 1 else 0
    phys_total = phys * S if S > 1 else phys

    # source offsets: class outs first (class order), then take outs
    src_offset: Dict[int, int] = {}
    cursor = 0
    for c in classes:
        for tid in c.table_ids:
            src_offset[tid] = cursor
            cursor += c.dim
    for g in groups:
        for tid in g.table_ids:
            src_offset[tid] = cursor
            cursor += g.dim
    emb_total = cursor

    zero_src = emb_total + dense_dim
    perm = np.full(feature_dim, zero_src, dtype=np.int64)
    for t in tables:
        if t.table_id in hidden:
            continue  # QR remainder tables: summed into Q, not placed
        perm[t.out_offset : t.out_offset + t.dim] = np.arange(
            src_offset[t.table_id], src_offset[t.table_id] + t.dim
        )
    if dense_dim:
        perm[feature_dim - dense_dim :] = np.arange(emb_total, emb_total + dense_dim)

    dim_of = {t.table_id: t.dim for t in tables}
    qr_sum = tuple(
        (src_offset[dst], src_offset[src], dim_of[dst])
        for dst, src in sum_pairs
    )

    index_ids = tuple(
        [tid for c in classes for tid in c.table_ids]
        + [tid for g in groups for tid in g.table_ids]
    )
    rows_of = {t.table_id: t.rows for t in tables}
    take_rows = tuple(rows_of[tid] for g in groups for tid in g.table_ids)
    return PackedLayout(
        onehot_classes=classes,
        take_groups=tuple(groups),
        take_phys_total=phys_total,
        take_lanes=take_lanes,
        feature_perm=tuple(int(p) for p in perm),
        feature_dim=feature_dim,
        dense_dim=dense_dim,
        index_table_ids=index_ids,
        take_rows=take_rows,
        take_stripes=S,
        stripe_height=stripe_height,
        qr_sum_pairs=qr_sum,
    )


def plan_tensors(layout: PackedLayout, device) -> Dict[str, torch.Tensor]:
    """The layout's int64 constants on ``device``, made once so that a
    forward copies nothing from the host: per take column the physical base,
    the logical rows per physical row and the row limit; and the feature
    permutation."""
    bases, ss = [], []
    for g in layout.take_groups:
        bases.extend(g.base_phys)
        ss.extend([g.rows_per_phys] * g.num_tables)

    def t(vals):
        return torch.as_tensor(np.asarray(vals, np.int64), device=device)

    return {"take_base": t(bases), "take_s": t(ss),
            "take_lim": t(layout.take_rows),
            "feature_perm": t(layout.feature_perm)}


@dataclasses.dataclass
class PackedTables:
    """Device-resident storage: one stacked buffer per class plus the
    unified take buffer.  For int8 storage the per-table power-of-two
    dequant scales ride along.  ``plan`` holds ``plan_tensors(layout)`` on
    the buffers' device."""

    layout: PackedLayout
    onehot_buffers: List[torch.Tensor]  # parallel to layout.onehot_classes
    take_buffer: Optional[torch.Tensor]  # [phys_total, lanes] or None
    plan: Dict[str, torch.Tensor]
    onehot_scales: Optional[List[torch.Tensor]] = None  # [n] f32 per class
    take_scales: Optional[torch.Tensor] = None  # [n_take] f32 per column


def _pow2_scale(arr: np.ndarray) -> float:
    """Smallest power-of-two scale with arr/scale in [-127, 127]."""
    amax = float(np.max(np.abs(arr))) if arr.size else 0.0
    if amax == 0.0:
        return 1.0
    e = int(np.ceil(np.log2(amax / 127.0)))
    return float(2.0 ** e)


def _to_device(buf: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    # float32 staging values cast exactly to int8 (already rounded/clipped);
    # bfloat16 rounds to nearest even, as jnp.asarray(..., bfloat16) does
    return torch.from_numpy(buf).to(device=device, dtype=dtype)


def pack_tables(
    tables_np: Sequence[np.ndarray],
    specs: Sequence[TableSpec],
    layout: PackedLayout,
    dtype: str = "float32",
    device="cpu",
) -> PackedTables:
    """Pack per-table [rows, dim] numpy arrays into the layout's buffers on
    ``device``.  dtype "int8" stores power-of-two quantized tables with
    per-table scales."""
    tdtype = TORCH_DTYPES[dtype]
    by_id = {s.table_id: (s, np.asarray(a)) for s, a in zip(specs, tables_np)}
    quant = tdtype == torch.int8
    if quant:
        scales = {tid: _pow2_scale(a) for tid, (_sp, a) in by_id.items()}
        by_id = {
            tid: (sp, np.clip(np.rint(a / scales[tid]), -127, 127).astype(np.float32))
            for tid, (sp, a) in by_id.items()
        }

    onehot_buffers = []
    onehot_scales = [] if quant else None
    for c in layout.onehot_classes:
        buf = np.zeros((c.num_tables, c.rows_pad, c.dim), dtype=np.float32)
        for j, tid in enumerate(c.table_ids):
            spec, arr = by_id[tid]
            assert arr.shape == (spec.rows, spec.dim), (tid, arr.shape)
            buf[j, : spec.rows] = arr
        if c.r2:
            # factored storage: row id r lives at [r // r2, (r % r2)*d : +d]
            buf = buf.reshape(c.num_tables, c.r1, c.r2 * c.dim)
        onehot_buffers.append(_to_device(buf, tdtype, device))
        if quant:
            sc = np.asarray([scales[tid] for tid in c.table_ids], np.float32)
            onehot_scales.append(torch.from_numpy(sc).to(device))

    take = None
    if layout.take_phys_total:
        S, H = layout.take_stripes, layout.stripe_height
        buf = np.zeros((layout.take_phys_total, layout.take_lanes), dtype=np.float32)
        for g in layout.take_groups:
            s = g.rows_per_phys
            for tid, base in zip(g.table_ids, g.base_phys):
                spec, arr = by_id[tid]
                assert arr.shape == (spec.rows, spec.dim), (tid, arr.shape)
                phys_rows = -(-spec.rows // s)
                p = np.zeros((phys_rows * s, spec.dim), dtype=np.float32)
                p[: spec.rows] = arr
                packed_rows = p.reshape(phys_rows, g.lanes)
                if S > 1:
                    pr = np.arange(phys_rows)
                    buf[(pr % S) * H + base + pr // S] = packed_rows
                else:
                    buf[base : base + phys_rows] = packed_rows
        take = _to_device(buf, tdtype, device)
        del buf
    take_scales = None
    if quant and layout.take_groups:
        sc = []
        for g in layout.take_groups:
            sc.extend(scales[tid] for tid in g.table_ids)
        take_scales = torch.from_numpy(np.asarray(sc, np.float32)).to(device)
    return PackedTables(
        layout=layout, onehot_buffers=onehot_buffers, take_buffer=take,
        plan=plan_tensors(layout, device),
        onehot_scales=onehot_scales, take_scales=take_scales,
    )


def take_phys_sub(layout: PackedLayout, tidx: torch.Tensor,
                  base: torch.Tensor, s: torch.Tensor):
    """Map plan-order logical take ids [B, n_take] to int64 (buffer row,
    sub-row), for contiguous (S=1) and striped layouts alike.  ``base`` and
    ``s`` are the per-column physical bases and rows per physical row
    (``plan_tensors``).  Division is floored, as in jnp."""
    tidx = tidx.long()
    p = torch.div(tidx, s, rounding_mode="floor")
    sub = torch.remainder(tidx, s)
    S = layout.take_stripes
    if S > 1:
        phys = (torch.remainder(p, S) * layout.stripe_height + base
                + torch.div(p, S, rounding_mode="floor"))
    else:
        phys = base + p
    return phys, sub


def take_bad_ids(tidx: torch.Tensor, lim: torch.Tensor) -> torch.Tensor:
    """[B, n_take] bool: take ids outside their table's [0, rows)."""
    lim = lim.clamp(max=np.iinfo(np.int32).max)
    return (tidx < 0) | (tidx >= lim)


def take_bad_rows(tidx: torch.Tensor, lim: torch.Tensor) -> torch.Tensor:
    """[B] bool: batch rows with any take id outside its table's logical
    [0, rows) range; their scores are poisoned with NaN."""
    return take_bad_ids(tidx, lim).any(dim=1)


def _dequant(rows: torch.Tensor, scale: Optional[torch.Tensor], n: int,
             d: int) -> torch.Tensor:
    """[B*n, d] gathered rows -> [B, n*d]; int8 rows dequantize by their
    table's power-of-two scale (exact)."""
    if scale is None:
        return rows.reshape(-1, n * d)
    return (rows.reshape(-1, n, d).float() * scale[None, :, None]).reshape(-1, n * d)


@dataclasses.dataclass
class TierGather:
    """One tier's row read: ``gather_rows(table, ids)`` gives [B*n, dim]
    rows, b-major, dequantized by ``scale`` [n] when the storage is int8."""

    name: str
    table: torch.Tensor  # [rows, dim] view of a packed buffer
    ids: torch.Tensor  # [B*n] int64 flat row ids, -1 = zero row
    n: int
    dim: int
    scale: Optional[torch.Tensor]


def tier_gathers(packed: PackedTables, indices: torch.Tensor) -> List[TierGather]:
    """The row reads of ``lookup_concat``, one per class and per take group,
    in source-column order.

    A class buffer [n, rows_pad, d] (or the factored [n, R1, r2*d], the
    same memory) is read as [n*rows_pad, d] at ``j*rows_pad + id`` for
    0 <= id < rows_pad.  A take group reads the unified buffer as
    [phys_total*lanes/d, d] at ``phys*(lanes/d) + sub`` (take_phys_sub),
    for ids inside the table's [0, rows).  Every other id becomes -1, a
    zero row."""
    layout = packed.layout
    plan = packed.plan
    quant = packed.onehot_scales is not None
    out = []
    k = 0
    for i, (c, buf) in enumerate(zip(layout.onehot_classes, packed.onehot_buffers)):
        n = c.num_tables
        gi = indices[:, k : k + n].long()
        off = torch.arange(n, device=gi.device) * c.rows_pad
        ok = (gi >= 0) & (gi < c.rows_pad)
        flat = torch.where(ok, gi + off, -1).reshape(-1)
        out.append(TierGather(
            f"{'factored' if c.r2 else 'class'} d{c.dim} x{n}",
            buf.view(n * c.rows_pad, c.dim), flat, n, c.dim,
            packed.onehot_scales[i] if quant else None))
        k += n
    if layout.take_groups:
        tidx = indices[:, k : k + layout.n_take]
        phys, sub = take_phys_sub(layout, tidx, plan["take_base"], plan["take_s"])
        bad = take_bad_ids(tidx, plan["take_lim"])
        kk = 0
        for g in layout.take_groups:
            ng, s, d = g.num_tables, g.rows_per_phys, g.dim
            flat = phys[:, kk : kk + ng] * s + sub[:, kk : kk + ng]
            flat = torch.where(bad[:, kk : kk + ng], -1, flat).reshape(-1)
            out.append(TierGather(
                f"take d{d} x{ng}", packed.take_buffer.view(-1, d), flat, ng, d,
                None if packed.take_scales is None
                else packed.take_scales[kk : kk + ng]))
            kk += ng
    return out


def lookup_concat(
    packed: PackedTables,
    indices: torch.Tensor,
    dense: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full multi-table lookup + fixed-offset concat.

    indices: [B, num_tables] in plan order (column k belongs to table
    ``layout.index_table_ids[k]``; see ``index_columns``); dense
    [B, dense_dim].  Returns [B, feature_dim] in the VECTOR_START_IDX
    layout, in the table storage dtype (float32 for int8 storage).

    Out-of-range ids give zero features here: a class id outside
    [0, rows_pad), as the JAX one-hot does; a take id outside its table's
    [0, rows), where jnp.take fills NaN or wraps.  The score of such a row
    is NaN-poisoned by FleetRecModel.forward in both packages."""
    layout = packed.layout
    B = indices.shape[0]
    parts = [_dequant(gather_rows(t.table, t.ids), t.scale, t.n, t.dim)
             for t in tier_gathers(packed, indices)]
    emb = (torch.cat(parts, dim=1) if parts
           else torch.zeros((B, 0), device=indices.device))
    emb = apply_qr_sums(emb, layout)
    srcs = [emb]
    if layout.dense_dim:
        assert dense is not None
        srcs.append(dense.to(emb.dtype))
    srcs.append(torch.zeros((B, 1), dtype=emb.dtype, device=emb.device))
    return torch.cat(srcs, dim=1).index_select(1, packed.plan["feature_perm"])


def apply_qr_sums(emb: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """QR embeddings: add each remainder table's columns into its quotient
    table's (emb = Q[q] + R[r]) in the pre-permutation source layout, in
    place.  No-op without QR pairs."""
    for dst, src, d in layout.qr_sum_pairs:
        emb[:, dst : dst + d] += emb[:, src : src + d]
    return emb


def index_columns(layout: PackedLayout, spec_table_ids: Sequence[int]) -> np.ndarray:
    """Static permutation taking an index matrix whose columns follow
    ``spec_table_ids`` order into the plan order lookup_concat expects:
    ``indices_plan = indices[:, index_columns(...)]``."""
    col_of = {tid: j for j, tid in enumerate(spec_table_ids)}
    return np.asarray([col_of[tid] for tid in layout.index_table_ids], dtype=np.int64)
