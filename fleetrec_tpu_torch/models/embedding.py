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
exactly one row per (query, table), so here every tier is a row read.
``lookup_concat`` is the tier-by-tier port: it views each buffer as
``[rows, dim]`` (the same memory) and calls the ``gather_rows`` kernel once
per class and once per take group; int8 dequant, ``apply_qr_sums``, the
dense tail and the ``feature_perm`` gather into the VECTOR_START_IDX layout
follow in torch ops.  The forward runs all of it, with ``plan_indices`` and
``take_bad_rows``, in one ``ops/lookup.py::lookup_fused`` launch, which
reads the descriptors ``lookup_tensors`` builds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import LANES, TableSpec
from ..ops.gather import gather_rows
from ..ops.lookup import (KIND_CLASS, KIND_TAKE, LOOKUP_COL_FIELDS, OP_DIV,
                          OP_MOD, OP_NONE, POS_DENSE, POS_ZERO, VEC4, VEC8)

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


def lookup_tensors(layout: PackedLayout, index_perm: Sequence[int],
                   qr_positions: Sequence[Tuple[int, int]],
                   device, shard: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """The descriptors of ``ops/lookup.py::lookup_fused``, which computes
    ``lookup_concat(packed, plan_indices(ids), dense)`` and
    ``take_bad_rows`` from config-order ids in one pass.  Offsets and kinds
    only: the buffers' pointers are passed at every call.

    ``cols``, int64 [n_plan, len(LOOKUP_COL_FIELDS)], one row a plan-order
    index column k:

    * ``src``: the config-order id column it reads; ``op`` / ``rem``: the
      QR split (``plan_indices``): none, floor(id / rem) or id mod rem;
    * ``kind``: a class column (plain or factored) or a take column;
      ``buf``: its buffer, class i or the take buffer (after the classes);
    * a class column reads row ``base + id`` (``base = j * rows_pad``) of
      its buffer's [n * rows_pad, dim] view, for ``0 <= id < lim =
      rows_pad``;
    * a take column reads row ``phys * s + sub`` of the take buffer's
      [-1, dim] view (``take_phys_sub``, ``base`` the physical base, ``s``
      the rows per physical row), for ``0 <= id < lim``, the table's rows
      clamped to int32 max (``take_bad_ids``); another id flags its row;
    * every other id reads a zero row; ``scale``: the column's index in its
      buffer's int8 scales.

    ``pos``, int32 [feature_dim, 2], one row an output column p (the
    ``feature_perm`` and ``qr_sum_pairs`` of the layout): ``[0]`` holds the
    source column (a plan column k, ``POS_ZERO`` or ``POS_DENSE``) in its
    low 16 bits and the plan column whose row is added to it (the QR
    remainder table's, or -1) in its high 16; ``[1]`` the offset within
    the row, or the dense column, with ``VEC4`` (``VEC8``) set on the first
    of 4 (8) output columns, at a multiple of 4 (8), that are one run of
    one row at an offset that is a multiple of 4 (8) in a row whose width
    is one too (or all zeros): the kernel moves them as one word.

    ``shard=(m, M)``: the descriptors of model shard m of M
    (``parallel/sharded.py``), whose class buffer i holds the class's
    tables ``[m * n_loc, (m + 1) * n_loc)`` with ``n_loc = ceil(n / M)``
    (``class_tables``).  A class column of a table that shard holds reads
    its local table (``base`` and ``scale`` rebased); any other class column
    has ``lim = 0``, so it reads a zero row and, being a class column, flags
    nothing.  Take columns keep their global ``base`` and ``lim``: the
    kernel's row window drops another shard's rows, and the flags are the
    same on every shard.  On a shard other than 0 the dense tail's output
    columns are zeros (shard 0 contributes it), and the descriptors read no
    dense tail.  Without ``shard`` (or with ``(0, 1)``) the descriptors are
    the single-device ones."""
    n_cfg = len(index_perm) - len(qr_positions)
    qr_rem = dict(qr_positions)
    m, M = shard or (0, 1)
    rows = []  # one dict of LOOKUP_COL_FIELDS a plan column
    for i, c in enumerate(layout.onehot_classes):
        lo, hi = class_tables(c.num_tables, m, M)
        rows += [dict(kind=KIND_CLASS, buf=i, base=(j - lo) * c.rows_pad, lim=c.rows_pad,
                      s=1, dim=c.dim, scale=j - lo) if lo <= j < hi else
                 dict(kind=KIND_CLASS, buf=i, base=0, lim=0, s=1, dim=c.dim, scale=0)
                 for j in range(c.num_tables)]
    int32_max = np.iinfo(np.int32).max
    take_bases = [(g, b) for g in layout.take_groups for b in g.base_phys]
    rows += [dict(kind=KIND_TAKE, buf=len(layout.onehot_classes), base=b,
                  lim=min(layout.take_rows[kk], int32_max), s=g.rows_per_phys,
                  dim=g.dim, scale=kk) for kk, (g, b) in enumerate(take_bases)]
    for row, j in zip(rows, index_perm):
        if j >= n_cfg:  # a QR remainder column, appended after the config's
            src, rem = qr_positions[j - n_cfg]
            row.update(src=src, op=OP_MOD, rem=rem)
        else:
            row.update(src=j, op=OP_DIV if j in qr_rem else OP_NONE,
                       rem=qr_rem.get(j, 0))
    n_plan = len(rows)
    if n_plan >= 1 << 15:
        raise NotImplementedError(f"{n_plan} index columns: at most 32767")
    cols = np.asarray([[r[f] for f in LOOKUP_COL_FIELDS] for r in rows],
                      np.int64).reshape(n_plan, len(LOOKUP_COL_FIELDS))
    dims = np.asarray([r["dim"] for r in rows], np.int64)
    cursor = np.concatenate([[0], np.cumsum(dims)])  # each column's source offset

    col_at = {int(off): k for k, off in enumerate(cursor[:-1])}
    add_of = {}
    for dst, src, d in layout.qr_sum_pairs:
        kd, ks = col_at.get(dst), col_at.get(src)
        if (kd is None or ks is None or dims[kd] != d or dims[ks] != d
                or kd in add_of or ks in add_of or kd in add_of.values()):
            raise NotImplementedError(
                f"QR pair {(dst, src, d)}: the fused lookup adds one whole "
                f"remainder column to one whole quotient column")
        add_of[kd] = ks

    emb_total = int(cursor[-1])
    perm = np.asarray(layout.feature_perm, np.int64)
    col = np.full(perm.shape, POS_ZERO, np.int64)
    add = np.full(perm.shape, -1, np.int64)
    off = np.zeros(perm.shape, np.int64)
    emb = perm < emb_total
    col[emb] = np.searchsorted(cursor, perm[emb], side="right") - 1
    off[emb] = perm[emb] - cursor[col[emb]]
    add[emb] = [add_of.get(int(k), -1) for k in col[emb]]
    dense = (perm >= emb_total) & (perm < emb_total + layout.dense_dim)
    col[dense] = POS_DENSE if m == 0 else POS_ZERO
    off[dense] = perm[dense] - emb_total if m == 0 else 0
    # chunks of n output columns that are one run of one source, aligned to
    # n in a row of n-multiple width (or zeros): their first column's VEC bit
    widths = np.append(dims, layout.dense_dim)  # a plan column's, the dense row's
    vec = np.zeros_like(off)
    for bit, n in ((VEC4, 4), (VEC8, 8)):
        m = len(perm) // n * n
        c, a, o = (x[:m].reshape(-1, n) for x in (col, add, off))
        one = (c == c[:, :1]).all(1) & (a == a[:, :1]).all(1)
        run = (((o - o[:, :1]) == np.arange(n)).all(1) & (o[:, 0] % n == 0)
               & (widths[np.where(c[:, 0] >= 0, c[:, 0], n_plan)] % n == 0))
        vec[:m:n] |= np.where(one & ((c[:, 0] == POS_ZERO) | run), bit, 0)
    pos = np.stack([(col & 0xFFFF) | ((add & 0xFFFF) << 16), off | vec], 1)
    pos = pos.astype(np.uint32).view(np.int32)
    return {"cols": torch.as_tensor(cols, device=device),
            "pos": torch.as_tensor(pos, device=device)}


def class_tables(n: int, m: int, M: int) -> Tuple[int, int]:
    """The tables [lo, hi) of a class of ``n`` that model shard m of M
    holds: ``n_loc = ceil(n / M)`` a shard (the class's table axis padded to
    ``n_loc * M`` with zero tables, as the JAX package's ``shard_params``
    pads it), clipped to the real tables."""
    n_loc = -(-n // M)
    return min(m * n_loc, n), min((m + 1) * n_loc, n)


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
