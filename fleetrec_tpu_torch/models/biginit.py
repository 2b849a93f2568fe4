"""pm1 tables written straight into the packed buffers, the port of
``fleetrec_tpu/models/biginit.py``.

``init_model`` draws every table on the host and ``pack_tables`` stages a
float32 numpy copy of the whole take buffer before the cast: at
criteo_terabyte's real cardinalities (1,655,169,127 rows, one table of 1e9)
that copy alone is ~212 GB, more than a one-card host holds.  Here the pm1
pattern (row r of every table +1 when r is even, -1 when odd, every column;
int8 storage ±64 at scale 2^-6) is generated where it lives:

* ``pm1_take_chunk`` is the JAX package's numpy generator of buffer rows
  ``[lo, hi)``, kept as the reference the tests hold the device generator to;
* ``fill_pm1_take`` computes the same map with torch ops on the buffer's
  device, into a slice of a buffer allocated once, in the target dtype;
* ``pack_pm1_sharded`` builds a ``PackedTables`` with it: the whole take
  buffer on one device, or, with a mesh, only this rank's window of
  physical rows (what ``parallel/sharded.py::shard_operands`` would slice
  from a whole model), for ``ShardedFleetRec.from_packed``.

Host memory holds no table: the classes and the take rows are made on the
device, a chunk of ``chunk_rows`` buffer rows at a time, whose int64
temporaries are ``[rows, lanes // dim]``, never ``[rows, lanes]``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import ModelConfig, qr_expand
from .embedding import TORCH_DTYPES, PackedLayout, PackedTables, plan_tensors
from .fleetrec import resolve_device

# pm1 data has amax 1.0, so the power-of-two int8 scale is 2^-6: the
# quantized value ±64 dequantizes to ±1 exactly
_PM1_INT8_SCALE = 2.0 ** -6
_PM1_INT8_Q = 64


def _rows_of(cfg: ModelConfig) -> Dict[int, int]:
    """Every packed table's rows by id: the config's tables and, for QR
    embeddings, the hidden remainder tables (``qr_expand``'s specs)."""
    return {t.table_id: t.rows for t in qr_expand(cfg)[0]}


def pm1_take_chunk(layout: PackedLayout, cfg: ModelConfig,
                   lo: int, hi: int, dtype) -> np.ndarray:
    """Rows [lo, hi) of the unified take buffer under the pm1 scheme, as a
    numpy array of ``dtype``.

    Inverts the packing map: buffer row P = (pr % S) * H + base + pr // S
    for physical row pr of the table at intra-stripe offset base
    (``embedding.pack_tables``' striped write), so stripe k = P // H,
    intra-stripe o = P % H, pr = (o - base) * S + k.  Rows past a table's
    last physical row, sub-rows past its last logical row, and shard-pad
    rows past take_phys_total are zero, as ``pack_tables`` writes them."""
    dtype = np.dtype(dtype)
    qval = _PM1_INT8_Q if dtype == np.int8 else 1.0
    out = np.zeros((hi - lo, layout.take_lanes), dtype)
    S = layout.take_stripes
    H = layout.stripe_height if S > 1 else layout.take_phys_total
    Prow = np.arange(lo, hi)
    in_buf = Prow < layout.take_phys_total
    if S > 1:
        k = Prow // H
        o = Prow % H
    else:
        k = np.zeros_like(Prow)
        o = Prow
    rows_of = _rows_of(cfg)
    for g in layout.take_groups:
        s, d = g.rows_per_phys, g.dim
        for tid, base in zip(g.table_ids, g.base_phys):
            rows_t = rows_of[tid]
            pr_t = -(-rows_t // s)
            span = -(-pr_t // S) if S > 1 else pr_t
            m = in_buf & (o >= base) & (o < base + span)
            if not m.any():
                continue
            sel = np.nonzero(m)[0]
            pr = (o[sel] - base) * S + k[sel] if S > 1 else (o[sel] - base)
            r = pr[:, None] * s + np.arange(s)[None, :]  # logical rows [m, s]
            sign = np.where(r % 2 == 0, qval, -qval)
            sign = np.where((r < rows_t) & (pr[:, None] < pr_t), sign, 0)
            out[sel] = np.repeat(sign, d, axis=1).astype(dtype)
    return out


def take_segments(layout: PackedLayout, cfg: ModelConfig) -> List[Tuple[int, int, int, int]]:
    """Each take table's rows in the buffer, one (table id, first buffer
    row, rows, stripe k) a (stripe, table) pair: a striped table holds rows
    ``[k * H + base, k * H + base + span)`` of every stripe k (span =
    ceil(physical rows / S)); an unstriped one ``[base, base + physical
    rows)`` (k = 0)."""
    S = layout.take_stripes
    H = layout.stripe_height if S > 1 else 0
    rows_of = _rows_of(cfg)
    segs = []
    for k in range(S):
        for g in layout.take_groups:
            for tid, base in zip(g.table_ids, g.base_phys):
                pr_t = -(-rows_of[tid] // g.rows_per_phys)
                segs.append((tid, k * H + base, -(-pr_t // S) if S > 1 else pr_t, k))
    return segs


def fill_pm1_take(buf: torch.Tensor, layout: PackedLayout, cfg: ModelConfig,
                  lo: int = 0, chunk_rows: int = 1 << 22) -> torch.Tensor:
    """Write the pm1 take rows ``[lo, lo + len(buf))`` of the unified
    buffer into ``buf`` ([rows, lanes], zeroed, in the storage dtype, on
    any device), in place; returns ``buf``.  The map of ``pm1_take_chunk``
    with torch ops on ``buf``'s device: for each (stripe k, table) segment
    that meets the rows, buffer row P -> offset o = P - k * H -> physical
    row pr = (o - base) * S + k -> logical rows pr * s + j, j < s -> +q for
    an even row, -q for an odd one, 0 past the table's end (q = 64 in int8,
    else 1).  Rows no segment covers (the pad rows past take_phys_total, a
    stripe's tail past its last table) stay zero.  At most ``chunk_rows``
    rows a step, with int64 temporaries [rows, s]."""
    S = layout.take_stripes
    n = buf.shape[0]
    q = _PM1_INT8_Q if buf.dtype == torch.int8 else 1
    dev = buf.device
    plus = torch.tensor(q, dtype=buf.dtype, device=dev)
    minus = torch.tensor(-q, dtype=buf.dtype, device=dev)
    zero = torch.zeros((), dtype=buf.dtype, device=dev)
    group_of = {tid: g for g in layout.take_groups for tid in g.table_ids}
    rows_of = _rows_of(cfg)
    for tid, start, span, k in take_segments(layout, cfg):
        a, b = max(start, lo), min(start + span, lo + n)
        s, d = group_of[tid].rows_per_phys, group_of[tid].dim
        j = torch.arange(s, device=dev)
        for c0 in range(a, b, chunk_rows):
            c1 = min(c0 + chunk_rows, b)
            # physical rows of the table: (o - base) * S + k, o - base = P - start
            pr = torch.arange(c0 - start, c1 - start, device=dev) * S + k
            r = pr[:, None] * s + j  # logical rows [rows, s]
            v = torch.where(r % 2 == 0, plus, minus)
            # r < rows also drops a physical row past the table's last
            # (pr >= ceil(rows / s) gives r >= rows for every j)
            v = torch.where(r < rows_of[tid], v, zero)
            rows = buf[c0 - lo:c1 - lo, :s * d].unflatten(1, (s, d))
            rows.copy_(v[:, :, None].expand(-1, s, d))
    return buf


def _pm1_classes(layout: PackedLayout, cfg: ModelConfig, dtype: torch.dtype, dev,
                 quant: bool):
    """The one-hot and factored class buffers under pm1 on ``dev``
    (plain [n, rows_pad, dim], factored [n, R1, r2 * dim]) and their int8
    scales ([n] float32 of 2^-6; None for float storage)."""
    rows_of = _rows_of(cfg)
    q = _PM1_INT8_Q if quant else 1
    bufs, scales = [], ([] if quant else None)
    for c in layout.onehot_classes:
        buf = torch.zeros((c.num_tables, c.rows_pad, c.dim), dtype=dtype, device=dev)
        for j, tid in enumerate(c.table_ids):
            r = torch.arange(rows_of[tid], device=dev)
            buf[j, :rows_of[tid]] = torch.where(r % 2 == 0, q, -q).to(dtype)[:, None]
        if c.r2:
            buf = buf.view(c.num_tables, c.r1, c.r2 * c.dim)
        bufs.append(buf)
        if quant:
            scales.append(torch.full((c.num_tables,), _PM1_INT8_SCALE, device=dev))
    return bufs, scales


def pack_pm1_sharded(cfg: ModelConfig, layout: PackedLayout, mesh=None, device=None,
                     chunk_rows: int = 1 << 22) -> PackedTables:
    """``PackedTables`` of pm1 tables generated on the device: what
    ``pack_tables(init_tables(cfg, "pm1"), ...)`` builds, in
    ``cfg.table_dtype``, without a table on the host.

    The class buffers are whole (they are small).  Without a mesh the take
    buffer is whole, ``[take_phys_total, lanes]``; with one (a
    ``parallel.Mesh``) it is this rank's window only: physical rows
    ``[m * rows_local, (m + 1) * rows_local)`` with ``rows_local =
    ceil(take_phys_total / M)``, zero rows past the buffer's end, the rows
    ``shard_operands`` slices (``ShardedFleetRec.from_packed`` takes it as
    it is).  ``device``: where the buffers go, by default the mesh's device,
    else the card (a CUDA device this host lacks raises).  int8 scales are
    2^-6 a table: ``[n]`` a class, ``[n_take]`` for the take buffer."""
    dev = resolve_device(device if device is not None
                         else (mesh.device if mesh is not None else "cuda"))
    dtype = TORCH_DTYPES[cfg.table_dtype]
    quant = dtype == torch.int8
    onehot, onehot_scales = _pm1_classes(layout, cfg, dtype, dev, quant)
    take = take_scales = None
    if layout.take_phys_total:
        total = layout.take_phys_total
        if mesh is None:
            lo, rows = 0, total
        else:
            rows = -(-total // mesh.model)
            lo = mesh.m * rows
        take = fill_pm1_take(torch.zeros((rows, layout.take_lanes), dtype=dtype, device=dev),
                             layout, cfg, lo, chunk_rows)
        if quant:
            take_scales = torch.full((layout.n_take,), _PM1_INT8_SCALE, device=dev)
    return PackedTables(layout=layout, onehot_buffers=onehot, take_buffer=take,
                        plan=plan_tensors(layout, dev), onehot_scales=onehot_scales,
                        take_scales=take_scales)
