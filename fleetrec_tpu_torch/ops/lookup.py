"""The whole index-mode lookup in one launch: config-order ids [B, T] ->
the features [B, feature_dim] of ``lookup_concat(packed,
plan_indices(ids), dense)`` and the [B] bad-row flags of
``take_bad_rows``.

The main path's form of kernel (a), the port of
``fleetrec_tpu/ops/gather_pallas.py::gather_rows`` together with the XLA
ops the JAX package runs around its lookups (``plan_indices``,
``take_phys_sub``, ``take_bad_rows``, the int8 dequant, ``apply_qr_sums``,
the dense tail and the ``feature_perm`` take).  What it reads is laid out
by ``models/embedding.py::lookup_tensors``: one descriptor row a plan
column (where its id comes from, which buffer, which row) and one an output
column (which plan column and offset, the QR remainder column added to it,
the dense tail or a zero).

On a CUDA tensor ``lookup_fused`` launches ``ops/csrc/lookup_fused.cu`` or
raises; on a CPU tensor it runs ``lookup_fused_plain``, which walks the
same descriptors with PyTorch ops (and, using no data-dependent shapes,
can be captured in a CUDA graph).  ``lookup_fused.launches`` counts the
calls that launched the kernel: eager calls, and calls recorded while a
CUDA graph is captured; replaying a graph adds nothing.

``lookup_fused_bags`` is the same for pooled bags, the port of
``fleetrec_tpu/models/pooled.py``: config-order ids [B, T, L] (a negative
id is padding) -> the features of ``pooled_lookup_concat(packed,
plan_bags(ids), dense, mean)`` and the flags of ``pooled_bad_rows``, over
the same descriptors, by the second kernel of ``lookup_fused.cu``.  One
rule fixes its arithmetic, and ``lookup_fused_bags_plain`` follows it
exactly, so the two are bit-equal on every input.  For each output
element, walk the slots l = 0 .. L-1 in order.  A slot whose source id is
negative, or whose id (after the QR split) is not in [0, lim), adds
nothing; the second kind still counts as a member of the bag and, on a
take column, flags the row.  The first slot that adds starts the sum with
its element widened to float32 (``float(q) * scale`` for int8); each later
one is added in float32.  A bag in which no slot adds gives +0.  For mean
pooling the sum is multiplied by ``inv``, the float32 ``1 / count`` of the
column's non-negative slots (0 for an empty bag).  A QR quotient column
then adds its remainder column's pooled (and mean-scaled) value in
float32, and the result is rounded once to the output type.  The JAX
package rounds more often in bfloat16 (a factored class adds L lookups in
bfloat16, the take tier sums in bfloat16, the mean multiplies in
bfloat16); on float32 and int8 storage, and on small-integer data in any
dtype, the two agree to the last bit or to a float32 sum's order.  L = 1
with no negative id reproduces ``lookup_fused`` bit for bit.

``lookup_fused_ragged`` is the bag lookup over bags of different sizes
(MLPerf's DLRM-DCNv2: 1 to 100 members a table): config-order int32 ids
[B, sum(bag_sizes)], table t's ``bag_sizes[t]`` members in one run, tables
in config order (the wire's layout), by the ragged kernel of
``lookup_fused.cu``, which reads each table's run where it lies and pads no
bag to the longest.  Its rule is the bag rule above, so on bags of one size
L it gives ``lookup_fused_bags``' bits on the same ids viewed as [B, T, L];
``lookup_fused_ragged_plain`` is that plain version on the ids padded to
the longest bag with -1.

``window=(row_lo, rows_local)`` is the two forward kernels' form for one
model shard of the sharded forward (``parallel/sharded.py``): the take
buffer passed is physical rows ``[row_lo, row_lo + rows_local)`` of the
whole (padded) buffer, and a take id whose row falls outside them reads a
zero row (in a bag: adds nothing).  The window never flags a row: flags come
from the ids and the descriptors' global row limits.  ``None`` is the whole
buffer, as on one device.

``lookup_fused_backward`` is ``lookup_fused``'s gradient with respect to
the packed buffers, for training (the port of the VJP XLA derives from
``lookup_concat`` in the JAX package): the third kernel of
``lookup_fused.cu`` walks the same descriptors and adds each cotangent
into the element its output column read, as float32 reductions into
device memory, 16 bytes at a time where 4 output columns are one aligned
word of one row, in one pass over the batch whose grid ``backward_plan``
gives.  ``lookup_fused_backward_plain`` computes the same sums with
``index_add_``.  It takes the same ``window``, for one model shard's
training step (``ShardedFleetRec.train_step``): the take gradient is the
shard's ``rows_local`` rows, and a take row outside the window adds
nothing.
``LookupFunction`` is the ``torch.autograd.Function`` that pairs the two.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

# The fields of one row of the plan-column descriptors
# (models/embedding.py::lookup_tensors), in the order lookup_fused.cu reads
# them, and their codes.
LOOKUP_COL_FIELDS = ("src", "op", "rem", "kind", "buf", "base", "lim", "s",
                     "dim", "scale")
OP_NONE, OP_DIV, OP_MOD = 0, 1, 2
KIND_CLASS, KIND_TAKE = 0, 1
# an output column's source when it is not a plan column
POS_ZERO, POS_DENSE = -1, -2
# bits of an output column's offset word: the 4 (8) output columns it starts
# are one aligned run of one source (lookup_tensors), which the kernel moves
# as one 16-byte word of float32 (bfloat16) output
VEC4, VEC8 = 1 << 30, 1 << 29
OFF_MASK = VEC8 - 1

_F = {name: i for i, name in enumerate(LOOKUP_COL_FIELDS)}
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_IDX_DTYPES = (torch.int32, torch.int64)
# the kernel's limits (lookup_fused.cu: kMaxBufs, kSmemMax: the dynamic
# shared memory of one block, Hopper's 227 KB less 1 KB of static)
MAX_BUFS = 16
SMEM_BYTES = 232448 - 1024
# a tile holds up to TILE_ELEMS output columns (1-16 batch rows), fewer rows
# when the batch would give an SM fewer than TILES_PER_SM tiles; a launch has
# up to BLOCKS_PER_SM blocks (of 256 threads) an SM, which walk the tiles
# (on an H100, utils/lookup_sweep.py put this shape within 8% of the best
# of rows 1-16 x 1-8 blocks an SM at model1 B=1024 / 4096, model3 and
# criteo B=4096; PERF.md)
TILE_ELEMS = 4096
TILES_PER_SM = 3
BLOCKS_PER_SM = 4
# The bag kernel's plan (bags_plan): a persistent grid of BAG_BLOCKS_PER_SM
# blocks an SM walks tiles of up to BAG_MAX_ROWS batch rows, about
# BAG_TILES_PER_BLOCK tiles a block; a ring of BAG_STAGES slots of ids;
# BAG_SLOTS member loads in flight a bag (4 or 8).  On an H100
# (utils/bag_sweep.py, PERF.md) this put every model1 shape within 3% of the
# best of rows 1-16 x 2-4 blocks an SM, and model3 within 3%; more stages
# and slots were no faster.
BAG_BLOCKS_PER_SM = 4
BAG_TILES_PER_BLOCK = 1
BAG_MAX_ROWS = 16
BAG_STAGES = 2
BAG_SLOTS = 4
# an SM's shared memory on sm_90 (228 KB), of which each resident block
# takes 1 KB for itself
SM_SMEM_BYTES = 233472


def lookup_out_dtype(bufs: Sequence[torch.Tensor]) -> torch.dtype:
    """The features' dtype: the storage dtype, float32 for int8 storage
    (and for a model with no tables, as ``lookup_concat``)."""
    store = bufs[0].dtype if bufs else torch.float32
    return torch.float32 if store == torch.int8 else store


def lookup_offsets_plain(ids: torch.Tensor, cols: torch.Tensor, stripes: int,
                         stripe_height: int, window: Optional[Tuple[int, int]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, n_plan] int64 element offset of each plan column's row in its
    buffer, -1 for a zero row; [B] bool, a take id out of range).  Bags,
    ids [B, T, L]: offsets [B, n_plan, L], -1 also for a padding slot (a
    negative source id, whatever its QR split gives), which flags no
    row.  ``window``: the take buffer's row window (module docstring); a
    take row outside it is a zero row, not a flag."""
    bags = ids.dim() == 3
    f = {name: (cols[:, i, None] if bags else cols[:, i]) for name, i in _F.items()}
    x = ids.long().index_select(1, cols[:, _F["src"]])
    valid = x >= 0
    rem = f["rem"].clamp(min=1)
    x = torch.where(f["op"] == OP_DIV, torch.div(x, rem, rounding_mode="floor"),
                    torch.where(f["op"] == OP_MOD, torch.remainder(x, rem), x))
    ok = (x >= 0) & (x < f["lim"])
    take = f["kind"] == KIND_TAKE
    if bags:
        bad = (valid & ~ok & take).any(dim=2).any(dim=1)
        ok = ok & valid
    else:
        bad = (~ok & take).any(dim=1)
    x = torch.where(ok, x, 0)
    s = f["s"]
    p, sub = torch.div(x, s, rounding_mode="floor"), torch.remainder(x, s)
    if stripes > 1:
        phys = (torch.remainder(p, stripes) * stripe_height + f["base"]
                + torch.div(p, stripes, rounding_mode="floor"))
    else:
        phys = f["base"] + p
    if window is not None:
        phys = phys - window[0]
        ok = ok & (~take | ((phys >= 0) & (phys < window[1])))
    row = torch.where(take, phys * s + sub, f["base"] + x)
    return torch.where(ok, row * f["dim"], -1), bad


def _decode_pos(pos: torch.Tensor):
    """(source column, added column, offset) of each output column."""
    w = pos[:, 0]
    return ((w & 0xFFFF) ^ 0x8000) - 0x8000, w >> 16, (pos[:, 1] & OFF_MASK).long()


def _check_dense(ids: torch.Tensor, dense: Optional[torch.Tensor], dense_dim: int) -> None:
    """``dense`` must be [B, dense_dim] when the descriptors read a dense
    tail of that width, and None (or [B, 0]) when they read none."""
    if (dense is None and dense_dim) or (
            dense is not None and tuple(dense.shape) != (ids.shape[0], dense_dim)):
        raise ValueError(f"the descriptors read dense [{ids.shape[0]}, {dense_dim}], got "
                         f"{None if dense is None else tuple(dense.shape)}")


def _column_scales(scales: Optional[Sequence[torch.Tensor]],
                   cols: torch.Tensor) -> Optional[torch.Tensor]:
    """[n_plan] float32: each plan column's int8 dequant scale (None for
    float storage)."""
    if scales is None:
        return None
    buf_of, scale_at = cols[:, _F["buf"]], cols[:, _F["scale"]]
    scale_of = torch.zeros(cols.shape[0], device=cols.device)
    for i, sc in enumerate(scales):
        mine = buf_of == i
        scale_of = torch.where(mine, sc[torch.where(mine, scale_at, 0)], scale_of)
    return scale_of


def _elements(bufs: Sequence[torch.Tensor], cols: torch.Tensor, c: torch.Tensor,
              off: torch.Tensor, o: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, F] elements, in the storage dtype, of plan columns ``c`` [F]
    (-1: none) at row offsets ``off`` [B, n_plan] plus ``o`` [F], 0 where
    no row is read; [B, F] bool, a row is read)."""
    buf_of = cols[:, _F["buf"]]
    k = c.clamp(min=0)
    at = off.index_select(1, k)
    live = (c >= 0) & (at >= 0)
    v = torch.zeros(at.shape, dtype=bufs[0].dtype, device=off.device)
    for i, buf in enumerate(bufs):
        m = live & (buf_of[k] == i)
        idx = torch.where(m, at + o, 0).reshape(-1)
        v = torch.where(m, buf.reshape(-1).index_select(0, idx).view(at.shape), v)
    return v, live


def _place_dense(out: torch.Tensor, dense: Optional[torch.Tensor], col: torch.Tensor,
                 o: torch.Tensor) -> torch.Tensor:
    """``out`` with the dense tail, cast to its dtype, in its columns."""
    if dense is None or not dense.shape[1]:
        return out
    dv = dense.to(out.dtype).index_select(1, torch.where(col == POS_DENSE, o, 0))
    return torch.where(col == POS_DENSE, dv, out)


def lookup_fused_plain(ids: torch.Tensor, dense: Optional[torch.Tensor],
                       bufs: Sequence[torch.Tensor],
                       scales: Optional[Sequence[torch.Tensor]],
                       cols: torch.Tensor, pos: torch.Tensor, stripes: int = 1,
                       stripe_height: int = 0, dense_dim: int = 0, with_bad: bool = True,
                       window: Optional[Tuple[int, int]] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The same function with PyTorch ops: every output column's element
    read from its buffer at its plan column's row offset, dequantized by
    the column's scale, the QR remainder element added in the output
    dtype (as ``apply_qr_sums``'s ``+=``), the dense tail cast, zeros
    elsewhere."""
    _check_dense(ids, dense, dense_dim)
    B = ids.shape[0]
    col, add, o = _decode_pos(pos)
    off, bad = lookup_offsets_plain(ids, cols, stripes, stripe_height, window)
    scale_of = _column_scales(scales, cols)

    def values(c):
        """[B, F] elements of plan columns ``c`` (-1: none) at offsets o."""
        v, _ = _elements(bufs, cols, c, off, o)
        return v if scale_of is None else v.float() * scale_of[c.clamp(min=0)]

    # a zero or dense output column reads no row: its value is 0 until the
    # dense tail is placed
    out = torch.zeros((B, pos.shape[0]), dtype=lookup_out_dtype(bufs), device=ids.device)
    if bufs and cols.shape[0]:
        v = values(col)
        out = torch.where(add >= 0, v + values(add), v)
    return _place_dense(out, dense, col, o), (bad if with_bad else None)


def bag_columns(bag_sizes: Sequence[int]) -> np.ndarray:
    """int64 [T + 1]: table t's bag is the id columns [c[t], c[t + 1])."""
    return np.concatenate([[0], np.cumsum(np.asarray(bag_sizes, np.int64))]).astype(np.int64)


def _check_bag_sizes(ids: torch.Tensor, bag_sizes: Sequence[int]) -> None:
    if not bag_sizes or min(bag_sizes) < 1 or max(bag_sizes) > np.iinfo(np.int16).max:
        raise ValueError(f"bag sizes must be 1 .. 32767, got {tuple(bag_sizes)}")
    if ids.dim() != 2 or ids.shape[1] != sum(bag_sizes):
        raise ValueError(f"ragged bags of sizes summing to {sum(bag_sizes)} are ids "
                         f"[B, {sum(bag_sizes)}], got {tuple(ids.shape)}")


def pad_ragged(ids: torch.Tensor, bag_sizes: Sequence[int]) -> torch.Tensor:
    """Ragged ids [B, sum(bag_sizes)] -> bags [B, T, max(bag_sizes)], each
    bag's members first and -1 (padding) after them."""
    B, L = ids.shape[0], max(bag_sizes)
    c = bag_columns(bag_sizes)
    src = torch.as_tensor(np.minimum(c[:-1, None] + np.arange(L)[None, :], ids.shape[1] - 1),
                          device=ids.device)
    real = torch.as_tensor(np.arange(L)[None, :] < np.asarray(bag_sizes)[:, None],
                           device=ids.device)
    return torch.where(real, ids[:, src], -1)


def lookup_fused_ragged_plain(ids: torch.Tensor, dense: Optional[torch.Tensor],
                              bufs: Sequence[torch.Tensor],
                              scales: Optional[Sequence[torch.Tensor]],
                              cols: torch.Tensor, pos: torch.Tensor,
                              bag_sizes: Sequence[int], stripes: int = 1,
                              stripe_height: int = 0, dense_dim: int = 0, mean: bool = False,
                              with_bad: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``lookup_fused_ragged`` with PyTorch ops: ``lookup_fused_bags_plain``
    on the bags padded with -1 to the longest (``pad_ragged``), which adds
    nothing and counts no member, so the bits are the kernel's."""
    _check_bag_sizes(ids, bag_sizes)
    return lookup_fused_bags_plain(pad_ragged(ids, bag_sizes), dense, bufs, scales, cols, pos,
                                   stripes, stripe_height, dense_dim, mean, with_bad)


def lookup_fused_bags_plain(ids: torch.Tensor, dense: Optional[torch.Tensor],
                            bufs: Sequence[torch.Tensor],
                            scales: Optional[Sequence[torch.Tensor]],
                            cols: torch.Tensor, pos: torch.Tensor, stripes: int = 1,
                            stripe_height: int = 0, dense_dim: int = 0,
                            mean: bool = False, with_bad: bool = True,
                            window: Optional[Tuple[int, int]] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``lookup_fused_bags`` with PyTorch ops, by the module docstring's
    rule to the bit: per output column the slots' elements summed in slot
    order in float32 from the first that adds, times the float32 ``1 /
    count`` for mean pooling, plus the QR remainder column's pooled value,
    rounded once to the output dtype."""
    _check_dense(ids, dense, dense_dim)
    B, _T, L = ids.shape
    col, add, o = _decode_pos(pos)
    off, bad = lookup_offsets_plain(ids, cols, stripes, stripe_height, window)
    scale_of = _column_scales(scales, cols)
    inv = None
    if mean:
        # 1 / count, rounded to float32 on the host: the same bits on any device
        table = np.zeros(L + 1, np.float32)
        table[1:] = np.float32(1) / np.arange(1, L + 1, dtype=np.float32)
        table = torch.from_numpy(table).to(ids.device)
        inv = table[(ids.index_select(1, cols[:, _F["src"]]) >= 0).sum(dim=2)]

    def pooled(c):
        """[B, F] float32 pooled values of plan columns ``c`` (-1: none)."""
        k = c.clamp(min=0)
        acc = torch.zeros((B, c.shape[0]), device=ids.device)
        some = torch.zeros((B, c.shape[0]), dtype=torch.bool, device=ids.device)
        for l in range(L):
            v, live = _elements(bufs, cols, c, off[:, :, l], o)
            v = v.float() if scale_of is None else v.float() * scale_of[k]
            acc = torch.where(live, torch.where(some, acc + v, v), acc)
            some = some | live
        return acc if inv is None else acc * inv.index_select(1, k)

    out = torch.zeros((B, pos.shape[0]), dtype=lookup_out_dtype(bufs), device=ids.device)
    if bufs and cols.shape[0]:
        v = pooled(col)
        out = torch.where(add >= 0, v + pooled(add), v).to(out.dtype)
    return _place_dense(out, dense, col, o), (bad if with_bad else None)


_LOOKUP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
# the window that is the whole take buffer (lookup_fused.cu: INT64_MAX rows)
_WHOLE = (0, (1 << 63) - 1)


@functools.cache
def _entry():
    fn = _build.kernels().fr_lookup_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [*_LOOKUP_ARGS, ctypes.c_void_p]
    return fn


@functools.cache
def _entry_bags():
    fn = _build.kernels().fr_lookup_fused_bags
    fn.restype = ctypes.c_int
    # fr_lookup_fused's arguments (with the window), then L, mean, stages,
    # slots and the stream
    fn.argtypes = [*_LOOKUP_ARGS, *[ctypes.c_int] * 4, ctypes.c_void_p]
    return fn


@functools.cache
def _entry_ragged():
    fn = _build.kernels().fr_lookup_ragged_bags
    fn.restype = ctypes.c_int
    # fr_lookup_fused's arguments (with the window), then runs, n_ids, L,
    # mean, stages, slots and the stream
    fn.argtypes = [*_LOOKUP_ARGS, ctypes.c_void_p, *[ctypes.c_int] * 5, ctypes.c_void_p]
    return fn


# (bag sizes, device) -> the ragged kernel's runs: int32 [T + 1] on the device
_RUNS: dict = {}


def bag_runs(bag_sizes: Sequence[int], device: torch.device) -> torch.Tensor:
    """``bag_columns`` as int32 on ``device``, made once a (sizes, device)
    (a copy from the host: the first call of a served shape comes before its
    CUDA graphs are captured)."""
    key = (tuple(int(b) for b in bag_sizes), str(device))
    hit = _RUNS.get(key)
    if hit is None:
        hit = _RUNS[key] = torch.as_tensor(bag_columns(bag_sizes).astype(np.int32),
                                           device=device)
    return hit


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(F: int, n_plan: int, rows: int) -> int:
    """Dynamic shared memory of one block of the single-id kernel
    (lookup_fused.cu's smem_bytes): 8 bytes an output column, 40 a plan
    column, a row pointer a (row, plan column) and a flag a row."""
    return 8 * F + 40 * n_plan + 8 * rows * n_plan + 4 * rows


def launch_shape(B: int, F: int, n_plan: int, sm_count: int, rows: Optional[int] = None,
                 blocks_per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int]:
    """The single-id kernel's (rows a tile, blocks): ``rows`` (by default
    see TILE_ELEMS) halved until a tile's shared memory fits a block, and
    at most ``blocks_per_sm`` blocks an SM."""
    if rows is None:
        rows = max(1, min(16, TILE_ELEMS // max(F, 1), B // (TILES_PER_SM * sm_count)))
    while rows > 1 and smem_bytes(F, n_plan, rows) > SMEM_BYTES:
        rows //= 2
    if smem_bytes(F, n_plan, rows) > SMEM_BYTES:
        raise ValueError(f"feature_dim {F} with {n_plan} index columns does not fit one "
                         f"block's shared memory")
    return rows, max(1, min(-(-B // rows), blocks_per_sm * sm_count))


def bag_record_words(L: int) -> int:
    """4-byte words of one bag's record (lookup_fused.cu): its count of
    members that add, the mean's 1 / count and up to L row numbers, made
    odd so that neighbouring threads write to other banks."""
    return (L + 2) | 1


def bag_smem_bytes(n_pos: int, n_plan: int, T: int, L: int, rows: int, stages: int,
                   id_bytes: int, n_ids: Optional[int] = None) -> int:
    """Dynamic shared memory of one block of the bag kernel (lookup_fused.cu's
    smem_bytes_bags): an mbarrier a ring slot (rounded up to 16 bytes),
    ``stages`` slots of a tile's ids (its bytes rounded up to 16, and the two
    16-byte lines its ends may share), 8 bytes a staged output descriptor
    (``n_pos``: a 16-byte chunk each where the output moves in chunks, else
    a column each), 40 a plan column, and two tiles' records (a bag each) and
    flags (a row each).  ``n_ids``: a row's ids where they are not T * L (the
    ragged kernel's; L is then the longest bag)."""
    row_ids = T * L if n_ids is None else n_ids
    slot = -(-rows * row_ids * id_bytes // 16) * 16 + 32
    return (-(-8 * stages // 16) * 16 + stages * slot + 8 * n_pos + 40 * n_plan
            + 8 * rows * n_plan * bag_record_words(L) + 8 * rows)


@dataclasses.dataclass(frozen=True)
class BagPlan:
    """The bag kernel's launch (``bags_plan``): ``grid`` persistent blocks of
    256 threads walk tiles of ``rows`` batch rows; a ring of ``stages``
    slots of ids; ``slots`` member loads in flight a thread; ``smem`` bytes
    of dynamic shared memory a block."""

    rows: int
    grid: int
    stages: int
    slots: int
    smem: int


def bags_plan(B: int, T: int, L: int, F: int, n_plan: int, sm_count: int, id_bytes: int = 4,
              pos_cols: int = 1, rows: Optional[int] = None,
              blocks_per_sm: int = BAG_BLOCKS_PER_SM, stages: int = BAG_STAGES,
              slots: int = BAG_SLOTS, n_ids: Optional[int] = None) -> BagPlan:
    """The bag kernel's launch for B batch rows of T tables of L slots (ids
    of ``id_bytes``), F output columns staged ``pos_cols`` to a descriptor
    (the 4 float32 or 8 bfloat16 columns of a 16-byte chunk where the
    output moves in chunks, else 1) and ``n_plan`` plan columns, on a card
    of ``sm_count`` SMs: at most ``blocks_per_sm`` blocks an SM and one a
    tile.  ``rows`` by default: enough for BAG_TILES_PER_BLOCK tiles a block
    (at most BAG_MAX_ROWS), halved until ``blocks_per_sm`` blocks fit an
    SM's shared memory.  Raises when one row does not fit a block.
    ``n_ids``: the ragged kernel's ids a row (L its longest bag)."""
    if F % pos_cols or stages < 2 or slots not in (4, 8) or min(B, T, L, blocks_per_sm) < 1:
        raise ValueError(f"no bag plan for B={B} T={T} L={L} F={F} pos_cols={pos_cols} "
                         f"stages={stages} slots={slots} blocks_per_sm={blocks_per_sm}")

    def smem(r):
        return bag_smem_bytes(F // pos_cols, n_plan, T, L, r, stages, id_bytes, n_ids)

    if rows is None:
        rows = max(1, min(BAG_MAX_ROWS,
                          -(-B // (BAG_TILES_PER_BLOCK * blocks_per_sm * sm_count))))
        fit = min(SMEM_BYTES, SM_SMEM_BYTES // blocks_per_sm - 1024)
        while rows > 1 and smem(rows) > fit:
            rows //= 2
    if smem(rows) > SMEM_BYTES:
        raise ValueError(f"{rows} rows of {T} bags of {L} slots with feature_dim {F} and "
                         f"{n_plan} index columns do not fit one block's shared memory")
    grid = max(1, min(-(-B // rows), blocks_per_sm * sm_count))
    return BagPlan(rows, grid, stages, slots, smem(rows))


# per descriptor tensor: (a weak reference to it, its plan columns' (buffer,
# width)), read to the host once
_COLUMN_WIDTHS: dict = {}


def bag_buffer_rows(bufs: Sequence[torch.Tensor], cols: torch.Tensor) -> int:
    """The most rows any buffer holds in the width of a plan column that
    reads it: the bag kernel keeps a member's row as 4 bytes, so this must
    stay below 2^32.  ``cols`` is read to the host once (a synchronize) and
    remembered while it lives: descriptors are built once and never edited
    (``lookup_tensors``)."""
    hit = _COLUMN_WIDTHS.get(id(cols))
    if hit is None or hit[0]() is not cols:
        hit = (weakref.ref(cols), cols[:, [_F["buf"], _F["dim"]]].tolist())
        _COLUMN_WIDTHS[id(cols)] = hit
    return max((bufs[b].numel() // d for b, d in hit[1] if d > 0 and b < len(bufs)), default=0)


def _launch(ids: torch.Tensor, dense: Optional[torch.Tensor],
            bufs: Sequence[torch.Tensor], scales: Optional[Sequence[torch.Tensor]],
            cols: torch.Tensor, pos: torch.Tensor, stripes: int, stripe_height: int,
            dense_dim: int, with_bad: bool, shape, mean: Optional[bool],
            window: Optional[Tuple[int, int]], bag_sizes: Optional[Sequence[int]] = None
            ) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """What ``lookup_fused`` (ids [B, T], ``mean`` None; ``shape`` its
    ``tile``), ``lookup_fused_bags`` (ids [B, T, L]; ``shape`` its ``plan``)
    and ``lookup_fused_ragged`` (int32 ids [B, sum(bag_sizes)] on the card;
    ``shape`` its ``plan``) share: the checks of their operands, then, for
    CUDA tensors, one launch of the kernel.  Returns None for CPU tensors:
    the caller runs its plain version."""
    ragged = bag_sizes is not None
    bags = mean is not None and not ragged
    if ragged:
        if ids.dtype not in _IDX_DTYPES:
            raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
        _check_bag_sizes(ids, bag_sizes)
    elif ids.dim() != 2 + bags or ids.dtype not in _IDX_DTYPES or (bags and ids.shape[2] < 1):
        raise TypeError(f"ids must be [B, T{', L >= 1' if bags else ''}] int32 or int64, got "
                        f"{tuple(ids.shape)} {ids.dtype}")
    if cols.dim() != 2 or cols.shape[1] != len(LOOKUP_COL_FIELDS) or pos.dim() != 2:
        raise ValueError("cols / pos are not lookup_tensors' descriptors")
    if len({b.dtype for b in bufs}) > 1 or any(b.dtype not in _STORAGE for b in bufs):
        raise TypeError(f"buffers of one storage dtype in {list(_STORAGE)}, got "
                        f"{[b.dtype for b in bufs]}")
    if (scales is not None) != (bool(bufs) and bufs[0].dtype == torch.int8):
        raise ValueError("int8 buffers need their scales, and only they")
    tensors = [ids, cols, pos, *bufs, *(scales or []),
               *([] if dense is None else [dense])]
    if any(t.device != ids.device for t in tensors):
        raise ValueError("the lookup's tensors lie on more than one device")
    _check_dense(ids, dense, dense_dim)
    _check_window(window)
    if (bags or ragged) and bag_buffer_rows(bufs, cols) >= 1 << 32:
        raise ValueError("a buffer holds 2^32 rows or more: the bag kernel's member lists "
                         "keep 4-byte row numbers")
    if ids.device.type == "cpu":
        return None
    if ids.device.type != "cuda":
        raise ValueError(f"no lookup kernel for device {ids.device}")
    if len(bufs) > MAX_BUFS:
        raise ValueError(f"{len(bufs)} buffers: the kernel takes {MAX_BUFS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the lookup kernel needs contiguous tensors")
    if ragged and ids.dtype != torch.int32:
        raise TypeError(f"the ragged bag kernel reads int32 ids, got {ids.dtype}")
    if dense is not None and dense.dtype != torch.float32:
        if dense.dtype not in (torch.bfloat16, torch.float16):
            raise TypeError(f"dense must be float32 (or exactly widened), got {dense.dtype}")
        dense = dense.float()
    B, T = ids.shape[:2]
    L = ids.shape[2] if bags else 0
    if ragged:
        T, L = len(bag_sizes), max(bag_sizes)
    n_plan, F = cols.shape[0], pos.shape[0]
    dev = ids.device
    out = torch.empty((B, F), dtype=lookup_out_dtype(bufs), device=dev)
    bad = torch.empty(B, dtype=torch.bool, device=dev) if with_bad else None
    if B == 0:
        return out, bad
    # 16-byte words of output (4 float32 or 8 bfloat16 columns) when every
    # row of the output starts one and every buffer is aligned for them
    chunk = 16 // out.element_size()
    vec = F % chunk == 0 and all(t.data_ptr() % 16 == 0 for t in [out, *bufs, *(
        [] if dense is None else [dense])])
    if bags or ragged:
        plan = bags_plan(B, T, L, F, n_plan, _sm_count(dev.index or 0),
                         id_bytes=ids.element_size(), pos_cols=chunk if vec else 1,
                         n_ids=ids.shape[1] if ragged else None, **(shape or {}))
        rows, grid = plan.rows, plan.grid
    else:
        rows, grid = launch_shape(B, F, n_plan, _sm_count(dev.index or 0), *(shape or ()))
    vp = ctypes.c_void_p * max(len(bufs), 1)
    ptrs = vp(*[b.data_ptr() for b in bufs])
    sptrs = None if scales is None else vp(*[s.data_ptr() for s in scales])
    storage = _STORAGE[bufs[0].dtype] if bufs else 0
    args = [ptrs, sptrs, len(bufs), storage, ids.data_ptr(),
            int(ids.dtype == torch.int64),
            None if dense is None else dense.data_ptr(),
            cols.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if bad is None else bad.data_ptr(),
            B, T, n_plan, F, dense_dim if dense is not None else 0,
            rows, grid, stripes, stripe_height, int(vec), *(window or _WHOLE)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if ragged:
            rc = _entry_ragged()(*args, bag_runs(bag_sizes, dev).data_ptr(), ids.shape[1], L,
                                 int(mean), plan.stages, plan.slots, stream)
        elif bags:
            rc = _entry_bags()(*args, L, int(mean), plan.stages, plan.slots, stream)
        else:
            rc = _entry()(*args, stream)
    _build.check(rc, "lookup_fused_ragged" if ragged else
                 "lookup_fused_bags" if bags else "lookup_fused")
    return out, bad


def lookup_fused(ids: torch.Tensor, dense: Optional[torch.Tensor],
                 bufs: Sequence[torch.Tensor],
                 scales: Optional[Sequence[torch.Tensor]],
                 cols: torch.Tensor, pos: torch.Tensor, stripes: int = 1,
                 stripe_height: int = 0, dense_dim: int = 0, with_bad: bool = True,
                 tile: Optional[Tuple[int, int]] = None,
                 window: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ids [B, T] int32 or int64 (config order), dense [B, dense_dim] (None
    when the descriptors read no dense tail, ``dense_dim`` 0), the packed
    buffers (classes, then the take buffer) and, for int8 storage, their
    scales (parallel to ``bufs``), the descriptors of ``lookup_tensors``
    and the layout's stripes -> (features [B, feature_dim] in
    ``lookup_out_dtype(bufs)``, bad [B] bool or None when not
    ``with_bad``).  ``tile``: (rows a tile, blocks an SM) in place of
    ``launch_shape``'s defaults, for timing sweeps
    (``utils/lookup_sweep.py``).  ``window``: the take buffer's row window
    of a model shard (module docstring)."""
    res = _launch(ids, dense, bufs, scales, cols, pos, stripes, stripe_height,
                  dense_dim, with_bad, tile, None, window)
    if res is None:
        return lookup_fused_plain(ids, dense, bufs, scales, cols, pos, stripes,
                                  stripe_height, dense_dim, with_bad, window)
    if ids.shape[0]:
        lookup_fused.launches += 1
    return res


lookup_fused.launches = 0


def lookup_fused_bags(ids: torch.Tensor, dense: Optional[torch.Tensor],
                      bufs: Sequence[torch.Tensor],
                      scales: Optional[Sequence[torch.Tensor]],
                      cols: torch.Tensor, pos: torch.Tensor, stripes: int = 1,
                      stripe_height: int = 0, dense_dim: int = 0, mean: bool = False,
                      with_bad: bool = True, plan: Optional[dict] = None,
                      window: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pooled bags: ids [B, T, L] int32 or int64 (config order, L >= 1, a
    negative id is padding) and ``lookup_fused``'s other operands ->
    (features [B, feature_dim]: per table the sum, or with ``mean`` the
    mean, of the rows its bag's ids read; bad [B] bool, a non-negative
    take id out of range, or None when not ``with_bad``), by the module
    docstring's rule.  On a CUDA tensor it launches the bag kernel of
    ``lookup_fused.cu`` in ``bags_plan``'s launch or raises (also when a
    buffer holds 2^32 rows or more, ``bag_buffer_rows``); on a CPU tensor
    it runs ``lookup_fused_bags_plain``.  ``plan``: keyword arguments of
    ``bags_plan`` (rows, blocks_per_sm, stages, slots) in place of its
    defaults, for timing sweeps (``utils/bag_sweep.py``).  ``window``: as
    for ``lookup_fused``; the mean still divides by the whole bag's
    count."""
    res = _launch(ids, dense, bufs, scales, cols, pos, stripes, stripe_height,
                  dense_dim, with_bad, plan, bool(mean), window)
    if res is None:
        return lookup_fused_bags_plain(ids, dense, bufs, scales, cols, pos, stripes,
                                       stripe_height, dense_dim, bool(mean), with_bad, window)
    if ids.shape[0]:
        lookup_fused_bags.launches += 1
    return res


lookup_fused_bags.launches = 0


def lookup_fused_ragged(ids: torch.Tensor, dense: Optional[torch.Tensor],
                        bufs: Sequence[torch.Tensor],
                        scales: Optional[Sequence[torch.Tensor]],
                        cols: torch.Tensor, pos: torch.Tensor, bag_sizes: Sequence[int],
                        stripes: int = 1, stripe_height: int = 0, dense_dim: int = 0,
                        mean: bool = False, with_bad: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Ragged bags: ids [B, sum(bag_sizes)] (config order, table t's
    ``bag_sizes[t]`` members in one run; a negative id is padding; int32 on
    the card) and ``lookup_fused_bags``' other operands -> its (features,
    bad), by the same rule.  On a CUDA tensor it launches the ragged kernel
    of ``lookup_fused.cu`` in ``bags_plan``'s launch (4 member loads in
    flight a thread) or raises; on a CPU tensor it runs
    ``lookup_fused_ragged_plain``.  One device only: no take window."""
    res = _launch(ids, dense, bufs, scales, cols, pos, stripes, stripe_height,
                  dense_dim, with_bad, None, bool(mean), None, bag_sizes=bag_sizes)
    if res is None:
        return lookup_fused_ragged_plain(ids, dense, bufs, scales, cols, pos, bag_sizes,
                                         stripes, stripe_height, dense_dim, bool(mean),
                                         with_bad)
    if ids.shape[0]:
        lookup_fused_ragged.launches += 1
    return res


lookup_fused_ragged.launches = 0


def require_float_storage(bufs: Sequence[torch.Tensor]) -> None:
    """Raise ValueError when the packed buffers hold int8: quantized tables
    have no gradient (the JAX package's ``check_trainable``)."""
    if any(b.dtype == torch.int8 for b in bufs):
        raise ValueError(
            "training requires float table storage (table_dtype='float32' or "
            "'bfloat16'); this model holds int8-quantized tables: rebuild it with "
            "a float table_dtype and quantize only the serving checkpoint "
            "(io.quantize_tables)")


def _check_window(window: Optional[Tuple[int, int]]) -> None:
    if window is not None and (len(window) != 2 or min(window) < 0):
        raise ValueError(f"window must be (row_lo, rows_local) >= 0, got {window}")


def _check_backward(grad_out: torch.Tensor, ids: torch.Tensor,
                    bufs: Sequence[torch.Tensor], cols: torch.Tensor, pos: torch.Tensor,
                    out: Optional[Sequence[torch.Tensor]],
                    window: Optional[Tuple[int, int]]) -> None:
    if ids.dim() != 2 or ids.dtype not in _IDX_DTYPES:
        raise TypeError(f"ids must be [B, T] int32 or int64, got {tuple(ids.shape)} {ids.dtype}")
    if cols.dim() != 2 or cols.shape[1] != len(LOOKUP_COL_FIELDS) or pos.dim() != 2:
        raise ValueError("cols / pos are not lookup_tensors' descriptors")
    require_float_storage(bufs)
    if tuple(grad_out.shape) != (ids.shape[0], pos.shape[0]):
        raise ValueError(f"grad_out must be [{ids.shape[0]}, {pos.shape[0]}], got "
                         f"{tuple(grad_out.shape)}")
    if out is not None and (len(out) != len(bufs) or any(
            o.dtype != torch.float32 or o.numel() != b.numel() or not o.is_contiguous()
            for o, b in zip(out, bufs))):
        raise ValueError("out must hold one contiguous float32 buffer of each packed "
                         "buffer's size")
    _check_window(window)
    tensors = [grad_out, ids, cols, pos, *bufs, *(out or [])]
    if any(t.device != ids.device for t in tensors):
        raise ValueError("the lookup's tensors lie on more than one device")


def _gradients(bufs: Sequence[torch.Tensor],
               out: Optional[Sequence[torch.Tensor]]) -> list:
    """The flat float32 buffers the gradients are summed in: ``out``, or
    zeros."""
    if out is not None:
        return [o.view(-1) for o in out]
    return [torch.zeros(b.numel(), dtype=torch.float32, device=b.device) for b in bufs]


def _finish(grads: Sequence[torch.Tensor], bufs: Sequence[torch.Tensor],
            out: Optional[Sequence[torch.Tensor]]) -> list:
    """``out`` as it was given, or each sum in its buffer's shape, cast once
    to its storage dtype."""
    if out is not None:
        return list(out)
    return [g.view(b.shape).to(b.dtype) for g, b in zip(grads, bufs)]


def lookup_fused_backward_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                                bufs: Sequence[torch.Tensor], cols: torch.Tensor,
                                pos: torch.Tensor, stripes: int = 1, stripe_height: int = 0,
                                out: Optional[Sequence[torch.Tensor]] = None,
                                window: Optional[Tuple[int, int]] = None) -> list:
    """``lookup_fused_backward`` with PyTorch ops: the element offsets of
    ``lookup_offsets_plain`` (with the window: a take row outside it reads
    no row), then ``index_add_`` of the cotangents in float32, a quotient
    column's also into its QR remainder column's element."""
    _check_backward(grad_out, ids, bufs, cols, pos, out, window)
    grads = _gradients(bufs, out)
    col, add, o = _decode_pos(pos)
    off, _ = lookup_offsets_plain(ids, cols, stripes, stripe_height, window)
    g = grad_out.float()
    buf_of = cols[:, _F["buf"]]
    for c in (col, add):
        k = c.clamp(min=0)
        at = off.index_select(1, k)
        live = (c >= 0) & (at >= 0)
        for i, flat in enumerate(grads):
            m = live & (buf_of[k] == i)
            flat.index_add_(0, (at + o)[m], g[m])
    return _finish(grads, bufs, out)


@functools.cache
def _entry_backward():
    fn = _build.kernels().fr_lookup_fused_backward
    fn.restype = ctypes.c_int
    # grads, n_bufs, ids, ids_64, cols, pos, grad; B; T, n_plan, F, grid,
    # vec; stripes, stripe_height, row_lo, rows_local; the stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   *[ctypes.c_int] * 5, *[ctypes.c_int64] * 4, ctypes.c_void_p]
    return fn


# The backward's grid: a block a 256 (row, 4 columns) units, at most
# BACKWARD_BLOCKS_PER_SM an SM.  On an H100 at B=4096 (utils/backward_sweep.py,
# PERF.md) 3 an SM beat 2 and 4 at model1, whole and on shard 0 of 2, and at
# dlrm_terabyte, although 4 fit on an SM at once.
BACKWARD_BLOCKS_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The backward kernel's launch shape (``backward_plan``): ``grid``
    blocks of 256 threads walk the batch's (row, 4 output columns) units
    grid-stride; ``vec``: 16-byte loads and reductions where the operands
    allow them (else one float at a time)."""

    grid: int
    vec: bool = True


def backward_plan(cols, pos, B: int, sm_count: int,
                  blocks_per_sm: int = BACKWARD_BLOCKS_PER_SM, vec: bool = True) -> BackwardPlan:
    """The backward kernel's launch shape for descriptors ``cols`` / ``pos``
    (``lookup_tensors``'; tensors or arrays) and B batch rows on a card of
    ``sm_count`` SMs: a block a 256 units, at most ``blocks_per_sm`` an SM,
    and at least one.  Raises when a block's shared memory (the output and
    plan columns' descriptors) does not fit."""
    n_plan, F = cols.shape[0], pos.shape[0]
    if smem_bytes(F, n_plan, 0) > SMEM_BYTES:
        raise ValueError(f"the backward of feature_dim {F} with {n_plan} index columns needs "
                         f"{smem_bytes(F, n_plan, 0)} bytes of shared memory a block, more "
                         f"than {SMEM_BYTES}")
    units = B * (F // 4 if F % 4 == 0 else F)
    return BackwardPlan(max(1, min(blocks_per_sm * sm_count, -(-units // 256))), vec)


def lookup_fused_backward(grad_out: torch.Tensor, ids: torch.Tensor,
                          bufs: Sequence[torch.Tensor], cols: torch.Tensor,
                          pos: torch.Tensor, stripes: int = 1, stripe_height: int = 0,
                          out: Optional[Sequence[torch.Tensor]] = None,
                          window: Optional[Tuple[int, int]] = None,
                          plan: Optional[BackwardPlan] = None) -> list:
    """The gradient of ``lookup_fused``'s features with respect to the packed
    buffers: the cotangent ``grad_out`` [B, feature_dim] (float32 or
    bfloat16) and ``lookup_fused``'s ids, float buffers (classes, then the
    take buffer) and descriptors -> one gradient a buffer, in its shape and
    storage dtype.  Each cotangent adds into the element its output column
    read (a QR quotient column's also into its remainder column's); zero and
    dense columns and ids that read no row add nothing (the JAX package's
    VJP of ``lookup_concat`` adds a bad take id's cotangent, which the
    model's NaN poison makes 0, to a wrapped or dropped row).  The sums are
    float32 and rounded once to the storage dtype.  ``out``: float32
    buffers (one a packed buffer, any shape of its size) to add into in
    place of zeroed ones, returned as they are.  int8 storage raises.
    ``window``: the take buffer's row window of a model shard (module
    docstring); the take buffer given is the shard's.

    On a CUDA tensor it launches the backward kernel of ``lookup_fused.cu``
    once, in the shape ``plan`` gives (by default ``backward_plan``'s), or
    raises: float32 reductions into device memory, 16 bytes at a time where
    4 output columns are one aligned word of one row, summed in an order
    that changes from run to run (bit-equal to
    ``lookup_fused_backward_plain`` on integer cotangents whose sums stay
    below 2^24).  On a CPU tensor it runs ``lookup_fused_backward_plain``."""
    _check_backward(grad_out, ids, bufs, cols, pos, out, window)
    if ids.device.type == "cpu":
        return lookup_fused_backward_plain(grad_out, ids, bufs, cols, pos, stripes,
                                           stripe_height, out, window)
    if ids.device.type != "cuda":
        raise ValueError(f"no lookup kernel for device {ids.device}")
    if len(bufs) > MAX_BUFS:
        raise ValueError(f"{len(bufs)} buffers: the kernel takes {MAX_BUFS}")
    if not all(t.is_contiguous() for t in (ids, cols, pos)):
        raise ValueError("the lookup kernel needs contiguous tensors")
    g = grad_out.float().contiguous()
    grads = _gradients(bufs, out)
    B, T = ids.shape
    n_plan, F = cols.shape[0], pos.shape[0]
    if B:
        dev = ids.device
        plan = plan or backward_plan(cols, pos, B, _sm_count(dev.index or 0))
        # 16-byte cotangent loads and sums where 4 columns are one aligned word
        vec = plan.vec and F % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in [g, *grads])
        ptrs = (ctypes.c_void_p * len(grads))(*[t.data_ptr() for t in grads])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _entry_backward()(ptrs, len(grads), ids.data_ptr(),
                                   int(ids.dtype == torch.int64), cols.data_ptr(),
                                   pos.data_ptr(), g.data_ptr(), B, T, n_plan, F, plan.grid,
                                   int(vec), stripes, stripe_height, *(window or _WHOLE),
                                   stream)
        _build.check(rc, "lookup_fused_backward")
        lookup_fused_backward.launches += 1
    return _finish(grads, bufs, out)


lookup_fused_backward.launches = 0


class LookupFunction(torch.autograd.Function):
    """``lookup_fused`` with a gradient for the packed buffers, for
    training: ``LookupFunction.apply(ids, dense, cols, pos, stripes,
    stripe_height, dense_dim, with_bad, window, *bufs)`` -> (features, bad
    flags or None).  The forward is ``lookup_fused`` (the kernel on a CUDA
    tensor, the plain version on a CPU one), the backward
    ``lookup_fused_backward``, both over the same take window (None on one
    device; a model shard's window in ``ShardedFleetRec.train_step``).  Only
    the buffers get a gradient: the JAX package differentiates the params,
    not the ids, the descriptors or the dense tail.  Float storage only:
    the lookup is passed no int8 scales."""

    _N_ARGS = 9  # the arguments before the buffers

    @staticmethod
    def forward(ctx, ids, dense, cols, pos, stripes, stripe_height, dense_dim, with_bad,
                window, *bufs):
        require_float_storage(bufs)
        feats, bad = lookup_fused(ids, dense, bufs, None, cols, pos, stripes, stripe_height,
                                  dense_dim, with_bad, window=window)
        ctx.save_for_backward(ids, cols, pos, *bufs)
        ctx.stripes = (stripes, stripe_height)
        ctx.window = window
        if bad is not None:
            ctx.mark_non_differentiable(bad)
        return feats, bad

    @staticmethod
    def backward(ctx, grad_feats, _grad_bad):
        ids, cols, pos, *bufs = ctx.saved_tensors
        n = LookupFunction._N_ARGS
        need = ctx.needs_input_grad[n:]
        grads = [None] * len(bufs)
        if any(need):
            grads = lookup_fused_backward(grad_feats, ids, bufs, cols, pos, *ctx.stripes,
                                          window=ctx.window)
        return (None,) * n + tuple(g if k else None for g, k in zip(grads, need))
