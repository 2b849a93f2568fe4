"""Row gather: ``out[i] = table[idx[i]]``, zero for an id outside [0, R).

The port of ``fleetrec_tpu/ops/gather_pallas.py``'s two kernels:

* ``gather_rows`` (``ops/csrc/gather_rows.cu``), the port of
  ``gather_rows``: the lookup of every tier of the model;
* ``gather_rows_grouped`` (``ops/csrc/gather_grouped.cu``), the port of
  ``gather_rows_grouped``: rows land in a staged output block through
  asynchronous copies, ``group`` rows completing on one barrier and
  ``window`` groups in flight.  ``cli gatherbench`` times it against the
  other two.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs ``gather_rows_plain``, the plain PyTorch version of the same
function.  ``<wrapper>.launches`` counts the calls that launched a kernel:
eager calls, and calls recorded while a CUDA graph is captured; replaying
a graph adds nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_IDX_DTYPES = (torch.int32, torch.int64)

# Shared memory one block may use on Hopper (sm_90: 227 KB), and what the
# grouped kernel keeps there besides the staged rows: 128 barrier slots,
# and an int64 id per row rounded up to 128 bytes (gather_grouped.cu's
# smem_bytes).
SMEM_BYTES = 232448
_MAX_WINDOW = 128
_BAR_BYTES = 8 * _MAX_WINDOW


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_select`` with the kernel's rule: an id outside [0, R) gives a
    zero row."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table.index_select(0, torch.where(ok, idx, torch.zeros_like(idx)))
    return rows.masked_fill_(~ok[:, None], 0)


def _on_cpu(table: torch.Tensor, idx: torch.Tensor) -> bool:
    """Check a gather's inputs; True when they lie on the CPU (plain
    version), False on CUDA (kernel).  Any other device raises."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be [R, L] and idx [N], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _TABLE_DTYPES or idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"unsupported dtypes table={table.dtype} idx={idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.device.type == "cpu":
        return True
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the gather kernels need a contiguous table and idx")
    return False


@functools.cache
def _entry():
    fn = _build.kernels().fr_gather_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, L] (float32, bfloat16 or int8), idx [N] (int32 or int64)
    -> [N, L] in table.dtype.  The kernel copies bytes and reads int64 ids:
    int32 ids are widened first (the model's path passes int64)."""
    if _on_cpu(table, idx):
        return gather_rows_plain(table, idx)
    idx = idx.long()
    R, L = table.shape
    N = idx.shape[0]
    out = torch.empty((N, L), dtype=table.dtype, device=table.device)
    if N == 0 or L == 0:
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, N,
                      L * table.element_size(), stream)
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def grouped_params(chunk: int, group: int, window: int) -> Tuple[int, int, int]:
    """The JAX wrapper's clamp (gather_pallas.py:122-124): ``group`` at most
    ``chunk``, ``chunk`` rounded down to a multiple of ``group``, ``window``
    at most ``chunk // group`` groups."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    group = max(1, min(group, chunk))
    chunk = (chunk // group) * group
    window = max(1, min(window, chunk // group))
    return chunk, group, window


def _granule(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) dividing the row width
    and every pointer; 16 selects the kernel's bulk-copy path."""
    a = row_bytes
    for p in ptrs:
        a |= p
    return next(v for v in (16, 8, 4, 2, 1) if a % v == 0)


def grouped_launch_params(row_bytes: int, chunk: int = 1024, group: int = 8,
                          window: int = 4, granule: int = 0
                          ) -> Tuple[int, int, int, int]:
    """(chunk, group, window, seg) that the grouped kernel runs for rows of
    ``row_bytes``: ``grouped_params``, then clamped to shared memory.

    ``chunk`` staged rows plus their ids must fit in 227 KB, so ``group``
    and ``chunk`` shrink to the rows that fit (``chunk`` staying a multiple
    of ``group``) and ``window`` again to ``chunk // group`` (at most 128
    barrier slots).  A row wider than shared memory is gathered one row per
    block in slabs of ``seg`` bytes (a multiple of ``granule``, by default
    the widest unit dividing ``row_bytes``); otherwise ``seg == row_bytes``."""
    chunk, group, window = grouped_params(chunk, group, window)
    granule = granule or _granule(row_bytes)
    # smem = bars + round_up(8 * chunk, 128) + chunk * seg, and the round-up
    # adds at most 120 bytes to a multiple of 8
    fit = (SMEM_BYTES - _BAR_BYTES - 120) // (row_bytes + 8)
    if fit >= 1:
        group = min(group, fit)
        chunk = min(chunk, fit) // group * group
        seg = row_bytes
    else:
        chunk = group = 1
        seg = (SMEM_BYTES - _BAR_BYTES - 128) // granule * granule
    window = max(1, min(window, chunk // group, _MAX_WINDOW))
    return chunk, group, window, seg


@functools.cache
def _entry_grouped():
    fn = _build.kernels().fr_gather_rows_grouped
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def gather_rows_grouped(table: torch.Tensor, idx: torch.Tensor,
                        chunk: int = 1024, group: int = 8,
                        window: int = 4) -> torch.Tensor:
    """Same function and inputs as ``gather_rows``, by the grouped kernel:
    blocks of ``chunk`` rows, ``group`` rows per barrier, ``window`` groups
    in flight, after ``grouped_launch_params``' clamps.  The output is
    [N, L] exactly; nothing is padded."""
    chunk, group, window = grouped_params(chunk, group, window)
    if _on_cpu(table, idx):
        return gather_rows_plain(table, idx)
    idx = idx.long()
    R, L = table.shape
    N = idx.shape[0]
    out = torch.empty((N, L), dtype=table.dtype, device=table.device)
    if N == 0 or L == 0:
        return out
    row_bytes = L * table.element_size()
    granule = _granule(row_bytes, table.data_ptr(), out.data_ptr())
    chunk, group, window, seg = grouped_launch_params(row_bytes, chunk, group,
                                                      window, granule)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry_grouped()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                              R, N, row_bytes, chunk, group, window, seg,
                              granule, stream)
    _build.check(rc, "gather_rows_grouped")
    gather_rows_grouped.launches += 1
    return out


gather_rows_grouped.launches = 0
