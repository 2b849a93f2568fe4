"""Row gather: ``out[i] = table[idx[i]]``, zero for an id outside [0, R).

The port of ``fleetrec_tpu/ops/gather_pallas.py::gather_rows``.  On a CUDA
tensor ``gather_rows`` launches the hand-written kernel
(``ops/csrc/gather_rows.cu``) or raises; on a CPU tensor it runs
``gather_rows_plain``, the plain PyTorch version of the same function.
``gather_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_IDX_DTYPES = (torch.int32, torch.int64)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_select`` with the kernel's rule: an id outside [0, R) gives a
    zero row."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table.index_select(0, torch.where(ok, idx, torch.zeros_like(idx)))
    return rows.masked_fill_(~ok[:, None], 0)


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
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be [R, L] and idx [N], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _TABLE_DTYPES or idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"unsupported dtypes table={table.dtype} idx={idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous table and idx")
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
