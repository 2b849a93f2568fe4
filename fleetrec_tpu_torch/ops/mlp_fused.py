"""Fused MLP tower: the whole bias-free chain ``x @ W1 @ ... @ Wn`` in one
kernel.

The port of ``fleetrec_tpu/ops/mlp_fused.py::fused_mlp``.  On a CUDA
tensor ``fused_mlp`` launches the hand-written kernel
(``ops/csrc/fused_mlp.cu``) or raises; on a CPU tensor it runs
``fused_mlp_plain``, the plain PyTorch chain with the same casts.
``fused_mlp.launches`` counts kernel launches.

Semantics (those of ``models/mlp.py::mlp_apply``): weights are cast to
``x.dtype``, every sum is fp32, ReLU (optional) applies on every layer but
the last, activations re-narrow to ``x.dtype`` between layers, the output
is fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build

# Shared memory one block may use on Hopper (sm_90: 227 KB).
SMEM_BYTES = 232448
_MAX_LAYERS = 8
_TILES = (32, 16, 8, 4, 2, 1)
_ENTRY = {torch.float32: "fr_fused_mlp_f32", torch.bfloat16: "fr_fused_mlp_bf16"}


def tile_rows(widths: Sequence[int], dtype: torch.dtype) -> int:
    """Rows per block: the largest T in 32..1 whose two activation buffers
    (T x widest layer, 4-aligned) fit in shared memory; 0 if none does."""
    stride = -(-max(widths) // 4) * 4
    bpe = dtype.itemsize
    for t in _TILES:
        if 2 * t * stride * bpe <= SMEM_BYTES:
            return t
    return 0


def fused_mlp_available(widths: Sequence[int], dtype: torch.dtype) -> bool:
    """The kernel takes this tower: a tile of at least one row fits in
    shared memory and the chain has at most 8 layers."""
    return (dtype in _ENTRY and 1 <= len(widths) - 1 <= _MAX_LAYERS
            and tile_rows(widths, dtype) >= 1)


def fused_mlp_plain(weights: Sequence[torch.Tensor], x: torch.Tensor,
                    activation: Optional[str] = None) -> torch.Tensor:
    """The ``torch.matmul`` chain.  Products of bfloat16 values are exact in
    fp32, so upcasting the operands and multiplying in fp32 is bf16-operand,
    fp32-accumulate arithmetic."""
    dtype = x.dtype
    h = x
    for i, w in enumerate(weights):
        h = torch.matmul(h.float(), w.to(dtype).float())
        if i < len(weights) - 1:
            if activation == "relu":
                h = torch.relu(h)
            h = h.to(dtype)
    return h


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(_build.kernels(), _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def fused_mlp(weights: Sequence[torch.Tensor], x: torch.Tensor,
              activation: Optional[str] = None) -> torch.Tensor:
    """x: [B, input_dim] float32 or bfloat16; weights [in, out] per layer
    -> [B, out_dim] float32."""
    if activation not in (None, "relu"):
        raise ValueError(f"activation {activation!r} not in (None, 'relu')")
    if x.dim() != 2 or not weights:
        raise ValueError(f"x must be [B, D] with >= 1 weight, got {tuple(x.shape)}")
    widths = [x.shape[1]]
    for w in weights:
        if w.dim() != 2 or w.shape[0] != widths[-1]:
            raise ValueError(f"weight {tuple(w.shape)} does not follow width {widths[-1]}")
        if w.device != x.device:
            raise ValueError(f"weight on {w.device}, x on {x.device}")
        widths.append(w.shape[1])
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_mlp takes float32 or bfloat16 x, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_mlp_plain(weights, x, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_mlp kernel for device {x.device}")
    if not fused_mlp_available(widths, x.dtype):
        raise ValueError(f"fused_mlp kernel cannot take widths {widths} in "
                         f"{x.dtype} (shared memory or layer count)")
    if not x.is_contiguous():
        raise ValueError("fused_mlp needs a contiguous x")
    B = x.shape[0]
    out = torch.empty((B, widths[-1]), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    ws = [w.to(x.dtype).contiguous() for w in weights]
    ptrs = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
    dims = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(x.dtype)(x.data_ptr(), out.data_ptr(), B, len(ws), ptrs,
                             dims, tile_rows(widths, x.dtype),
                             int(activation == "relu"), stream)
    _build.check(rc, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
