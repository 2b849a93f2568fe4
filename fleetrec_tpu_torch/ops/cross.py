"""The elementwise tail of a DCNv2 cross layer, ``x0 * (xw + b) + x_l``, in
one launch (``ops/csrc/cross_tail.cu``), where ``xw`` is the layer's
product ``x_l U V`` (or ``x_l W``) summed in fp32
(``models/interaction.py::cross_network``).

On a CUDA tensor ``cross_tail`` launches the kernel or raises (the kernel
has no backward, so a tensor that requires grad raises too: training
passes ``cross_tail_plain`` to ``cross_network``); on a CPU tensor it runs
``cross_tail_plain``, the torch expression whose arithmetic the kernel
follows to the bit: ``xw`` rounded to the activation dtype D, then ``+ b``,
``x0 *`` and ``+ x_l`` each rounded to D.  ``cross_tail.launches`` counts
the calls that launched the kernel (eager, or recorded while a CUDA graph
is captured).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks of 256 threads an SM; the kernel walks the elements grid-stride
BLOCKS_PER_SM = 8


def cross_tail_plain(x0: torch.Tensor, xw: torch.Tensor, b: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    dtype = x0.dtype
    return x0 * (xw.to(dtype) + b.to(dtype)) + x


@functools.cache
def _entry():
    fn = _build.kernels().fr_cross_tail
    fn.restype = ctypes.c_int
    # x0, xw, b, x, out, B, F, dtype, vec, grid, stream
    fn.argtypes = [*[ctypes.c_void_p] * 5, ctypes.c_int64, *[ctypes.c_int] * 4,
                   ctypes.c_void_p]
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cross_tail(x0: torch.Tensor, xw: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """x0, x [B, F] in the activation dtype (float32 or bfloat16), xw [B, F]
    float32, b [F] -> x_{l+1} [B, F] in x0's dtype."""
    B, F = x0.shape
    dtype = x0.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"cross_tail takes float32 or bfloat16 activations, got {dtype}")
    if x.shape != x0.shape or xw.shape != x0.shape or tuple(b.shape) != (F,):
        raise ValueError(f"cross_tail: x0 {tuple(x0.shape)}, xw {tuple(xw.shape)}, "
                         f"b {tuple(b.shape)}, x {tuple(x.shape)}")
    if len({t.device for t in (x0, xw, b, x)}) > 1:
        raise ValueError("cross_tail's tensors lie on more than one device")
    if x0.device.type == "cpu":
        return cross_tail_plain(x0, xw, b, x)
    if x0.device.type != "cuda":
        raise ValueError(f"no cross_tail kernel for device {x0.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xw, b, x)):
        raise ValueError("cross_tail has no backward: train with cross_tail_plain")
    x0, x, b = x0.contiguous(), x.contiguous().to(dtype), b.contiguous().to(dtype)
    xw = xw.float().contiguous()
    out = torch.empty_like(x0)
    if B == 0:
        return out
    tensors = (x0, xw, b, x, out)
    vec = dtype == torch.float32 and F % 4 == 0 and all(t.data_ptr() % 16 == 0
                                                         for t in tensors)
    steps = B * F // (4 if vec else 1)
    dev = x0.device
    grid = max(1, min(-(-steps // 256), BLOCKS_PER_SM * _sm_count(dev.index or 0)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(*[t.data_ptr() for t in tensors], B, F, _DTYPES[dtype], int(vec), grid,
                      stream)
    _build.check(rc, "cross_tail")
    cross_tail.launches += 1
    return out


cross_tail.launches = 0
