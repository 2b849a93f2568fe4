"""Fused MLP tower: the bias-free chain ``x @ W1 @ ... @ Wn``, one kernel
launch per layer with the inter-layer activations in an L2-resident
scratch.

The port of ``fleetrec_tpu/ops/mlp_fused.py::fused_mlp``.  On a CUDA
tensor ``fused_mlp`` launches the hand-written kernels
(``ops/csrc/fused_mlp.cu``) or raises; on a CPU tensor it runs
``fused_mlp_plain``, the plain PyTorch chain with the same casts.
``fused_mlp.launches`` counts wrapper calls that launched the kernels:
one a forward, which is ``n_layers`` kernel launches on the stream.

Semantics (those of ``models/mlp.py::mlp_apply``): weights are cast to
``x.dtype``, every sum is fp32, ReLU (optional) applies on every layer but
the last, activations re-narrow to ``x.dtype`` between layers, the output
is fp32.

``mlp_plan`` decides every launch from the widths, the dtype and the
batch alone, once per (widths, dtype, batch): for each layer the kernel (a
tiled product, or a row-dot for a last layer narrower than 8) and its
block tile, and for the whole chain the zero-padded widths and the bytes
of the two ping-pong scratch buffers.  The kernels own the rest of a
launch (depth, stages, shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

# A layer's tile is the largest whose grid still gives about one block to
# each of the H100's 132 SMs.
MIN_BLOCKS = 128
_MAX_LAYERS = 8
# A last layer narrower than this is a row-dot (one warp a row), not a
# product: a 64-wide tile would leave most of its columns empty.
ROWDOT_MAX_N = 7
# Block tiles (BM, BN) in order of preference; the kernels hold the depth,
# the stages and the shared memory of each (ops/csrc/fused_mlp.cu).
TILES = ((128, 128), (64, 128), (64, 64))
_ENTRY = {torch.float32: "fr_fused_mlp_f32", torch.bfloat16: "fr_fused_mlp_bf16"}
PRODUCT, ROWDOT = 0, 1


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One launch.  ``k``: padded input width (the row stride of the input
    and the rows of the padded weight); ``n``: padded output width (the
    columns of the padded weight, and the row stride of the scratch it
    writes); ``n_store``: the columns written and the output's row stride
    (``n``, or the real width for the fp32 output of the last layer)."""
    kind: int
    bm: int
    bn: int
    k: int
    n: int
    n_store: int


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    widths: Tuple[int, ...]       # the real widths
    padded: Tuple[int, ...]       # every width rounded up to 16 bytes
    layers: Tuple[LayerPlan, ...]
    scratch_rows: Tuple[int, int]  # row width of ping-pong buffers 0 and 1
    scratch_bytes: int
    ints: Tuple[int, ...]          # the layers as the kernels take them

    @property
    def k0(self) -> int:
        return self.padded[0]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _refusal(widths: Sequence[int], dtype: torch.dtype) -> Optional[str]:
    """Why the kernels cannot take this tower, or None."""
    if dtype not in _ENTRY:
        return f"dtype {dtype} not in (float32, bfloat16)"
    if not 1 <= len(widths) - 1 <= _MAX_LAYERS:
        return f"{len(widths) - 1} layers, the kernels take 1..{_MAX_LAYERS}"
    if min(widths) < 1:
        return f"a width below 1 in {tuple(widths)}"
    return None


def _tile(B: int, n: int) -> Tuple[int, int]:
    """128 x 128 where that gives at least MIN_BLOCKS blocks, else a
    smaller BM, then a smaller BN, down to 64 x 64."""
    for bm, bn in TILES:
        if -(-B // bm) * -(-n // bn) >= MIN_BLOCKS:
            return bm, bn
    return TILES[-1]


def mlp_plan(widths: Sequence[int], dtype: torch.dtype, B: int) -> MlpPlan:
    """The launches of one ``fused_mlp`` call on a batch of ``B`` rows,
    made once per (widths, dtype, B).

    Every width is padded up to a multiple of 16 bytes (4 fp32, 8 bf16
    values): ``cp.async`` of 16 bytes and TMA's global strides need it.
    The wrapper zero-pads x and the weights to these widths, so the sums
    are those of the unpadded chain.  Raises ValueError for a tower the
    kernels do not take (more than 8 layers, a width below 1)."""
    return _plan(tuple(widths), dtype, int(B))


@functools.lru_cache(maxsize=4096)
def _plan(widths: Tuple[int, ...], dtype: torch.dtype, B: int) -> MlpPlan:
    why = _refusal(widths, dtype)
    if why is not None:
        raise ValueError(f"fused_mlp kernels cannot take widths {widths}: {why}")
    bpe = dtype.itemsize
    padded = tuple(_round_up(w, 16 // bpe) for w in widths)
    n_layers = len(widths) - 1
    layers = []
    for l in range(n_layers):
        k, last = padded[l], l == n_layers - 1
        if last and widths[-1] <= ROWDOT_MAX_N:
            layers.append(LayerPlan(ROWDOT, 0, 0, k, widths[-1], widths[-1]))
            continue
        n = padded[l + 1]
        layers.append(LayerPlan(PRODUCT, *_tile(B, n), k, n, widths[-1] if last else n))
    # layer l (not the last) writes buffer l % 2
    rows = [0, 0]
    for l in range(n_layers - 1):
        rows[l % 2] = max(rows[l % 2], padded[l + 1])
    ints = tuple(v for lp in layers for v in dataclasses.astuple(lp))
    return MlpPlan(widths, padded, tuple(layers), (rows[0], rows[1]),
                   B * (rows[0] + rows[1]) * bpe, ints)


def fused_mlp_available(widths: Sequence[int], dtype: torch.dtype) -> bool:
    """The kernels take this tower: the plan exists (1..8 layers, every
    width >= 1, float32 or bfloat16)."""
    return _refusal(widths, dtype) is None


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


def pad_operands(plan: MlpPlan, weights: Sequence[torch.Tensor],
                 x: torch.Tensor):
    """x and the weights in ``x.dtype``, contiguous, zero-padded to the
    plan's widths (a copy only where a width is not a multiple of 16
    bytes).  The zeros add nothing to any sum."""
    dtype = x.dtype
    if x.shape[1] != plan.k0:
        x = F.pad(x, (0, plan.k0 - x.shape[1]))
    ws = []
    for w, lp in zip(weights, plan.layers):
        w = w.to(dtype)
        if w.shape != (lp.k, lp.n):
            w = F.pad(w, (0, lp.n - w.shape[1], 0, lp.k - w.shape[0]))
        ws.append(w.contiguous())
    return x.contiguous(), ws


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(_build.kernels(), _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def _check_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"fused_mlp needs 16-byte aligned {what}")


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
    if not x.is_contiguous():
        raise ValueError("fused_mlp needs a contiguous x")
    B = x.shape[0]
    plan = mlp_plan(widths, x.dtype, B)
    out = torch.empty((B, widths[-1]), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    xp, ws = pad_operands(plan, weights, x)
    _check_aligned(xp, "x")
    for w in ws:
        _check_aligned(w, "weights")
    scratch = torch.empty(plan.scratch_bytes // x.element_size(), dtype=x.dtype,
                          device=x.device)
    base = scratch.data_ptr()
    bufs = (base, base + B * plan.scratch_rows[0] * x.element_size())
    n_layers = len(ws)
    # layer l writes ping-pong buffer l % 2, the last layer the scores
    outs = [bufs[l % 2] for l in range(n_layers - 1)] + [out.data_ptr()]
    vp = ctypes.c_void_p * n_layers
    args = (vp(xp.data_ptr(), *outs[:-1]), vp(*[w.data_ptr() for w in ws]), vp(*outs),
            (ctypes.c_int * len(plan.ints))(*plan.ints))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(x.dtype)(n_layers, *args, B, int(activation == "relu"), stream)
    _build.check(rc, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
