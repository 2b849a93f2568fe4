"""The plain reference: a configuration's scores in plain PyTorch, from the
harness's own inputs (``tables.py``'s values, ``inputs.py``'s ids and
dense features, ``tables.tower_weights``), imports nothing of the program.

``features`` builds the concatenated feature vector as the configuration
states it: table t's row at its ``out_offset``, int8 tables dequantized
with their scale, float tables as stored, the dense features at the tail
(rounded to the feature dtype).  ``tower`` runs the bias-free chain in
float64 on weights as served; a bfloat16 tower re-narrows its activations
to bfloat16 between layers, as the configuration's compute dtype says.
``tower_control`` is the same chain one precision below the configuration
(float32 -> TF32 operands, bfloat16 -> fp8 e4m3 operands with a scale a
tensor), with float32 sums: the control that the comparison must fail.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import tables as tb
from .yardstick import feature_dtype

FP8_MAX = 448.0


def _dim_groups(model: dict) -> Dict[int, np.ndarray]:
    """Config columns of each table dim."""
    dims = np.asarray([t["dim"] for t in model["tables"]])
    return {int(d): np.flatnonzero(dims == d) for d in np.unique(dims)}


def features(model: dict, key: int, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """float64 [B, feature_dim]: the features of ids [B, T] (int64) and
    dense [B, dense_dim] (float32), holding exactly the values the
    configuration stores."""
    B, F, D = ids.shape[0], model["feature_dim"], model["dense_dim"]
    dev = ids.device
    out = torch.zeros((B, F), dtype=torch.float64, device=dev)
    storage = model["table_dtype"]
    offsets = np.asarray([t["out_offset"] for t in model["tables"]])
    for d, cols in _dim_groups(model).items():
        tid = torch.as_tensor(cols, dtype=torch.int64, device=dev)
        q = tb.codes(tb.row_hash(key, tid[None, :], ids[:, tid]), d).double()
        if storage == "int8":
            scale = torch.tensor([tb.table_scale(key, int(t)) for t in cols],
                                 dtype=torch.float32, device=dev).double()
            v = q * scale[None, :, None]
        else:
            v = q * tb.FLOAT_STEP
        pos = torch.as_tensor(offsets[cols][:, None] + np.arange(d)[None, :], device=dev)
        out[:, pos.reshape(-1)] = v.reshape(B, -1)
    if D:
        x = dense.to(tb.STORAGE_DTYPES[feature_dtype(model)])
        out[:, F - D:] = x.double()
    return out


def tower(model: dict, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """float64 scores [B] of features x [B, F] (float64) through
    ``weights`` as served, at the configuration's precision."""
    narrow = model["dtype"] == "bfloat16"
    h = x.double()
    for i, w in enumerate(weights):
        h = h @ w.double()
        if i < len(weights) - 1:
            if model.get("activation") == "relu":
                h = h.clamp_min(0)
            if narrow:
                h = h.to(torch.bfloat16).double()
    return h[:, 0]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties to
    even)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` through fp8 e4m3 with one scale for the tensor."""
    x = x.float()
    s = x.abs().max().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def tower_control(model: dict, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tower one precision below the configuration's: every operand
    of every product rounded (float32 tower: to TF32; bfloat16 tower: to
    fp8 e4m3), sums in float32.  float64 scores [B]."""
    rnd = _round_tf32 if model["dtype"] == "float32" else _round_fp8
    h = x.float()
    for i, w in enumerate(weights):
        h = (rnd(h).double() @ rnd(w).double()).float()
        if i < len(weights) - 1 and model.get("activation") == "relu":
            h = h.clamp_min(0)
    return h[:, 0].double()


def pool_scores(model: dict, key: int, ids: np.ndarray, dense: np.ndarray,
                weights: List[torch.Tensor], control: bool = False, block: int = 4
                ) -> np.ndarray:
    """float64 [P, B]: the reference's (or the control's) scores of every
    pool entry, ``block`` entries at a time."""
    dev = weights[0].device
    fn = tower_control if control else tower
    out = []
    for p0 in range(0, ids.shape[0], block):
        i = torch.from_numpy(ids[p0:p0 + block].astype(np.int64)).to(dev)
        d = torch.from_numpy(dense[p0:p0 + block]).to(dev)
        n, B = i.shape[:2]
        x = features(model, key, i.reshape(n * B, -1), d.reshape(n * B, -1))
        out.append(fn(model, x, weights).reshape(n, B).cpu().numpy())
    return np.concatenate(out)


def max_err(got: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of scores got [n, B] from ref [n, B], each batch's
    gaps over the root mean square of its reference scores; a score that
    is not finite reads inf."""
    got = np.asarray(got, dtype=np.float64)
    if got.size == 0:
        return 0.0
    if not np.isfinite(got).all():
        return float("inf")
    rms = np.sqrt((ref ** 2).mean(axis=1, keepdims=True))
    return float((np.abs(got - ref) / rms).max())
