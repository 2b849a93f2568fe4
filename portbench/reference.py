"""The plain reference: a configuration's scores in plain PyTorch, from the
harness's own inputs (``tables.py``'s values, ``inputs.py``'s ids and
dense features, ``tables.head_weights``), imports nothing of the program.

It follows the published model that the configuration states, not the
program: where the two part, the comparison decides.

``features`` builds the concatenated feature vector as the configuration
states it: table t's bag (its ``hot`` ids, one without the key) summed at
its ``out_offset`` from the stored values (int8 codes times their scale,
float codes as stored) in float64 and rounded to the feature dtype, and the
raw dense features (rounded to the feature dtype) in the dense columns
(``dense_columns``) when no bottom tower takes them.  ``head`` runs the
rest in float64 at the configuration's precision: the bottom tower on the
dense features, its output in the dense columns; then the DLRM dots over
[bottom output, tables in config order] (the strict lower triangle, row
major; the top tower's input is [bottom output, dots]), or the DCNv2 cross
layers x_{l+1} = x0 * (x_l U_l V_l + b_l) + x_l over the feature vector,
or nothing; then the top tower.  Towers apply their activation between
layers (the bottom tower also after its last layer where
``last_activation`` says so) and add a bias a layer where ``bias`` says so.
A bfloat16 configuration re-narrows to bfloat16 where the program's towers,
dots and cross layers cast: the top tower's input and its activations
between layers, the bottom tower's output, the dots, and in each cross
layer x_l U V, the sum with b, the product with x0 and the sum with x_l.

The control (``control=True``) is the same head one precision below the
configuration: every operand of every product (towers, dots, cross layers)
rounded (float32 -> TF32, bfloat16 -> fp8 e4m3 with a scale a tensor), sums
and everything else in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import inputs
from . import tables as tb
from .yardstick import feature_dtype

FP8_MAX = 448.0


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


class Exact:
    """The configuration's precision: float64, re-narrowed to bfloat16 at
    the program's cast points for a bfloat16 configuration."""

    def __init__(self, model: dict):
        self.bf16 = model["dtype"] == "bfloat16"

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor entering the head or a tower in the compute dtype."""
        return self.narrow(x.double()) if self.bf16 else x.double()

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a @ w.double()

    def narrow(self, h: torch.Tensor) -> torch.Tensor:
        return h.to(torch.bfloat16).double() if self.bf16 else h

    def param(self, w: torch.Tensor) -> torch.Tensor:
        return w.double()


class Control:
    """One precision below the configuration: product operands rounded
    (TF32 for float32, fp8 e4m3 for bfloat16), float32 sums."""

    def __init__(self, model: dict):
        self.rnd = _round_tf32 if model["dtype"] == "float32" else _round_fp8

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x.float()

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (self.rnd(a).double() @ self.rnd(w).double()).float()

    def narrow(self, h: torch.Tensor) -> torch.Tensor:
        return h

    def param(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()


def dense_columns(model: dict) -> np.ndarray:
    """The feature vector's columns of the dense part (the bottom tower's
    output, or the raw dense features without one): the tail where no
    table covers it, else from the first column no table covers.  Raises
    where they would overlap a table or run past the vector."""
    F = model["feature_dim"]
    bottom = model.get("bottom_mlp")
    W = bottom["widths"][-1] if bottom else model["dense_dim"]
    covered = np.zeros(F, bool)
    for t in model["tables"]:
        covered[t["out_offset"]:t["out_offset"] + t["dim"]] = True
    if not W:
        return np.zeros(0, np.int64)
    start = F - W if not covered[F - W:].any() else int(np.flatnonzero(~covered)[0])
    cols = np.arange(start, start + W)
    if start + W > F or covered[cols].any():
        raise ValueError(f"the dense part ({W} columns) has no room among the {F} "
                         f"features that no table covers")
    return cols


def features(model: dict, key: int, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """float64 [B, feature_dim]: the features of ids [B, sum(hot)] (int64,
    ``inputs.py``'s layout) and dense [B, dense_dim] (float32), holding
    exactly the values the configuration's lookup writes; the dense columns
    stay zero where a bottom tower fills them (``head``)."""
    B, F = ids.shape[0], model["feature_dim"]
    dev = ids.device
    out = torch.zeros((B, F), dtype=torch.float64, device=dev)
    storage = model["table_dtype"]
    fdtype = tb.STORAGE_DTYPES[feature_dtype(model)]
    hot = inputs.hot_of(model)
    c0 = inputs.id_columns(hot)
    groups: Dict[tuple, List[int]] = {}
    for t, spec in enumerate(model["tables"]):
        groups.setdefault((spec["dim"], hot[t]), []).append(t)
    for (d, h), tids in groups.items():
        tid = torch.as_tensor(tids, dtype=torch.int64, device=dev)
        cols = torch.as_tensor(c0[tids][:, None] + np.arange(h)[None, :], device=dev)
        q = tb.codes(tb.row_hash(key, tid[None, :, None], ids[:, cols]), d).double()
        if storage == "int8":
            scale = torch.tensor([tb.table_scale(key, t) for t in tids],
                                 dtype=torch.float32, device=dev).double()
            v = q * scale[None, :, None, None]
        else:
            v = q * tb.FLOAT_STEP
        v = v.sum(dim=2).to(fdtype).double()
        pos = torch.as_tensor(np.asarray([model["tables"][t]["out_offset"] for t in tids])[:, None]
                              + np.arange(d)[None, :], device=dev)
        out[:, pos.reshape(-1)] = v.reshape(B, -1)
    if model["dense_dim"] and not model.get("bottom_mlp"):
        x = dense.to(fdtype)
        out[:, torch.as_tensor(dense_columns(model), device=dev)] = x.double()
    return out


def _tower(p, x: torch.Tensor, weights: Sequence[torch.Tensor], activation: Optional[str],
           biases: Sequence[torch.Tensor] = (), last_activation: bool = False) -> torch.Tensor:
    """A tower on x entered in the compute dtype: each layer's product,
    its bias, its activation (every layer but the last, and the last where
    ``last_activation``), re-narrowed between layers."""
    h = x
    for i, w in enumerate(weights):
        h = p.mm(h, w)
        if biases:
            h = h + p.param(biases[i])
        last = i == len(weights) - 1
        if activation == "relu" and (not last or last_activation):
            h = h.clamp_min(0)
        if not last:
            h = p.narrow(h)
    return h


def tower(model: dict, x: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """float64 scores [B] of the top tower on x [B, F] (float64) through
    ``weights`` as served, at the configuration's precision."""
    p = Exact(model)
    return _tower(p, p.enter(x), weights, model.get("activation"), biases)[:, 0]


def cross(p, x0: torch.Tensor, layers: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """The cross layers on x0 entered in the compute dtype."""
    x = x0
    for layer in layers:
        *mats, b = layer
        xw = x
        for m in mats:
            xw = p.mm(xw, m)
        x = p.narrow(p.narrow(x0 * p.narrow(p.narrow(xw) + p.param(b))) + x)
    return x


def dots(p, vecs: torch.Tensor) -> torch.Tensor:
    """[B, n, D] -> [B, n * (n - 1) / 2]: <v_i, v_j> for i > j, row major."""
    n = vecs.shape[1]
    li, lj = np.tril_indices(n, -1)
    gram = p.mm(vecs, vecs.transpose(1, 2).contiguous())
    return p.narrow(gram.reshape(vecs.shape[0], n * n)[:, torch.as_tensor(li * n + lj)])


def head(model: dict, x: torch.Tensor, dense: torch.Tensor, weights: Dict[str, list],
         control: bool = False) -> torch.Tensor:
    """float64 scores [B] of the features x [B, F] (``features``) and the
    raw dense features [B, dense_dim] (float32) through the configuration's
    head and ``tables.head_weights``, at its precision or the control's."""
    p = Control(model) if control else Exact(model)
    interaction = model.get("interaction", "none")
    x = x.clone()
    cols = torch.as_tensor(dense_columns(model), device=x.device)
    bottom = model.get("bottom_mlp")
    if bottom:
        d = p.enter(dense.to(tb.STORAGE_DTYPES[model["dtype"]]))
        b = _tower(p, d, weights["bottom"], bottom.get("activation"), weights["bottom_bias"],
                   bool(bottom.get("last_activation")))
        x[:, cols] = p.narrow(b).to(x.dtype)
    x = p.enter(x)
    if interaction == "dot":
        if model["dense_dim"] and not bottom:
            raise ValueError("a dot head takes its dense features through a bottom tower")
        D = model["tables"][0]["dim"]
        vecs = [x[:, cols]] if bottom else []
        vecs += [x[:, t["out_offset"]:t["out_offset"] + D] for t in model["tables"]]
        z = dots(p, torch.stack(vecs, dim=1))
        x = torch.cat(([x[:, cols]] if bottom else []) + [z], dim=1)
    elif interaction == "cross":
        x = cross(p, x, weights["cross"])
    elif interaction != "none":
        raise ValueError(f"interaction {interaction!r} not in none / dot / cross")
    s = _tower(p, x, weights["mlp"], model.get("activation"), weights["mlp_bias"])
    return s[:, 0].double()


def pool_scores(model: dict, key: int, ids: np.ndarray, dense: np.ndarray,
                weights: Dict[str, list], control: bool = False, block: int = 4
                ) -> np.ndarray:
    """float64 [P, B]: the reference's (or the control's) scores of every
    pool entry, ``block`` entries at a time."""
    dev = weights["mlp"][0].device
    out = []
    for p0 in range(0, ids.shape[0], block):
        i = torch.from_numpy(ids[p0:p0 + block].astype(np.int64)).to(dev)
        d = torch.from_numpy(dense[p0:p0 + block]).to(dev)
        n, B = i.shape[:2]
        d = d.reshape(n * B, -1)
        x = features(model, key, i.reshape(n * B, -1), d)
        out.append(head(model, x, d, weights, control).reshape(n, B).cpu().numpy())
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
