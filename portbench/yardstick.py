"""The yardstick: the card's peaks and the operations and bytes of each
layer's work, counted from a configuration's sizes and a batch's ids (never
from the program's descriptors or layout).

Peaks are the NVIDIA H100 SXM data sheet's dense rates at its 700 W limit;
a run prints the card's ``power.limit`` beside every share of them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .inputs import hot_of, id_columns

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def flops_per_query(widths: Sequence[int]) -> int:
    """2 * sum(K * N) over the tower's published (unpadded) widths."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def tower_bound_s(widths: Sequence[int], dtype: str, batch: int) -> float:
    """The least time of one tower call on ``batch`` rows: the larger of
    its FLOPs over the dtype's peak and its bytes over HBM bandwidth, the
    bytes being the weights read once, the input read once and every
    layer's output written once (the last in float32)."""
    e = DTYPE_BYTES[dtype]
    weights = sum(a * b for a, b in zip(widths[:-1], widths[1:])) * e
    acts = batch * widths[0] * e + batch * sum(widths[1:-1]) * e + batch * widths[-1] * 4
    return max(batch * flops_per_query(widths) / PEAK_FLOPS[dtype],
               (weights + acts) / HBM_BYTES_PER_S)


def feature_dtype(model: dict) -> str:
    """The dtype of the features the lookup writes: int8 tables are
    dequantized into the tower's dtype, float tables keep theirs."""
    return model["dtype"] if model["table_dtype"] == "int8" else model["table_dtype"]


def distinct_rows(ids: np.ndarray, hot: Sequence[int]) -> np.ndarray:
    """int64 [T]: the distinct ids of each table's run of ``hot[t]``
    columns of ids [B, sum(hot)]."""
    c = id_columns(hot)
    return np.asarray([np.unique(ids[:, c[t]:c[t + 1]]).size for t in range(len(hot))],
                      np.int64)


def lookup_bytes(model: dict, ids: np.ndarray) -> int:
    """The bytes one lookup of ids [B, sum(hot)] must move: the ids once
    (int32), each distinct (table, row) once (dim x the table dtype), and
    one flag a row; without a bottom tower the dense features read
    (float32) and all features written, with one the table's features
    written (the bottom tower reads the dense features and writes the
    rest)."""
    B, n_ids = ids.shape
    dims = np.asarray([t["dim"] for t in model["tables"]], dtype=np.int64)
    rows = int((distinct_rows(ids, hot_of(model)) * dims).sum())
    rows *= DTYPE_BYTES[model["table_dtype"]]
    bottom = model.get("bottom_mlp")
    dense = 0 if bottom else B * model["dense_dim"] * 4
    written = model["feature_dim"] - (bottom["widths"][-1] if bottom else 0)
    return (B * n_ids * 4 + rows + dense
            + B * written * DTYPE_BYTES[feature_dtype(model)] + B)


def cross_flops_per_query(model: dict) -> int:
    """The cross layers' FLOPs a query: 2 * F * r * 2 a low-rank layer (x U,
    then V), 2 * F^2 a full-rank one, F the feature vector's width; the
    elementwise work and the bias are not counted.  0 without the head."""
    if model.get("interaction", "none") != "cross":
        return 0
    F, r = model["feature_dim"], model.get("cross_rank", 0)
    return model["cross_layers"] * (2 * F * r * 2 if r else 2 * F * F)


def dot_flops_per_query(model: dict) -> int:
    """The DLRM dots' FLOPs a query: 2 * D a pair of the strict triangle
    over [bottom output, tables].  0 without the head."""
    if model.get("interaction", "none") != "dot":
        return 0
    n = len(model["tables"]) + (1 if model.get("bottom_mlp") else 0)
    return 2 * model["tables"][0]["dim"] * (n * (n - 1) // 2)


def step_flops_per_query(model: dict) -> int:
    """The published model's FLOPs a query: the bottom and top towers (2 *
    sum K * N), the dots and the cross layers; biases and elementwise work
    are not counted."""
    bottom = model.get("bottom_mlp")
    return (flops_per_query(model["mlp"]) + (flops_per_query(bottom["widths"]) if bottom else 0)
            + dot_flops_per_query(model) + cross_flops_per_query(model))


def cross_bound_s(model: dict, batch: int) -> float:
    """The least time of the cross layers on ``batch`` rows: the larger of
    their FLOPs over the dtype's peak and their bytes over HBM bandwidth,
    the bytes being each layer's U, V and b (or W and b) read once, x0
    read once and each layer's output written once."""
    dtype = model["dtype"]
    e = DTYPE_BYTES[dtype]
    F, r, n = model["feature_dim"], model.get("cross_rank", 0), model["cross_layers"]
    weights = n * ((2 * F * r if r else F * F) + F) * e
    acts = batch * F * e * (1 + n)
    return max(batch * cross_flops_per_query(model) / PEAK_FLOPS[dtype],
               (weights + acts) / HBM_BYTES_PER_S)
