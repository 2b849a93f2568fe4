"""The yardstick: the card's peaks and the operations and bytes of each
layer's work, counted from a configuration's sizes and a batch's ids (never
from the program's descriptors or layout).

Peaks are the NVIDIA H100 SXM data sheet's dense rates at its 700 W limit;
a run prints the card's ``power.limit`` beside every share of them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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


def distinct_rows(ids: np.ndarray) -> np.ndarray:
    """int64 [T]: the distinct ids of each column of ids [B, T]."""
    s = np.sort(ids, axis=0)
    return 1 + (np.diff(s, axis=0) != 0).sum(axis=0)


def lookup_bytes(model: dict, ids: np.ndarray) -> int:
    """The bytes one lookup of ids [B, T] must move: the ids once (int32),
    each distinct (table, row) once (dim x the table dtype), the dense
    features read (float32), the features written and one flag a row."""
    B, T = ids.shape
    dims = np.asarray([t["dim"] for t in model["tables"]], dtype=np.int64)
    rows = int((distinct_rows(ids) * dims).sum()) * DTYPE_BYTES[model["table_dtype"]]
    return (B * T * 4 + rows + B * model["dense_dim"] * 4
            + B * model["feature_dim"] * DTYPE_BYTES[feature_dtype(model)] + B)
