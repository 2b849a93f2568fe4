"""CPU/numpy golden model — the parity oracle (the port's copy of
``fleetrec_tpu/reference.py``, held equal to it by tests/test_torch_config.py).

The reference verifies correctness by construction with deterministic data:
embedding tables where even rows are +1.0 and odd rows are -1.0
(FPGA/host/embedding_krnl/host.cpp:282-718), all-ones MLP weights and
all-ones sender payloads giving closed-form scores
(GPU/final_network_cublasLt_1_node_no_FIFO_scatter/README.md:7-11,
width 512 -> 68719476736, width 1024 -> 137438953472).  This module turns
that convention into an executable oracle: numpy float64 forward pass used
by the pytest suite and chip_smoke.py to check the engine bit-for-bit on the integer-
valued parity configurations and to tight tolerance elsewhere.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import ModelConfig, TableSpec


def init_table(t: TableSpec, scheme: str = "pm1", seed: int = 0) -> np.ndarray:
    """Materialize one table as [rows, dim] float32.

    scheme:
      "pm1"    — even rows +1.0, odd rows -1.0 (host.cpp:287-305 convention)
      "plram"  — even rows +1.0, odd rows 0.0 (kernel-side PLRAM init,
                 embedding_krnl.cpp:963-987)
      "rowid"  — value = (row * dim + col) scaled; unique per element, for
                 catching index/offset permutation bugs exactly
      "uniform"— seeded uniform [-1, 1)
    """
    if scheme == "pm1":
        col = np.where(np.arange(t.rows) % 2 == 0, 1.0, -1.0).astype(np.float32)
        return np.broadcast_to(col[:, None], (t.rows, t.dim)).copy()
    if scheme == "plram":
        col = np.where(np.arange(t.rows) % 2 == 0, 1.0, 0.0).astype(np.float32)
        return np.broadcast_to(col[:, None], (t.rows, t.dim)).copy()
    if scheme == "rowid":
        base = np.arange(t.rows, dtype=np.float32)[:, None] + t.table_id * 1000.0
        off = np.arange(t.dim, dtype=np.float32)[None, :] / 64.0
        return base + off
    if scheme == "uniform":
        rng = np.random.default_rng(seed * 7919 + t.table_id)
        return rng.uniform(-1.0, 1.0, size=(t.rows, t.dim)).astype(np.float32)
    raise ValueError(scheme)


def init_tables(cfg: ModelConfig, scheme: str = "pm1", seed: int = 0) -> List[np.ndarray]:
    return [init_table(t, scheme, seed) for t in cfg.tables]


def init_mlp_weights(cfg: ModelConfig, scheme: str = "ones", seed: int = 0) -> List[np.ndarray]:
    """Weight matrices [in, out] for the matmul chain (cuda_server.c:154-161
    initializes all weights to 1.0)."""
    ws = []
    widths = cfg.mlp.widths
    for li, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        if scheme == "ones":
            ws.append(np.ones((a, b), dtype=np.float32))
        elif scheme == "uniform":
            rng = np.random.default_rng(seed * 104729 + li)
            ws.append((rng.uniform(-1.0, 1.0, size=(a, b)) / np.sqrt(a)).astype(np.float32))
        else:
            raise ValueError(scheme)
    return ws


def gather_concat(
    cfg: ModelConfig,
    tables: Sequence[np.ndarray],
    indices: np.ndarray,
    dense: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Reference lookup + fixed-offset concatenation.

    indices: [B, num_tables] int; dense: [B, dense_dim] or None.
    Returns [B, feature_dim] float32 with each table's row at its
    out_offset (the VECTOR_START_IDX layout) and the dense slice at the
    tail (cuda_server.c:514-587 places CPU0 first; we standardize on the
    tail — layout is config-owned, parity checks use the same layout on
    both sides).  Unused positions (e.g. model2's 876->880 pad) stay zero.
    """
    B = indices.shape[0]
    out = np.zeros((B, cfg.feature_dim), dtype=np.float32)
    for j, t in enumerate(cfg.tables):
        rows = tables[j][indices[:, j]]
        out[:, t.out_offset : t.out_offset + t.dim] = rows
    if cfg.dense_dim:
        assert dense is not None and dense.shape == (B, cfg.dense_dim)
        out[:, cfg.feature_dim - cfg.dense_dim :] = dense
    return out


def mlp_chain(features: np.ndarray, weights: Sequence[np.ndarray],
              activation: Optional[str] = None, dtype=np.float64) -> np.ndarray:
    """Bias-free matmul chain in float64 (oracle precision)."""
    x = features.astype(dtype)
    for i, w in enumerate(weights):
        x = x @ w.astype(dtype)
        if activation == "relu" and i < len(weights) - 1:
            x = np.maximum(x, 0.0)
    return x


def init_bottom_weights(cfg: ModelConfig, scheme: str = "ones", seed: int = 0) -> List[np.ndarray]:
    """Bottom-MLP weights for dot-interaction configs; seeded to match
    models.init_model (which uses seed+1 for the bottom tower)."""
    assert cfg.bottom_mlp is not None
    ws = []
    widths = cfg.bottom_mlp.widths
    for li, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        if scheme == "ones":
            ws.append(np.ones((a, b), dtype=np.float32))
        elif scheme == "uniform":
            rng = np.random.default_rng((seed + 1) * 104729 + li)
            ws.append((rng.uniform(-1.0, 1.0, size=(a, b)) / np.sqrt(a)).astype(np.float32))
        else:
            raise ValueError(scheme)
    return ws


def init_cross_weights(cfg: ModelConfig, scheme: str = "ones", seed: int = 0) -> List[List[np.ndarray]]:
    """DCNv2 cross-layer weights, seeded in the (seed+2) namespace (cf. the
    bottom tower's seed+1) to match models.interaction.init_cross_params:
    per layer [W [F,F], b [F]] full-rank or [U [F,r], V [r,F], b [F]]."""
    assert cfg.interaction == "cross"
    F, r = cfg.feature_dim, cfg.cross_rank
    layers: List[List[np.ndarray]] = []
    for li in range(cfg.cross_layers):
        if scheme == "ones":
            mats = ([np.ones((F, F), np.float32)] if r == 0 else
                    [np.ones((F, r), np.float32), np.ones((r, F), np.float32)])
        elif scheme == "uniform":
            rng = np.random.default_rng((seed + 2) * 104729 + li)
            if r == 0:
                mats = [(rng.uniform(-1, 1, (F, F)) / np.sqrt(F)).astype(np.float32)]
            else:
                mats = [
                    (rng.uniform(-1, 1, (F, r)) / np.sqrt(F)).astype(np.float32),
                    (rng.uniform(-1, 1, (r, F)) / np.sqrt(r)).astype(np.float32),
                ]
        else:
            raise ValueError(scheme)
        layers.append(mats + [np.zeros((F,), np.float32)])
    return layers


def cross_network_np(x0: np.ndarray, layers: Sequence[Sequence[np.ndarray]],
                     dtype=np.float64) -> np.ndarray:
    """DCNv2 oracle: x_{l+1} = x0 * (x_l W_l + b_l) + x_l in float64 —
    must match models.interaction.cross_network."""
    x0 = x0.astype(dtype)
    x = x0
    for lp in layers:
        *mats, b = lp
        xw = x
        for m in mats:
            xw = xw @ m.astype(dtype)
        x = x0 * (xw + b.astype(dtype)) + x
    return x


def dot_interaction_np(vecs: np.ndarray) -> np.ndarray:
    """[B, n, D] -> [B, n*(n-1)//2] strict-lower-triangle pairwise dots,
    row-major (i>j) order — must match models.interaction.dot_interaction."""
    gram = np.einsum("bnd,bmd->bnm", vecs, vecs)
    li, lj = np.tril_indices(vecs.shape[1], k=-1)
    return gram[:, li, lj]


def forward(
    cfg: ModelConfig,
    tables: Sequence[np.ndarray],
    weights: Sequence[np.ndarray],
    indices: np.ndarray,
    dense: Optional[np.ndarray] = None,
    bottom_weights: Optional[Sequence[np.ndarray]] = None,
    cross_weights: Optional[Sequence[Sequence[np.ndarray]]] = None,
) -> np.ndarray:
    if cfg.interaction == "dot":
        B = indices.shape[0]
        D = cfg.tables[0].dim
        emb = np.zeros((B, cfg.num_tables, D), dtype=np.float64)
        order = sorted(range(cfg.num_tables), key=lambda j: cfg.tables[j].out_offset)
        for pos, j in enumerate(order):
            emb[:, pos] = tables[j][indices[:, j]]
        vecs = emb
        bottom = None
        if cfg.bottom_mlp is not None:
            assert bottom_weights is not None and dense is not None
            bottom = mlp_chain(dense, bottom_weights, cfg.bottom_mlp.activation)
            vecs = np.concatenate([bottom[:, None, :], emb], axis=1)
        z = dot_interaction_np(vecs)
        if bottom is not None:
            z = np.concatenate([bottom, z], axis=1)
        return mlp_chain(z, weights, cfg.mlp.activation)[:, 0]
    feats = gather_concat(cfg, tables, indices, dense)
    if cfg.interaction == "cross":
        assert cross_weights is not None
        feats = cross_network_np(feats, cross_weights)
    return mlp_chain(feats, weights, cfg.mlp.activation)[:, 0]


def closed_form_all_ones_score(input_width: int, hidden=(1024, 512, 256)) -> float:
    """All-ones input through all-ones bias-free chain: score =
    input_width * prod(hidden).  512 -> 68719476736, 1024 -> 137438953472
    (reference README parity constants)."""
    s = float(input_width)
    for h in hidden:
        s *= h
    return s
