"""The traffic's inputs, drawn from ``--seed`` with numpy alone (the load
generator imports this module and nothing of torch or the program).

* ``id_pool`` / ``dense_pool``: a pool of whole batches, made before the
  window opens: ids uniform over each table's rows (the paper's senders
  draw random indices), dense features uniform in [-1, 1).  Batch j of a
  run is pool entry ``j % pool``.
* ``payloads``: each sender's bytes of one pool entry, for a wire given as
  a list of segments a sender (``("ids", c0, c1)``: the int32 ids of
  config columns [c0, c1); ``("dense",)``: the float32 dense features).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def id_pool(seed: int, rows: Sequence[int], batch: int, pool: int) -> np.ndarray:
    """int32 [pool, batch, tables]: ids uniform in [0, rows[t]) a column."""
    rng = np.random.default_rng([int(seed), 1])
    hi = np.asarray(rows, dtype=np.int64)
    return rng.integers(0, hi, size=(pool, batch, len(hi)), dtype=np.int64).astype(np.int32)


def dense_pool(seed: int, dense_dim: int, batch: int, pool: int) -> np.ndarray:
    """float32 [pool, batch, dense_dim], uniform in [-1, 1)."""
    rng = np.random.default_rng([int(seed), 2])
    return (rng.random((pool, batch, dense_dim), dtype=np.float32) * 2 - 1).astype(np.float32)


def payloads(ids: np.ndarray, dense: np.ndarray, wire: Sequence[Sequence[Sequence]]
             ) -> List[bytes]:
    """One pool entry's bytes a sender: ids [B, T] int32, dense [B, D]."""
    out = []
    for segs in wire:
        parts = []
        for seg in segs:
            if seg[0] == "ids":
                parts.append(np.ascontiguousarray(ids[:, seg[1]:seg[2]]).tobytes())
            elif seg[0] == "dense":
                parts.append(np.ascontiguousarray(dense, dtype=np.float32).tobytes())
            else:
                raise ValueError(f"unknown wire segment {seg!r}")
        out.append(b"".join(parts))
    return out
