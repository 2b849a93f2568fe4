"""The traffic's inputs, drawn from ``--seed`` with numpy alone (the load
generator imports this module and nothing of torch or the program).

* ``id_pool`` / ``dense_pool``: a pool of whole batches, made before the
  window opens: ids uniform over each table's rows (the paper's senders
  draw random indices), dense features uniform in [-1, 1).  Batch j of a
  run is pool entry ``j % pool``.  A query's ids are each table's ``hot``
  ids (its bag; one without the key) in one contiguous run, tables in
  config order: ``[B, sum(hot)]`` columns, the ``[B, T]`` of single ids.
* ``payloads``: each sender's bytes of one pool entry, for a wire given as
  a list of segments a sender (``("ids", c0, c1)``: the int32 ids of
  id columns [c0, c1); ``("dense",)``: the float32 dense features).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def hot_of(model: dict) -> List[int]:
    """The members of each table's bag (``hot``, 1 without the key)."""
    hot = [int(t.get("hot", 1)) for t in model["tables"]]
    if min(hot) < 1:
        raise ValueError(f"a table's hot must be >= 1, got {hot}")
    return hot


def id_columns(hot: Sequence[int]) -> np.ndarray:
    """int64 [T + 1]: table t's ids are columns [c[t], c[t + 1])."""
    return np.concatenate([[0], np.cumsum(hot)]).astype(np.int64)


def id_pool(seed: int, rows: Sequence[int], batch: int, pool: int,
            hot: Optional[Sequence[int]] = None) -> np.ndarray:
    """int32 [pool, batch, sum(hot)]: each table's ``hot[t]`` ids (one
    each without ``hot``) uniform in [0, rows[t])."""
    rng = np.random.default_rng([int(seed), 1])
    hi = np.asarray(rows, dtype=np.int64)
    if hot is not None:
        hi = np.repeat(hi, hot)
    return rng.integers(0, hi, size=(pool, batch, len(hi)), dtype=np.int64).astype(np.int32)


def dense_pool(seed: int, dense_dim: int, batch: int, pool: int) -> np.ndarray:
    """float32 [pool, batch, dense_dim], uniform in [-1, 1)."""
    rng = np.random.default_rng([int(seed), 2])
    return (rng.random((pool, batch, dense_dim), dtype=np.float32) * 2 - 1).astype(np.float32)


def pools(seed: int, model: dict, batch: int, pool: int) -> Tuple[np.ndarray, np.ndarray]:
    """``id_pool`` and ``dense_pool`` of a configuration's ``model`` block."""
    return (id_pool(seed, [t["rows"] for t in model["tables"]], batch, pool, hot_of(model)),
            dense_pool(seed, model["dense_dim"], batch, pool))


def payloads(ids: np.ndarray, dense: np.ndarray, wire: Sequence[Sequence[Sequence]]
             ) -> List[bytes]:
    """One pool entry's bytes a sender: ids [B, sum(hot)] int32, dense
    [B, D]."""
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
