"""Multi-sender index-mode wire format (the port's copy of
``fleetrec_tpu/serving/wire.py``) — the reference's 3-node serving
topology (one GPU server assembling 64 + 1952 + 1952 floats per query from
a CPU node and two FPGA nodes at fixed offsets,
GPU/final_network_cublasLt_3_nodes_no_FIFO_scatter/cuda_server.c:362-488,
constant.h:25-27) carried over to the engine's index mode: the
embedding-shard nodes ship int32 row-ids for THEIR table subset (what the
FPGAs look up locally in the reference) and the CPU node ships the dense
float slice; the server assembles the full index matrix at fixed slot
offsets and runs the lookup+concat+MLP on the device.

Sender 0 is the dense sender (the CPU0 analog — the reference places its
slice first in the receive buffer, cuda_server.c:515); senders 1..N ship
contiguous config-order table ranges (model3 with 3 senders = 188 + 188
tables, the two embedding_377_krnl FPGA shards).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class IndexWireFormat:
    """Static per-batch wire layout for N senders in index mode."""

    batch_size: int
    table_splits: Tuple[int, ...]  # tables per index sender, config order
    dense_dim: int = 0

    @classmethod
    def plan(cls, cfg, batch_size: int, n_senders: int) -> "IndexWireFormat":
        """Split cfg's tables evenly over the index senders (first sender
        is the dense node when cfg.dense_dim > 0).  model3 with 3 senders
        -> dense + 188 + 188 tables, the reference geometry."""
        n_idx = n_senders - 1 if cfg.dense_dim else n_senders
        if not (1 <= n_idx <= cfg.num_tables):
            raise ValueError(
                f"{n_senders} senders over {cfg.num_tables} tables "
                f"(dense_dim={cfg.dense_dim}) is not a valid split"
            )
        base, rem = divmod(cfg.num_tables, n_idx)
        splits = tuple(base + (1 if i < rem else 0) for i in range(n_idx))
        return cls(batch_size=batch_size, table_splits=splits,
                   dense_dim=cfg.dense_dim)

    @property
    def n_senders(self) -> int:
        return len(self.table_splits) + (1 if self.dense_dim else 0)

    @property
    def num_tables(self) -> int:
        return sum(self.table_splits)

    def bytes_per_sender(self) -> List[int]:
        out = []
        if self.dense_dim:
            out.append(self.batch_size * self.dense_dim * 4)
        out.extend(self.batch_size * t * 4 for t in self.table_splits)
        return out

    def parse(self, view: np.ndarray):
        """Slot float32 view -> (indices [B, T] int32, dense [B, D] or
        None).  Copies out of the ring slot (the view dies at release)."""
        B = self.batch_size
        off = 0
        dense = None
        if self.dense_dim:
            n = B * self.dense_dim
            dense = view[:n].reshape(B, self.dense_dim).copy()
            off = n
        parts = []
        for t in self.table_splits:
            n = B * t
            parts.append(view[off : off + n].view(np.int32).reshape(B, t))
            off += n
        idx = (np.concatenate(parts, axis=1) if len(parts) > 1
               else parts[0].copy())
        return idx, dense

    def payloads(self, idx: np.ndarray, dense: Optional[np.ndarray] = None
                 ) -> List[bytes]:
        """Inverse of parse: the per-sender byte payloads for one batch
        (what each node puts on its wire) — loadgen/test side."""
        out = []
        if self.dense_dim:
            assert dense is not None and dense.shape == (self.batch_size, self.dense_dim)
            out.append(np.ascontiguousarray(dense, dtype=np.float32).tobytes())
        c = 0
        for t in self.table_splits:
            out.append(np.ascontiguousarray(idx[:, c : c + t], dtype=np.int32).tobytes())
            c += t
        return out
