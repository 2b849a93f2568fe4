"""The device mesh, the port of ``fleetrec_tpu/parallel/mesh.py``.

The JAX package's ``Mesh`` has two axes, "data" (batch replicas) and
"model" (table shards), over the devices one program drives.  In the port a
rank is one process holding one model shard on one device, so the mesh is a
description of this rank's place in a ``torch.distributed`` world of
``data * model`` ranks: rank ``r`` sits at ``(d, m) = divmod(r, model)``,
the M ranks of one data row share a process group (the "model" axis, over
which the sharded forward's one exchange runs), and each data row scores its
own rows of the batch.  The D ranks of one model column (the same shard of
every data row) share a second group, over which the sharded training step
sums its gradients and losses (the "data" axis).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data=D, model=M) mesh: its coordinates, the
    process group of its data row's M model ranks (None in a world of no
    process group: one rank, nothing to exchange), its device, and the
    process group of its model column's D ranks (None when D = 1: nothing
    to sum over the data axis)."""

    data: int
    model: int
    d: int
    m: int
    group: Optional[object]
    device: torch.device
    col_group: Optional[object] = None

    @property
    def rank(self) -> int:
        return self.d * self.model + self.m

    @property
    def leader(self) -> int:
        """The global rank of this data row's model rank 0: it holds the
        row's batch and returns its scores."""
        return self.d * self.model

    @property
    def is_leader(self) -> bool:
        return self.m == 0


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:<local rank % cards>`` for "cuda"
    (torchrun's LOCAL_RANK, else the rank), so that ranks beyond the cards
    of a host share them round-robin; ``device`` as it is otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: this host has no CUDA device (pass "
                           f"device='cpu' to run on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """This rank's mesh over the initialized ``torch.distributed`` world of
    ``data * model`` ranks (``multihost.init_distributed``), or, with no
    process group, a mesh of one rank.  Every rank must call it, in the same
    order as every other ``new_group``: it makes one process group a data
    row, then (D > 1) one a model column, every rank every group in that
    order, as NCCL and gloo both need."""
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): both axes must be >= 1")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"mesh ({data}, {model}) needs a world of {n} ranks: "
                             f"initialize torch.distributed first (init_distributed)")
        return Mesh(1, 1, 0, 0, None, rank_device(device, 0))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"mesh ({data}, {model}) needs {n} ranks, the world has {world} "
                         f"(one device a rank)")
    d, m = divmod(rank, model)
    group = col_group = None
    for row in range(data):
        g = dist.new_group(ranks=list(range(row * model, (row + 1) * model)))
        if row == d:
            group = g
    if data > 1:
        for col in range(model):
            g = dist.new_group(ranks=list(range(col, n, model)))
            if col == m:
                col_group = g
    return Mesh(data, model, d, m, group, rank_device(device, rank), col_group)


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh(1, 1, device)
