"""Multi-process bring-up, the port of ``fleetrec_tpu/parallel/multihost.py``.

The JAX package runs one program on every host over ``jax.distributed`` and
a global mesh whose arrays span the hosts.  Here every rank is a process
with one device, joined by ``torch.distributed``:

* ``init_distributed`` joins the world (torchrun's ``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` where the JAX package reads
  ``JAX_*``), with the backend the caller names: ``nccl`` for CUDA when
  every rank has a card of its own, ``gloo`` otherwise (CPU tensors, or CUDA
  tensors staged through host memory, as when several ranks share a card);
* ``global_mesh`` is this rank's ``(data, model)`` mesh;
* ``host_local_batch_to_global``: a data row's model-rank 0 (its leader)
  holds the row's batch and broadcasts it to the row's ranks, where JAX
  replicates the batch over the model axis with ``device_put``;
* ``global_scores_to_host_local``: the leader alone returns the row's
  scores.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, rank_device

# how long a collective may wait for a peer before the process group gives up
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, ranks_here: int) -> None:
    """Raise when ``backend`` cannot carry ``ranks_here`` ranks of this host
    on ``device``: NCCL takes CUDA tensors only and refuses two ranks on one
    card."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend != "nccl":
        return
    dev = torch.device(device)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.type != "cuda" or ranks_here > cards:
        raise ValueError(
            f"backend nccl with {ranks_here} ranks on this host on device {str(device)!r} "
            f"and {cards} CUDA devices: NCCL needs a card of its own for each rank and "
            f"refuses two ranks on one device; pass --backend gloo (it stages CUDA "
            f"tensors through host memory)")


def bind_device(device, rank: int) -> None:
    """Make ``rank``'s card (``rank_device``) the current CUDA device; a
    CPU device binds nothing."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, rank))


def init_method(coordinator_address: Optional[str]) -> str:
    """A ``host:port`` address, or a URL (``tcp://``, ``file://``) as it is;
    None reads MASTER_ADDR / MASTER_PORT."""
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            raise ValueError("no coordinator address: pass one or set MASTER_ADDR and "
                             "MASTER_PORT")
        return "env://"
    return coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the ``torch.distributed`` world from the arguments or torchrun's
    environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).  No-op for one
    process.  ``backend`` None is ``nccl`` for a CUDA device and ``gloo``
    for the CPU; nccl with more ranks on this host (LOCAL_WORLD_SIZE, else
    all of them) than cards raises.  On a CUDA device the rank's card
    (``mesh.rank_device``) becomes the current device before the process
    group is made, so NCCL's communicators sit on it."""
    num = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if num <= 1:
        return
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    backend = backend or default_backend(device)
    check_backend(backend, device, int(os.environ.get("LOCAL_WORLD_SIZE", num)))
    bind_device(device, rank)
    dist.init_process_group(backend, init_method=init_method(coordinator_address),
                            world_size=num, rank=rank, timeout=TIMEOUT)


def global_mesh(data: int, model: int, device="cuda") -> Mesh:
    """This rank's mesh over every rank of the world, data-major: rank r
    is (r // model, r % model), so a data row's ranks are neighbours (on
    one host where they fit)."""
    return make_mesh(data, model, device)


def host_local_batch_to_global(mesh: Mesh, arr) -> torch.Tensor:
    """The data row's batch on every rank of the row: the leader's ``arr``
    (numpy or a tensor), on ``mesh.device`` and broadcast to the row's model
    group.  A follower passes an array of the same shape and dtype to
    receive into (its values are overwritten)."""
    t = torch.as_tensor(arr).to(mesh.device).contiguous()
    if mesh.group is not None:
        dist.broadcast(t, src=mesh.leader, group=mesh.group)
    return t


def global_scores_to_host_local(mesh: Mesh, scores: torch.Tensor) -> Optional[np.ndarray]:
    """The leader's scores of its data row ([B_loc], or [K, B_loc] for a
    pipelined call) as numpy; None on a follower, which replies nothing."""
    return scores.cpu().numpy() if mesh.is_leader else None
