"""Serving and training over several devices: the port of
``fleetrec_tpu/parallel`` (``mesh``, ``multihost``, ``sharded`` with its
``train_step``) on ``torch.distributed``, one rank a device.  The planner
is not ported yet."""

from .mesh import Mesh, make_mesh, single_device_mesh
from .multihost import (global_mesh, global_scores_to_host_local, host_local_batch_to_global,
                        init_distributed)
from .sharded import ShardedFleetRec, shard_operands

__all__ = ["Mesh", "make_mesh", "single_device_mesh", "init_distributed", "global_mesh",
           "host_local_batch_to_global", "global_scores_to_host_local", "ShardedFleetRec",
           "shard_operands"]
