"""Serving and training over several devices: the port of
``fleetrec_tpu/parallel`` (``mesh``, ``multihost``, ``sharded`` with its
``train_step``, ``planner``) on ``torch.distributed``, one rank a device,
and ``dryrun.dryrun_multichip``, the twin of the JAX package's multi-device
dry run."""

from .dryrun import dryrun_multichip
from .mesh import Mesh, make_mesh, single_device_mesh
from .multihost import (global_mesh, global_scores_to_host_local, host_local_batch_to_global,
                        init_distributed)
from .planner import (H100_HBM_BYTES, PlacementPlan, ShardReport, plan, recommend,
                      split_table_columns, split_table_data)
from .sharded import ShardedFleetRec, packed_operands, shard_operands

__all__ = ["Mesh", "make_mesh", "single_device_mesh", "init_distributed", "global_mesh",
           "host_local_batch_to_global", "global_scores_to_host_local", "ShardedFleetRec",
           "shard_operands", "packed_operands", "plan", "recommend", "PlacementPlan",
           "ShardReport", "split_table_columns", "split_table_data", "H100_HBM_BYTES",
           "dryrun_multichip"]
