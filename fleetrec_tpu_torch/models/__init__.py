from .embedding import PackedTables, lookup_concat, pack_tables
from .fleetrec import FleetRecModel, ModelPlan, init_model
from .mlp import init_mlp_params, mlp_apply

__all__ = [
    "PackedTables", "pack_tables", "lookup_concat",
    "init_mlp_params", "mlp_apply",
    "FleetRecModel", "ModelPlan", "init_model",
]
