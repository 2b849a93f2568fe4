"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Kernels are built at first use (ops/_build.py)."""

from .gather import (gather_rows, gather_rows_grouped, gather_rows_plain,
                     grouped_params)
from .mlp_fused import fused_mlp, fused_mlp_available, fused_mlp_plain

__all__ = ["gather_rows", "gather_rows_grouped", "gather_rows_plain",
           "grouped_params", "fused_mlp",
           "fused_mlp_available", "fused_mlp_plain"]
