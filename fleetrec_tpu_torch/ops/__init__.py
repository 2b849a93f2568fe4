"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Kernels are built at first use (ops/_build.py)."""

from .gather import (gather_rows, gather_rows_grouped, gather_rows_plain,
                     grouped_params)
from .lookup import (lookup_fused, lookup_fused_backward, lookup_fused_backward_plain,
                     lookup_fused_plain)
from .mlp_fused import fused_mlp, fused_mlp_available, fused_mlp_plain

__all__ = ["gather_rows", "gather_rows_grouped", "gather_rows_plain",
           "grouped_params", "lookup_fused", "lookup_fused_plain", "lookup_fused_backward",
           "lookup_fused_backward_plain", "fused_mlp",
           "fused_mlp_available", "fused_mlp_plain"]
