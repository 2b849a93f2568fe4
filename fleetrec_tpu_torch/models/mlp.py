"""Dense towers, the port of ``fleetrec_tpu/models/mlp.py``: the scoring
tower (the reference's chain of four cublasLtMatmul calls, bias-free by
default) and the DLRM bottom tower.

On a CUDA tensor ``mlp_apply`` runs the ``fused_mlp`` kernels (one
launch a layer, the activations between them in an L2-resident scratch);
on a CPU tensor it runs the plain chain.  Both keep
the JAX package's compute-dtype rule: the compute dtype is ``x.dtype`` on
entry, weights are cast to it per layer, sums are fp32, and activations
re-narrow to it between layers."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import MLPSpec
from ..ops.mlp_fused import fused_mlp


def init_mlp_params(
    spec: MLPSpec, scheme: str = "ones", seed: int = 0,
    dtype: torch.dtype = torch.float32, device="cpu",
) -> List[torch.Tensor]:
    """Weights [in, out] per layer, numpy-seeded as in the JAX package;
    "ones" matches the reference parity setup."""
    ws = []
    for li, (a, b) in enumerate(zip(spec.widths[:-1], spec.widths[1:])):
        if scheme == "ones":
            w = np.ones((a, b), dtype=np.float32)
        elif scheme == "uniform":
            rng = np.random.default_rng(seed * 104729 + li)
            w = (rng.uniform(-1, 1, size=(a, b)) / np.sqrt(a)).astype(np.float32)
        else:
            raise ValueError(scheme)
        ws.append(torch.from_numpy(w).to(device=device, dtype=dtype))
    return ws


def mlp_apply(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    activation: Optional[str] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """x: [B, input_dim] -> [B, out_dim] in ``out_dtype``; fp32 sums
    whatever the storage dtype.  No TF32: matmuls run in full fp32.  The
    fp32 sums of the last layer are cast to ``out_dtype`` once, as the JAX
    package rounds them."""
    return fused_mlp(weights, x, activation).to(out_dtype)
