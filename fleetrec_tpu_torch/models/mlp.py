"""Dense towers, the port of ``fleetrec_tpu/models/mlp.py``: the scoring
tower (the reference's chain of four cublasLtMatmul calls, bias-free by
default) and the DLRM bottom tower.

On a CUDA tensor ``mlp_apply`` runs the ``fused_mlp`` kernels (one
launch a layer, the activations between them in an L2-resident scratch);
on a CPU tensor it runs the plain chain.  ``mlp_train``, the training
path's tower, is a ``torch.matmul`` chain under autograd.  All keep
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
    biases: Optional[Sequence[torch.Tensor]] = None,
    last_activation: bool = False,
) -> torch.Tensor:
    """x: [B, input_dim] -> [B, out_dim] in ``out_dtype``; fp32 sums
    whatever the storage dtype.  No TF32: matmuls run in full fp32.  The
    fp32 sums of the last layer are cast to ``out_dtype`` once, as the JAX
    package rounds them.  ``biases``: a float32 ``[out]`` a layer, added to
    each layer's fp32 sum before its activation (float32 towers only);
    ``last_activation``: the activation after the last layer too."""
    return fused_mlp(weights, x, activation, biases, last_activation).to(out_dtype)


def mlp_train(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    activation: Optional[str] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The tower for training: ``mlp_apply``'s function as a ``torch.matmul``
    chain that autograd differentiates, never the ``fused_mlp`` kernels (the
    JAX package differentiates its XLA chain, and its Pallas tower is
    inference-only).  The same compute-dtype rule: weights cast to
    ``x.dtype`` a layer, fp32 operands and sums (TF32 stays off), the ReLU
    on the fp32 sums of every layer but the last, activations re-narrowed
    between layers, the last layer's sums cast to ``out_dtype`` once.  The
    ReLU is ``max(h, 0)``, whose gradient at 0 is halved as ``jnp.maximum``'s
    is."""
    dtype = x.dtype
    zero = x.new_zeros((), dtype=torch.float32)
    h = x
    for i, w in enumerate(weights):
        h = torch.matmul(h.float(), w.to(dtype).float())
        if i < len(weights) - 1:
            if activation == "relu":
                h = torch.maximum(h, zero)
            h = h.to(dtype)
    return h.to(out_dtype)
