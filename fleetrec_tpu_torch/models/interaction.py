"""Feature-interaction layers, the port of
``fleetrec_tpu/models/interaction.py``: DLRM's pairwise dot interaction
and DCNv2's cross network, as plain functions on tensors.

Neither runs inside a TPU kernel in the JAX package (both are XLA ops
there), so their products stay library products here, with the JAX
package's cast points: every product takes fp32 operands and sums in fp32
(TF32 stays off), and the result is cast back to the activation dtype
where JAX casts it.

* dot: the Gram matrix of the per-example vectors, one ``torch.bmm``, then
  one static column gather of its strict lower triangle in row-major order.
* cross: x_{l+1} = x0 * (x_l W_l + b_l) + x_l a layer (arXiv:2008.13535);
  the low-rank variant factors W = U V into two skinny products
  (``torch.matmul``), and the layer's elementwise tail is one launch of the
  port's own kernel (``ops/cross.py::cross_tail``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.cross import cross_tail


def num_pairs(n_vectors: int) -> int:
    """Strict lower triangle count (DLRM convention: self-dots excluded)."""
    return n_vectors * (n_vectors - 1) // 2


def pair_columns(n_vectors: int, device="cpu") -> torch.Tensor:
    """The strict lower triangle of an [n, n] matrix as flat row-major
    columns ``li * n + lj`` (int64 [n*(n-1)//2]), in np.tril_indices order."""
    li, lj = np.tril_indices(n_vectors, -1)
    return torch.as_tensor(li * n_vectors + lj, dtype=torch.int64, device=device)


def dot_interaction(vecs: torch.Tensor, cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, n, D] -> [B, n*(n-1)//2] in ``vecs.dtype``: entry k is
    <v_i, v_j> for the k-th (i > j) pair in row-major lower-triangle order.

    The Gram matrix is summed in fp32 from fp32 operands (bf16 widens
    exactly), then cast to ``vecs.dtype``, as JAX's
    ``preferred_element_type=float32`` then ``.astype`` does; the cast is
    taken after the gather, which gives the same values.  ``cols`` is
    ``pair_columns(n)`` on the device of ``vecs``: a model passes its own
    buffer, so the forward copies nothing from the host and stays
    capturable in a CUDA graph; None makes it here."""
    B, n, _ = vecs.shape
    if cols is None:
        cols = pair_columns(n, vecs.device)
    v = vecs.float()
    gram = torch.bmm(v, v.transpose(1, 2))
    return gram.reshape(B, n * n).index_select(1, cols).to(vecs.dtype)


def init_cross_params(
    feature_dim: int,
    n_layers: int,
    rank: int = 0,
    scheme: str = "ones",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> List[List[torch.Tensor]]:
    """Per-layer cross weights: [W [F, F], b [F]] full rank, or
    [U [F, r], V [r, F], b [F]] when rank > 0; numpy-seeded in the
    (seed + 2) namespace as in the JAX package.  "ones" (with a zero bias)
    is the parity scheme."""
    layers: List[List[torch.Tensor]] = []
    F = feature_dim
    for li in range(n_layers):
        if scheme == "ones":
            mats = ([np.ones((F, F), np.float32)] if rank == 0 else
                    [np.ones((F, rank), np.float32), np.ones((rank, F), np.float32)])
        elif scheme == "uniform":
            rng = np.random.default_rng((seed + 2) * 104729 + li)
            if rank == 0:
                mats = [(rng.uniform(-1, 1, (F, F)) / np.sqrt(F)).astype(np.float32)]
            else:
                mats = [
                    (rng.uniform(-1, 1, (F, rank)) / np.sqrt(F)).astype(np.float32),
                    (rng.uniform(-1, 1, (rank, F)) / np.sqrt(rank)).astype(np.float32),
                ]
        else:
            raise ValueError(scheme)
        layers.append([torch.from_numpy(m).to(device=device, dtype=dtype) for m in mats]
                      + [torch.zeros(F, dtype=dtype, device=device)])
    return layers


def cross_network(x0: torch.Tensor, layers: Sequence[Sequence[torch.Tensor]],
                  tail=None) -> torch.Tensor:
    """DCNv2 stacked cross layers on x0 [B, F] -> [B, F] in ``x0.dtype``.

    Each layer's x_l W (or x_l U V) is summed in fp32 from operands in
    ``x0.dtype`` (the low-rank intermediate stays fp32, as JAX's promotion
    keeps it), then cast to ``x0.dtype``; ``+ b``, ``x0 * (...)`` and
    ``+ x_l`` are each computed in ``x0.dtype``, by one ``tail`` a layer:
    None is ``cross_tail`` (the kernel), which the served forward runs;
    training passes ``cross_tail_plain`` (the same arithmetic,
    differentiable)."""
    tail = cross_tail if tail is None else tail
    dtype = x0.dtype
    x = x0
    for lp in layers:
        *mats, b = lp
        xw = x.float()
        for m in mats:
            xw = torch.matmul(xw, m.to(dtype).float())
        x = tail(x0, xw, b, x)
    return x
