"""Training on one device, the port of ``fleetrec_tpu/models/train.py``:
BCE on the scores' logits, Adagrad computed as optax computes it (and the
plain ``SGD`` of the sharded step), and a ``Trainer`` over the tensors the
serving model reads, updated in place, so the model it trains serves as it
is afterwards (train -> ``io.quantize_tables`` -> serve, as in the JAX
package).

A step runs ``FleetRecModel.forward_train`` under autograd: the fused
lookup kernel forward and its hand-written backward kernel
(``ops/lookup.py::LookupFunction``), the towers and heads as a
``torch.matmul`` chain with TF32 off.  ``torch.autograd.grad`` returns
fresh gradients (the tables' are float32 sums cast once to the storage
dtype), so nothing is accumulated or zeroed between steps.  The optimizer
updates every table element at every step, as optax's dense update does.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.lookup import require_float_storage
from .fleetrec import FleetRecModel, resolve_device, trainable_tensors


def bce_with_logits(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, the JAX package's
    formula term for term: ``mean(max(s, 0) - s * y + log1p(exp(-|s|)))``
    (``max`` splits its gradient at a tie, as ``jnp.maximum`` does, and
    ``|s|`` is ``where(s >= 0, s, -s)``, whose gradient at 0 is 1, as
    ``jnp.abs``'s)."""
    zero = scores.new_zeros(())
    mag = torch.where(scores >= 0, scores, -scores)
    return torch.mean(torch.maximum(scores, zero) - scores * labels
                      + torch.log1p(torch.exp(-mag)))


def check_trainable(model: FleetRecModel) -> None:
    """Raise ValueError when the model's tables are int8-quantized:
    gradients through quantized buffers are meaningless.  Train with
    table_dtype float32 or bfloat16 and quantize the serving checkpoint."""
    require_float_storage(model.lookup_operands()["bufs"])


class SGD:
    """Plain gradient descent, ``p - lr * g``: the update of the JAX
    package's ``ShardedFleetRec.train_step``, with ``Adagrad``'s interface
    (``init`` holds no state).  Per tensor, in its own dtype, in place: ``lr``
    is rounded to the tensor's dtype first, as JAX's weakly typed Python
    float is, then ``lr * g`` is rounded to it, then subtracted."""

    def __init__(self, lr: float = 1e-2):
        self.lr = lr

    def init(self, params: Sequence[torch.Tensor]) -> list:
        return []

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: Sequence[torch.Tensor] = ()) -> None:
        """One step: ``params`` updated in place."""
        for p, g in zip(params, grads):
            p.sub_(g * float(torch.tensor(self.lr, dtype=p.dtype)))


# optax.adagrad's defaults, which the JAX package's Trainer uses
INITIAL_ACCUMULATOR, EPS = 0.1, 1e-7


class Adagrad:
    """``optax.adagrad(lr)``'s arithmetic, written out
    (``torch.optim.Adagrad`` starts its sums at 0 and adds eps outside the
    square root: another function).  Sums of squares start at
    INITIAL_ACCUMULATOR; per tensor, in its own dtype, in place: ``s += g *
    g``; ``u = where(s > 0, rsqrt(s + EPS), 0) * g``; ``p = p + (-lr) * u``.
    The scalars are rounded to the tensor's dtype first, as JAX's weakly
    typed Python floats are."""

    def __init__(self, lr: float = 1e-2):
        self.lr = lr

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sums of squares, one a tensor, at INITIAL_ACCUMULATOR."""
        return [torch.full_like(p, INITIAL_ACCUMULATOR) for p in params]

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: Sequence[torch.Tensor]) -> None:
        """One step: ``params`` and ``state`` updated in place."""
        for p, g, s in zip(params, grads, state):
            neg_lr = float(torch.tensor(-self.lr, dtype=p.dtype))
            eps = float(torch.tensor(EPS, dtype=p.dtype))
            s.add_(g * g)
            u = torch.where(s > 0, torch.rsqrt(s + eps), 0.0)
            p.add_(u.mul_(g).mul_(neg_lr))


class Trainer:
    """Minimal CTR trainer: loss = BCE(score, click), ``Adagrad(lr)`` (the
    JAX package's ``optax.adagrad(1e-2)``) over every tensor of
    ``trainable_tensors``, or ``optimizer`` (an object with ``init(params)
    -> state`` and ``update(params, grads, state)`` that updates in place).

    ``device``: where the model must lie (the card unless the caller asks
    for the CPU; without a card, "cuda" raises).  The model's tensors are
    updated in place: it serves its trained weights as it is."""

    def __init__(self, model: FleetRecModel, lr: float = 1e-2, optimizer=None,
                 device="cuda"):
        dev = resolve_device(device)
        here = model.device
        if here.type != dev.type or (dev.index is not None and here.index != dev.index):
            raise ValueError(f"the model lies on {here}, not {dev}: build it there "
                             f"(init_model(..., device=...)) or pass device={str(here)!r}")
        check_trainable(model)
        self.model = model
        self.opt = optimizer or Adagrad(lr)
        self.state = None

    def init(self) -> list:
        """Fresh optimizer state for the model's tensors as they are now."""
        self.state = self.opt.init(list(trainable_tensors(self.model).values()))
        return self.state

    def step(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        """One step on a batch on the model's device (ids [B, num_tables],
        dense [B, dense_dim] or None, labels [B] float32); returns the loss,
        a 0-dim tensor computed before the update."""
        if self.state is None:
            self.init()
        tensors = trainable_tensors(self.model)
        # leaves that alias the buffers: the update below writes the buffers
        leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
        loss = bce_with_logits(self.model.forward_train(indices, dense, leaves), labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        self.opt.update(list(tensors.values()), grads, self.state)
        return loss.detach()

    def fit(self, batches: Iterable, epochs: int = 1, log_every: int = 0) -> List[float]:
        """batches: an iterable of (indices, dense or None, labels) numpy
        arrays; a fresh optimizer state, then one step a batch.  Returns the
        losses."""
        self.init()
        dev = self.model.device
        losses = []
        for _ in range(epochs):
            for idx, dense, labels in batches:
                d = None if dense is None else torch.as_tensor(np.asarray(dense), device=dev)
                loss = self.step(torch.as_tensor(np.asarray(idx), device=dev), d,
                                 torch.as_tensor(np.asarray(labels, np.float32), device=dev))
                losses.append(float(loss))
                if log_every and len(losses) % log_every == 0:
                    print(f"step {len(losses)}: loss {losses[-1]:.4f}", flush=True)
        return losses
