"""Faults planted in the timed path for the tests, and the control put in
the program's place."""

from __future__ import annotations


def altered_answer() -> None:
    """One score of every forward off by its batch's scale: an answer
    altered where it is produced."""
    from fleetrec_tpu_torch.models import FleetRecModel

    forward = FleetRecModel.forward

    def bad(self, indices, dense=None):
        s = forward(self, indices, dense)
        s[0] += s.abs().mean() + 1
        return s

    FleetRecModel.forward = bad


def tf32_tower() -> None:
    """The control in the program's place: the served forward's tower with
    every operand of every product rounded to TF32 and float32 sums
    (``reference.Control``'s rounding), one precision below a float32
    configuration; the lookup and the rest of the path stay the program's."""
    from fleetrec_tpu_torch.models import fleetrec

    from portbench.reference import _round_tf32

    def control(weights, x, activation=None, out_dtype=None):
        h = x.float()
        for i, w in enumerate(weights):
            h = _round_tf32(h) @ _round_tf32(w)
            if i < len(weights) - 1 and activation == "relu":
                h = h.clamp_min(0)
        return h

    fleetrec.mlp_apply = control


def cross_without_residual() -> None:
    """Each cross layer's ``+ x_l`` dropped: x_{l+1} = x0 * (x_l U V + b)."""
    from fleetrec_tpu_torch.models import fleetrec

    def bad(x0, layers):
        dtype, x = x0.dtype, x0
        for *mats, b in layers:
            xw = x.float()
            for m in mats:
                xw = xw @ m.to(dtype).float()
            x = x0 * (xw.to(dtype) + b.to(dtype))
        return x

    fleetrec.cross_network = bad


def tf32_cross() -> None:
    """The control in the cross layers: every operand of their products
    rounded to TF32, float32 sums (``reference.Control``'s rounding); the
    rest of the path stays the program's."""
    from fleetrec_tpu_torch.models import fleetrec

    from portbench.reference import _round_tf32

    def control(x0, layers):
        dtype, x = x0.dtype, x0
        for *mats, b in layers:
            xw = x.float()
            for m in mats:
                xw = _round_tf32(xw) @ _round_tf32(m.float())
            x = x0 * (xw.to(dtype) + b.to(dtype)) + x
        return x

    fleetrec.cross_network = control


def bottom_tower_skipped() -> None:
    """The DLRM head with its bottom tower's output left out (zeros in its
    place)."""
    import torch

    from fleetrec_tpu_torch.models import fleetrec

    head = fleetrec.interaction_head

    def bad(cfg, pair_cols, emb_flat, dense, bottom_weights, top_weights, **kw):
        zeros = [torch.zeros_like(w) for w in bottom_weights]
        return head(cfg, pair_cols, emb_flat, dense, zeros, top_weights, **kw)

    fleetrec.interaction_head = bad


def bag_last_dropped() -> None:
    """Each bag's last member dropped (read as padding) in the pooled
    forward."""
    from fleetrec_tpu_torch.models import FleetRecModel

    forward = FleetRecModel.forward_pooled

    def bad(self, indices, dense=None, mean=False):
        indices = indices.clone()
        indices[..., -1] = -1
        return forward(self, indices, dense, mean)

    FleetRecModel.forward_pooled = bad
