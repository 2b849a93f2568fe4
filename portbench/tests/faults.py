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
    (``reference.tower_control``'s rounding), one precision below a float32
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
