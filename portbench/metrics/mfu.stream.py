"""mfu.stream: the tower's FLOPs of every query scored in the window (2 *
sum K * N over the published widths) over the window's seconds times the
tower dtype's peak times the chips, in %.  Needs no kernel name."""

from portbench import yardstick
from portbench.readers import answered_queries


def read(out):
    m = out.cell.model
    flops = yardstick.flops_per_query(m["mlp"]) * answered_queries(out)
    if not flops:
        return None
    return 100.0 * flops / (out.seconds * yardstick.PEAK_FLOPS[m["dtype"]] * out.cell.chips)
