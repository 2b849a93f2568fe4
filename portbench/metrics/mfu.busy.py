"""mfu.busy: the whole step's FLOPs (``yardstick.step_flops_per_query``,
the published widths) of the queries scored in the profiled stretch, over
the device's busy seconds there times the dtype's peak times the chips, in
%: the share of the peak that bounds ``device_ms_per_mquery``."""

from portbench import yardstick
from portbench.readers import stretch_queries, trace_of


def read(out):
    tr = trace_of(out)
    if tr is None or not tr.kernels or not tr.busy_ns:
        return None
    m = out.cell.model
    flops = yardstick.step_flops_per_query(m) * stretch_queries(tr, out.batch)
    if not flops:
        return None
    return 100.0 * flops / (tr.busy_s * yardstick.PEAK_FLOPS[m["dtype"]] * out.cell.chips)
