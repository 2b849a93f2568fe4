"""tower_roofline.stream: the tower's bound (``yardstick.tower_bound_s``)
over its kernels' device time a served batch in the run's trace, in %."""

from portbench import yardstick
from portbench.readers import READBACK, trace_of, per_call_s

# the port's tower kernels (ops/csrc/fused_mlp.cu)
KERNELS = r"ffma_product|wgmma_product|rowdot"


def read(out):
    tr = trace_of(out)
    if tr is None:
        return None
    t = per_call_s(tr, KERNELS, calls=tr.count(READBACK))
    if not t:
        return None
    m = out.cell.model
    return 100.0 * yardstick.tower_bound_s(m["mlp"], m["dtype"], out.batch) / t
