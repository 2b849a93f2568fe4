"""lookup_roofline.stream: the lookup's bound (``yardstick.lookup_bytes``
of the window's batches over HBM bandwidth, the whole batch's bytes over
every chip's bandwidth on a mesh) over its device time a call in the
run's trace, in %."""

from portbench import yardstick
from portbench.readers import trace_of, per_call_s, window_lookup_bytes

# the port's lookup kernels (ops/csrc/lookup_fused.cu)
KERNELS = r"lookup_fused_kernel"


def read(out):
    tr = trace_of(out)
    t = None if tr is None else per_call_s(tr, KERNELS)
    if not t:
        return None
    bound = window_lookup_bytes(out) / (yardstick.HBM_BYTES_PER_S * out.cell.chips)
    return 100.0 * bound / t
