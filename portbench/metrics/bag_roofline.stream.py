"""bag_roofline.stream: the ragged bag lookup's bound (``yardstick.lookup_bytes``
of the window's batches over HBM bandwidth: the ids once, each distinct
(table, row) once, a flag a row, the pooled features written) over the ragged
bag kernel's device time a call in the run's trace, in %.  None where the
trace holds no call of that kernel (a program without it)."""

from portbench import yardstick
from portbench.readers import per_call_s, trace_of, window_lookup_bytes

# the port's ragged bag kernel (ops/csrc/lookup_fused.cu)
KERNELS = r"lookup_ragged_kernel"


def read(out):
    tr = trace_of(out)
    t = None if tr is None else per_call_s(tr, KERNELS)
    if not t:
        return None
    bound = window_lookup_bytes(out) / (yardstick.HBM_BYTES_PER_S * out.cell.chips)
    return 100.0 * bound / t
