"""cross_roofline.stream: the cross layers' bound (``yardstick.cross_bound_s``
at the cell's batch) over their device time a served batch in the run's
trace (a batch is one score readback), in %.  Their device time is the
products' (x_l U and then V: cuBLAS float32 kernels, a GEMM and its split-K
reduction, the only library products of the forward, whose towers are the
port's own kernels) and the tails' (``cross_tail``).  None where the trace
holds no ``cross_tail`` (a program without it)."""

from portbench import yardstick
from portbench.readers import READBACK, per_call_s, trace_of

# the cross layers' kernels: cuBLAS's float32 products (on the H100 with
# torch 2.11 / CUDA 12.8: cutlass_80_simt_sgemm_256x128_8x4_nn_align1 and
# cublasLt::splitKreduce_kernel) and the port's tail (ops/csrc/cross_tail.cu)
KERNELS = r"gemm|splitKreduce|cross_tail"
TAIL = r"cross_tail"


def read(out):
    tr = trace_of(out)
    if tr is None or not tr.count(TAIL):
        return None
    t = per_call_s(tr, KERNELS, calls=tr.count(READBACK))
    if not t:
        return None
    return 100.0 * yardstick.cross_bound_s(out.cell.model, out.batch) / t
