// Row gather over a packed embedding buffer: out[i] = table[idx[i]].
//
// Replaces the Pallas kernel fleetrec_tpu/ops/gather_pallas.py::gather_rows
// (_gather_kernel, one HBM->VMEM row DMA per index, `window` in flight).  In
// the port this one kernel is the whole lookup: every tier of
// models/embedding.py::lookup_concat (plain one-hot class, factored class,
// take group) selects exactly one row per (query, table), so each becomes a
// row read over a row-width view of the same buffer bytes the JAX package
// packs.
//
// What bounds it: bytes from device memory.  There is no arithmetic; each
// output row costs one random row read (16-128 bytes on the model1 tiers)
// plus one coalesced write.  The design is the simple one: a grid-stride
// loop over (row, word) pairs, so neighbouring threads touch neighbouring
// words of a row and of the output, and each thread moves the widest word
// (16, 8, 4, 2 or 1 bytes) that the row width and the pointers' alignment
// allow.  Async-copy (cp.async / TMA) rings that keep more rows in flight
// are later work.
//
// The copy moves bytes, so one entry point serves every element type: the
// caller passes the row width in bytes (L * element size).  Ids are int64
// and offsets are computed in int64 (a take buffer can exceed 2^31
// elements).  An id outside [0, R), -1 included, writes a zero row and
// reads nothing: on the GPU an out-of-bounds read is a fault, where
// jnp.take filled NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int64_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t R, int64_t N,
                                   int64_t vpr) {
  const int64_t total = N * vpr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += stride) {
    const int64_t i = u / vpr;
    const int64_t k = u - i * vpr;
    const int64_t id = idx[i];
    V v{};
    if (id >= 0 && id < R) v = table[id * vpr + k];
    out[u] = v;
  }
}

template <typename V>
cudaError_t launch(const void* table, const int64_t* idx, void* out,
                   int64_t R, int64_t N, int64_t vpr, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (N * vpr + threads - 1) / threads;
  // enough blocks to fill 132 SMs several times over; the loop strides on
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), R, N, vpr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fr_gather_rows(const void* table, const void* idx, void* out,
                              int64_t R, int64_t N, int64_t row_bytes,
                              void* stream) {
  const int64_t* ids = static_cast<const int64_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return (int)launch<uint4>(table, ids, out, R, N, row_bytes / 16, s);
  if (row_bytes % 8 == 0 && a % 8 == 0)
    return (int)launch<uint2>(table, ids, out, R, N, row_bytes / 8, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return (int)launch<uint32_t>(table, ids, out, R, N, row_bytes / 4, s);
  if (row_bytes % 2 == 0 && a % 2 == 0)
    return (int)launch<uint16_t>(table, ids, out, R, N, row_bytes / 2, s);
  return (int)launch<uint8_t>(table, ids, out, R, N, row_bytes, s);
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
