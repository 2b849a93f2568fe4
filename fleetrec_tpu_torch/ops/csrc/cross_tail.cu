// The elementwise tail of a DCNv2 cross layer in one launch:
// out = x0 * (xw + b) + x_l, where xw = x_l U V (or x_l W) is the layer's
// product, summed in fp32 by the caller (models/interaction.py::
// cross_network).  It replaces the three torch ops that computed the tail
// (+ b, x0 *, + x_l), each a pass over [B, F] of its own, and gives the cross
// layers a kernel name of their own in a device trace.
//
// Arithmetic (ops/cross.py::cross_tail_plain, to the bit): in the
// activation dtype D, as the torch expression x0 * (xw.to(D) + b) + x_l
// computes it: xw rounded to D, then each of the three operations in fp32
// and rounded to D (the identity for float32).  Each is an _rn intrinsic, so
// the product and the sum are never contracted into a fused multiply-add.
//
// What bounds it: bytes.  It reads x0, xw and x_l once and writes out once
// (4 x 28 MB in fp32 at DLRM-DCNv2's B = 2048, F = 3456), 16 bytes a load
// where F is a multiple of 4 (VEC), and the bias from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename D>
__device__ __forceinline__ D narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename D>
__device__ __forceinline__ D tail(D x0, float xw, D b, D x) {
  const float t = widen(narrow<D>(__fadd_rn(widen(narrow<D>(xw)), widen(b))));
  const float u = widen(narrow<D>(__fmul_rn(widen(x0), t)));
  return narrow<D>(__fadd_rn(u, widen(x)));
}

// VEC (float32 only): 4 neighbouring elements a step (F a multiple of 4,
// every pointer 16-byte aligned)
template <typename D, bool VEC>
__global__ void __launch_bounds__(kThreads)
    cross_tail(const D* __restrict__ x0, const float* __restrict__ xw,
               const D* __restrict__ b, const D* __restrict__ x, D* __restrict__ out,
               int64_t n, int F) {
  constexpr int kW = VEC ? 4 : 1;
  const int64_t steps = n / kW;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < steps;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t e = i * kW;
    const int c = (int)(e % F);
    if constexpr (VEC) {
      static_assert(sizeof(D) == 4, "16-byte steps are float32's");
      const float4 w = __ldg(reinterpret_cast<const float4*>(xw + e));
      const float4 a = __ldg(reinterpret_cast<const float4*>(x0 + e));
      const float4 r = __ldg(reinterpret_cast<const float4*>(x + e));
      *reinterpret_cast<float4*>(out + e) =
          make_float4(tail<D>(a.x, w.x, __ldg(b + c), r.x),
                      tail<D>(a.y, w.y, __ldg(b + c + 1), r.y),
                      tail<D>(a.z, w.z, __ldg(b + c + 2), r.z),
                      tail<D>(a.w, w.w, __ldg(b + c + 3), r.w));
    } else {
      out[e] = tail<D>(__ldg(x0 + e), __ldg(xw + e), __ldg(b + c), __ldg(x + e));
    }
  }
}

template <typename D, bool VEC>
cudaError_t launch(const void* x0, const float* xw, const void* b, const void* x, void* out,
                   int64_t n, int F, int grid, cudaStream_t st) {
  cross_tail<D, VEC><<<grid, kThreads, 0, st>>>(static_cast<const D*>(x0), xw,
                                                static_cast<const D*>(b),
                                                static_cast<const D*>(x), static_cast<D*>(out),
                                                n, F);
  return cudaGetLastError();
}

}  // namespace

// One launch on `stream`: x0, x_l and out [B, F] and b [F] in D (dtype 0:
// float32, 1: bfloat16), xw [B, F] float32; vec (float32 only): 4
// elements a step (F a multiple of 4, every pointer 16-byte aligned); grid
// blocks of 256 threads walk the elements (ops/cross.py).
extern "C" int fr_cross_tail(const void* x0, const void* xw, const void* b, const void* x,
                             void* out, int64_t B, int F, int dtype, int vec, int grid,
                             void* stream) {
  if (B < 1 || F < 1 || grid < 1 || dtype < 0 || dtype > 1 || (vec && (F % 4 || dtype)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(xw);
  const int64_t n = B * F;
  if (dtype == 1) return (int)launch<__nv_bfloat16, false>(x0, w, b, x, out, n, F, grid, st);
  return (int)(vec ? launch<float, true>(x0, w, b, x, out, n, F, grid, st)
                   : launch<float, false>(x0, w, b, x, out, n, F, grid, st));
}
