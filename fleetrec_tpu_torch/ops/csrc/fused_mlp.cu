// Fused bias-free MLP tower: scores = x @ W1 @ ... @ Wn, one kernel for the
// whole chain.
//
// Replaces the Pallas kernel fleetrec_tpu/ops/mlp_fused.py::fused_mlp
// (_kernel), with the same semantics as models/mlp.py::mlp_apply: weights
// in the activation dtype D (float32 or bfloat16), every sum in fp32, ReLU
// (optional) on every layer but the last, activations re-narrowed to D
// between layers, fp32 out.
//
// The TPU kernel kept every weight resident in VMEM.  Here the weights do
// not fit in shared memory (model1's are 4.1 MB in fp32, a block gets at
// most 227 KB), so each block owns a tile of T batch rows instead: the
// tile's activations ping-pong between two shared-memory buffers of
// T x max_width values, and the weights are read from device memory, where
// they stay resident in the 50 MB L2 across tiles.  Only x in and the
// scores out touch device memory.  The wrapper picks T so that
// 2 * T * max_width * sizeof(D) fits in 227 KB (T = 16 for model1 fp32).
//
// What bounds it: fp32 FMAs on the CUDA cores (no tensor cores, no TF32, so
// the pm1 / all-ones parity data is exact) and the weight reads from L2,
// each weight element being read once per tile.  Each thread owns one
// output column at a time and keeps T fp32 accumulators in registers; the
// activations are broadcast from shared memory four k-steps per load.  The
// sum over k runs in ascending order, one fmaf per term.  wgmma, TMA and
// bf16 tensor cores are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 512;

struct MlpArgs {
  const void* w[kMaxLayers];
  int widths[kMaxLayers + 1];
  int n_layers;
  int relu;
  int stride;  // row stride of the shared-memory buffers (max width, 4-aligned)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename D>
__device__ __forceinline__ D from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four consecutive activations of one row (p is 4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename D, int T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const D* __restrict__ x, float* __restrict__ out, int64_t B,
                 MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  D* in = reinterpret_cast<D*>(smem_raw);
  D* nxt = in + (size_t)T * a.stride;

  const int64_t row0 = (int64_t)blockIdx.x * T;
  const int rows = (int)((B - row0) < T ? (B - row0) : T);

  // x tile -> shared memory; rows past B are zero and never written out
  const int K0 = a.widths[0];
  for (int e = threadIdx.x; e < T * K0; e += blockDim.x) {
    const int r = e / K0;
    const int k = e - r * K0;
    in[r * K0 + k] = r < rows ? x[(row0 + r) * K0 + k] : from_f<D>(0.f);
  }
  __syncthreads();

  for (int l = 0; l < a.n_layers; ++l) {
    const int K = a.widths[l];
    const int N = a.widths[l + 1];
    const D* __restrict__ W = static_cast<const D*>(a.w[l]);
    const bool last = l == a.n_layers - 1;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float acc[T];
#pragma unroll
      for (int r = 0; r < T; ++r) acc[r] = 0.f;
      int k = 0;
      if (K % 4 == 0) {
        for (; k < K; k += 4) {
          const float w0 = to_f(W[(size_t)(k + 0) * N + n]);
          const float w1 = to_f(W[(size_t)(k + 1) * N + n]);
          const float w2 = to_f(W[(size_t)(k + 2) * N + n]);
          const float w3 = to_f(W[(size_t)(k + 3) * N + n]);
#pragma unroll
          for (int r = 0; r < T; ++r) {
            const float4 v = load4(in + r * K + k);
            acc[r] = fmaf(v.x, w0, acc[r]);
            acc[r] = fmaf(v.y, w1, acc[r]);
            acc[r] = fmaf(v.z, w2, acc[r]);
            acc[r] = fmaf(v.w, w3, acc[r]);
          }
        }
      }
      for (; k < K; ++k) {
        const float w = to_f(W[(size_t)k * N + n]);
#pragma unroll
        for (int r = 0; r < T; ++r) acc[r] = fmaf(to_f(in[r * K + k]), w, acc[r]);
      }
      if (last) {
#pragma unroll
        for (int r = 0; r < T; ++r)
          if (r < rows) out[(row0 + r) * N + n] = acc[r];
      } else {
#pragma unroll
        for (int r = 0; r < T; ++r) {
          const float v = a.relu ? fmaxf(acc[r], 0.f) : acc[r];
          nxt[r * N + n] = from_f<D>(v);
        }
      }
    }
    __syncthreads();
    D* t = in;
    in = nxt;
    nxt = t;
  }
}

template <typename D, int T>
cudaError_t launch_tile(const D* x, float* out, int64_t B, const MlpArgs& a,
                        cudaStream_t stream) {
  const size_t smem = 2 * (size_t)T * a.stride * sizeof(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + T - 1) / T;
  fused_mlp_kernel<D, T><<<(unsigned)blocks, kThreads, smem, stream>>>(x, out, B, a);
  return cudaGetLastError();
}

template <typename D>
cudaError_t fused_mlp(const D* x, float* out, int64_t B, int n_layers,
                      const void* const* w, const int* widths, int tile,
                      int relu, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || B < 1) return cudaErrorInvalidValue;
  MlpArgs a;
  int maxw = 0;
  for (int i = 0; i < n_layers; ++i) a.w[i] = w[i];
  for (int i = 0; i <= n_layers; ++i) {
    a.widths[i] = widths[i];
    if (widths[i] > maxw) maxw = widths[i];
  }
  a.n_layers = n_layers;
  a.relu = relu;
  a.stride = (maxw + 3) / 4 * 4;
  switch (tile) {
    case 1: return launch_tile<D, 1>(x, out, B, a, stream);
    case 2: return launch_tile<D, 2>(x, out, B, a, stream);
    case 4: return launch_tile<D, 4>(x, out, B, a, stream);
    case 8: return launch_tile<D, 8>(x, out, B, a, stream);
    case 16: return launch_tile<D, 16>(x, out, B, a, stream);
    case 32: return launch_tile<D, 32>(x, out, B, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fr_fused_mlp_f32(const void* x, void* out, int64_t B,
                                int n_layers, const void* const* w,
                                const int* widths, int tile, int relu,
                                void* stream) {
  return (int)fused_mlp<float>(static_cast<const float*>(x),
                               static_cast<float*>(out), B, n_layers, w,
                               widths, tile, relu,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int fr_fused_mlp_bf16(const void* x, void* out, int64_t B,
                                 int n_layers, const void* const* w,
                                 const int* widths, int tile, int relu,
                                 void* stream) {
  return (int)fused_mlp<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<float*>(out), B, n_layers,
                                       w, widths, tile, relu,
                                       static_cast<cudaStream_t>(stream));
}
