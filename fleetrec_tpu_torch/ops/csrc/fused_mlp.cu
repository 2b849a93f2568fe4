// Fused MLP tower: scores = x @ W1 @ ... @ Wn, bias-free by default, one
// launch per layer on the caller's stream, so one fused_mlp call is n_layers
// launches.
//
// Replaces the Pallas kernel fleetrec_tpu/ops/mlp_fused.py::fused_mlp
// (_kernel), with the same semantics as models/mlp.py::mlp_apply: weights
// in the activation dtype D (float32 or bfloat16), every sum in fp32, ReLU
// (optional) on every layer but the last (and on the last too where the
// caller asks: MLPerf DLRM's bottom MLP), activations re-narrowed to D
// between layers, fp32 out.  In fp32 a tower may carry a bias a layer
// (DLRM-DCNv2's towers): the epilogue adds it to the fp32 sum, rounded, before
// the ReLU.  The bias is a compile-time switch (ffma_product<BM, BN, true>,
// rowdot<float, true>), so a bias-free tower's kernels read no bias and take
// no branch for it.
//
// The TPU kernel kept every weight resident in VMEM and every intermediate
// out of HBM.  Here the weights cannot stay on chip (model1's are 4.1 MB in
// fp32, model3's 37 MB; a block gets 227 KB), so each layer is a tiled
// product and the intermediates go through two ping-pong scratch buffers
// that the wrapper allocates (24 MB for model1 fp32 at B = 4096), small
// enough to stay in the 50 MB L2.  Each product's epilogue applies the ReLU
// and the cast to D.  The plan of launches (kernel, tile, padded widths)
// is made in Python (ops/mlp_fused.py::mlp_plan) and passed in as 6 ints a
// layer: kind, BM, BN, K, N, n_store.  The depth, stages and shared memory
// of each tile are this file's (ffma_smem, wgmma_smem).  Every K and N of
// a product is a multiple of 16 bytes: the wrapper zero-pads x and weights.
//
// * fp32 (ffma_product): register-tiled FFMA on the CUDA cores, no TF32, so
//   the pm1 / all-ones parity data stays exact.  256 threads own a BM x BN
//   tile, each thread (BM/16) x (BN/16) accumulators (8 x 8 at 128 x 128).
//   Tiles of depth 32 land in a 3-stage shared-memory ring by 16-byte
//   cp.async (zero-filled past the edges), the copies of stage s+2 in
//   flight during the FMAs on stage s.  A and W are read as float4 (A
//   four k-steps of a row, W four columns): 16 FMAs per shared-memory
//   load, and a warp's loads are conflict-free.  Each weight is read
//   B / BM times a forward from L2 (32 x 4.06 MB at model1, B = 4096),
//   not once per 16 rows as a rows-per-block design does.  The sum runs
//   in ascending k within each thread, one fmaf a term.  Bound: the FFMA
//   rate one block an SM sustains.  At 128 x 128 a thread needs ~175
//   registers, so an SM runs one block of 8 warps, two warps a scheduler
//   to hide shared-memory latency and the barrier; a 128-register cap
//   (two blocks) spills and is slower.  On an H100 SXM at 700 W it reaches
//   about 43 TFLOP/s on model3's 3968 x 2048 layer at B = 4096, against
//   ~67 on the data sheet and ~50 for the cuBLAS fp32 product.
// * bf16 (wgmma_product): tensor cores.  One warpgroup per 64-row slab
//   runs wgmma.mma_async m64nBNk16 .f32.bf16.bf16 from shared memory: A
//   (activations, K-major) and B (W as stored, [K, N] with N contiguous, so
//   MN-major through the transpose-B immediate).  Both land by TMA
//   (cp.async.bulk.tensor.2d, 128-byte swizzle, one mbarrier a stage) in a
//   3-stage ring of depth 64, started by one thread; TMA zero-fills ragged
//   B, K and N.  The tensor maps are built on the host at every call (the
//   pointers change between calls, and a CUDA graph captures the
//   __grid_constant__ parameters by value).  Bound: at these sizes the
//   launches between layers and the L2 traffic, not the tensor-core rate.
// * The score (a last layer narrower than 8) is a row-dot: one warp a row,
//   lanes over K, a shuffle reduction.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;
constexpr int kRowdotMaxN = 7;
constexpr int kPlanInts = 6;
constexpr int kSmemMax = 232448;  // shared memory one block may use (227 KB)
enum { kProduct = 0, kRowdot = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- fp32: register-tiled FFMA fed by cp.async -------------------------------

// 16 bytes global -> shared; with ok false it reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int kFfmaThreads = 256;
constexpr int kFfmaBK = 32;
// A rows in shared memory are BK + 4 floats apart, so that the four rows a
// warp reads at once fall in four different 16-byte bank groups
constexpr int kFfmaPad = 4;

template <int BM, int BN>
constexpr int ffma_smem() {
  return kStages * (BM * (kFfmaBK + kFfmaPad) + kFfmaBK * BN) * (int)sizeof(float);
}

// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
// (j / 4) * 64 + tx * 4 + j % 4 of the tile.  A warp is a 4 x 8 patch of
// that grid: per k it reads 4 A values (one bank group each) and 32
// consecutive W values, one shared-memory wavefront each.
template <int BM, int BN, bool BIAS>
__global__ void __launch_bounds__(kFfmaThreads)
ffma_product(const float* __restrict__ A, const float* __restrict__ W,
             const float* __restrict__ bias, float* __restrict__ C, int M, int K, int N,
             int n_store, int relu) {
  constexpr int BK = kFfmaBK, AS = BK + kFfmaPad, TM = BM / 16, TN = BN / 16;
  constexpr int A_TILE = BM * AS, W_TILE = BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // kStages x [BM][AS]
  float* Ws = smem + kStages * A_TILE;   // kStages x [BK][BN]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  // Each thread copies the same 16-byte column of A_CHUNKS rows of the A
  // tile and of W_CHUNKS rows of the W tile every stage.  K and N are
  // multiples of 4: a chunk is all in or all out.
  constexpr int A_CHUNKS = BM * BK / 4 / kFfmaThreads, A_STEP = kFfmaThreads / (BK / 4);
  constexpr int W_CHUNKS = BK * BN / 4 / kFfmaThreads, W_STEP = kFfmaThreads / (BN / 4);
  const int a_r = tid / (BK / 4), a_k = (tid % (BK / 4)) * 4;
  const int w_r = tid / (BN / 4), w_n = (tid % (BN / 4)) * 4;
  const float* a_src = A + (size_t)(m0 + a_r) * K + a_k;
  const float* w_src = W + (size_t)w_r * N + n0 + w_n;
  const uint32_t a_dst = smem_u32(As + a_r * AS + a_k);
  const uint32_t w_dst = smem_u32(Ws + w_r * BN + w_n);
  auto load = [&](int kt) {
    const int s = kt % kStages, k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const bool ok = m0 + a_r + i * A_STEP < M && k0 + a_k < K;
      cp_async16(a_dst + (s * A_TILE + i * A_STEP * AS) * 4,
                 ok ? a_src + (size_t)i * A_STEP * K + k0 : A, ok);
    }
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const bool ok = k0 + w_r + i * W_STEP < K && n0 + w_n < N;
      cp_async16(w_dst + (s * W_TILE + i * W_STEP * BN) * 4,
                 ok ? w_src + (size_t)(k0 + i * W_STEP) * N : W, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < ktiles) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage (kt-1) is free
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1);
    cp_async_commit();
    const float* as = As + (kt % kStages) * A_TILE;
    const float* ws = Ws + (kt % kStages) * W_TILE;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * AS + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int jj = 0; jj < TN / 4; ++jj) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (k4 + kk) * BN + jj * 64 + tx * 4);
          b[jj * 4 + 0] = v.x;
          b[jj * 4 + 1] = v.y;
          b[jj * 4 + 2] = v.z;
          b[jj * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool vec = n_store % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
    float* crow = C + (size_t)r * n_store;
#pragma unroll
    for (int jj = 0; jj < TN / 4; ++jj) {
      const int c = n0 + jj * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][jj * 4 + q];
        if constexpr (BIAS) v[q] = __fadd_rn(v[q], c + q < n_store ? __ldg(bias + c + q) : 0.f);
        if (relu) v[q] = fmaxf(v[q], 0.f);
      }
      if (vec && c + 3 < n_store) {
        *reinterpret_cast<float4*>(crow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < n_store) crow[c + q] = v[q];
      }
    }
  }
}

// ---- bf16: wgmma from shared memory, tiles by TMA ---------------------------

constexpr int kWgBK = 64;  // one 128-byte swizzled row of bf16

// the ring, and 1024 bytes to align it to the swizzle pattern's period
template <int BM, int BN>
constexpr int wgmma_smem() {
  return kStages * (BM * kWgBK + kWgBK * BN) * 2 + 1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// A copy that never completes (a box that disagrees with the expected
// bytes) traps after ~2^26 polls instead of spinning forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// box at (c0 inner, c1 outer) of `map` -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define FR_ACC8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x BN] += A[64 x 16] * B[16 x BN]: A K-major, B MN-major (transpose-B)
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : FR_ACC8(0), FR_ACC8(8), FR_ACC8(16), FR_ACC8(24), FR_ACC8(32), FR_ACC8(40),
        FR_ACC8(48), FR_ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n\t}"
      : FR_ACC8(0), FR_ACC8(8), FR_ACC8(16), FR_ACC8(24)
      : "l"(da), "l"(db), "r"(1));
}
#undef FR_ACC8

// Shared memory of one stage: A box [BM rows][64 k] (K-major, each row 128
// swizzled bytes), then BN / 64 W boxes [64 k][64 n] (MN-major).  Stages
// and boxes start on 1024-byte boundaries, the swizzle pattern's period.
template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
wgmma_product(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_w, void* __restrict__ C,
              int M, int K, int n_store, int relu, int out_f32) {
  constexpr int A_BYTES = BM * kWgBK * 2, W_BOX = kWgBK * 64 * 2;
  constexpr int STAGE = A_BYTES + (BN / 64) * W_BOX;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kWgBK - 1) / kWgBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t a = base + s * STAGE, bar = smem_u32(&full[s]);
    mbar_arrive_expect_tx(bar, STAGE);  // out-of-bounds parts count too
    tma_load_2d(a, &map_a, kt * kWgBK, m0, bar);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h)
      tma_load_2d(a + A_BYTES + h * W_BOX, &map_w, n0 + h * 64, kt * kWgBK, bar);
  };
  if (tid == 0)
    for (int kt = 0; kt < kStages && kt < ktiles; ++kt) load_stage(kt);

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t a = base + s * STAGE + wg * (64 * 128);  // this warpgroup's slab
    const uint32_t w = base + s * STAGE + A_BYTES;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_acc(d[i]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < kWgBK / 16; ++j) {
      // A: k16 step = 32 bytes along the swizzled row; 8-row groups 1024 B
      // apart.  W: k16 step = 16 rows of 128 B; 8-k groups 1024 B apart,
      // 64-column boxes W_BOX apart.
      wgmma_bf16<BN>(d, sw128_desc(a + j * 32, 16, 1024),
                     sw128_desc(w + j * 2048, W_BOX, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_acc(d[i]);
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && kt + kStages < ktiles) load_stage(kt + kStages);
  }

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w + lane/4 (+8); d[4j + 2i + c] is column 8j + 2(lane%4) + c
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (out_f32) {
        float* crow = static_cast<float*>(C) + (size_t)r * n_store;
        if (c + 1 < n_store && n_store % 2 == 0) {
          *reinterpret_cast<float2*>(crow + c) = make_float2(v0, v1);
        } else {
          if (c < n_store) crow[c] = v0;
          if (c + 1 < n_store) crow[c + 1] = v1;
        }
      } else if (c < n_store) {  // scratch: n_store is a multiple of 8
        __nv_bfloat16* crow = static_cast<__nv_bfloat16*>(C) + (size_t)r * n_store;
        *reinterpret_cast<__nv_bfloat162*>(crow + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---- the score: one warp a row ----------------------------------------------

constexpr int kRowdotWarps = 8;

template <typename D, bool BIAS>
__global__ void __launch_bounds__(kRowdotWarps * 32)
rowdot(const D* __restrict__ H, const D* __restrict__ W, const float* __restrict__ bias,
       float* __restrict__ out, int M, int K, int N) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kRowdotWarps + threadIdx.x / 32;
  if (row >= M) return;
  const D* h = H + row * K;
  float acc[kRowdotMaxN];
#pragma unroll
  for (int n = 0; n < kRowdotMaxN; ++n) acc[n] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float hv = to_f(h[k]);
#pragma unroll
    for (int n = 0; n < kRowdotMaxN; ++n)
      if (n < N) acc[n] = fmaf(hv, to_f(W[(size_t)k * N + n]), acc[n]);
  }
#pragma unroll
  for (int n = 0; n < kRowdotMaxN; ++n) {
    if (n >= N) break;
    float v = acc[n];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if constexpr (BIAS) v = __fadd_rn(v, __ldg(bias + n));
    if (lane == 0) out[row * N + n] = v;
  }
}

// ---- host side --------------------------------------------------------------

struct Layer {
  int kind, bm, bn, k, n, n_store;
};

// Raises a kernel's dynamic shared-memory limit to `bytes`, once per
// device: `done` holds one bit a device, per kernel instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (__atomic_load_n(&done, __ATOMIC_RELAXED) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELAXED);
  return err;
}

inline dim3 product_grid(const Layer& p, int64_t B) {
  return dim3((unsigned)((p.n + p.bn - 1) / p.bn), (unsigned)((B + p.bm - 1) / p.bm));
}

template <typename D, bool BIAS>
cudaError_t launch_rowdot(const Layer& p, const void* in, const void* w, const float* bias,
                          void* out, int64_t B, cudaStream_t st) {
  if (p.n < 1 || p.n > kRowdotMaxN) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kRowdotWarps - 1) / kRowdotWarps);
  rowdot<D, BIAS><<<blocks, kRowdotWarps * 32, 0, st>>>(
      static_cast<const D*>(in), static_cast<const D*>(w), bias, static_cast<float*>(out),
      (int)B, p.k, p.n);
  return cudaGetLastError();
}

template <int BM, int BN, bool BIAS>
cudaError_t launch_ffma(const Layer& p, const void* in, const void* w, const float* bias,
                        void* out, int64_t B, int relu, cudaStream_t st) {
  constexpr int smem = ffma_smem<BM, BN>();
  static_assert(smem <= kSmemMax, "fp32 tile ring does not fit shared memory");
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(ffma_product<BM, BN, BIAS>, smem, smem_set);
  if (err != cudaSuccess) return err;
  ffma_product<BM, BN, BIAS><<<product_grid(p, B), kFfmaThreads, smem, st>>>(
      static_cast<const float*>(in), static_cast<const float*>(w), bias,
      static_cast<float*>(out), (int)B, p.k, p.n, p.n_store, relu);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_ffma_bias(const Layer& p, const void* in, const void* w, const float* bias,
                             void* out, int64_t B, int relu, cudaStream_t st) {
  return bias ? launch_ffma<BM, BN, true>(p, in, w, bias, out, B, relu, st)
              : launch_ffma<BM, BN, false>(p, in, w, nullptr, out, B, relu, st);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda on the link line)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 matrix [outer][inner], boxes of [box_outer][64], 128-byte
// swizzle, zeros outside
bool bf16_map(CUtensorMap* map, const void* ptr, int64_t inner, int64_t outer,
              int box_outer) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgBK, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t launch_wgmma(const Layer& p, const void* in, const void* w, void* out,
                         int64_t B, int relu, int last, cudaStream_t st) {
  CUtensorMap map_a, map_w;
  if (!bf16_map(&map_a, in, p.k, B, BM) || !bf16_map(&map_w, w, p.n, p.k, kWgBK))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem<BM, BN>();
  static_assert(smem <= kSmemMax, "bf16 tile ring does not fit shared memory");
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(wgmma_product<BM, BN>, smem, smem_set);
  if (err != cudaSuccess) return err;
  wgmma_product<BM, BN><<<product_grid(p, B), BM * 2, smem, st>>>(
      map_a, map_w, out, (int)B, p.k, p.n_store, relu, last);
  return cudaGetLastError();
}

// bias: the layer's fp32 bias [n], or null for none (bfloat16 takes none)
template <typename D>
cudaError_t launch_product(const Layer& p, const void* in, const void* w, const float* bias,
                           void* out, int64_t B, int relu, int last, cudaStream_t st);

template <>
cudaError_t launch_product<float>(const Layer& p, const void* in, const void* w,
                                  const float* bias, void* out, int64_t B, int relu, int,
                                  cudaStream_t st) {
  if (p.bm == 128 && p.bn == 128)
    return launch_ffma_bias<128, 128>(p, in, w, bias, out, B, relu, st);
  if (p.bm == 64 && p.bn == 128)
    return launch_ffma_bias<64, 128>(p, in, w, bias, out, B, relu, st);
  if (p.bm == 64 && p.bn == 64) return launch_ffma_bias<64, 64>(p, in, w, bias, out, B, relu, st);
  return cudaErrorInvalidValue;
}

template <>
cudaError_t launch_product<__nv_bfloat16>(const Layer& p, const void* in, const void* w,
                                          const float* bias, void* out, int64_t B, int relu,
                                          int last, cudaStream_t st) {
  if (bias != nullptr) return cudaErrorInvalidValue;
  if (p.bm == 128 && p.bn == 128)
    return launch_wgmma<128, 128>(p, in, w, out, B, relu, last, st);
  if (p.bm == 64 && p.bn == 128)
    return launch_wgmma<64, 128>(p, in, w, out, B, relu, last, st);
  if (p.bm == 64 && p.bn == 64) return launch_wgmma<64, 64>(p, in, w, out, B, relu, last, st);
  return cudaErrorInvalidValue;
}

template <typename D>
cudaError_t fused_mlp(int n_layers, const void* const* in, const void* const* w,
                      const void* const* biases, void* const* out, const int* plan, int64_t B,
                      int relu, int relu_last, cudaStream_t st) {
  const int align = 16 / (int)sizeof(D);
  if (n_layers < 1 || B < 1 || B > INT32_MAX || (B + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    const int* q = plan + kPlanInts * l;
    const Layer p{q[0], q[1], q[2], q[3], q[4], q[5]};
    const int last = l == n_layers - 1;
    const float* bias = biases ? static_cast<const float*>(biases[l]) : nullptr;
    cudaError_t err;
    if (p.kind == kRowdot && last && !relu_last && (bias == nullptr || sizeof(D) == 4)) {
      err = bias ? launch_rowdot<D, true>(p, in[l], w[l], bias, out[l], B, st)
                 : launch_rowdot<D, false>(p, in[l], w[l], nullptr, out[l], B, st);
    } else if (p.kind == kProduct && p.k % align == 0 && p.n % align == 0 &&
               p.n_store <= p.n) {
      err = launch_product<D>(p, in[l], w[l], bias, out[l], B, relu && (!last || relu_last),
                              last, st);
    } else {
      err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// n_layers launches on `stream`: layer l reads in[l] ([B, K_l]), its padded
// weight w[l] ([K_l, N_l]) and, where biases is not null, its fp32 bias
// biases[l] ([N_l], zero-padded; float32 only), and writes out[l] (scratch in
// D, or the fp32 output of the last layer).  plan: kPlanInts ints a layer
// (mlp_plan).  relu: ReLU after every layer but the last; relu_last: after
// the last too (a product, never a row-dot).
extern "C" int fr_fused_mlp_f32(int n_layers, const void* const* in,
                                const void* const* w, const void* const* biases,
                                void* const* out, const int* plan, int64_t B, int relu,
                                int relu_last, void* stream) {
  return (int)fused_mlp<float>(n_layers, in, w, biases, out, plan, B, relu, relu_last,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int fr_fused_mlp_bf16(int n_layers, const void* const* in,
                                 const void* const* w, const void* const* biases,
                                 void* const* out, const int* plan, int64_t B, int relu,
                                 int relu_last, void* stream) {
  return (int)fused_mlp<__nv_bfloat16>(n_layers, in, w, biases, out, plan, B, relu,
                                       relu_last, static_cast<cudaStream_t>(stream));
}
