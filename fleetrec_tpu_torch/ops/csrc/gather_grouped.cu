// Grouped row gather: out[i] = table[idx[i]], each row landing in a staged
// output block through an asynchronous copy that is tracked per group.
//
// Replaces the Pallas kernel fleetrec_tpu/ops/gather_pallas.py::
// gather_rows_grouped (_gather_grouped_kernel): one row DMA per id, straight
// into the output block, `group` rows sharing one DMA semaphore, `window`
// groups in flight.  Here the semaphores are mbarriers in shared memory and
// the DMAs are asynchronous copies:
//
// * One block owns one output block of `chunk` rows, staged in shared
//   memory (row j at slot j).  Group g (rows g*group .. g*group+group-1)
//   completes on mbarrier g % window, and group g+window is started only
//   after group g's phase has completed, so `window` groups stay in flight
//   and each barrier slot's phase parity is (g / window) & 1.
// * Bulk path (row bytes, table and out 16-byte aligned): thread 0 starts
//   one 1-D bulk copy per row (cp.async.bulk ... mbarrier::complete_tx),
//   the TPU's one-descriptor-per-row DMA, after arming the group's barrier
//   with the bytes of the rows it really copies.
// * Granule path (any other row): every thread starts 8- or 4-byte
//   cp.async copies of the group's rows and then arrives on the group's
//   barrier when its own copies land (cp.async.mbarrier.arrive.noinc);
//   2- and 1-byte rows are copied with plain loads and a plain arrive.
// * Then the block writes its rows to `out` with coalesced stores.
//
// An id outside [0, R), -1 included, starts no copy, adds no bytes to its
// group's expected count, and gives a zero row.  Offsets are int64.  The
// last block holds fewer than `chunk` rows; nothing is padded.  A row too
// wide for shared memory is gathered in column slabs (grid.y), one row per
// block.  The wrapper (ops/gather.py::grouped_launch_params) picks chunk,
// group, window and the slab width so that smem_bytes() fits in 227 KB.
//
// What bounds it: bytes from device memory, as for gather_rows.cu, but only
// when enough blocks share an SM.  A block's loads and its store do not
// overlap, and one thread walks its groups one wait at a time, so a block
// that fills shared memory (hundreds of 512-byte rows) leaves the SM idle
// between phases; small chunks run near gather_rows' rate (PERF.md has the
// measured sweep).  A ring of `window` staged groups, with stores
// overlapping loads, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 128;
constexpr int64_t kBarBytes = kMaxWindow * 8;
constexpr int64_t kSmemMax = 232448;  // shared memory one block may use on sm_90

__host__ __device__ inline int64_t round_up(int64_t x, int64_t m) {
  return (x + m - 1) / m * m;
}

// barriers | ids (int64 per row) | staged rows (chunk x seg bytes)
__host__ __device__ inline int64_t smem_bytes(int chunk, int seg) {
  return kBarBytes + round_up(8 * (int64_t)chunk, 128) + (int64_t)chunk * seg;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst), "l"(src), "n"(V)
               : "memory");
}

// arrives on `bar` once every cp.async this thread started so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

struct Block {
  const unsigned char* table;
  unsigned char* stage;  // staged rows, stride seg
  const int64_t* ids;    // in-range id or -1, per staged row
  uint64_t* bars;
  int64_t row_bytes;
  int64_t col0;  // this slab's first byte within a row
  int bytes;     // this slab's bytes per row
  int seg;       // staged row stride
  int rows;      // rows of this block
  int group;
  int window;
};

// Start group g's copies onto barrier g % window.
template <typename W, bool kBulk>
__device__ __forceinline__ void start_group(const Block& b, int g) {
  const uint32_t bar = smem_addr(&b.bars[g % b.window]);
  const int j0 = g * b.group;
  const int n = min(b.group, b.rows - j0);
  if constexpr (kBulk) {
    if (threadIdx.x != 0) return;
    uint32_t tx = 0;
    for (int k = 0; k < n; ++k) tx += b.ids[j0 + k] >= 0 ? (uint32_t)b.bytes : 0u;
    // armed before the copies: the phase completes when all `tx` bytes landed
    mbar_arrive_expect_tx(bar, tx);
    for (int k = 0; k < n; ++k) {
      const int64_t id = b.ids[j0 + k];
      if (id >= 0)
        bulk_copy(smem_addr(b.stage + (int64_t)(j0 + k) * b.seg),
                  b.table + id * b.row_bytes + b.col0, (uint32_t)b.bytes, bar);
    }
  } else {
    const int words = b.bytes / (int)sizeof(W);
    for (int u = threadIdx.x; u < n * words; u += blockDim.x) {
      const int k = u / words;
      const int w = u - k * words;
      const int64_t id = b.ids[j0 + k];
      if (id < 0) continue;
      const W* src = reinterpret_cast<const W*>(b.table + id * b.row_bytes + b.col0) + w;
      W* dst = reinterpret_cast<W*>(b.stage + (int64_t)(j0 + k) * b.seg) + w;
      if constexpr (sizeof(W) >= 4) {
        cp_async<sizeof(W)>(smem_addr(dst), src);
      } else {
        *dst = *src;
      }
    }
    // every thread arrives once per group, copies or not
    if constexpr (sizeof(W) >= 4) {
      cp_async_arrive(bar);
    } else {
      mbar_arrive(bar);
    }
  }
}

template <typename W, bool kBulk>
__global__ void __launch_bounds__(kThreads)
    gather_grouped_kernel(const unsigned char* __restrict__ table,
                          const int64_t* __restrict__ idx, unsigned char* __restrict__ out,
                          int64_t R, int64_t N, int64_t row_bytes, int chunk, int group,
                          int window, int seg) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block b;
  b.bars = reinterpret_cast<uint64_t*>(smem);
  int64_t* ids = reinterpret_cast<int64_t*>(smem + kBarBytes);
  b.ids = ids;
  b.stage = smem + kBarBytes + round_up(8 * (int64_t)chunk, 128);
  b.table = table;
  b.row_bytes = row_bytes;
  b.col0 = (int64_t)blockIdx.y * seg;
  b.bytes = (int)min((int64_t)seg, row_bytes - b.col0);
  b.seg = seg;
  b.group = group;
  b.window = window;
  const int64_t base = (int64_t)blockIdx.x * chunk;
  b.rows = (int)min((int64_t)chunk, N - base);
  const int n_groups = (b.rows + group - 1) / group;

  for (int j = threadIdx.x; j < b.rows; j += blockDim.x) {
    const int64_t id = idx[base + j];
    ids[j] = (id >= 0 && id < R) ? id : -1;
  }
  if (threadIdx.x == 0) {
    for (int w = 0; w < window; ++w)
      mbar_init(smem_addr(&b.bars[w]), kBulk ? 1u : (uint32_t)blockDim.x);
    fence_barrier_init();
  }
  __syncthreads();

  const int warm = min(window, n_groups);
  for (int g = 0; g < warm; ++g) start_group<W, kBulk>(b, g);
  // Bulk: only the issuing thread walks the groups.  Granule: every thread
  // does, and none can miss a phase, since a slot's next phase needs its
  // own arrival.
  if (!kBulk || threadIdx.x == 0) {
    for (int g = 0; g < n_groups; ++g) {
      mbar_wait(smem_addr(&b.bars[g % window]), (uint32_t)((g / window) & 1));
      if (g + window < n_groups) start_group<W, kBulk>(b, g + window);
    }
  }
  __syncthreads();
  if constexpr (kBulk) {
    // each thread observes the last phase of every slot (all complete by
    // now) so that the bulk copies' bytes are visible to it
    for (int w = 0; w < warm; ++w) {
      const int last = w + (n_groups - 1 - w) / window * window;
      mbar_wait(smem_addr(&b.bars[w]), (uint32_t)((last / window) & 1));
    }
  }

  const int words = b.bytes / (int)sizeof(W);
  const int total = b.rows * words;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int j = u / words;
    const int w = u - j * words;
    W v{};
    if (ids[j] >= 0) v = reinterpret_cast<const W*>(b.stage + (int64_t)j * seg)[w];
    reinterpret_cast<W*>(out + (base + j) * row_bytes + b.col0)[w] = v;
  }
}

template <typename W, bool kBulk>
cudaError_t launch(const void* table, const int64_t* idx, void* out, int64_t R, int64_t N,
                   int64_t row_bytes, int chunk, int group, int window, int seg,
                   cudaStream_t stream) {
  const int64_t smem = smem_bytes(chunk, seg);
  cudaError_t err = cudaFuncSetAttribute(gather_grouped_kernel<W, kBulk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + chunk - 1) / chunk),
                  (unsigned)((row_bytes + seg - 1) / seg));
  gather_grouped_kernel<W, kBulk><<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const unsigned char*>(table), idx, static_cast<unsigned char*>(out), R, N,
      row_bytes, chunk, group, window, seg);
  return cudaGetLastError();
}

}  // namespace

// granule: 16 selects the bulk path (row bytes, table and out 16-byte
// aligned); 8 / 4 the cp.async path; 2 / 1 plain loads.
extern "C" int fr_gather_rows_grouped(const void* table, const void* idx, void* out,
                                      int64_t R, int64_t N, int64_t row_bytes, int chunk,
                                      int group, int window, int seg, int granule,
                                      void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  const bool ok = N >= 1 && row_bytes >= 1 && chunk >= 1 && group >= 1 &&
                  chunk % group == 0 && window >= 1 && window <= kMaxWindow &&
                  window <= chunk / group && seg >= 1 &&
                  (granule == 1 || granule == 2 || granule == 4 || granule == 8 ||
                   granule == 16) &&
                  row_bytes % granule == 0 && seg % granule == 0 && a % granule == 0 &&
                  (seg >= row_bytes || chunk == 1) && smem_bytes(chunk, seg) <= kSmemMax &&
                  (N + chunk - 1) / chunk <= 0x7fffffff;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int64_t* ids = static_cast<const int64_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (granule) {
    case 16:
      return (int)launch<uint4, true>(table, ids, out, R, N, row_bytes, chunk, group, window,
                                      seg, s);
    case 8:
      return (int)launch<uint2, false>(table, ids, out, R, N, row_bytes, chunk, group, window,
                                       seg, s);
    case 4:
      return (int)launch<uint32_t, false>(table, ids, out, R, N, row_bytes, chunk, group,
                                          window, seg, s);
    case 2:
      return (int)launch<uint16_t, false>(table, ids, out, R, N, row_bytes, chunk, group,
                                          window, seg, s);
    default:
      return (int)launch<uint8_t, false>(table, ids, out, R, N, row_bytes, chunk, group,
                                         window, seg, s);
  }
}
