// The whole index-mode lookup in one launch: config-order ids [B, T] -> the
// features [B, F] of lookup_concat(packed, plan_indices(ids), dense) and the
// [B] bad-row flags of take_bad_rows.
//
// Replaces, on the main path, the TPU kernel
// fleetrec_tpu/ops/gather_pallas.py::gather_rows (kernel (a), one row DMA a
// lookup; the port's gather_rows.cu, once a tier) together with the XLA ops
// the JAX package runs around its lookups: FleetRecModel.plan_indices
// (fleetrec_tpu/models/fleetrec.py:86, the QR split and the column
// permutation), take_phys_sub and take_bad_rows
// (fleetrec_tpu/models/embedding.py:453, :475), and lookup_concat's int8
// dequant, concat, apply_qr_sums, dense tail and feature_perm take
// (fleetrec_tpu/models/embedding.py:531-628).  models/embedding.py::
// lookup_tensors lays out what it reads: one descriptor row a plan column
// (which id column and QR split, which buffer, base row, row limit, rows per
// physical row, width, scale) and 8 bytes an output column (its plan column
// and offset within the row, the QR remainder column added to it, or the
// dense tail, or a zero; and whether the 4 or 8 output columns it starts can
// move as one 16-byte word).  The buffers' pointers arrive by value at every
// launch, so a model whose buffers move keeps working.
//
// What bounds it: bytes from device memory, once the work per output element
// is small.  Each output element is one element of a randomly placed table
// row (16-128 bytes on the paper geometries' rows) and one coalesced store;
// the ids are read once.  The model1 forward used to spend ~0.13 ms in 15
// torch kernels around seven ~2 us gathers; here the id arithmetic, the row
// offsets, the dequant, the QR sums and the layout are register work inside
// the one launch.  Moved an element at a time, the instructions around each
// element and not the bytes set the time (model3's 16.3M int8 elements took
// nearly as long with every id 0 as with random ids), so the output moves in
// 16-byte chunks where it can.  Then random rows set it: model3's 1.5M
// reads of 16-32 bytes cost about as much again as the same kernel with
// every id 0 (PERF.md).
//
// Design.  A block walks tiles of `rows` batch rows (grid-stride).  It stages
// the output columns' descriptors and the plan columns in shared memory once.
// Per tile, pass 1 gives one thread each (row, plan column): it reads the id,
// splits it for QR, range-checks it, computes the row's address (int64: a
// take buffer can pass 2^31 elements) and keeps it in shared memory, null
// for a zero row; a take id out of range sets its row's flag.  Pass 2 walks
// the tile's output in order.  Where every row of the output is 16-byte
// aligned (F a multiple of kV, the 4 float32 or 8 bfloat16 columns of 16
// bytes, and every buffer aligned), it moves chunks of kV columns: a chunk
// that is one aligned run of one table row (or of the dense row, or zeros)
// is one vector load (16 bytes; 4 for int8 rows) and one 16-byte store, so a
// warp stores 512 neighbouring bytes; another chunk goes element by element.
// A thread loads kUnroll chunks before it stores them.  Otherwise (criteo's
// 845 bfloat16 columns) pass 2 goes element by element, kUnrollOne loads in
// flight a thread.  int8 dequantizes as float(q) * scale (a power of two:
// exact); a QR sum adds in float and rounds once to the output type, as
// `emb += ...` does; the dense tail rounds to the output type to nearest
// even.  No atomics, no memset: every output element and flag is written
// once.
//
// The bag kernel (lookup_bags_kernel, entry point fr_lookup_fused_bags) is the
// same lookup for pooled bags, config-order ids [B, T, L] with a negative id
// as padding: the features of pooled_lookup_concat(packed, plan_bags(ids),
// dense, mean) and the flags of pooled_bad_rows, the port of
// fleetrec_tpu/models/pooled.py, over the same descriptors.  One rule fixes
// its arithmetic (ops/lookup.py::lookup_fused_bags_plain follows it to the
// bit).  For each output element, walk the slots l = 0 .. L-1 in order.  A
// slot whose source id is negative, or whose id after the QR split is not in
// [0, lim), adds nothing; the second kind still counts as a member of the bag
// and, on a take column, flags the row.  The first slot that adds starts the
// sum with its element widened to float (float(q) * scale for int8); each
// later one is added in float.  A bag in which no slot adds gives +0.  For
// mean pooling the sum is multiplied by inv, the float 1 / count of the
// column's non-negative slots (0 for an empty bag).  A QR quotient column
// then adds its remainder column's pooled (and mean-scaled) value in float,
// and the result is rounded once to the output type.  Every product and sum
// is an _rn intrinsic, so none is contracted into a fused multiply-add.  L = 1
// with no negative id gives the single-id kernel's bits.
//
// What bounds it: instruction issue and latency, not bytes.  Its first form
// (a thread each (row, plan column, slot) writing an 8-byte row address, a
// pass over every slot of every output chunk, padding included) ran at
// 0.17-0.29 of its byte bound and took 0.73-0.82 of its random-id time with
// every id 0 (PERF.md).  So the work a member costs is cut and its latency
// overlapped.  A persistent block walks tiles of `rows` batch rows.  A tile's
// ids are one contiguous run; one thread brings it into a ring of `stages`
// slots in shared memory by a bulk async copy (cp.async.bulk, completion on an
// mbarrier) of its 16-byte aligned body, and warp 0 loads the few ids at its
// unaligned ends, so the next tiles' ids arrive while this one is pooled.
// Pass 1 gives a thread each bag (row, plan column): it reads the bag's L ids
// from the ring in slot order and writes one record, the number of members
// that add, the mean's 1 / count (its own count of members: no shared-memory
// atomics) and the 4-byte row number in the column's buffer of each member
// that adds, in slot order (the buffer and the row width come from the
// column).  Padding, out-of-range ids and take rows outside the window are
// left out of the list.  Pass 2 walks the tile's output in order, in runs of
// one row of one column: a thread reads its bag's record once, issues every
// member's load of its run (up to kSlots in flight) before the first add, sums
// from the first member in slot order, and stores 16-byte words.  int8 rows
// whose 16 (8) output columns are one aligned run of one row move 16 (8)
// bytes a member and store 64 (32) bytes; the runs are derived from the
// descriptors while staging.  Lists and flags are double-buffered, so a tile
// costs one block barrier, and the first tiles' ids are fetched before the
// descriptors are staged.  On an H100 the kernel is bound by the SMs' rate of
// scattered row loads (PERF.md): staging the members' loads in shared memory
// by cp.async, and several runs' loads in flight a thread, were measured and
// were no faster.  L is an argument, bounded by shared memory (ids
// and records grow with it: ops/lookup.py::bags_plan).
//
// The ragged bag kernel (lookup_ragged_kernel, entry point
// fr_lookup_ragged_bags) is the bag kernel over bags of different sizes, as
// MLPerf's DLRM-DCNv2 sends them (1 to 100 members a table, 214 ids a query):
// int32 ids [B, n_ids], each table's bag one run of ids [runs[t], runs[t +
// 1]) of a row, tables in config order.  The ids stay as they came: no bag
// is padded to the longest (padding DCNv2's to L = 100 would move 2,600 id
// slots a query to serve 214).  Both kernels run one body: staging gives each
// plan column where its bag starts in a row of ids and its member count, and
// pass 1 walks that run; L is the longest bag (the records' size).  The
// uniform kernel's runs are [t * L, (t + 1) * L).  Its arithmetic is the bag
// kernel's rule, so a ragged call on bags of one size gives the bag kernel's
// bits.
//
// The row window (row_lo, rows_local) is the two forward kernels' form for one
// model shard of the sharded forward (parallel/sharded.py, the port of
// fleetrec_tpu/parallel/sharded.py:177-261 and :312-414): the take buffer
// passed is rows [row_lo, row_lo + rows_local) of the padded whole, and a take
// id whose physical row falls outside them reads a zero row (in a bag: adds
// nothing).  The window never flags a row: the flags come from the ids and the
// global row limits, the same on every shard.  The whole buffer is (0,
// INT64_MAX), which is what a single-device lookup passes.
//
// The backward kernel (lookup_backward_kernel, entry point
// fr_lookup_fused_backward) is the single-id kernel's gradient for training:
// it walks the same descriptors and adds the features' cotangent into float32
// gradient buffers laid out as the packed buffers.  What bounds it is the
// reductions into device memory and their contention on small class tables,
// so it issues as few as the descriptors allow (see the kernel): one pass
// over the batch's (row, 4 output columns) units, adding 4 columns that are
// one aligned word of one row as one 16-byte reduction.  It takes the same
// row window, for one model shard's step of the sharded training
// (parallel/sharded.py::ShardedFleetRec.train_step): its take gradient buffer
// is the shard's rows_local rows, and a take row outside the window adds
// nothing (an unwindowed add there would land past the end of the buffer);
// the shard's class columns of other shards' tables (lim = 0) add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ops/lookup.py::LOOKUP_COL_FIELDS
enum { kSrc, kOp, kRem, kKind, kBuf, kBase, kLim, kS, kDim, kScale, kColFields };
enum { kOpNone = 0, kOpDiv = 1, kOpMod = 2 };
enum { kClass = 0, kTake = 1 };
constexpr int kPosDense = -2;  // ops/lookup.py::POS_DENSE (POS_ZERO is -1)
// ops/lookup.py::VEC4 / VEC8 / OFF_MASK: an output column's offset word
// holds whether the 4 (8) columns it starts move as one word
constexpr int kVec4 = 1 << 30, kVec8 = 1 << 29, kOffMask = (1 << 29) - 1;
constexpr int kMaxBufs = 16;   // ops/lookup.py::MAX_BUFS
constexpr int kThreads = 256;
constexpr int kUnroll = 2;     // 16-byte chunks a thread loads before it stores
constexpr int kUnrollOne = 4;  // elements, when the output moves element by element
// ops/lookup.py::SMEM_BYTES: a block's 227 KB less 1 KB for the static
// s_buf / s_sc (the two limits are summed)
constexpr int kSmemMax = 232448 - 1024;

struct Buffers {
  const void* ptr[kMaxBufs];
  const float* scale[kMaxBufs];
};

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

template <int Bytes>
struct Word;
template <>
struct Word<1> {
  using T = unsigned char;
};
template <>
struct Word<2> {
  using T = unsigned short;
};
template <>
struct Word<16> {
  using T = int4;
};
template <>
struct Word<8> {
  using T = int2;
};
template <>
struct Word<4> {
  using T = int;
};

// N values of T that move as one word.
template <typename T, int N>
struct Vec {
  using W = typename Word<sizeof(T) * N>::T;
  union {
    W w;
    T v[N];
  };
};

// Storage type -> how an element is read (Raw), summed and written (Out,
// as its bits: bfloat16 output is written as unsigned short).
template <typename TS>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float;
  using Out = float;
  __device__ static Out value(Raw r, float) { return r; }
  __device__ static Out add(Raw a, Raw b, float, float) { return __fadd_rn(a, b); }
  __device__ static Out dense(float d) { return d; }
  __device__ static float widen(Raw r, float) { return r; }
  __device__ static Out round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  using Out = unsigned short;
  __device__ static Out value(Raw r, float) { return r; }
  __device__ static Out add(Raw a, Raw b, float, float) {
    return __bfloat16_as_ushort(
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)),
                                      __bfloat162float(__ushort_as_bfloat16(b)))));
  }
  __device__ static Out dense(float d) { return __bfloat16_as_ushort(__float2bfloat16_rn(d)); }
  __device__ static float widen(Raw r, float) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Out round(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
};

template <>
struct Elem<int8_t> {
  using Raw = signed char;
  using Out = float;
  __device__ static Out value(Raw r, float s) { return __fmul_rn((float)r, s); }
  __device__ static Out add(Raw a, Raw b, float sa, float sb) {
    return __fadd_rn(__fmul_rn((float)a, sa), __fmul_rn((float)b, sb));
  }
  __device__ static Out dense(float d) { return d; }
  __device__ static float widen(Raw r, float s) { return __fmul_rn((float)r, s); }
  __device__ static Out round(float x) { return x; }
};

// element o of a row, or 0 for a zero row (null)
template <typename Raw>
__device__ __forceinline__ Raw load1(const void* row, int o) {
  return row ? __ldg(static_cast<const Raw*>(row) + o) : Raw(0);
}

// elements o .. o + N - 1 of a row as one word, or zeros for a zero row
template <typename Raw, int N>
__device__ __forceinline__ Vec<Raw, N> loadn(const void* row, int o) {
  using W = typename Vec<Raw, N>::W;
  Vec<Raw, N> x;
  x.w = row ? __ldg(reinterpret_cast<const W*>(static_cast<const Raw*>(row) + o)) : W{};
  return x;
}

// A plan column as pass 1 reads it, staged in shared memory once a block.
struct Col {
  int64_t base;    // first row of the table (class) or its physical base (take)
  int32_t lim;     // ids in [0, lim) read a row
  int32_t src;     // the config-order id column
  int32_t rem;     // the QR split's divisor (op != kOpNone)
  int32_t s;       // logical rows per physical row (take)
  int32_t dim;     // the row's width
  float scale;     // int8 dequant scale (1 for float storage)
  int16_t op, take;
  int16_t buf;
  int16_t count;   // the bag kernels': the members of the column's bag (else 0)
};
static_assert(sizeof(Col) == 40, "Col is 40 bytes (ops/lookup.py::smem_bytes)");

__host__ __device__ constexpr int smem_bytes(int F, int n_plan, int rows) {
  // ops/lookup.py::smem_bytes: the output columns' descriptors (8 B), the
  // plan columns (Col), a row address a (row, plan column), a flag a row
  return 8 * F + (int)sizeof(Col) * n_plan + 8 * rows * n_plan + 4 * rows;
}

// A bag's record in shared memory (ops/lookup.py::bag_record_words): the
// number of members that add, the mean's 1 / count, up to L row numbers; an
// odd number of words, so that neighbouring threads write to other banks.
__host__ __device__ constexpr int bag_record_words(int L) { return (L + 2) | 1; }

// Bytes of one ring slot: a tile's ids (row_ids a batch row) and the 16-byte
// lines its ends share with the neighbouring tiles.
__host__ __device__ constexpr int64_t ring_slot_bytes(int rows, int64_t row_ids, int id_bytes) {
  return ((int64_t)rows * row_ids * id_bytes + 15) / 16 * 16 + 32;
}

// row_ids: ids a batch row (T * L, or the ragged kernel's sum of the bags);
// L: the most members a bag has
__host__ __device__ constexpr int64_t smem_bytes_bags(int n_pos, int n_plan, int rows,
                                                      int64_t row_ids, int L, int id_bytes,
                                                      int stages) {
  // ops/lookup.py::bag_smem_bytes: a mbarrier a ring slot (16-byte
  // aligned), the ring, n_pos staged output descriptors (8 B), the plan
  // columns, two buffers of a record a (row, plan column) and of a flag a row
  return (8 * (int64_t)stages + 15) / 16 * 16 + stages * ring_slot_bytes(rows, row_ids, id_bytes) +
         8 * (int64_t)n_pos + (int64_t)sizeof(Col) * n_plan +
         8 * (int64_t)rows * n_plan * bag_record_words(L) + 8 * (int64_t)rows;
}

// Thread 0 stages the buffers' pointers and scales.
__device__ __forceinline__ void stage_buffers(const Buffers& bufs, const void** s_buf,
                                              const float** s_sc) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxBufs; ++i) {
      s_buf[i] = bufs.ptr[i];
      s_sc[i] = bufs.scale[i];
    }
  }
}

// Stages the plan columns (after a barrier that follows stage_buffers).
__device__ __forceinline__ void stage_cols(const int64_t* __restrict__ cols, int n_plan,
                                           Col* s_col, const float* const* s_sc) {
  for (int k = threadIdx.x; k < n_plan; k += kThreads) {
    const int64_t* c = cols + (int64_t)k * kColFields;
    const float* sc = s_sc[c[kBuf]];
    Col col;
    col.base = c[kBase];
    col.lim = (int32_t)c[kLim];
    col.src = (int32_t)c[kSrc];
    col.rem = (int32_t)c[kRem];
    col.s = (int32_t)c[kS];
    col.dim = (int32_t)c[kDim];
    col.scale = sc ? sc[c[kScale]] : 1.f;
    col.op = (int16_t)c[kOp];
    col.take = c[kKind] == kTake;
    col.buf = (int16_t)c[kBuf];
    col.count = 0;
    s_col[k] = col;
  }
}

// Stages the buffers' pointers, the output columns' descriptors and the plan
// columns in shared memory; the caller synchronizes before it reads s_col.
__device__ __forceinline__ void stage(const Buffers& bufs, const int64_t* __restrict__ cols,
                                      const int2* __restrict__ pos, int n_plan, int F,
                                      int2* s_pos, Col* s_col, const void** s_buf,
                                      const float** s_sc) {
  stage_buffers(bufs, s_buf, s_sc);
#pragma unroll 4
  for (int p = threadIdx.x; p < F; p += kThreads) s_pos[p] = __ldg(pos + p);
  __syncthreads();
  stage_cols(cols, n_plan, s_col, s_sc);
}

// The address of the row plan column c reads for the id x in [0, lim) (int64
// offsets: a take buffer can pass 2^31 elements), or null for a take row
// outside the window [row_lo, row_lo + rows_local) of physical rows.
template <typename TS>
__device__ __forceinline__ const void* row_address(const Col& c, uint32_t x,
                                                   const void* const* s_buf, uint32_t S,
                                                   int64_t stripe_height, int64_t row_lo,
                                                   int64_t rows_local) {
  int64_t flat;
  if (c.take) {
    const uint32_t s = (uint32_t)c.s;
    const uint32_t p = x / s, sub = x - p * s;
    const int64_t phys =
        c.base + (S > 1 ? (int64_t)(p % S) * stripe_height + p / S : (int64_t)p) - row_lo;
    if ((uint64_t)phys >= (uint64_t)rows_local) return nullptr;  // another shard's row
    flat = phys * s + sub;
  } else {
    flat = c.base + x;
  }
  return static_cast<const TS*>(s_buf[c.buf]) + flat * c.dim;
}

// output column e of one batch row: its plan column's element (dequantized,
// with the QR remainder's added), its dense element, or 0
template <typename E>
__device__ __forceinline__ typename E::Out element(const void* const* rp, const Col* s_col,
                                                   int2 e, const float* dense_row) {
  using Raw = typename E::Raw;
  const int col = (short)(e.x & 0xFFFF), add = e.x >> 16;  // low half sign-extended
  const int o = e.y & kOffMask;
  if (col >= 0) {
    const Raw a = load1<Raw>(rp[col], o);
    return add >= 0 ? E::add(a, load1<Raw>(rp[add], o), s_col[col].scale, s_col[add].scale)
                    : E::value(a, s_col[col].scale);
  }
  if (col == kPosDense) return E::dense(__ldg(dense_row + o));
  return typename E::Out(0);
}

// VEC: pass 2 moves 16-byte chunks (every output row 16-byte aligned)
template <typename TS, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads)
    lookup_fused_kernel(Buffers bufs, const I* __restrict__ ids,
                        const float* __restrict__ dense, const int64_t* __restrict__ cols,
                        const int2* __restrict__ pos, typename Elem<TS>::Out* __restrict__ out,
                        bool* __restrict__ bad, int B, int T, int n_plan, int F, int dense_dim,
                        int rows, int64_t stripes, int64_t stripe_height, int64_t row_lo,
                        int64_t rows_local) {
  using E = Elem<TS>;
  using Out = typename E::Out;
  using Raw = typename E::Raw;
  constexpr int kV = 16 / sizeof(Out);  // output columns a 16-byte chunk
  constexpr int kVecBit = kV == 4 ? kVec4 : kVec8;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pos = reinterpret_cast<int2*>(smem);
  Col* s_col = reinterpret_cast<Col*>(s_pos + F);
  const void** s_row = reinterpret_cast<const void**>(s_col + n_plan);
  int* s_bad = reinterpret_cast<int*>(s_row + rows * n_plan);
  __shared__ const void* s_buf[kMaxBufs];
  __shared__ const float* s_sc[kMaxBufs];

  stage(bufs, cols, pos, n_plan, F, s_pos, s_col, s_buf, s_sc);
  const uint32_t S = (uint32_t)stripes;
  const int tiles = (B + rows - 1) / rows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * rows;
    const int nr = min(rows, B - b0);
    __syncthreads();  // s_col is staged; the last tile is done with s_row, s_bad
    for (int r = threadIdx.x; r < nr; r += kThreads) s_bad[r] = 0;
    __syncthreads();

    // pass 1: a row address a (row, plan column); flags of bad take ids
    const I* tile_ids = ids + (int64_t)b0 * T;
#pragma unroll 2
    for (int u = threadIdx.x; u < nr * n_plan; u += kThreads) {
      const int r = u / n_plan;
      const Col& c = s_col[u - r * n_plan];
      int64_t id = (int64_t)tile_ids[(int64_t)r * T + c.src];
      if (c.op == kOpDiv) id = floor_div(id, c.rem);
      else if (c.op == kOpMod) id = floor_mod(id, c.rem);
      const void* row = nullptr;
      if (id >= 0 && id < c.lim) {  // then 0 <= id < 2^31
        row = row_address<TS>(c, (uint32_t)id, s_buf, S, stripe_height, row_lo, rows_local);
      } else if (c.take) {
        s_bad[r] = 1;
      }
      s_row[u] = row;
    }
    __syncthreads();
    if (bad != nullptr)
      for (int r = threadIdx.x; r < nr; r += kThreads) bad[b0 + r] = s_bad[r] != 0;

    // pass 2: the tile's output in order, a few loads in flight a thread
    Out* tile_out = out + (int64_t)b0 * F;
    const float* tile_dense = dense + (int64_t)b0 * dense_dim;
    if constexpr (VEC) {  // chunks of kV columns, kUnroll loaded before a store
      const int chunks = F / kV, total = nr * chunks;
      for (int u0 = threadIdx.x; u0 < total; u0 += kThreads * kUnroll) {
        int2 q[kUnroll];
        bool whole[kUnroll];
        Vec<Raw, kV> a[kUnroll], b[kUnroll];
        float4 d[kUnroll][kV / 4];  // a run of the dense row
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int u = u0 + j * kThreads;
          whole[j] = false;
          if (u < total) {
            const int r = u / chunks;
            q[j] = s_pos[(u - r * chunks) * kV];
            whole[j] = q[j].y & kVecBit;
            if (whole[j]) {  // one aligned run: load it as words now
              const int col = (short)(q[j].x & 0xFFFF), add = q[j].x >> 16;
              const int o = q[j].y & kOffMask;
              const void* const* rp = s_row + r * n_plan;
              if (col >= 0) {
                a[j] = loadn<Raw, kV>(rp[col], o);
                if (add >= 0) b[j] = loadn<Raw, kV>(rp[add], o);
              } else if (col == kPosDense) {
                const float4* run = reinterpret_cast<const float4*>(
                    tile_dense + (int64_t)r * dense_dim + o);
#pragma unroll
                for (int h = 0; h < kV / 4; ++h) d[j][h] = __ldg(run + h);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int u = u0 + j * kThreads;
          if (u >= total) continue;
          const int r = u / chunks;
          const int p0 = (u - r * chunks) * kV;
          Out* dst = tile_out + (int64_t)r * F + p0;
          if (whole[j]) {
            const int col = (short)(q[j].x & 0xFFFF), add = q[j].x >> 16;
            const float* dv = reinterpret_cast<const float*>(d[j]);
            Vec<Out, kV> v;
#pragma unroll
            for (int i = 0; i < kV; ++i) {
              if (col >= 0)
                v.v[i] = add >= 0 ? E::add(a[j].v[i], b[j].v[i], s_col[col].scale,
                                           s_col[add].scale)
                                  : E::value(a[j].v[i], s_col[col].scale);
              else if (col == kPosDense)
                v.v[i] = E::dense(dv[i]);
              else
                v.v[i] = Out(0);
            }
            *reinterpret_cast<int4*>(dst) = v.w;
          } else {
            for (int i = 0; i < kV; ++i)
              dst[i] = element<E>(s_row + r * n_plan, s_col, s_pos[p0 + i],
                                  tile_dense + (int64_t)r * dense_dim);
          }
        }
      }
    } else {  // element by element, kUnrollOne elements loaded before a store
      const int total = nr * F;
      for (int u0 = threadIdx.x; u0 < total; u0 += kThreads * kUnrollOne) {
        Raw a[kUnrollOne] = {}, b[kUnrollOne] = {};
        float d[kUnrollOne] = {};
        int col[kUnrollOne], add[kUnrollOne];
#pragma unroll
        for (int j = 0; j < kUnrollOne; ++j) {
          const int u = u0 + j * kThreads;
          col[j] = add[j] = -1;
          if (u < total) {
            const int r = u / F;
            const int2 q = s_pos[u - r * F];
            col[j] = (short)(q.x & 0xFFFF);
            add[j] = q.x >> 16;
            const int o = q.y & kOffMask;
            const void* const* rp = s_row + r * n_plan;
            if (col[j] >= 0) {
              a[j] = load1<Raw>(rp[col[j]], o);
              if (add[j] >= 0) b[j] = load1<Raw>(rp[add[j]], o);
            } else if (col[j] == kPosDense) {
              d[j] = __ldg(tile_dense + (int64_t)r * dense_dim + o);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kUnrollOne; ++j) {
          const int u = u0 + j * kThreads;
          if (u >= total) continue;
          Out v;
          if (col[j] >= 0)
            v = add[j] >= 0 ? E::add(a[j], b[j], s_col[col[j]].scale, s_col[add[j]].scale)
                            : E::value(a[j], s_col[col[j]].scale);
          else if (col[j] == kPosDense)
            v = E::dense(d[j]);
          else
            v = Out(0);
          tile_out[u] = v;
        }
      }
    }
  }
}

// ---- the bag kernel ---------------------------------------------------------

// The staged output descriptors of the bag kernel (VEC): one a chunk of kV
// output columns, its offset word holding, instead of the layout's VEC bits,
// the kernel's own runs: kVecBit (the chunk is one aligned run of one source)
// and, where a row moves 4 bytes a chunk (int8 storage), kRun2 / kRun4 (this
// chunk and the next 1 / 3 are one run of 2 / 4 chunks of one row, aligned to
// the run's bytes in a row whose width is a multiple of them).
constexpr int kRun2 = 1 << 29;
constexpr int kRun4 = (int)(1u << 31);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// arrives on `bar` and adds `bytes` to the transfer its phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A phase that never completes traps after ~2^26 polls instead of hanging.
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

// Brings the ids of the block's tile (its k-th) into ring slot `dst`: thread 0
// arms the slot's mbarrier and copies the run's 16-byte aligned body with one
// bulk async copy; warp 0 loads the ids at its unaligned ends.  The slot's
// byte j is the ids' byte floor16(start) + j.  Nothing past the batch is read.
template <typename I>
__device__ __forceinline__ void fetch_ids(const I* __restrict__ ids, int tile, int tiles,
                                          int rows, int B, int64_t row_ids,
                                          unsigned char* dst, uint32_t bar) {
  if (tile >= tiles || threadIdx.x >= 32) return;
  const int b0 = tile * rows;
  const uintptr_t start = reinterpret_cast<uintptr_t>(ids + (int64_t)b0 * row_ids);
  const uintptr_t end = start + (uintptr_t)min(rows, B - b0) * row_ids * sizeof(I);
  const uintptr_t base = start & ~(uintptr_t)15, lo = (start + 15) & ~(uintptr_t)15,
                  hi = end & ~(uintptr_t)15;
  const bool body = hi > lo;
  if (threadIdx.x == 0) {
    // order this block's earlier reads of the slot before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_tx(bar, body ? (uint32_t)(hi - lo) : 0u);
    if (body)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + (lo - base))),
          "l"(lo), "r"((uint32_t)(hi - lo)), "r"(bar)
          : "memory");
  }
  // the ends: [start, lo) and [hi, end), or all of a run within two lines
  const int n_head = (int)((body ? lo : end) - start) / (int)sizeof(I);
  const int n_tail = body ? (int)(end - hi) / (int)sizeof(I) : 0;
  const int e = threadIdx.x;
  if (e < n_head) {
    const uintptr_t at = start + (uintptr_t)e * sizeof(I);
    *reinterpret_cast<I*>(dst + (at - base)) = __ldg(reinterpret_cast<const I*>(at));
  } else if (e < n_head + n_tail) {
    const uintptr_t at = hi + (uintptr_t)(e - n_head) * sizeof(I);
    *reinterpret_cast<I*>(dst + (at - base)) = __ldg(reinterpret_cast<const I*>(at));
  }
}

// Whether chunks c .. c + m - 1 of the output (kV columns each) are one run of
// one source: all one aligned chunk of the same column pair, consecutive
// offsets (zeros: any), and, for a plan column, the run's start and its rows'
// width multiples of the run.
template <int kV, int kVecBit>
__device__ __forceinline__ bool is_run(const int2* __restrict__ pos,
                                       const int64_t* __restrict__ cols, int c, int m,
                                       int chunks) {
  if (c % m != 0 || c + m > chunks) return false;
  const int2 q = __ldg(pos + c * kV);
  const int col = (short)(q.x & 0xFFFF), add = q.x >> 16;
  const int o = q.y & kOffMask;
  for (int j = 0; j < m; ++j) {
    const int2 e = __ldg(pos + (c + j) * kV);
    if (!(e.y & kVecBit) || e.x != q.x) return false;
    if (col != -1 && (e.y & kOffMask) != o + j * kV) return false;  // POS_ZERO: -1
  }
  if (col < 0) return true;
  const int n = m * kV;
  return o % n == 0 && __ldg(cols + (int64_t)col * kColFields + kDim) % n == 0 &&
         (add < 0 || __ldg(cols + (int64_t)add * kColFields + kDim) % n == 0);
}

// The pooled float values of N neighbouring elements of one bag: its record
// `rec` (count, 1 / count, row numbers), the elements at `base` (the buffer
// plus the run's offset) of rows of `row_bytes`.  Every member's word is
// loaded, kSlots at a time, before the first is added; the sum starts from
// the first member and adds in slot order; +0 for no member; times 1 / count
// for the mean.
template <typename E, int N, int kSlots>
__device__ __forceinline__ void pool_bag(const uint32_t* rec, const unsigned char* base,
                                         uint32_t row_bytes, float scale, bool mean,
                                         float (&acc)[N]) {
  using Raw = typename E::Raw;
  using W = typename Vec<Raw, N>::W;
  const int n = (int)rec[0];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kSlots) {
    Vec<Raw, N> x[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (j0 + j < n)
        x[j].w = __ldg(reinterpret_cast<const W*>(base + (uint64_t)rec[2 + j0 + j] * row_bytes));
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j0 + j < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float w = E::widen(x[j].v[i], scale);
          acc[i] = j0 + j ? __fadd_rn(acc[i], w) : w;
        }
      }
    }
  }
  if (mean) {
    const float f = __uint_as_float(rec[1]);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = __fmul_rn(acc[i], f);
  }
}

// N output columns of one batch row that are one run of the descriptor word
// q: plan column col's bag pooled (its QR remainder column's added), the
// dense row's, or zeros; rounded once to the output type.  recs: the row's
// records, W words each.
template <typename TS, int N, int kSlots>
__device__ __forceinline__ void run_values(int2 q, const uint32_t* recs, int W, const Col* s_col,
                                           const void* const* s_buf, bool mean,
                                           const float* dense_row,
                                           typename Elem<TS>::Out (&v)[N]) {
  using E = Elem<TS>;
  const int col = (short)(q.x & 0xFFFF), add = q.x >> 16;  // low half sign-extended
  const int o = q.y & kOffMask;
  if (col >= 0) {
    float a[N];
    const Col& c = s_col[col];
    pool_bag<E, N, kSlots>(recs + col * W,
                           static_cast<const unsigned char*>(s_buf[c.buf]) + o * sizeof(TS),
                           (uint32_t)c.dim * sizeof(TS), c.scale, mean, a);
    if (add >= 0) {
      float b[N];
      const Col& d = s_col[add];
      pool_bag<E, N, kSlots>(recs + add * W,
                             static_cast<const unsigned char*>(s_buf[d.buf]) + o * sizeof(TS),
                             (uint32_t)d.dim * sizeof(TS), d.scale, mean, b);
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = __fadd_rn(a[i], b[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = E::round(a[i]);
  } else if (col == kPosDense) {
    if constexpr (N % 4 == 0) {
      const float4* run = reinterpret_cast<const float4*>(dense_row + o);
#pragma unroll
      for (int h = 0; h < N / 4; ++h) {
        const float4 d = __ldg(run + h);
        v[4 * h] = E::dense(d.x);
        v[4 * h + 1] = E::dense(d.y);
        v[4 * h + 2] = E::dense(d.z);
        v[4 * h + 3] = E::dense(d.w);
      }
    } else {
      v[0] = E::dense(__ldg(dense_row + o));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = typename E::Out(0);
  }
}

// A run of N output columns stored as 16-byte words at dst (N a multiple of
// the word's columns).
template <typename TS, int N, int kSlots>
__device__ __forceinline__ void store_run(int2 q, const uint32_t* recs, int W,
                                          const Col* s_col, const void* const* s_buf,
                                          bool mean, const float* dense_row,
                                          typename Elem<TS>::Out* dst) {
  using Out = typename Elem<TS>::Out;
  constexpr int kV = 16 / sizeof(Out);
  Out v[N];
  run_values<TS, N, kSlots>(q, recs, W, s_col, s_buf, mean, dense_row, v);
#pragma unroll
  for (int h = 0; h < N / kV; ++h) {
    Vec<Out, kV> w;
#pragma unroll
    for (int i = 0; i < kV; ++i) w.v[i] = v[h * kV + i];
    reinterpret_cast<int4*>(dst)[h] = w.w;
  }
}

// The two bag kernels' body: a batch row's ids are row_ids ids, config-order
// table t's bag the run of ids [runs[t], runs[t + 1]) of it (the ragged
// kernel), or, with runs null, [t * L, (t + 1) * L) (ids [B, T, L]); a
// negative id is padding; L is the most members a bag has.  VEC as above;
// kSlots: member loads in flight a thread.  Dynamic shared memory
// smem_bytes_bags: the ring's mbarriers, the ring, the staged output
// descriptors (a chunk each with VEC, else a column each), the plan columns,
// two buffers of records and of flags.
template <typename TS, typename I, bool VEC, int kSlots>
__device__ __forceinline__ void bags_body(
    const Buffers& bufs, const I* __restrict__ ids, const float* __restrict__ dense,
    const int64_t* __restrict__ cols, const int2* __restrict__ pos,
    typename Elem<TS>::Out* __restrict__ out, bool* __restrict__ bad, int B,
    const int* __restrict__ runs, int64_t row_ids, int L, int n_plan, int F, int dense_dim,
    int rows, int stages, int mean, int64_t stripes, int64_t stripe_height, int64_t row_lo,
    int64_t rows_local) {
  using E = Elem<TS>;
  using Out = typename E::Out;
  constexpr int kV = 16 / sizeof(Out);  // output columns a 16-byte chunk
  constexpr int kVecBit = kV == 4 ? kVec4 : kVec8;
  // chunks a thread's unit: 16 bytes of a row (4 chunks of int8 rows)
  constexpr int kG = VEC ? 16 / (kV * (int)sizeof(TS)) : 1;
  const int chunks = F / kV;
  const int n_pos = VEC ? chunks : F;
  const int W = bag_record_words(L);
  const int64_t slot_bytes = ring_slot_bytes(rows, row_ids, sizeof(I));
  const int tile_recs = rows * n_plan * W;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* s_ring = smem + (8 * stages + 15) / 16 * 16;
  int2* s_pos = reinterpret_cast<int2*>(s_ring + stages * slot_bytes);
  Col* s_col = reinterpret_cast<Col*>(s_pos + n_pos);
  uint32_t* s_rec = reinterpret_cast<uint32_t*>(s_col + n_plan);  // two tiles' records
  int* s_bad = reinterpret_cast<int*>(s_rec + 2 * tile_recs);     // two tiles' flags
  __shared__ const void* s_buf[kMaxBufs];
  __shared__ const float* s_sc[kMaxBufs];

  // the first tiles' ids are on their way while the descriptors are staged
  const int tiles = (B + rows - 1) / rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_addr(s_bar + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = 0; k < stages; ++k)
    fetch_ids(ids, blockIdx.x + k * gridDim.x, tiles, rows, B, row_ids, s_ring + k * slot_bytes,
              smem_addr(s_bar + k));
  stage_buffers(bufs, s_buf, s_sc);
  for (int c = threadIdx.x; c < n_pos; c += kThreads) {
    int2 q = __ldg(pos + c * (VEC ? kV : 1));
    if constexpr (VEC) {
      q.y &= kOffMask | kVecBit;
      if constexpr (kG >= 2)
        if (is_run<kV, kVecBit>(pos, cols, c, 2, chunks)) q.y |= kRun2;
      if constexpr (kG >= 4)
        if (is_run<kV, kVecBit>(pos, cols, c, 4, chunks)) q.y |= kRun4;
    }
    s_pos[c] = q;
  }
  for (int i = threadIdx.x; i < 2 * rows; i += kThreads) s_bad[i] = 0;
  __syncthreads();
  stage_cols(cols, n_plan, s_col, s_sc);
  // each column's bag: where it starts in a row of ids, and its members (the
  // thread that staged the column)
  for (int k = threadIdx.x; k < n_plan; k += kThreads) {
    Col& c = s_col[k];
    const int t = c.src;
    c.src = runs ? __ldg(runs + t) : t * L;
    c.count = (int16_t)(runs ? __ldg(runs + t + 1) - __ldg(runs + t) : L);
  }
  __syncthreads();  // s_col, and the first tiles' unaligned ends

  const uint32_t S = (uint32_t)stripes;
  const int S_sh = (S & (S - 1)) ? -1 : __ffs(S) - 1;
  // ids in 32 bits where they are int32 (the QR split of an int64 id needs 64)
  using Id = typename std::conditional<sizeof(I) == 4, int32_t, int64_t>::type;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int b0 = tile * rows;
    const int nr = min(rows, B - b0);
    const int slot = i % stages;
    unsigned char* ring = s_ring + slot * slot_bytes;
    const I* tile_ids = reinterpret_cast<const I*>(
        ring + (reinterpret_cast<uintptr_t>(ids + (int64_t)b0 * row_ids) & 15));
    uint32_t* recs = s_rec + (i & 1) * tile_recs;
    int* flags = s_bad + (i & 1) * rows;
    mbar_wait(smem_addr(s_bar + slot), (uint32_t)(i / stages) & 1);

    // pass 1: a record a bag (row, plan column); flags of bad take ids
    for (int u = threadIdx.x; u < nr * n_plan; u += kThreads) {
      const int r = u / n_plan;
      const Col& c = s_col[u - r * n_plan];
      const I* x = tile_ids + (int64_t)r * row_ids + c.src;
      const int members_max = c.count;
      uint32_t* rec = recs + u * W;
      // row_address's row number, with shifts where the divisors are powers of 2
      const uint32_t s = (uint32_t)c.s;
      const int s_sh = (s & (s - 1)) ? -1 : __ffs(s) - 1;
      int n = 0, members = 0;
      bool flag = false;
      for (int l0 = 0; l0 < members_max; l0 += 4) {
        Id v[4];  // four slots' ids read before any is used
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = l0 + j < members_max ? (Id)x[l0 + j] : Id(-1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Id id = v[j];
          if (id < 0) continue;  // padding; the QR split of an id >= 0 is >= 0
          ++members;
          if (c.op == kOpDiv) id /= c.rem;
          else if (c.op == kOpMod) id %= c.rem;
          if (id >= c.lim) {
            flag |= c.take != 0;
            continue;
          }
          const uint32_t xi = (uint32_t)id;
          int64_t flat;
          if (!c.take) {
            flat = c.base + xi;
          } else {
            const uint32_t p = s_sh >= 0 ? xi >> s_sh : xi / s;
            const uint32_t sub = xi - p * s;
            const int64_t phys =
                c.base +
                (S > 1 ? (S_sh >= 0 ? (int64_t)(p & (S - 1)) * stripe_height + (p >> S_sh)
                                    : (int64_t)(p % S) * stripe_height + p / S)
                       : (int64_t)p) -
                row_lo;
            if ((uint64_t)phys >= (uint64_t)rows_local) continue;  // another shard's row
            flat = phys * s + sub;
          }
          rec[2 + n++] = (uint32_t)flat;
        }
      }
      rec[0] = (uint32_t)n;
      if (mean) rec[1] = __float_as_uint(members ? __fdiv_rn(1.f, (float)members) : 0.f);
      if (flag) flags[r] = 1;
    }
    __syncthreads();  // the records; every thread is done with this ring slot
    fetch_ids(ids, tile + stages * gridDim.x, tiles, rows, B, row_ids, ring,
              smem_addr(s_bar + slot));
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      if (bad != nullptr) bad[b0 + r] = flags[r] != 0;
      flags[r] = 0;  // for the tile after next
    }

    // pass 2: the tile's output in order, a unit (16 bytes of a row) a thread
    Out* tile_out = out + (int64_t)b0 * F;
    const float* tile_dense = dense + (int64_t)b0 * dense_dim;
    if constexpr (VEC) {
      const int units = (chunks + kG - 1) / kG, total = nr * units;
      for (int u = threadIdx.x; u < total; u += kThreads) {
        const int r = u / units;
        const int c0 = (u - r * units) * kG;
        const int nch = min(kG, chunks - c0);
        const uint32_t* rrec = recs + r * n_plan * W;
        const float* dense_row = tile_dense + (int64_t)r * dense_dim;
        Out* dst = tile_out + (int64_t)r * F + c0 * kV;
        for (int h = 0; h < nch;) {
          const int2 q = s_pos[c0 + h];
          if constexpr (kG >= 4) {
            if (q.y & kRun4) {
              store_run<TS, 4 * kV, kSlots>(q, rrec, W, s_col, s_buf, mean, dense_row,
                                             dst + h * kV);
              h += 4;
              continue;
            }
          }
          if constexpr (kG >= 2) {
            if (q.y & kRun2) {
              store_run<TS, 2 * kV, kSlots>(q, rrec, W, s_col, s_buf, mean, dense_row,
                                             dst + h * kV);
              h += 2;
              continue;
            }
          }
          if (q.y & kVecBit) {
            store_run<TS, kV, kSlots>(q, rrec, W, s_col, s_buf, mean, dense_row, dst + h * kV);
          } else {  // element by element, from the layout's own descriptors
            for (int e = 0; e < kV; ++e) {
              Out v[1];
              run_values<TS, 1, kSlots>(__ldg(pos + (c0 + h) * kV + e), rrec, W, s_col, s_buf,
                                        mean, dense_row, v);
              dst[h * kV + e] = v[0];
            }
          }
          ++h;
        }
      }
    } else {  // element by element
      const int total = nr * F;
      for (int u = threadIdx.x; u < total; u += kThreads) {
        const int r = u / F;
        Out v[1];
        run_values<TS, 1, kSlots>(s_pos[u - r * F], recs + r * n_plan * W, W, s_col, s_buf,
                                  mean, tile_dense + (int64_t)r * dense_dim, v);
        tile_out[u] = v[0];
      }
    }
  }
}

// The bag kernel: ids [B, T, L], a negative id padding (bags_body).
template <typename TS, typename I, bool VEC, int kSlots>
__global__ void __launch_bounds__(kThreads)
    lookup_bags_kernel(Buffers bufs, const I* __restrict__ ids,
                       const float* __restrict__ dense, const int64_t* __restrict__ cols,
                       const int2* __restrict__ pos, typename Elem<TS>::Out* __restrict__ out,
                       bool* __restrict__ bad, int B, int T, int L, int n_plan, int F,
                       int dense_dim, int rows, int stages, int mean, int64_t stripes,
                       int64_t stripe_height, int64_t row_lo, int64_t rows_local) {
  bags_body<TS, I, VEC, kSlots>(bufs, ids, dense, cols, pos, out, bad, B, nullptr,
                                (int64_t)T * L, L, n_plan, F, dense_dim, rows, stages, mean,
                                stripes, stripe_height, row_lo, rows_local);
}

// The ragged bag kernel (entry point fr_lookup_ragged_bags): int32 ids
// [B, n_ids], table t's bag the ids [runs[t], runs[t + 1]) of a row (the
// wire's layout: no bag is padded to the longest), L the longest bag
// (bags_body).  A kernel of its own, so that a device trace tells it from
// the uniform bag kernel.
template <typename TS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    lookup_ragged_kernel(Buffers bufs, const int32_t* __restrict__ ids,
                         const float* __restrict__ dense, const int64_t* __restrict__ cols,
                         const int2* __restrict__ pos, typename Elem<TS>::Out* __restrict__ out,
                         bool* __restrict__ bad, int B, const int* __restrict__ runs,
                         int n_ids, int L, int n_plan, int F, int dense_dim, int rows,
                         int stages, int mean, int64_t stripes, int64_t stripe_height,
                         int64_t row_lo, int64_t rows_local) {
  bags_body<TS, int32_t, VEC, 4>(bufs, ids, dense, cols, pos, out, bad, B, runs, n_ids, L,
                                 n_plan, F, dense_dim, rows, stages, mean, stripes,
                                 stripe_height, row_lo, rows_local);
}

// The backward of the single-id kernel (entry point fr_lookup_fused_backward):
// the features' cotangent grad [B, F] float32 added into float32 gradient
// buffers laid out as the packed buffers (`grads` holds their pointers).
// Replaces XLA's VJP of lookup_concat (fleetrec_tpu/models/embedding.py:503-528,
// the transposed one-hot products; :581 and :598-599, the take and its
// mask-einsum, a scatter-add; :604, the QR sums; :616, the feature_perm take).
// Each cotangent adds into the element its output column read, and a QR
// quotient column's into its remainder column's element too; a zero or dense
// column and an id that reads no row add nothing.
//
// What bounds it: the reductions into device memory, not the bytes.  Added
// one scalar atomic a (row, column), a batch is B x F reductions (1.44M at
// model1, 13.6M at dlrm_terabyte), and a small class table's elements each
// take tens to thousands of them from blocks all over the card, which
// serialize in L2's atomic units (every add of a column of a 3-row table
// lands on 3 addresses).  So the kernel issues as few reductions as the
// descriptors allow, in one pass over the batch's (row, 4 output columns)
// units, grid-stride, with no staged row addresses and one barrier (after
// the descriptors): a unit reads its id, finds its gradient row (null for an
// id that reads no row or a take row outside the window), and where the 4
// columns are one aligned run of one row (the descriptors' kVec4 bit) loads
// them as one float4 and adds them as one 16-byte reduction
// (red.global.add.v4.f32, sm_90); other columns add element by element.
// Summing small class tables in shared memory first (a block a slab of class
// columns and a chunk of the batch, flushed once) was slower on an H100 at
// model1, model3 and dlrm_terabyte (PERF.md): a shared float add is a
// compare-and-swap loop on sm_90, and the 16-byte reductions leave the class
// tiers a small share of the time.
//
// Float sums in an order that changes from run to run (device-memory adds
// across threads and blocks): exact for integers below 2^24.  The row window
// (row_lo, rows_local) is the forward kernels': a take row another shard
// holds adds nothing here, and so does a class column the shard's
// descriptors give lim = 0 (a table another shard holds).

// Float reductions into device memory: the gradient rows' pointers come from
// shared memory, so the compiler cannot tell their address space and would
// test it at every add; these say it.  red4: one 16-byte reduction.
__device__ __forceinline__ void red4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(__cvta_generic_to_global(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void red1(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "f"(v)
               : "memory");
}

// The gradient row plan column c reads for the id x (the QR split applied),
// or null (no row, or a take row outside the window).
__device__ __forceinline__ float* grad_row(const Col& c, int64_t x, const void* const* s_buf,
                                           uint32_t S, int64_t stripe_height, int64_t row_lo,
                                           int64_t rows_local) {
  if (c.op == kOpDiv) x = floor_div(x, c.rem);
  else if (c.op == kOpMod) x = floor_mod(x, c.rem);
  if (x < 0 || x >= c.lim) return nullptr;
  return static_cast<float*>(const_cast<void*>(
      row_address<float>(c, (uint32_t)x, s_buf, S, stripe_height, row_lo, rows_local)));
}

// Output columns p0 .. p0 + n - 1 of batch row b, element by element.
template <typename I>
__device__ __forceinline__ void add_elements(const void* const* s_buf, const Col* s_col,
                                             const int2* s_pos, const I* __restrict__ ids,
                                             const float* __restrict__ grad, int64_t b, int p0,
                                             int n, int T, int F, uint32_t S,
                                             int64_t stripe_height, int64_t row_lo,
                                             int64_t rows_local) {
  for (int p = p0; p < p0 + n; ++p) {
    const int2 e = s_pos[p];
    const int col = (short)(e.x & 0xFFFF), add = e.x >> 16;  // low half sign-extended
    if (col < 0) continue;
    const int o = e.y & kOffMask;
    float* a = grad_row(s_col[col], (int64_t)ids[b * T + s_col[col].src], s_buf, S,
                        stripe_height, row_lo, rows_local);
    float* c = add >= 0 ? grad_row(s_col[add], (int64_t)ids[b * T + s_col[add].src], s_buf, S,
                                   stripe_height, row_lo, rows_local)
                        : nullptr;
    if (a == nullptr && c == nullptr) continue;
    const float v = __ldg(grad + b * F + p);
    if (a != nullptr) red1(a + o, v);
    if (c != nullptr) red1(c + o, v);
  }
}

constexpr int kAddUnroll = 4;  // units a thread loads before it adds

// Units u_first, u_first + u_step, ... of the batch's (row, chunk) units,
// row-major, so a warp's lanes take neighbouring chunks of one row and its
// cotangent loads coalesce.  VEC: a unit is 4 output columns, one float4
// load and one 16-byte reduction where the descriptors' kVec4 bit says they
// are one aligned word (else element by element); otherwise a unit is one
// column.  A thread issues kAddUnroll units' id and cotangent loads before it
// waits on any.
template <typename I, bool VEC>
__device__ __forceinline__ void add_units(const void* const* s_buf, const Col* s_col,
                                          const int2* s_pos, const I* __restrict__ ids,
                                          const float* __restrict__ grad, int B, int T, int F,
                                          uint32_t S, int64_t stripe_height, int64_t row_lo,
                                          int64_t rows_local, int u_first, int u_step) {
  constexpr int kW = VEC ? 4 : 1;  // output columns a unit
  using G = typename std::conditional<VEC, float4, float>::type;
  const int per_row = F / kW;
  // unit u is (row u / per_row, chunk u % per_row), followed without a
  // division a unit: a step moves step_b rows and step_c chunks
  const int step_b = u_step / per_row, step_c = u_step % per_row;
  int b0 = u_first / per_row, c0 = u_first % per_row;
  while (b0 < B) {
    int bj[kAddUnroll], p0[kAddUnroll], qy[kAddUnroll], ka[kAddUnroll], kc[kAddUnroll];
    I xa[kAddUnroll], xc[kAddUnroll];
    G g[kAddUnroll];
#pragma unroll
    for (int j = 0; j < kAddUnroll; ++j) {
      bj[j] = b0;
      p0[j] = c0 * kW;
      ka[j] = kc[j] = -1;
      c0 += step_c;
      b0 += step_b;
      if (c0 >= per_row) {
        c0 -= per_row;
        ++b0;
      }
      if (bj[j] >= B) {
        p0[j] = -1;
        continue;
      }
      const int2 q = s_pos[p0[j]];
      qy[j] = q.y;
      if (VEC && !(q.y & kVec4)) continue;  // element by element, below
      const int col = (short)(q.x & 0xFFFF), add = q.x >> 16;
      const int64_t row = (int64_t)bj[j] * T;
      // a column of a table another model shard holds (lim 0) reads no id
      // and no cotangent
      if (col >= 0 && s_col[col].lim > 0) {
        ka[j] = col;
        xa[j] = ids[row + s_col[col].src];
      }
      if (col >= 0 && add >= 0 && s_col[add].lim > 0) {
        kc[j] = add;
        xc[j] = ids[row + s_col[add].src];
      }
      if (ka[j] >= 0 || kc[j] >= 0)
        g[j] = __ldg(reinterpret_cast<const G*>(grad + (int64_t)bj[j] * F + p0[j]));
    }
#pragma unroll
    for (int j = 0; j < kAddUnroll; ++j) {
      if (p0[j] < 0) continue;
      if (VEC && !(qy[j] & kVec4)) {
        add_elements<I>(s_buf, s_col, s_pos, ids, grad, bj[j], p0[j], kW, T, F, S,
                        stripe_height, row_lo, rows_local);
        continue;
      }
      const int o = qy[j] & kOffMask;
      float* dst[2] = {nullptr, nullptr};
      if (ka[j] >= 0)
        dst[0] = grad_row(s_col[ka[j]], (int64_t)xa[j], s_buf, S, stripe_height, row_lo,
                          rows_local);
      if (kc[j] >= 0)
        dst[1] = grad_row(s_col[kc[j]], (int64_t)xc[j], s_buf, S, stripe_height, row_lo,
                          rows_local);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (dst[h] == nullptr) continue;
        if constexpr (VEC) red4(dst[h] + o, g[j]);
        else red1(dst[h] + o, g[j]);
      }
    }
  }
}

// Dynamic shared memory smem_bytes(F, n_plan, 0): the output columns, then
// the plan columns.
template <typename I, bool VEC>
__global__ void __launch_bounds__(kThreads)
    lookup_backward_kernel(Buffers grads, const I* __restrict__ ids,
                           const int64_t* __restrict__ cols, const int2* __restrict__ pos,
                           const float* __restrict__ grad, int B, int T, int n_plan, int F,
                           int64_t stripes, int64_t stripe_height, int64_t row_lo,
                           int64_t rows_local) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pos = reinterpret_cast<int2*>(smem);
  Col* s_col = reinterpret_cast<Col*>(s_pos + F);
  __shared__ const void* s_buf[kMaxBufs];
  __shared__ const float* s_sc[kMaxBufs];

  stage(grads, cols, pos, n_plan, F, s_pos, s_col, s_buf, s_sc);
  __syncthreads();
  add_units<I, VEC>(s_buf, s_col, s_pos, ids, grad, B, T, F, (uint32_t)stripes, stripe_height,
                    row_lo, rows_local, (int)blockIdx.x * kThreads + (int)threadIdx.x,
                    (int)gridDim.x * kThreads);
}

// Raises the kernel's dynamic shared-memory limit to the block's maximum,
// once per device: `done` holds one bit a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (__atomic_load_n(&done, __ATOMIC_RELAXED) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELAXED);
  return err;
}

struct Args {
  Buffers bufs;
  const void *ids, *dense, *cols, *pos;
  void *out, *bad;
  int B, T, n_plan, F, dense_dim, rows, grid, vec;
  int64_t stripes, stripe_height;
  int64_t row_lo, rows_local;  // the take buffer's row window
  int L, mean, stages, slots;  // the bag kernels'
  const int* runs;             // the ragged kernel's bags (null: [B, T, L])
  int n_ids;                   // the ragged kernel's ids a row
};

template <typename TS, typename I, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(lookup_fused_kernel<TS, I, VEC>, smem_set);
  if (err != cudaSuccess) return err;
  lookup_fused_kernel<TS, I, VEC><<<a.grid, kThreads, smem_bytes(a.F, a.n_plan, a.rows), st>>>(
      a.bufs, static_cast<const I*>(a.ids), static_cast<const float*>(a.dense),
      static_cast<const int64_t*>(a.cols), static_cast<const int2*>(a.pos),
      static_cast<typename Elem<TS>::Out*>(a.out), static_cast<bool*>(a.bad), a.B, a.T,
      a.n_plan, a.F, a.dense_dim, a.rows, a.stripes, a.stripe_height, a.row_lo, a.rows_local);
  return cudaGetLastError();
}

// the bag kernel's staged output descriptors: a chunk each, or a column each
int bag_pos_count(int storage, int F, int vec) { return vec ? F / (storage == 1 ? 8 : 4) : F; }

template <typename TS, typename I, bool VEC, int kSlots>
cudaError_t launch_bags(const Args& a, cudaStream_t st) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(lookup_bags_kernel<TS, I, VEC, kSlots>, smem_set);
  if (err != cudaSuccess) return err;
  const int64_t smem =
      smem_bytes_bags(VEC ? a.F / (16 / (int)sizeof(typename Elem<TS>::Out)) : a.F, a.n_plan,
                      a.rows, (int64_t)a.T * a.L, a.L, sizeof(I), a.stages);
  // a persistent grid: no more blocks than the card holds at once
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lookup_bags_kernel<TS, I, VEC, kSlots>, kThreads, smem)) != cudaSuccess)
    return err;
  const int grid = max(1, min(a.grid, per_sm * sms));
  lookup_bags_kernel<TS, I, VEC, kSlots><<<grid, kThreads, smem, st>>>(
      a.bufs, static_cast<const I*>(a.ids), static_cast<const float*>(a.dense),
      static_cast<const int64_t*>(a.cols), static_cast<const int2*>(a.pos),
      static_cast<typename Elem<TS>::Out*>(a.out), static_cast<bool*>(a.bad), a.B, a.T, a.L,
      a.n_plan, a.F, a.dense_dim, a.rows, a.stages, a.mean, a.stripes, a.stripe_height,
      a.row_lo, a.rows_local);
  return cudaGetLastError();
}

template <typename TS, bool VEC>
cudaError_t launch_ragged(const Args& a, cudaStream_t st) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(lookup_ragged_kernel<TS, VEC>, smem_set);
  if (err != cudaSuccess) return err;
  const int64_t smem =
      smem_bytes_bags(VEC ? a.F / (16 / (int)sizeof(typename Elem<TS>::Out)) : a.F, a.n_plan,
                      a.rows, a.n_ids, a.L, sizeof(int32_t), a.stages);
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lookup_ragged_kernel<TS, VEC>, kThreads, smem)) != cudaSuccess)
    return err;
  const int grid = max(1, min(a.grid, per_sm * sms));
  lookup_ragged_kernel<TS, VEC><<<grid, kThreads, smem, st>>>(
      a.bufs, static_cast<const int32_t*>(a.ids), static_cast<const float*>(a.dense),
      static_cast<const int64_t*>(a.cols), static_cast<const int2*>(a.pos),
      static_cast<typename Elem<TS>::Out*>(a.out), static_cast<bool*>(a.bad), a.B, a.runs,
      a.n_ids, a.L, a.n_plan, a.F, a.dense_dim, a.rows, a.stages, a.mean, a.stripes,
      a.stripe_height, a.row_lo, a.rows_local);
  return cudaGetLastError();
}

template <typename I, bool VEC>
cudaError_t launch_backward(const Args& a, const float* grad, cudaStream_t st) {
  static unsigned long long smem_set = 0;
  cudaError_t err = allow_smem(lookup_backward_kernel<I, VEC>, smem_set);
  if (err != cudaSuccess) return err;
  lookup_backward_kernel<I, VEC><<<a.grid, kThreads, smem_bytes(a.F, a.n_plan, 0), st>>>(
      a.bufs, static_cast<const I*>(a.ids), static_cast<const int64_t*>(a.cols),
      static_cast<const int2*>(a.pos), grad, a.B, a.T, a.n_plan, a.F, a.stripes,
      a.stripe_height, a.row_lo, a.rows_local);
  return cudaGetLastError();
}

// a.L == 0: the single-id kernel; a.runs: the ragged bag kernel (int32 ids,
// 4 member loads in flight a thread); else the bag kernel with a.slots (4 or
// 8)
template <typename TS, typename I, bool VEC>
cudaError_t launch_kind(const Args& a, cudaStream_t st) {
  if (!a.L) return launch<TS, I, VEC>(a, st);
  if (a.runs) {
    if constexpr (sizeof(I) == 4) return launch_ragged<TS, VEC>(a, st);
    return cudaErrorInvalidValue;
  }
  return a.slots == 4 ? launch_bags<TS, I, VEC, 4>(a, st) : launch_bags<TS, I, VEC, 8>(a, st);
}

template <typename TS>
cudaError_t launch_ids(int ids_64, const Args& a, cudaStream_t st) {
  if (a.vec)
    return ids_64 ? launch_kind<TS, int64_t, true>(a, st)
                  : launch_kind<TS, int32_t, true>(a, st);
  return ids_64 ? launch_kind<TS, int64_t, false>(a, st)
                : launch_kind<TS, int32_t, false>(a, st);
}

// Checks the arguments the two entry points share (L == 0: the single-id
// kernel) and launches.
int run(const void* const* bufs, const void* const* scales, int n_bufs, int storage,
        const void* ids, int ids_64, const void* dense, const void* cols, const void* pos,
        void* out, void* bad, int64_t B, int T, int n_plan, int F, int dense_dim, int rows,
        int grid, int64_t stripes, int64_t stripe_height, int vec, int64_t row_lo,
        int64_t rows_local, int L, int mean, int stages, int slots, void* stream,
        const int* runs = nullptr, int n_ids = 0) {
  const int chunk = storage == 1 ? 8 : 4;
  const int id_bytes = ids_64 ? 8 : 4;
  const int64_t row_ids = runs ? (int64_t)n_ids : (int64_t)T * L;
  if (n_bufs < 0 || n_bufs > kMaxBufs || B < 1 || B > INT32_MAX || rows < 1 || grid < 1 ||
      L < 0 || L > INT16_MAX || row_lo < 0 || rows_local < 0 ||
      (int64_t)rows * F > INT32_MAX / 2 ||
      (int64_t)rows * n_plan * (L ? bag_record_words(L) : 1) > INT32_MAX / 2 ||
      (runs && (ids_64 || slots != 4 || n_ids < 1)) ||
      (L ? smem_bytes_bags(bag_pos_count(storage, F, vec), n_plan, rows, row_ids, L, id_bytes,
                           stages)
         : smem_bytes(F, n_plan, rows)) > kSmemMax ||
      (L && (stages < 2 || stages > 8 || (slots != 4 && slots != 8) ||
             reinterpret_cast<uintptr_t>(ids) % id_bytes != 0)) ||
      stripes < 1 || (dense == nullptr && dense_dim != 0) || (vec && F % chunk != 0))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int i = 0; i < n_bufs; ++i) {
    a.bufs.ptr[i] = bufs[i];
    a.bufs.scale[i] = scales == nullptr ? nullptr : static_cast<const float*>(scales[i]);
  }
  a.ids = ids;
  a.dense = dense;
  a.cols = cols;
  a.pos = pos;
  a.out = out;
  a.bad = bad;
  a.B = (int)B;
  a.T = T;
  a.n_plan = n_plan;
  a.F = F;
  a.dense_dim = dense_dim;
  a.rows = rows;
  a.grid = grid;
  a.vec = vec;
  a.stripes = stripes;
  a.stripe_height = stripe_height;
  a.row_lo = row_lo;
  a.rows_local = rows_local;
  a.L = L;
  a.mean = mean;
  a.stages = stages;
  a.slots = slots;
  a.runs = runs;
  a.n_ids = n_ids;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return (int)launch_ids<float>(ids_64, a, st);
    case 1:
      return (int)launch_ids<__nv_bfloat16>(ids_64, a, st);
    case 2:
      return (int)launch_ids<int8_t>(ids_64, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch on `stream`.  bufs / scales: n_bufs pointers (the class buffers,
// then the take buffer; scales only for int8 storage, else null); storage: 0
// float32, 1 bfloat16, 2 int8; ids [B, T] int32 (ids_64 = 0) or int64;
// dense [B, dense_dim] float32 or null; cols / pos: lookup_tensors'
// descriptors; out [B, F] (float32 for int8 storage); bad [B] bool or null.
// rows: batch rows a tile; grid: blocks (ops/lookup.py::launch_shape); vec:
// chunks of 16 output bytes may move as words (F a multiple of the chunk,
// every buffer, dense and out 16-byte aligned); row_lo / rows_local: the take
// buffer's row window (0 / INT64_MAX: the whole buffer).
extern "C" int fr_lookup_fused(const void* const* bufs, const void* const* scales,
                               int n_bufs, int storage, const void* ids, int ids_64,
                               const void* dense, const void* cols, const void* pos,
                               void* out, void* bad, int64_t B, int T, int n_plan, int F,
                               int dense_dim, int rows, int grid, int64_t stripes,
                               int64_t stripe_height, int vec, int64_t row_lo,
                               int64_t rows_local, void* stream) {
  return run(bufs, scales, n_bufs, storage, ids, ids_64, dense, cols, pos, out, bad, B, T,
             n_plan, F, dense_dim, rows, grid, stripes, stripe_height, vec, row_lo, rows_local,
             0, 0, 0, 0, stream);
}

// The bag kernel, one launch on `stream`: fr_lookup_fused's arguments with
// ids [B, T, L] (L >= 1; a negative id is padding), mean (0: sum pooling, 1:
// mean pooling), the ring's stages (2-8) and the member loads a thread keeps
// in flight (slots: 4 or 8); rows / grid / stages / slots from
// ops/lookup.py::bags_plan.  Every row number a member list holds must be
// below 2^32 (the wrapper checks the buffers).
extern "C" int fr_lookup_fused_bags(const void* const* bufs, const void* const* scales,
                                    int n_bufs, int storage, const void* ids, int ids_64,
                                    const void* dense, const void* cols, const void* pos,
                                    void* out, void* bad, int64_t B, int T, int n_plan,
                                    int F, int dense_dim, int rows, int grid,
                                    int64_t stripes, int64_t stripe_height, int vec,
                                    int64_t row_lo, int64_t rows_local, int L, int mean,
                                    int stages, int slots, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  return run(bufs, scales, n_bufs, storage, ids, ids_64, dense, cols, pos, out, bad, B, T,
             n_plan, F, dense_dim, rows, grid, stripes, stripe_height, vec, row_lo, rows_local,
             L, mean != 0, stages, slots, stream);
}

// The ragged bag kernel, one launch on `stream`: fr_lookup_fused_bags'
// arguments with int32 ids [B, n_ids] (ids_64 must be 0), runs (int32 [T +
// 1], on the device: table t's bag is the ids [runs[t], runs[t + 1]) of a
// row, runs[T] = n_ids), L the longest bag (1 .. 32767) and slots 4.
extern "C" int fr_lookup_ragged_bags(const void* const* bufs, const void* const* scales,
                                     int n_bufs, int storage, const void* ids, int ids_64,
                                     const void* dense, const void* cols, const void* pos,
                                     void* out, void* bad, int64_t B, int T, int n_plan,
                                     int F, int dense_dim, int rows, int grid,
                                     int64_t stripes, int64_t stripe_height, int vec,
                                     int64_t row_lo, int64_t rows_local, const void* runs,
                                     int n_ids, int L, int mean, int stages, int slots,
                                     void* stream) {
  if (L < 1 || runs == nullptr) return (int)cudaErrorInvalidValue;
  return run(bufs, scales, n_bufs, storage, ids, ids_64, dense, cols, pos, out, bad, B, T,
             n_plan, F, dense_dim, rows, grid, stripes, stripe_height, vec, row_lo, rows_local,
             L, mean != 0, stages, slots, stream, static_cast<const int*>(runs), n_ids);
}

// The backward kernel, one launch on `stream`: grads, n_bufs float32 gradient
// buffers laid out as the packed buffers (the class buffers, then the take
// buffer), which it adds into; ids [B, T] int32 (ids_64 = 0) or int64; cols /
// pos: lookup_tensors' descriptors; grad [B, F] float32, the features'
// cotangent; grid from ops/lookup.py::backward_plan; vec: 16-byte loads and
// reductions (F a multiple of 4, grad and every gradient buffer 16-byte
// aligned); row_lo / rows_local: the take gradient buffer's row window (0 /
// INT64_MAX: the whole buffer).
extern "C" int fr_lookup_fused_backward(void* const* grads, int n_bufs, const void* ids,
                                        int ids_64, const void* cols, const void* pos,
                                        const void* grad, int64_t B, int T, int n_plan, int F,
                                        int grid, int vec, int64_t stripes,
                                        int64_t stripe_height, int64_t row_lo,
                                        int64_t rows_local, void* stream) {
  if (n_bufs < 1 || n_bufs > kMaxBufs || B < 1 || B > INT32_MAX || grid < 1 ||
      (int64_t)B * F > INT32_MAX / 2 || smem_bytes(F, n_plan, 0) > kSmemMax || stripes < 1 ||
      row_lo < 0 || rows_local < 0 || (vec && F % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  for (int i = 0; i < n_bufs; ++i) a.bufs.ptr[i] = grads[i];
  a.ids = ids;
  a.cols = cols;
  a.pos = pos;
  a.B = (int)B;
  a.T = T;
  a.n_plan = n_plan;
  a.F = F;
  a.grid = grid;
  a.stripes = stripes;
  a.stripe_height = stripe_height;
  a.row_lo = row_lo;
  a.rows_local = rows_local;
  const float* g = static_cast<const float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec)
    err = ids_64 ? launch_backward<int64_t, true>(a, g, st)
                 : launch_backward<int32_t, true>(a, g, st);
  else
    err = ids_64 ? launch_backward<int64_t, false>(a, g, st)
                 : launch_backward<int32_t, false>(a, g, st);
  return (int)err;
}
