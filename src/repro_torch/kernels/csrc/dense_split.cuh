// Split-K, event-driven fp32 accumulate of the dense spike layers, shared by
// the spike GEMM (spike_gemm.cu) and the fused GEMM+LIF step
// (spike_gemm_fused.cu).
//
// What bounds a dense spike layer on the H100.  M is the batch (64 rows on
// net-5) and K is large (fc1: K = 32,768, N = 512), so the least work is
// streaming W once (64 MiB, about 20 us at 3.35 TB/s; a plain float4
// stream of it reaches 2.9 TB/s, 23 us).  The operations, counted only on
// nonzero spikes, are 2 * nnz * N (fc1 at 18% firing: about 0.39 GFLOP,
// 6 us at 67 TFLOP/s fp32); a dense FMA loop over all of K is 2.1 GFLOP,
// 32 us, more than the bytes.  So the kernel has to (1) fill the card with
// a (64, 512) output, (2) keep the memory busy while it sums, and (3) skip
// zero spikes one by one.  What it cannot shrink is shared memory: each
// spike reads its row of W, kCols floats, from shared memory, 4 bytes per
// FMA, a quarter of the FMA rate; at fc1's traffic that is about as long
// as the stream, and the two overlap.
//
// (1) Split K.  One block owns kRows = 64 rows of M (two 32-row flag rows),
//     kCols = 256 columns of N and one contiguous split of whole 32-deep
//     slabs of K (one flag column each).  The host picks the number of
//     splits (kernels/spike_gemm.py:split_plan) so that about one wave of
//     blocks runs: fc1 is 2 column tiles x 64 splits = 128 blocks, and a
//     layer of a few slabs takes a split a slab (fc2: 16), since a block
//     sums its slabs one after another and the reduction costs less.  Each
//     split writes its (M, N) partial sums to a workspace, and a second
//     kernel adds splits 0, 1, ... in that order: no atomics, so every
//     output is the same bytes on every call.  With one split the block
//     writes the result itself.
// (2) A producer warp and a ring.  A slab (W: 32 x 256 fp32 = 32 KiB, S:
//     64 x 32 = 8 KiB) streams through kStages stages in shared memory.
//     One producer warp fills them: one thread sends tensor-memory-
//     accelerator copies (a W tile, and each 32-row half of S whose flag
//     is 1) of each operand whose rows are whole float4s, and the warp's
//     lanes copy the other operand's floats with cp.async; the stage's
//     "full" mbarrier completes when they land.  A
//     slab whose two flags are 0 is never loaded.  The kWarps consumer
//     warps wait on "full", sum, and arrive on the stage's "empty" barrier,
//     which the producer waits on before it refills the stage.  There is
//     no barrier across the block, so a warp whose rows spike often in one
//     slab holds up no other warp, and the copies run ahead of the sums.
// (3) The paper's PENC in the block.  For each of its rows a warp reads
//     the slab's 32 spikes (one per lane) and __ballot_sync(s != 0) gives a
//     32-bit mask; the lanes that hold a spike write (s, k) to the warp's
//     list at their rank in the mask.  Then the warp walks each row's list:
//     every lane owns two float4s of a W row in shared memory and does
//     acc = fmaf(s, W[k][c], acc).  The list is the same for the whole warp,
//     so nothing diverges, and the work is the spikes' (about 18% of K at
//     fc1).  Multiplying by the spike value keeps the function S @ W for any
//     S, as the TPU kernel's jnp.dot is.
//
// The tile, the stages and the warps were chosen on the H100 (PERF.md §6):
// a 128-column tile reads S from L2 twice as often and pays the per-row
// ballot twice as often; shared memory caps the stages (3 x 40 KiB); fewer
// warps hide less latency.  A block's time grows with its slabs whatever
// the layer's N, since the list walk is bound by shared memory; a layer
// narrower than the tile reads only the float4s of W inside N.
//
// Order of the sums.  Each output is summed over its split in ascending k,
// then the splits are added in ascending order: on operands whose partial
// sums are exact in fp32 (spikes and weights on a 2^-12 grid) the result
// equals any other order's bit for bit; otherwise it differs from one
// sequential chain by rounding only.
//
// Why no tensor cores.  At M = 64 the event-driven loop needs about 6 us of
// fp32 FMAs against about 22 us of bytes, so the bytes set the pace.
// wgmma takes bf16 or TF32, so an exact fp32 product needs W split into
// three bf16 parts: three times the operations, dense over K (no skipping
// of single spikes), and a different rounding.  At density 1.0 this loop
// does the dense 2.1 GFLOP and is bound by operations; that is allowed.
//
// The flags are the kernels' (BM, BK) occupancy flags of S from
// ops.block_flags, the same that dW reads in the backward.
//
// A cell axis.  A DSE slab trains C cells of one shape at once
// (distributed/cellstack.py), each with its own W.  S, W, the flags, the
// workspace and the output then lead with a cell axis, and the cell is the
// outermost grid index: blockIdx.z = cell * splits + split.  Each cell runs
// the solo shape's plan (split_plan of (M, N, K), never of C*M), so its
// arithmetic is the solo launch's instruction for instruction, and one
// launch serves the whole slab.  The tensor maps are 3-D, cells outermost;
// a solo call is the slab of one cell.
#pragma once

#include <cuda.h>                     // CUtensorMap; the encoder comes from
#include <cuda_runtime.h>             // the runtime, so nothing links libcuda
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#if !defined(BM) || !defined(BK) || !defined(DENSE_COLS)
#error "compile with -DBM=<rows> -DBK=<depth> -DDENSE_COLS=<cols> (build.py)"
#endif

namespace dense {

constexpr int kRows = 2 * BM;           // rows of M a block owns: 2 flag rows
constexpr int kCols = DENSE_COLS;       // columns of N: 32 lanes x kQuads
constexpr int kQuads = kCols / 128;     // float4s of columns a lane owns
constexpr int kSlab = BK;               // depth of a slab: one flag column
constexpr int kWarps = 16;              // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kRowsPerWarp = kRows / kWarps;  // warp w: rows w + kWarps*i
constexpr int kStages = 3;             // stages of the copy ring
static_assert(kSlab == 32, "a slab's spikes of one row are one warp ballot");
static_assert(kRows % kWarps == 0, "the warps must share the rows evenly");
static_assert(kStages >= 2, "the ring needs a stage in flight");
static_assert(kCols % 128 == 0, "a lane owns whole float4s of columns");

struct Stage {
  float w[kSlab][kCols];                // W rows k0.., columns n0..
  float s[kRows][kSlab];                // S rows m0.., columns k0..
};

struct Smem {
  Stage stage[kStages];
  float2 list[kWarps][kRowsPerWarp][kSlab];  // (spike, k) per warp and row
  unsigned long long full[kStages];     // mbarrier: the stage has landed
  unsigned long long empty[kStages];    // mbarrier: every warp is done
};

constexpr size_t kSmemBytes = sizeof(Smem);

// Tensor maps of S (boxes of BM rows x one slab) and W (one slab x kCols),
// 3-D with the cell outermost (boxes one cell deep),
// each used only where its flag says the operand takes tensor copies
// (rows of whole float4s from a 16-byte aligned base; host_maps).
struct Maps {
  CUtensorMap s, w;
  int tma_s, tma_w;
};

// A stage's full barrier counts one arrival a slab from the producer lane
// that sends tensor copies, and one from every producer lane once its
// cp.asyncs land, where an operand takes those.
__device__ __forceinline__ unsigned arrivals(const Maps& maps) {
  return (maps.tma_s || maps.tma_w ? 1u : 0u) +
         (maps.tma_s && maps.tma_w ? 0u : 32u);
}

// ---- copies and barriers -----------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The tensor memory accelerator: the box of `map` at (c0, c1) of cell c2,
// inner coordinate first, to shared memory, counted on the barrier;
// elements outside the cell's matrix arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"((unsigned long long)map), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// The tensor map (a __grid_constant__ parameter) into the cache.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// One float, counted on the thread's cp.asyncs.
__device__ __forceinline__ void cp_async4(void* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}


// The barrier counts one arrival of this thread once its cp.asyncs land.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// ---- the block's share of the product ----------------------------------
struct Tile {
  int cell;                             // the cell of the slab
  int m0, n0;                           // first row of M, first column of N
  int kt_end;                           // one past the split's last slab
  const int* f0;                        // flag row of rows m0 .. m0+BM-1
  const int* f1;                        // of rows m0+BM ..; null past M
};

// The first slab at or after kt whose flags are not both 0 (kt_end if none).
// Every thread computes the same, so the block never diverges on it.
__device__ __forceinline__ int next_active(const Tile& t, int kt) {
  while (kt < t.kt_end && t.f0[kt] == 0 && (t.f1 == nullptr || t.f1[kt] == 0))
    ++kt;
  return kt;
}

// What of slab kt holds data: its depth inside K, and the rows of each
// 32-row half inside M whose flag is 1 (0 rows where it is 0).
struct Slab {
  int k0, depth, rows0, rows1;
};

__device__ __forceinline__ Slab slab_of(const Tile& t, int M, int K, int kt) {
  Slab sl;
  sl.k0 = kt * kSlab;
  sl.depth = min(kSlab, K - sl.k0);
  sl.rows0 = t.f0[kt] != 0 ? min(BM, M - t.m0) : 0;
  sl.rows1 = t.f1 != nullptr && t.f1[kt] != 0 ? min(BM, M - t.m0 - BM) : 0;
  return sl;
}

// The producer warp starts the copies of slab kt into `st`; `bar`
// completes when they land.  An operand that takes tensor copies gets them
// from lane 0: the W tile, and each 32-row half of S whose flag is 1.
// Otherwise the 32 lanes copy the same rows with 4-byte cp.asyncs.  Either
// way the rest of the stage keeps what it held: accumulate_slab reads only
// the rows and depth the slab holds, and columns past N are never stored.
// S and W are the cell's own (accumulate offsets them); the tensor maps
// take the cell as their third coordinate.
__device__ __forceinline__ void issue_slab(const float* __restrict__ S,
                                           const float* __restrict__ W,
                                           const Maps& maps, int M, int N,
                                           int K, const Tile& t, int kt,
                                           Stage& st,
                                           unsigned long long* bar) {
  const int lane = threadIdx.x % 32;
  const Slab sl = slab_of(t, M, K, kt);
  if ((maps.tma_s || maps.tma_w) && lane == 0) {
    const unsigned half = sizeof(st.s) / 2;
    mbar_expect_tx(bar, (maps.tma_w ? (unsigned)sizeof(st.w) : 0u) +
                            (maps.tma_s ? half * ((sl.rows0 > 0) +
                                                  (sl.rows1 > 0))
                                        : 0u));
    // the stage was last read through the generic proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (maps.tma_w)
      tma_load(&st.w[0][0], &maps.w, t.n0, sl.k0, t.cell, bar);
    if (maps.tma_s && sl.rows0)
      tma_load(&st.s[0][0], &maps.s, sl.k0, t.m0, t.cell, bar);
    if (maps.tma_s && sl.rows1)
      tma_load(&st.s[BM][0], &maps.s, sl.k0, t.m0 + BM, t.cell, bar);
  }
  if (maps.tma_s && maps.tma_w) return;
  if (!maps.tma_s) {
    for (int e = lane; e < (sl.rows0 + sl.rows1) * sl.depth; e += 32) {
      const int i = e / sl.depth, c = e % sl.depth;
      const int r = i < sl.rows0 ? i : BM + i - sl.rows0;
      cp_async4(&st.s[r][c], S + (size_t)(t.m0 + r) * K + sl.k0 + c);
    }
  }
  if (!maps.tma_w) {
    const int w_cols = min(kCols, N - t.n0);
    for (int e = lane; e < sl.depth * w_cols; e += 32) {
      const int r = e / w_cols, c = e % w_cols;
      cp_async4(&st.w[r][c], W + (size_t)(sl.k0 + r) * N + t.n0 + c);
    }
  }
  cp_async_arrive(bar);
}

// The ballot of row r's spikes in the slab (bit k: S[m0 + r][k0 + k] != 0)
// and its spike on this lane (0 past the slab).
__device__ __forceinline__ unsigned row_spikes(const Stage& st,
                                               const Slab& sl, int r,
                                               float& s) {
  const int lane = threadIdx.x % 32;
  const bool live = r < (r < BM ? sl.rows0 : BM + sl.rows1);
  s = live && lane < sl.depth ? st.s[r][lane] : 0.0f;
  return __ballot_sync(0xffffffffu, s != 0.0f);
}

__device__ __forceinline__ void fma4(float s, const float4& w, float4& acc) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// One slab: each row's spikes compacted to the warp's list (the spike and
// its k, at the spike's rank in the row's ballot), then each row's list
// walked in order.
__device__ __forceinline__ void accumulate_slab(
    const Stage& st, const Slab& sl, int cols,
    float2 (&list)[kRowsPerWarp][kSlab],
    float4 (&acc)[kRowsPerWarp][kQuads]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int count[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float s;
    const unsigned mask = row_spikes(st, sl, warp + kWarps * i, s);
    count[i] = __popc(mask);
    if (s != 0.0f)
      list[i][__popc(mask & ((1u << lane) - 1u))] =
          make_float2(s, __int_as_float(lane));
  }
  __syncwarp();
  // lane's float4 q of W row k: columns 128*q + 4*lane .. +3, read only
  // where they start inside the tile's `cols` columns of N
  const float4* w4 = reinterpret_cast<const float4*>(&st.w[0][0]) + lane;
  bool inside[kQuads];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) inside[q] = 128 * q + 4 * lane < cols;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll 4
    for (int j = 0; j < count[i]; ++j) {
      const float2 e = list[i][j];
      const float4* row = w4 + __float_as_int(e.y) * (kCols / 4);
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        if (inside[q]) fma4(e.x, row[32 * q], acc[i][q]);
    }
  }
}

// Block (x: row tile, y: column tile, z: cell * splits + split) sums the
// cell's S @ W over its split's slabs.  The producer warp walks the active
// slabs and fills the ring; each consumer warp walks them too, waits for a
// stage to land, sums its rows of it into acc and frees it, with no barrier
// across the block, so a warp with many spikes in one slab holds up no
// other warp.  Returns false on
// the producer warp; on a consumer warp acc[i][q] holds row
// m0 + warp + kWarps*i, columns n0 + 128*q + 4*lane .. +3 (see row_of /
// col_of).
__device__ __forceinline__ bool accumulate(
    const float* __restrict__ S, const float* __restrict__ W,
    const Maps& maps, const int* __restrict__ flags, int M, int N, int K,
    int splits, int slabs_per_split, Smem& sm,
    float4 (&acc)[kRowsPerWarp][kQuads]) {
  const int kt_count = (K + kSlab - 1) / kSlab;
  const int flag_rows = (M + BM - 1) / BM;
  const int fr = 2 * (int)blockIdx.x;
  const int cell = (int)blockIdx.z / splits;
  const int kt_begin = ((int)blockIdx.z - cell * splits) * slabs_per_split;
  const int warp = threadIdx.x / 32;
  S += (size_t)cell * M * K;
  W += (size_t)cell * K * N;
  flags += (size_t)cell * flag_rows * kt_count;
  Tile t;
  t.cell = cell;
  t.m0 = (int)blockIdx.x * kRows;
  t.n0 = (int)blockIdx.y * kCols;
  t.kt_end = min(kt_count, kt_begin + slabs_per_split);
  t.f0 = flags + (size_t)fr * kt_count;
  t.f1 = fr + 1 < flag_rows ? t.f0 + kt_count : nullptr;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kStages; ++p) {
      mbar_init(&sm.full[p], arrivals(maps));
      mbar_init(&sm.empty[p], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {                 // the producer
    if (threadIdx.x % 32 == 0) {        // fetch the maps while flags load
      if (maps.tma_s) prefetch_map(&maps.s);
      if (maps.tma_w) prefetch_map(&maps.w);
    }
    int i = 0;
    for (int kt = next_active(t, kt_begin); kt < t.kt_end;
         kt = next_active(t, kt + 1), ++i) {
      const int p = i % kStages;
      if (i >= kStages)                 // the stage's last slab is summed
        mbar_wait(&sm.empty[p], (unsigned)(i / kStages - 1) & 1u);
      issue_slab(S, W, maps, M, N, K, t, kt, sm.stage[p], &sm.full[p]);
    }
    return false;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      acc[r][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 (&list)[kRowsPerWarp][kSlab] = sm.list[warp];
  int i = 0;
  for (int kt = next_active(t, kt_begin); kt < t.kt_end;
       kt = next_active(t, kt + 1), ++i) {
    const int p = i % kStages;
    mbar_wait(&sm.full[p], (unsigned)(i / kStages) & 1u);
    const Slab sl = slab_of(t, M, K, kt);
    accumulate_slab(sm.stage[p], sl, min(kCols, N - t.n0), list, acc);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[p]);
  }
  return true;
}

__device__ __forceinline__ int row_of(int i) {
  return (int)blockIdx.x * kRows + (int)threadIdx.x / 32 + kWarps * i;
}

__device__ __forceinline__ int col_of(int q, int j) {
  return (int)blockIdx.y * kCols + 128 * q + 4 * ((int)threadIdx.x % 32) + j;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// acc to dst[M][N] (the output, or this split's slice of the workspace),
// a float4 at a time where N is whole float4s.
__device__ __forceinline__ void store(
    float* __restrict__ dst, int M, int N,
    const float4 (&acc)[kRowsPerWarp][kQuads]) {
  const bool vec = (N & 3) == 0 && ((uintptr_t)dst & 15u) == 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row_of(i);
    if (r >= M) continue;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int c = col_of(q, 0);
      if (c >= N) continue;
      float* out = dst + (size_t)r * N + c;
      if (vec) {
        *reinterpret_cast<float4*>(out) = acc[i][q];
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < N) out[j] = lane_of(acc[i][q], j);
    }
  }
}

// Where a split block's sums go: its cell's output with one split, else
// its split's slice of the (cells, splits, M, N) workspace.
__device__ __forceinline__ float* split_dst(float* out, float* part, int M,
                                            int N, int splits) {
  const size_t mn = (size_t)M * N;
  if (splits == 1) return out + (size_t)blockIdx.z * mn;   // z = cell
  return part + (size_t)blockIdx.z * mn;   // z = cell * splits + split
}

// Sum of the splits' partials of output idx, in ascending split order.
__device__ __forceinline__ float sum_splits(const float* __restrict__ part,
                                            int splits, size_t mn,
                                            size_t idx) {
  float sum = part[idx];
  for (int p = 1; p < splits; ++p) sum = __fadd_rn(sum, part[p * mn + idx]);
  return sum;
}

// A row-major fp32 matrix with `cols` columns takes tensor copies when its
// rows are whole float4s from a 16-byte aligned base.
static inline bool tma_ok(const void* base, int cols) {
  return cols > 0 && cols % 4 == 0 && ((uintptr_t)base & 15u) == 0;
}

static inline dim3 grid(int cells, int M, int N, int splits) {
  return dim3((unsigned)((M + kRows - 1) / kRows),
              (unsigned)((N + kCols - 1) / kCols),
              (unsigned)(cells * splits));
}

// The tensor map of `cells` row-major fp32 (rows, cols) matrices, one
// after another, cut into (box_rows, box_cols) boxes one cell deep.  A map
// holds only the address, the shape and the box, so maps are kept in a
// small cache and reused while a slab lives at the same address with the
// same shape (the model's weights at every time step): encoding one costs
// host time on every call otherwise.  The encoder is libcuda's
// cuTensorMapEncodeTiled, found through the runtime.
static inline cudaError_t tensor_map(CUtensorMap* map, const void* base,
                                     int cells, int rows, int cols,
                                     int box_rows, int box_cols) {
  struct Entry {
    const void* base;
    int cells, rows, cols, box_rows, box_cols;
    CUtensorMap map;
  };
  static std::mutex lock;
  static Entry cache[16];
  static int next = 0;
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache) {
    if (e.base == base && e.cells == cells && e.rows == rows &&
        e.cols == cols && e.box_rows == box_rows && e.box_cols == box_cols) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = (decltype(&cuTensorMapEncodeTiled))fn;
  }
  // a cell's matrix is whole float4 rows (tma_ok), so its byte size, the
  // cell stride, is a multiple of 16 as the encoder requires
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)cells};
  const cuuint64_t stride[2] = {(cuuint64_t)cols * sizeof(float),
                                (cuuint64_t)rows * cols * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  Entry& e = cache[next];
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dims,
             stride, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.base = nullptr;
    return cudaErrorInvalidValue;
  }
  e.base = base;
  e.cells = cells;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  e.box_cols = box_cols;
  next = (next + 1) % 16;
  *map = e.map;
  return cudaSuccess;
}

// The kernel's Maps: a tensor map for each operand that takes them.
static inline cudaError_t host_maps(Maps* maps, const void* S, const void* W,
                                   int cells, int M, int N, int K) {
  *maps = Maps{};
  maps->tma_s = tma_ok(S, K);
  maps->tma_w = tma_ok(W, N) && K > 0;
  cudaError_t err = cudaSuccess;
  if (maps->tma_s) err = tensor_map(&maps->s, S, cells, M, K, BM, kSlab);
  if (err == cudaSuccess && maps->tma_w)
    err = tensor_map(&maps->w, W, cells, K, N, kSlab, kCols);
  return err;
}

// The kernel's dynamic shared memory above 48 KiB, allowed once a device
// (a template on the kernel itself, so each kernel keeps its own record).
template <auto kKernel>
static inline cudaError_t allow_smem() {
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && allowed[device])) return err;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess && device < 64) allowed[device] = true;
  return err;
}

}  // namespace dense
