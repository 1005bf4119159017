// Backward of the spike layers, the cotangent products of BPTT:
//
//   dW of a Dense layer, out = S @ W:   dW[K,N] = S[M,K]^T @ g[M,N]
//   dS of a Dense layer:                dS[M,K] = g[M,N] @ W[K,N]^T
//   dW of a Conv layer, from its NHWC input spikes x and output cotangent g:
//       dW[dy,dx,c,f] = sum over (b, oh, ow) of
//                       x_pad[b, oh*s+dy, ow*s+dx, c] * g[b,oh,ow,f]
//   dS of a Conv layer, (B, H, W, C), from g and the HWIO weights:
//       dS[b,y,x,c] = sum over taps (dy, dx) with y = oy*s + dy - pad_top,
//                     x = ox*s + dx - pad_left of
//                     sum over f of g[b,oy,ox,f] * W[dy,dx,c,f]
//
// All accumulate in fp32 with fmaf on CUDA cores; no TF32, no tensor cores.
// A zero operand adds exactly zero (fmaf(0, w, acc) is acc, and a sum that
// starts at +0 never becomes -0), so every skip below changes no result.
// No float atomics anywhere: every output has one writer and the order of
// every sum is fixed by the shapes, so two runs give the same bytes
// (deterministic training is what lets the trace cache republish a cell bit
// for bit).
//
// ---- dW of a Dense layer -------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_dw_pallas
// (_dw_kernel), which walks M as the TPU's sequential innermost grid axis
// with a VMEM accumulator.
//
// What bounds it on the H100: bytes.  M is the batch (64 rows at net-5) and
// the output is K x N (fc1: 32,768 x 512, a 64 MiB store stream, about
// 20 us at 3.35 TB/s); at fc1's 18% input spikes a column of S holds about
// 12 events, so the sums are 2 * nnz * N = 0.4 GFLOP.  The kernel is a
// store stream with an event walk on top, and the walk's bookkeeping (bit
// scans, shuffles, addresses: about 8 instructions an event) is what
// limits it unless each event feeds many FMAs:
//
// - A block of 16 warps owns 128 * f4 columns of N, all of fc1's 512
//   (f4 = 4 float4s a lane), stages g's rows of them once (64 x 512 fp32,
//   128 KiB) and walks strips of kDwK = 32 columns of K, one wave of blocks
//   over the strips.  Each strip's spikes (64 x 32) come in with cp.async,
//   rows read whole, while the last strip is walked (two buffers).
// - A warp owns 2 columns k of a strip.  For each it ballots the nonzero
//   spikes of the column (lane m holds S[m][k], 32 rows a ballot) and walks
//   the set bits in ascending m, two events a step: every lane adds
//   fmaf(S[m][k], g[m][its 4 * f4 columns], acc), g's row read as float4s
//   from shared memory, 16 FMAs an event at fc1.  A column with no event
//   costs two ballots.
// - The warp writes dW's row k once, a float4 a lane (512 bytes a warp
//   instruction).  Where M is larger than one chunk of kDwM rows the
//   chunks are staged one after another, in ascending m, with the
//   accumulators in registers.
//
// Order of the sums: one fmaf chain per output, ascending m, from 0; a
// spike of any value v adds fmaf(v, g, acc).  That is PR 12's kernel's
// order wherever it ran one split of M (net-5's fc1 among them), so there
// the result is bit for bit the same on {0,1} spikes and any g; where PR
// 12's kernel split M (fc2, fc3), the two differ by rounding on normal g.
// The forward's tile flags are not read: a tile it skipped has no events.
//
// ---- dS of a Dense layer -------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_ds_pallas
// (_ds_kernel).
//
// What bounds it on the H100: operations, then shared memory.  The
// cotangent is dense (net-5's fc1: every entry of g nonzero), so the
// product is 2 * M * K * N = 2.1 GFLOP at fc1, 32 us at 67 TFLOP/s fp32,
// against 20 us to read W (64 MiB) once.  Every FMA takes its two operands
// from shared memory through registers, and an SM's shared memory gives
// 128 bytes a clock against 128 FMAs a clock, so a lane must reuse each
// loaded value about 8 times:
//
// - The large block (fc1): 4 warps own 64 rows of M (all of net-5's batch,
//   so W is read from device memory once) and 128 columns of K, a warp
//   32 x 64 and a lane an 8 x 8 tile (rows ly + 4i, columns lx + 8j).  The
//   block walks N in chunks of kDsNc = 32 through a 3-stage cp.async ring,
//   g's and W's rows as they lie (rows of 36 floats: the 8 rows a warp's
//   load touches fall on 32 banks).  Per 4 n a lane reads its 8 rows of W
//   and, one after another, its 8 rows of g as float4s: 64 values for 256
//   FMAs, so shared memory and the FMA units are equally busy.
// - The small block (fc2, fc3, the cells' small layers, which would fill
//   few SMs with the large one): 8 warps own 32 x 32 outputs, a lane 4 of
//   them, with every chunk of N in flight at once (8 stages), since there
//   the time is the latency of the copies.
// - A warp skips a chunk in which its rows of g are all zero (an
//   any-nonzero test, never a sum: a row of +x and -x still holds work).
//   The gate comes from the staged chunk itself, so the wrapper builds no
//   flags.
// - The host picks the block from the shape alone
//   (kernels/spike_gemm_bwd.py:ds_plan).
//
// Order of the sums: one fmaf chain per output, ascending n, from 0, with
// no split of N: the order of PR 12's kernel, so the result is bit for bit
// the same on any operands.
//
// ---- dW of a Conv layer --------------------------------------------------
// Replaces the same TPU kernel where the JAX package's conv backward runs it
// on the im2col patch matrix (src/repro/kernels/ops.py:_spike_conv_train_bwd).
//
// What bounds it on the H100: bytes.  The reduction runs over every output
// pixel of the batch (net-5's conv1: 1,048,576) into a KH x KW x C x F
// output (conv2: 9 x 32 x 32).  The least it must read is the input spikes
// (8 MiB at conv1, 32 MiB at conv2) and the rows of g that an event
// reaches: at conv1's 1% input events about a sixth of its 128 MiB.  The
// patch matrix (72 MiB at conv1, 288 MiB at conv2) never exists:
//
// - A block owns a contiguous range of tiles of TR x TW output pixels (its
//   split), stages each tile's input halo and channel bitmasks as the
//   forward does (conv_halo.cuh), and copies in only the g rows (128 bytes
//   at F = 32) of the pixels whose receptive field holds an event.
// - A warp owns a tap (dy, dx) and a word of 32 channels, and a lane one
//   channel c of it, with dW[tap][c][the block's 32 filters] in registers
//   over a tile: every element has one writer, and no atomics.  The warp
//   walks the tile's pixels 32 at a time; a ballot over their masks under
//   its tap finds those that see an event in its word, and for each of them
//   every lane adds the outer product fmaf(x[c], g[pixel][f], acc[f]), g's
//   row read as float4s from shared memory by all lanes at once.  The work
//   is the pixels' that an event reaches; a lane whose channel has no event
//   there adds fmaf(0, g, acc), which is acc.  After each tile the lane adds
//   its registers to the block's partial dW in shared memory.
// - The splits' partials go to a workspace, added by dw_reduce_slab_kernel
//   in ascending split order (one split writes the result itself).  The split
//   count, one wave of blocks, comes from the shapes alone
//   (kernels/spike_gemm_bwd.py:conv_dw_plan), never from the card.
//
// ---- dS of a Conv layer --------------------------------------------------
// Replaces the same TPU kernel where the JAX package's conv backward runs it
// in patch space and folds the (B*OH*OW, KH*KW*C) result back by col2im
// (src/repro/kernels/ops.py:_spike_conv_train_bwd).  On the card neither
// the patch-space cotangent (288 MiB at net-5's conv2) nor the fold exists:
// the kernel writes (B, H, W, C) directly.
//
// What bounds it on the H100: operations.  Each nonzero of g feeds KH*KW*C
// outputs: at conv2 (B = 64, 64 x 64, C = F = 32, 3 x 3) and a cotangent
// 65% nonzero, 3.2 GFLOP, 47 us at 67 TFLOP/s fp32, against 20 us to read
// g and write dS (32 MiB each).  The dS is the forward convolution of g
// with the flipped filter: g (B, OH, OW, F) is its input, dS its output,
// its pads KH-1-pad_top and KW-1-pad_left.
//
// - The strip kernel (KW = 3, stride 1: every conv of the cells).  A block
//   owns 8 rows of 32 input pixels of one image and 32 channels; it stages
//   the block's W as [tap][f][channel] once (41 KiB at conv2) and each
//   tile's g halo transposed, [f][row][column], with 4-byte cp.async, then
//   marks the g pixels whose F values are all zero.  A warp owns a row and
//   a lane 8 adjacent pixels x 4 channels.  For a row of taps dy a lane
//   reads, per f, the 10 g values of its pixels' window as three float4s
//   and the 3 taps' 4 weights as three float4s, and does 96 FMAs: each g
//   value feeds the three taps of the pixels that see it.  Shared memory,
//   128 bytes a clock against 128 FMAs, is what bounds this loop.  A window
//   row whose g pixels are all zero is skipped by one vote of the warp (an
//   any-nonzero test, not a sum: a pixel of +x and -x still holds work).
// - The pixel kernel (any filter and stride; also where the strip kernel's
//   W does not fit in shared memory): a warp owns an input pixel and a lane
//   a channel, and walks the taps, reading g's row and W through the cache.
//
// Order of the sums: each tap's sum is an fmaf chain over ascending f from
// 0, and the taps are added in (dy, dx) order with __fadd_rn, starting from
// 0: exactly what the matrix dS in patch space followed by col2im computes.
// So on any operands the kernel equals col2im of this file's dense dS bit
// for bit, and the plain version (kernels/ref.py) on grid operands.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_halo.cuh"

constexpr int kThreads = 256;           // every kernel but the slab reduction
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Allow `kernel` the H100's 227 KiB of dynamic shared memory, once per
// device, where a launch needs more than the default 48 KiB.  Launches come
// from one host thread.
template <auto kernel>
static cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && allowed[device])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  if (err == cudaSuccess && device < 64) allowed[device] = true;
  return err;
}

// ---- dW of a Dense layer -------------------------------------------------

constexpr int kDwWarps = 16;            // warps of a block
constexpr int kDwK = 32;                // columns of K in a strip: 2 a warp
constexpr int kDwM = 64;                // rows of M staged at once
constexpr int kDwSRow = kDwK + 1;       // a spike row in shared memory: its
                                        // columns fall on 32 banks
constexpr int kDwKPerWarp = kDwK / kDwWarps;
static_assert(kDwM == 64, "a chunk of M is two ballots");

// g's rows m0.. of the block's 128 * kF4 columns n0.., zeros outside
// (M, N); the caller waits.
template <int kF4, bool kVec>
__device__ __forceinline__ void stage_dw_g(const float* __restrict__ G,
                                           float* gs, int m0, int n0, int M,
                                           int N) {
  constexpr int kCols = 128 * kF4;
  if (kVec) {
    for (int e = threadIdx.x; e < kDwM * kCols / 4; e += kDwWarps * 32) {
      const int r = e / (kCols / 4), q = e % (kCols / 4);
      const int m = m0 + r, n = n0 + 4 * q;
      const bool in = m < M && n < N;
      cp_async16(gs + r * kCols + 4 * q, in ? G + (size_t)m * N + n : G, in);
    }
  } else {
    for (int e = threadIdx.x; e < kDwM * kCols; e += kDwWarps * 32) {
      const int r = e / kCols, q = e % kCols;
      const int m = m0 + r, n = n0 + q;
      const bool in = m < M && n < N;
      conv::cp_async4(gs + e, in ? G + (size_t)m * N + n : G, in);
    }
  }
}

// The spikes S[m0.., k0..] of a strip, rows read whole, zeros outside.
__device__ __forceinline__ void stage_dw_s(const float* __restrict__ S,
                                           float* ss, int m0, int k0, int M,
                                           int K) {
  for (int e = threadIdx.x; e < kDwM * kDwK; e += kDwWarps * 32) {
    const int r = e / kDwK, q = e % kDwK;
    const int m = m0 + r, k = k0 + q;
    const bool in = m < M && k < K;
    conv::cp_async4(ss + r * kDwSRow + q, in ? S + (size_t)m * K + k : S,
                    in);
  }
}

// The events of one column among 32 rows of a chunk, in ascending m, two a
// step: `bits` has bit j set where row j's spike is nonzero (the same in
// every lane), `sval` is row `lane`'s spike, and `g` this lane's first
// float4 of row 0, rows 128 * kF4 floats apart.
template <int kF4>
__device__ __forceinline__ void walk_column(uint32_t bits, float sval,
                                            const float* g,
                                            float (&acc)[kF4][4]) {
  constexpr int kCols = 128 * kF4;
  while (bits) {
    const int j0 = __ffs(bits) - 1;
    bits &= bits - 1;
    const bool two = bits != 0;
    const int j1 = two ? __ffs(bits) - 1 : j0;
    bits &= bits - 1;
    const float v0 = __shfl_sync(0xffffffffu, sval, j0);
    const float v1 = __shfl_sync(0xffffffffu, sval, j1);
#pragma unroll
    for (int q = 0; q < kF4; ++q) {
      const float4 g0 = *(const float4*)(g + j0 * kCols + 128 * q);
      const float4 g1 = *(const float4*)(g + j1 * kCols + 128 * q);
      acc[q][0] = fmaf(v0, g0.x, acc[q][0]);
      acc[q][1] = fmaf(v0, g0.y, acc[q][1]);
      acc[q][2] = fmaf(v0, g0.z, acc[q][2]);
      acc[q][3] = fmaf(v0, g0.w, acc[q][3]);
      if (two) {
        acc[q][0] = fmaf(v1, g1.x, acc[q][0]);
        acc[q][1] = fmaf(v1, g1.y, acc[q][1]);
        acc[q][2] = fmaf(v1, g1.z, acc[q][2]);
        acc[q][3] = fmaf(v1, g1.w, acc[q][3]);
      }
    }
  }
}

// The warp's columns of a staged strip, rows m0 .. m0+63 of a chunk, added
// to acc.
template <int kF4>
__device__ __forceinline__ void walk_strip(const float* ss, const float* gs,
                                           int lane, int warp,
                                           float (&acc)[kDwKPerWarp][kF4][4]) {
#pragma unroll
  for (int i = 0; i < kDwKPerWarp; ++i) {
    const int kk = warp + kDwWarps * i;
    const float lo = ss[lane * kDwSRow + kk];
    const float hi = ss[(lane + 32) * kDwSRow + kk];
    walk_column<kF4>(__ballot_sync(0xffffffffu, lo != 0.0f), lo,
                     gs + 4 * lane, acc[i]);
    walk_column<kF4>(__ballot_sync(0xffffffffu, hi != 0.0f), hi,
                     gs + 32 * 128 * kF4 + 4 * lane, acc[i]);
  }
}

// dW's rows of the warp's columns of strip k0, each written once.
template <int kF4, bool kVec>
__device__ __forceinline__ void store_dw(
    float* __restrict__ out, const float (&acc)[kDwKPerWarp][kF4][4], int k0,
    int n0, int N, int K, int lane, int warp) {
#pragma unroll
  for (int i = 0; i < kDwKPerWarp; ++i) {
    const int k = k0 + warp + kDwWarps * i;
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < kF4; ++q) {
      const int n = n0 + 128 * q + 4 * lane;
      float* o = out + (size_t)k * N + n;
      if (kVec) {
        if (n < N)
          *(float4*)o = make_float4(acc[i][q][0], acc[i][q][1], acc[i][q][2],
                                    acc[i][q][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = acc[i][q][j];
      }
    }
  }
}

// A block owns 128 * kF4 columns of N (kF4 float4s a lane) and walks the
// strips blockIdx.x, blockIdx.x + gridDim.x, ...  kVec: N is a multiple of
// 4 and g and dW start on 16 bytes, so their rows are whole float4s.
template <int kF4, bool kVec>
__global__ void __launch_bounds__(kDwWarps * 32)
spike_gemm_dw_kernel(const float* __restrict__ S, const float* __restrict__ G,
                     float* __restrict__ out, int M, int N, int K) {
  constexpr int kCols = 128 * kF4;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                                  // [kDwM][kCols]
  float* ss = smem + kDwM * kCols;                   // [2][kDwM][kDwSRow]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * kCols;
  const int chunks = (M + kDwM - 1) / kDwM;
  const int strips = (K + kDwK - 1) / kDwK;
  float acc[kDwKPerWarp][kF4][4];
  if (chunks <= 1) {
    // g stays for every strip, and the next strip's spikes are copied
    // while this one is walked
    stage_dw_g<kF4, kVec>(G, gs, 0, n0, M, N);
    int st = blockIdx.x;
    if (st < strips) stage_dw_s(S, ss, 0, st * kDwK, M, K);
    cp_async_commit();
    for (int i = 0; st < strips; st += gridDim.x, ++i) {
      const int next = st + gridDim.x;
      if (next < strips)
        stage_dw_s(S, ss + ((i + 1) & 1) * kDwM * kDwSRow, 0, next * kDwK, M,
                   K);
      cp_async_commit();
      cp_async_wait<1>();     // this strip (and g) have landed
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kDwKPerWarp; ++a)
#pragma unroll
        for (int q = 0; q < kF4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][q][j] = 0.0f;
      walk_strip<kF4>(ss + (i & 1) * kDwM * kDwSRow, gs, lane, warp, acc);
      store_dw<kF4, kVec>(out, acc, st * kDwK, n0, N, K, lane, warp);
      __syncthreads();        // the walk is done with the buffer refilled next
    }
    cp_async_wait<0>();
    return;
  }
  // M larger than a chunk: the chunks in ascending m, acc in registers
  for (int st = blockIdx.x; st < strips; st += gridDim.x) {
#pragma unroll
    for (int a = 0; a < kDwKPerWarp; ++a)
#pragma unroll
      for (int q = 0; q < kF4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][q][j] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();        // the last walk is done with the tiles
      stage_dw_g<kF4, kVec>(G, gs, c * kDwM, n0, M, N);
      stage_dw_s(S, ss, c * kDwM, st * kDwK, M, K);
      conv::cp_async_wait_all();
      __syncthreads();
      walk_strip<kF4>(ss, gs, lane, warp, acc);
    }
    store_dw<kF4, kVec>(out, acc, st * kDwK, n0, N, K, lane, warp);
  }
}

// ---- dS of a Dense layer -------------------------------------------------

constexpr int kDsNc = 32;               // columns of N in a chunk

// The large block: 4 warps, 64 x 128 outputs.  Warp (wm, wk) of 2 x 2 owns
// 32 x 64 of them and lane (ly, lx) of 4 x 8 an 8 x 8 tile: rows
// 32 wm + ly + 4 i and columns 64 wk + lx + 8 j (i, j < 8).  Per 4 n a lane
// reads its 8 rows of W and, one after another, its 8 rows of g as
// float4s along n (rows of 36 floats: the 8 rows a load touches fall on 32
// banks), 64 values for 256 FMAs.
constexpr int kDsLWarps = 4;
constexpr int kDsLM = 64, kDsLK = 128;
constexpr int kDsLStages = 3;
constexpr int kDsRow = kDsNc + 4;
constexpr int kDsLStage = (kDsLM + kDsLK) * kDsRow;
constexpr size_t kDsLSmem = sizeof(float) * kDsLStages * kDsLStage;

// Rows of g (m0..) and of W (k0..) of chunk n0.. into a stage, [row][n]
// with rows of kDsRow floats, zeros outside; kVec: 16-byte copies.
template <bool kVec, int kRowsG, int kRowsW>
__device__ __forceinline__ void stage_ds(const float* __restrict__ G,
                                         const float* __restrict__ W,
                                         float* st, int m0, int k0, int n0,
                                         int M, int K, int N, int threads) {
  if (kVec) {
    for (int e = threadIdx.x; e < (kRowsG + kRowsW) * (kDsNc / 4);
         e += threads) {
      const int r = e / (kDsNc / 4), q = e % (kDsNc / 4), n = n0 + 4 * q;
      const bool g_row = r < kRowsG;
      const int row = g_row ? m0 + r : k0 + r - kRowsG;
      const bool in = row < (g_row ? M : K) && n < N;
      const float* src = g_row ? G : W;
      cp_async16(st + r * kDsRow + 4 * q, in ? src + (size_t)row * N + n : src,
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < (kRowsG + kRowsW) * kDsNc; e += threads) {
      const int r = e / kDsNc, q = e % kDsNc, n = n0 + q;
      const bool g_row = r < kRowsG;
      const int row = g_row ? m0 + r : k0 + r - kRowsG;
      const bool in = row < (g_row ? M : K) && n < N;
      const float* src = g_row ? G : W;
      conv::cp_async4(st + r * kDsRow + q, in ? src + (size_t)row * N + n : src,
                      in);
    }
  }
}

// kVec: N is a multiple of 4 and g and W start on 16 bytes.
template <bool kVec>
__global__ void __launch_bounds__(kDsLWarps * 32)
spike_gemm_ds_large_kernel(const float* __restrict__ G,
                           const float* __restrict__ W,
                           float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wk = warp >> 1;
  const int ly = lane >> 3, lx = lane & 7;
  const int m0 = blockIdx.x * kDsLM, k0 = blockIdx.y * kDsLK;
  const int chunks = (N + kDsNc - 1) / kDsNc;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kDsLStages - 1; ++s) {
    if (s < chunks)
      stage_ds<kVec, kDsLM, kDsLK>(G, W, smem + s * kDsLStage, m0, k0,
                                   s * kDsNc, M, K, N, kDsLWarps * 32);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDsLStages - 2>();  // chunk c has landed
    __syncthreads();                  // for every thread, and chunk c-1's
                                      // stage is free
    const int next = c + kDsLStages - 1;
    if (next < chunks)
      stage_ds<kVec, kDsLM, kDsLK>(G, W,
                                   smem + (next % kDsLStages) * kDsLStage, m0,
                                   k0, next * kDsNc, M, K, N, kDsLWarps * 32);
    cp_async_commit();
    const float* gs = smem + (c % kDsLStages) * kDsLStage + 32 * wm * kDsRow;
    const float* ws = smem + (c % kDsLStages) * kDsLStage +
                      (kDsLM + 64 * wk) * kDsRow;
    // the gate: any nonzero among the warp's 32 rows of the chunk (lane r)
    bool any = false;
#pragma unroll
    for (int q = 0; q < kDsNc / 4; ++q) {
      const float4 v = *(const float4*)(gs + lane * kDsRow + 4 * q);
      any |= v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    for (int q = 0; q < kDsNc / 4; ++q) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *(const float4*)(ws + (lx + 8 * j) * kDsRow + 4 * q);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *(const float4*)(gs + (ly + 4 * i) * kDsRow + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 32 * wm + ly + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 64 * wk + lx + 8 * j;
      if (k < K) out[(size_t)m * K + k] = acc[i][j];
    }
  }
}

// The small block (fc2, fc3, the cells' small layers, which would fill few
// SMs with the large one): 8 warps, 32 x 32 outputs, warp w owning rows
// 4w .. 4w+3 and lane l column l, with every chunk of N in flight at once
// up to kDsSStages.
constexpr int kDsSRows = 4;
constexpr int kDsSM = kWarps * kDsSRows, kDsSK = 32;
constexpr int kDsSStages = 8;
constexpr int kDsSStage = (kDsSM + kDsSK) * kDsRow;
constexpr size_t kDsSSmem = sizeof(float) * kDsSStages * kDsSStage;

// kVec: N is a multiple of 4 and g and W start on 16 bytes.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
spike_gemm_ds_small_kernel(const float* __restrict__ G,
                           const float* __restrict__ W,
                           float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kDsSM, k0 = blockIdx.y * kDsSK;
  const int chunks = (N + kDsNc - 1) / kDsNc;
  float acc[kDsSRows];
#pragma unroll
  for (int r = 0; r < kDsSRows; ++r) acc[r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kDsSStages - 1; ++s) {
    if (s < chunks)
      stage_ds<kVec, kDsSM, kDsSK>(G, W, smem + s * kDsSStage, m0, k0,
                                   s * kDsNc, M, K, N, kThreads);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDsSStages - 2>();
    __syncthreads();
    const int next = c + kDsSStages - 1;
    if (next < chunks)
      stage_ds<kVec, kDsSM, kDsSK>(G, W,
                                   smem + (next % kDsSStages) * kDsSStage, m0,
                                   k0, next * kDsNc, M, K, N, kThreads);
    cp_async_commit();
    const float* gs = smem + (c % kDsSStages) * kDsSStage +
                      warp * kDsSRows * kDsRow;
    const float* ws = smem + (c % kDsSStages) * kDsSStage +
                      (kDsSM + lane) * kDsRow;
    bool any = false;
#pragma unroll
    for (int r = 0; r < kDsSRows; ++r) any |= gs[r * kDsRow + lane] != 0.0f;
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll 2
    for (int q = 0; q < kDsNc / 4; ++q) {
      const float4 wv = *(const float4*)(ws + 4 * q);
#pragma unroll
      for (int r = 0; r < kDsSRows; ++r) {
        const float4 gv = *(const float4*)(gs + r * kDsRow + 4 * q);
        acc[r] = fmaf(gv.x, wv.x, acc[r]);
        acc[r] = fmaf(gv.y, wv.y, acc[r]);
        acc[r] = fmaf(gv.z, wv.z, acc[r]);
        acc[r] = fmaf(gv.w, wv.w, acc[r]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < kDsSRows; ++r) {
    const int m = m0 + warp * kDsSRows + r, k = k0 + lane;
    if (m < M && k < K) out[(size_t)m * K + k] = acc[r];
  }
}

// ---- dS of a Conv layer --------------------------------------------------

// The strip kernel (KW = 3, stride 1).  A block owns kDsRows rows of
// kDsStrip input pixels of one image and 32 channels; warp r owns row r,
// and lane (lc, lx) of 8 x 4 the pixels 8 lx .. 8 lx + 7 and the channels
// 4 lc .. 4 lc + 3 of it.  The g halo is staged transposed, [f][row][col],
// so that a lane reads the window of its pixels under a row of three taps
// (columns 8 lx .. 8 lx + 9) as three float4s; W as [tap][f][channel].
// Per f a row of taps costs a lane 12 + 12 loaded values for 96 FMAs.
constexpr int kDsStrip = 32;
constexpr int kDsRows = kWarps;
constexpr int kDsHaloCols = kDsStrip + 2;
constexpr int kDsHaloRow = kDsStrip + 4;    // a halo row, padded to float4s
constexpr int kDsCh = 32 + 4;               // W's channels, padded

// Floats of one f of the halo: its rows, padded to 4 mod 32, so that the
// transposed copies of 32 consecutive f fall on 8 banks, not 1.
__host__ __device__ constexpr int ds_plane(int kh) {
  return (kDsRows + kh - 1) * kDsHaloRow +
         ((36 - (kDsRows + kh - 1) * kDsHaloRow % 32) % 32);
}

// One row dy of taps of the lane's 8 x 4 outputs: t[dx][p][j] = sum over f
// of g[f][window column 8 lx + p + 2 - dx] * W[dy][dx][f][4 lc + j], each
// an fmaf chain in ascending f from 0.  `gp` is the lane's window in halo
// row dy's plane 0, `wp` W[dy][0][0][4 lc].
__device__ __forceinline__ void ds_taps_row(const float* gp, const float* wp,
                                            int F, int plane,
                                            float (&t)[3][8][4]) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) t[dx][p][j] = 0.0f;
#pragma unroll 2
  for (int f = 0; f < F; ++f) {
    const float4 a0 = *(const float4*)(gp + f * plane);
    const float4 a1 = *(const float4*)(gp + f * plane + 4);
    const float4 a2 = *(const float4*)(gp + f * plane + 8);
    const float a[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                         a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
    float b[3][4];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float4 v = *(const float4*)(wp + (dx * F + f) * kDsCh);
      b[dx][0] = v.x;
      b[dx][1] = v.y;
      b[dx][2] = v.z;
      b[dx][3] = v.w;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          t[dx][p][j] = fmaf(a[p + 2 - dx], b[dx][j], t[dx][p][j]);
  }
}

// g: the layer's own geometry; its tile is kDsRows x kDsStrip.
__global__ void __launch_bounds__(kThreads, 1)
spike_conv_ds_strip_kernel(const float* __restrict__ G,
                           const float* __restrict__ w,
                           float* __restrict__ out, conv::Geom g) {
  extern __shared__ __align__(16) float smem[];
  const int F = g.F, C = g.C, KH = g.KH;
  const int hrows = kDsRows + KH - 1, plane = ds_plane(KH);
  float* ws = smem;                                  // [KH*3][F][kDsCh]
  float* gt = ws + KH * 3 * F * kDsCh;               // [F][plane]
  int* busy = (int*)(gt + F * plane);                // [hrows][kDsHaloRow]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = lane & 3, lc = lane >> 2;
  const int c0 = blockIdx.y * 32;
  // the block's 32 channels of W, zeros past C, rows read whole
  for (int e = threadIdx.x; e < KH * 3 * 32 * F; e += kThreads) {
    const int f = e % F, tc = e / F, cl = tc % 32, tap = tc / 32;
    const bool in = c0 + cl < C;
    conv::cp_async4(ws + (tap * F + f) * kDsCh + cl,
                    in ? w + ((size_t)tap * C + c0 + cl) * F + f : w, in);
  }
  const int tiles_h = (g.H + kDsRows - 1) / kDsRows;
  const int tiles_w = (g.W + kDsStrip - 1) / kDsStrip;
  const int ntiles = g.B * tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_w * tiles_h);
    const int y0 = tile / tiles_w % tiles_h * kDsRows;
    const int x0 = tile % tiles_w * kDsStrip;
    // halo (hr, hc) is g's pixel (y0 + hr - (KH-1-pad_t), x0 + hc - (2-pad_l))
    const int oy0 = y0 - (KH - 1 - g.pad_t), ox0 = x0 - (2 - g.pad_l);
    __syncthreads();          // the last tile's walks are done with the halo
    for (int e = threadIdx.x; e < hrows * kDsHaloCols * F; e += kThreads) {
      const int f = e % F, px = e / F;
      const int hc = px % kDsHaloCols, hr = px / kDsHaloCols;
      const int oy = oy0 + hr, ox = ox0 + hc;
      const bool in = oy >= 0 && oy < g.OH && ox >= 0 && ox < g.OW;
      conv::cp_async4(
          gt + f * plane + hr * kDsHaloRow + hc,
          in ? G + (((size_t)b * g.OH + oy) * g.OW + ox) * F + f : G, in);
    }
    conv::cp_async_wait_all();
    __syncthreads();
    // which g pixels hold a nonzero value (an any-nonzero test, not a sum)
    for (int px = threadIdx.x; px < hrows * kDsHaloCols; px += kThreads) {
      const int hc = px % kDsHaloCols, hr = px / kDsHaloCols;
      const float* v = gt + hr * kDsHaloRow + hc;
      bool any = false;
      for (int f = 0; f < F; ++f) any |= v[f * plane] != 0.0f;
      busy[hr * kDsHaloRow + hc] = any;
    }
    __syncthreads();
    float total[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[p][j] = 0.0f;
    for (int dy = 0; dy < KH; ++dy) {
      const int hr = warp + KH - 1 - dy;
      // a window row whose g pixels are all zero: its three taps add +0
      const int* row = busy + hr * kDsHaloRow;
      if (!__any_sync(0xffffffffu,
                      row[lane] || (lane < kDsHaloCols - 32 && row[32 + lane])))
        continue;
      float t[3][8][4];
      ds_taps_row(gt + hr * kDsHaloRow + 8 * lx,
                  ws + dy * 3 * F * kDsCh + 4 * lc, F, plane, t);
      // the taps in (dy, dx) order, each rounded on its own, as col2im adds
      // them
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          total[p][j] = __fadd_rn(
              __fadd_rn(__fadd_rn(total[p][j], t[0][p][j]), t[1][p][j]),
              t[2][p][j]);
    }
    const int y = y0 + warp, c = c0 + 4 * lc;
    if (y >= g.H || c >= C) continue;
    const bool vec = C % 4 == 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int x = x0 + 8 * lx + p;
      if (x >= g.W) continue;
      float* o = out + (((size_t)b * g.H + y) * g.W + x) * C + c;
      if (vec) {
        *(float4*)o = make_float4(total[p][0], total[p][1], total[p][2],
                                  total[p][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < C) o[j] = total[p][j];
      }
    }
  }
  cp_async_wait<0>();
}

// Any filter and stride: a warp an input pixel, a lane a channel.
__global__ void __launch_bounds__(kThreads)
spike_conv_ds_pixel_kernel(const float* __restrict__ G,
                           const float* __restrict__ w,
                           float* __restrict__ out, conv::Geom g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane, cw = min(c, g.C - 1);
  const long long npix = (long long)g.B * g.H * g.W;
  for (long long pix = (long long)blockIdx.x * kWarps + warp; pix < npix;
       pix += (long long)gridDim.x * kWarps) {
    const int x = (int)(pix % g.W), y = (int)(pix / g.W % g.H);
    const int b = (int)(pix / ((long long)g.W * g.H));
    float total = 0.0f;
    for (int dy = 0; dy < g.KH; ++dy) {
      const int ty = y + g.pad_t - dy;
      if (ty < 0 || ty % g.stride || ty / g.stride >= g.OH) continue;
      for (int dx = 0; dx < g.KW; ++dx) {
        const int tx = x + g.pad_l - dx;
        if (tx < 0 || tx % g.stride || tx / g.stride >= g.OW) continue;
        const float* grow =
            G + (((size_t)b * g.OH + ty / g.stride) * g.OW + tx / g.stride) *
                    g.F;
        const float* wrow = w + ((size_t)(dy * g.KW + dx) * g.C + cw) * g.F;
        float acc = 0.0f;
        for (int f = 0; f < g.F; ++f)
          acc = fmaf(__ldg(grow + f), __ldg(wrow + f), acc);
        total = __fadd_rn(total, acc);
      }
    }
    if (c < g.C) out[(size_t)pix * g.C + c] = total;
  }
}

// ---- Sums of split partials (the conv dW) --------------------------------

// out[i] = part[0][i] + part[1][i] + ... in ascending split order, a
// thread an output: for a conv layer's dW of few splits (a small layer).
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = part[i];
  for (int s = 1; s < splits; ++s) sum += part[(size_t)s * n + i];
  out[i] = sum;
}

// The same sums for the hundreds of splits of a large conv layer's dW,
// whose outputs are few: a block owns 32 consecutive outputs, its warps copy
// slabs of 32 splits' partials of them (128 bytes a split) into shared
// memory, many loads in flight, and lane l of warp 0 adds output l's
// partials one after another.
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(kReduceWarps * 32)
dw_reduce_slab_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int splits, size_t n) {
  __shared__ float slab[kReduceWarps * 32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t i = (size_t)blockIdx.x * 32 + lane;
  float sum = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += kReduceWarps * 32) {
    __syncthreads();          // warp 0 is done with the last slabs
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int s = s0 + warp * 32 + r;
      slab[warp * 32 + r][lane] =
          s < splits && i < n ? part[(size_t)s * n + i] : 0.0f;
    }
    __syncthreads();
    if (warp == 0)
      for (int r = 0; r < min(kReduceWarps * 32, splits - s0); ++r)
        sum = s0 + r == 0 ? slab[r][lane] : sum + slab[r][lane];
  }
  if (warp == 0 && i < n) out[i] = sum;
}

static inline void dw_reduce(const float* part, float* out, int splits,
                             size_t n, cudaStream_t st) {
  if (splits <= 32)
    dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, st>>>(part, out, splits, n);
  else
    dw_reduce_slab_kernel<<<(unsigned)((n + 31) / 32), kReduceWarps * 32, 0,
                            st>>>(part, out, splits, n);
}

template <int kF4, bool kVec>
static cudaError_t dw_launch(const float* S, const float* G, float* out,
                             int M, int N, int K, int blocks,
                             cudaStream_t st) {
  const size_t smem = sizeof(float) * kDwM * (128 * kF4 + 2 * kDwSRow);
  cudaError_t err = allow_smem<spike_gemm_dw_kernel<kF4, kVec>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks,
                  (unsigned)((N + 128 * kF4 - 1) / (128 * kF4)));
  spike_gemm_dw_kernel<kF4, kVec><<<grid, kDwWarps * 32, smem, st>>>(
      S, G, out, M, N, K);
  return cudaGetLastError();
}

// dW of a Dense layer by blocks of 128 * f4 columns of N (f4 = 1, 2 or 4),
// `blocks` of them along K (one wave; the sums do not depend on how many)
// (kernels/spike_gemm_bwd.py:dw_plan).  `vec`: N is a multiple of 4 and g
// and dW start on 16 bytes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int spike_gemm_dw_launch(const void* S, const void* G, void* out,
                                   int M, int N, int K, int f4, int vec,
                                   int blocks, void* stream) {
  if (K == 0 || N == 0) return (int)cudaSuccess;
  const float* s = (const float*)S;
  const float* g = (const float*)G;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (f4 * 2 + (vec != 0)) {
    case 2: return (int)dw_launch<1, false>(s, g, o, M, N, K, blocks, st);
    case 3: return (int)dw_launch<1, true>(s, g, o, M, N, K, blocks, st);
    case 4: return (int)dw_launch<2, false>(s, g, o, M, N, K, blocks, st);
    case 5: return (int)dw_launch<2, true>(s, g, o, M, N, K, blocks, st);
    case 8: return (int)dw_launch<4, false>(s, g, o, M, N, K, blocks, st);
    case 9: return (int)dw_launch<4, true>(s, g, o, M, N, K, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <auto kernel>
static cudaError_t ds_launch(const float* G, const float* W, float* out,
                             int M, int K, int N, int bm, int bk,
                             int threads, size_t smem, cudaStream_t st) {
  const dim3 grid((unsigned)((M + bm - 1) / bm), (unsigned)((K + bk - 1) / bk));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(G, W, out, M, K, N);
  return cudaGetLastError();
}

// dS = g @ W^T by the large blocks of 64 x 128 outputs (`large`) or the
// small ones of 32 x 32 (kernels/spike_gemm_bwd.py:ds_plan).  `vec`: N is a
// multiple of 4 and g and W start on 16 bytes.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int spike_gemm_ds_launch(const void* G, const void* W, void* out,
                                   int M, int K, int N, int large, int vec,
                                   void* stream) {
  if (M == 0 || K == 0) return (int)cudaSuccess;
  const float* g = (const float*)G;
  const float* w = (const float*)W;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (large)
    return (int)(vec ? ds_launch<spike_gemm_ds_large_kernel<true>>(
                           g, w, o, M, K, N, kDsLM, kDsLK, kDsLWarps * 32,
                           kDsLSmem, st)
                     : ds_launch<spike_gemm_ds_large_kernel<false>>(
                           g, w, o, M, K, N, kDsLM, kDsLK, kDsLWarps * 32,
                           kDsLSmem, st));
  return (int)(vec ? ds_launch<spike_gemm_ds_small_kernel<true>>(
                         g, w, o, M, K, N, kDsSM, kDsSK, kThreads, kDsSSmem,
                         st)
                   : ds_launch<spike_gemm_ds_small_kernel<false>>(
                         g, w, o, M, K, N, kDsSM, kDsSK, kThreads, kDsSSmem,
                         st));
}

// dS of a Conv layer, (B, H, W, C), from its (B, OH, OW, F) cotangent and
// (KH, KW, C, F) weights, on `blocks` x ceil(C/32) blocks
// (kernels/spike_gemm_bwd.py:conv_ds_plan).  `strip` picks the strip
// kernel, which takes KW = 3, stride 1 and the tile TR x TW = kDsRows x
// kDsStrip, with `smem` bytes of dynamic shared memory: 4 * (KH*3*F*36 (W)
// + F*ds_plane(KH) (the g halo) + (kDsRows+KH-1)*36 (its busy pixels));
// else the pixel kernel runs, without shared memory.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int spike_conv_ds_launch(const void* G, const void* w, void* out,
                                    int B, int H, int W, int C, int OH,
                                    int OW, int F, int KH, int KW,
                                    int stride, int pad_t, int pad_l, int TR,
                                    int TW, int smem, int strip, int blocks,
                                    void* stream) {
  if ((long long)B * H * W == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)((C + 31) / 32));
  const conv::Geom geo{B, H, W, C, OH, OW, F, KH, KW, stride, pad_t, pad_l,
                       TR, TW};
  if (!strip) {
    spike_conv_ds_pixel_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)G, (const float*)w, (float*)out, geo);
    return (int)cudaGetLastError();
  }
  if (KW != 3 || stride != 1 || F < 1 || TR != kDsRows || TW != kDsStrip ||
      (size_t)smem != sizeof(float) * (KH * 3 * F * kDsCh +
                                       F * ds_plane(KH) +
                                       (kDsRows + KH - 1) * kDsHaloRow))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<spike_conv_ds_strip_kernel>((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  spike_conv_ds_strip_kernel<<<grid, kThreads, (size_t)smem, st>>>(
      (const float*)G, (const float*)w, (float*)out, geo);
  return (int)cudaGetLastError();
}

// ---- dW of a Conv layer --------------------------------------------------

constexpr int kConvDwMaxWarps = 16;

__global__ void __launch_bounds__(kConvDwMaxWarps * 32)
spike_conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ G,
                     float* __restrict__ part, conv::Geom g,
                     int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int taps = g.KH * g.KW;
  const int hc = conv::halo_cols(g), cw = conv::mask_words(g);
  const int npix = g.TR * g.TW;
  const int nhalo = conv::halo_rows(g) * hc;
  float* gt = smem;                                      // [TR*TW][32]
  float* dws = gt + npix * 32;                           // [taps*C][33]
  float* halo = dws + taps * g.C * 33;                   // [HR*HC][C]
  uint32_t* masks = (uint32_t*)(halo + nhalo * g.C);     // [HR*HC][CW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int f = blockIdx.y * 32 + lane;

  for (int e = threadIdx.x; e < taps * g.C * 33; e += blockDim.x)
    dws[e] = 0.0f;

  const int first = blockIdx.x * tiles_per_split;
  const int last = min(conv::num_tiles(g), first + tiles_per_split);
  for (int tile = first; tile < last; ++tile) {
    const conv::Tile t = conv::tile_at(g, tile);
    __syncthreads();          // the last tile's walk is done with the halo
    conv::stage_tile(x, g, t, halo, masks);
    // the g rows of the pixels whose receptive field holds an event; the
    // other pixels' rows are never read
    for (int p0 = warp * 32; p0 < npix; p0 += nwarps * 32) {
      const conv::Pixel px = conv::pixel_at(g, t, p0 + lane);
      uint32_t any = 0;
      if (px.inside)
        for (int dy = 0; dy < g.KH; ++dy)
          for (int dx = 0; dx < g.KW; ++dx)
            for (int i = 0; i < cw; ++i)
              any |= masks[(px.q + dy * hc + dx) * cw + i];
      for (uint32_t busy = __ballot_sync(0xffffffffu, any != 0); busy;
           busy &= busy - 1) {
        const int j = __ffs(busy) - 1;
        const size_t row = (size_t)__shfl_sync(0xffffffffu, px.out, j) * g.F;
        conv::cp_async4(gt + (p0 + j) * 32 + lane,
                        f < g.F ? G + row + f : G, f < g.F);
      }
    }
    conv::cp_async_wait_all();
    __syncthreads();
    // warp w walks the items (tap, channel word k) w, w + nwarps, ...; lane
    // c of an item owns dW[tap][32 k + c][the block's 32 filters], in
    // registers over the tile: for each pixel whose tap sees an event in
    // the word, acc[f] = fmaf(x[c], g[pixel][f], acc[f]).  A channel with
    // no event adds fmaf(0, g, acc), which is acc.
    for (int it = warp; it < taps * cw; it += nwarps) {
      const int tap = it / cw, k = it - tap * cw;
      const int dy = tap / g.KW, dx = tap - dy * g.KW;
      const int c = 32 * k + lane;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      for (int p0 = 0; p0 < npix; p0 += 32) {
        const conv::Pixel px = conv::pixel_at(g, t, p0 + lane);
        const int qj = px.q + dy * hc + dx;
        const uint32_t mine = px.inside ? masks[qj * cw + k] : 0u;
        for (uint32_t busy = __ballot_sync(0xffffffffu, mine != 0); busy;
             busy &= busy - 1) {
          const int j = __ffs(busy) - 1;
          const int q = __shfl_sync(0xffffffffu, qj, j);
          const float xv = c < g.C ? halo[q * g.C + c] : 0.0f;
          const float4* gp = (const float4*)(gt + (p0 + j) * 32);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 gv = gp[i];
            acc[4 * i] = fmaf(xv, gv.x, acc[4 * i]);
            acc[4 * i + 1] = fmaf(xv, gv.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(xv, gv.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(xv, gv.w, acc[4 * i + 3]);
          }
        }
      }
      // into the block's partial sums: the tiles in order (rows of 33
      // floats, so that the 32 lanes' rows fall on 32 banks)
      if (c < g.C) {
        float* d = dws + (tap * g.C + c) * 33;
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] += acc[i];
      }
    }
  }
  __syncthreads();
  // the block's partial sums, part[split][(tap*C + c)*F + f]
  float* dst = part + (size_t)blockIdx.x * taps * g.C * g.F;
  for (int e = threadIdx.x; e < taps * g.C * 32; e += blockDim.x) {
    const int fe = blockIdx.y * 32 + (e & 31);
    if (fe < g.F) dst[(size_t)(e >> 5) * g.F + fe] = dws[(e >> 5) * 33 + (e & 31)];
  }
}

// dW of a Conv layer over `splits` ranges of `tiles_per_split` tiles each,
// by blocks of `warps` warps (kernels/spike_gemm_bwd.py:conv_dw_plan).
// With one split the partials are the result and go straight to `out`;
// otherwise `part` holds splits x (KH*KW*C*F) floats.  `smem` is a block's
// dynamic shared memory in bytes: 4 * (KH*KW*C*33 (the partial sums) +
// TR*TW*32 (g rows) + HR*HC*C (the halo) + HR*HC*ceil(C/32) (its masks)).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int spike_conv_dw_launch(const void* x, const void* G, void* part,
                                    void* out, int B, int H, int W, int C,
                                    int OH, int OW, int F, int KH, int KW,
                                    int stride, int pad_t, int pad_l, int TR,
                                    int TW, int warps, int splits,
                                    int tiles_per_split, int smem,
                                    void* stream) {
  const size_t n = (size_t)KH * KW * C * F;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * OH * OW == 0)
    return (int)cudaMemsetAsync(out, 0, n * sizeof(float), st);
  if (warps < 1 || warps > kConvDwMaxWarps) return (int)cudaErrorInvalidValue;
  const conv::Geom g{B, H, W, C, OH, OW, F, KH, KW, stride, pad_t, pad_l,
                     TR, TW};
  cudaError_t err = allow_smem<spike_conv_dw_kernel>((size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)splits, (unsigned)((F + 31) / 32));
  spike_conv_dw_kernel<<<grid, warps * 32, (size_t)smem, st>>>(
      (const float*)x, (const float*)G, (float*)(splits == 1 ? out : part),
      g, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  dw_reduce((const float*)part, (float*)out, splits, n, st);
  return (int)cudaGetLastError();
}
