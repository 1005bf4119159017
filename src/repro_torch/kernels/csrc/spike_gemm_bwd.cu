// Backward of the spike layers, the two cotangent products of BPTT:
//
//   dW of a Dense layer, out = S @ W:   dW[K,N] = S[M,K]^T @ g[M,N], skipping
//       the spike tiles whose FORWARD flag is 0 (flags[m-tile, k-tile], read
//       with the reduction index first)
//   dW of a Conv layer, from its NHWC input spikes x and output cotangent g:
//       dW[dy,dx,c,f] = sum over (b, oh, ow) of
//                       x_pad[b, oh*s+dy, ow*s+dx, c] * g[b,oh,ow,f]
//   dS[M,K] = g[M,N] @ W[K,N]^T        skipping the BM x BK tiles of g whose
//       any-nonzero flag is 0 (a Conv layer's dS is this product in patch
//       space, which ops.py folds back to the input by col2im)
//
// All accumulate in fp32 with fmaf on CUDA cores; no TF32, no tensor cores.
// An empty tile, or a zero spike, adds exactly zero, so skipping changes no
// result.  No float atomics anywhere: the order of every sum is fixed by the
// shapes, so two runs give the same bytes (deterministic training is what
// lets the trace cache republish a cell bit for bit).
//
// ---- dW of a Dense layer -------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_dw_pallas
// (_dw_kernel), which walks M as the TPU's sequential innermost grid axis
// with a VMEM accumulator.
//
// What bounds it on the H100: bytes, and filling the card.  The reduction
// runs over M, the batch (64 rows at net-5), into a K x N output (fc1:
// 32,768 x 512).  Block (kt, nt, split) owns the BK x BN output tile
// (kt, nt) and a contiguous range of BM-row chunks of M, and writes its
// partial sums to a workspace (splits x K x N); a second kernel adds the
// partials of each output in ascending split order.  The reduction chunk is
// BM rows and the output-row tile BK, the forward flags' own tile, so one
// flag gates one whole spike tile.
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
// ---- dS ------------------------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_ds_pallas
// (_ds_kernel).
//
// Block (mt, nt) owns the BM x BN tile of dS, i.e. BM rows of M and BN
// columns of K, and walks N in chunks of BK with W read as W^T in place.
// Its flags are the any-nonzero occupancy of g at that (BM, BK) tile over
// (M, N), computed by the wrapper (ops.cotangent_block_flags, a `!= 0`
// test, never `sum > 0`: a tile of +x and -x sums to zero and still holds
// work).  The loop is its own: a template over the transposed read, shared
// with the forward kernels, made nvcc compile them with 32 registers
// instead of 64, and fc1's fused forward went from 2.7 to 6.0 ms on the
// H100.
//
// What bounds it on the H100: bytes.  net-5's conv2 writes a 262,144 x 288
// patch-space dS (288 MiB, about 100 us at 3.35 TB/s) from a 262,144 x 32
// cotangent; fc1 reads a 32,768 x 512 W (64 MiB, about 20 us).  The design
// skips empty cotangent tiles and reads each W tile from L2 for every row
// tile; fc1's 64 rows give it only 2 x 512 blocks and no split of the
// reduction.  conv1's dS is never launched: its input spikes are the
// encoded events and need no gradient (the autograd Functions ask for dS
// only where ctx.needs_input_grad does).
#include "block_skip.cuh"
#include "conv_halo.cuh"

constexpr int kDwRk = BK / kTy;         // dW outputs per thread, rows (k)
constexpr int kDwRn = BN / kTx;         // dW outputs per thread, cols (n)
static_assert(BK % kTy == 0, "dW's output-row tile must divide the threads");

struct DwSmem {
  float s[BM][BK];                      // spike tile, m rows x k columns
  float g[BM][BN];                      // cotangent tile, m rows x n columns
};

__global__ void __launch_bounds__(kThreads)
spike_gemm_dw_kernel(const float* __restrict__ S, const float* __restrict__ G,
                     const int* __restrict__ flags, float* __restrict__ part,
                     int M, int N, int K) {
  __shared__ DwSmem sm;
  const int kt = blockIdx.x, nt = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int k0 = kt * BK, n0 = nt * BN;
  const int mt_count = (M + BM - 1) / BM, kt_count = (K + BK - 1) / BK;
  const int per = (mt_count + gridDim.z - 1) / gridDim.z;
  const int mt_end = min(mt_count, (split + 1) * per);

  float acc[kDwRk][kDwRn];
#pragma unroll
  for (int i = 0; i < kDwRk; ++i)
#pragma unroll
    for (int j = 0; j < kDwRn; ++j) acc[i][j] = 0.0f;

  for (int mt = split * per; mt < mt_end; ++mt) {
    if (flags[(size_t)mt * kt_count + kt] == 0) continue;
    const int m0 = mt * BM;
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = m0 + r, gc = k0 + c;
      sm.s[r][c] = (gr < M && gc < K) ? S[(size_t)gr * K + gc] : 0.0f;
    }
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = m0 + r, gc = n0 + c;
      sm.g[r][c] = (gr < M && gc < N) ? G[(size_t)gr * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < BM; ++mm) {
      float a[kDwRk], b[kDwRn];
#pragma unroll
      for (int i = 0; i < kDwRk; ++i) a[i] = sm.s[mm][ty + kTy * i];
#pragma unroll
      for (int j = 0; j < kDwRn; ++j) b[j] = sm.g[mm][tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kDwRk; ++i)
#pragma unroll
        for (int j = 0; j < kDwRn; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)split * K * N;
#pragma unroll
  for (int i = 0; i < kDwRk; ++i) {
    const int r = k0 + ty + kTy * i;
#pragma unroll
    for (int j = 0; j < kDwRn; ++j) {
      const int c = n0 + tx + kTx * j;
      if (r < K && c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in ascending split order, a
// thread an output: for the few splits of a dense layer's dW.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = part[i];
  for (int s = 1; s < splits; ++s) sum += part[(size_t)s * n + i];
  out[i] = sum;
}

// The same sums for the hundreds of splits of a conv layer's dW, whose
// outputs are few: a block owns 32 consecutive outputs, its warps copy
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

struct DsSmem {
  float g[BM][BK + 1];                  // cotangent tile, m rows x n columns
  float w[BK][BN + 1];                  // W^T tile, n rows x k columns; +1:
                                        // its stores walk a column
};

__global__ void __launch_bounds__(kThreads)
spike_gemm_ds_kernel(const float* __restrict__ G, const float* __restrict__ W,
                     const int* __restrict__ gflags, float* __restrict__ out,
                     int M, int K, int N) {
  __shared__ DsSmem sm;
  const int mt = blockIdx.x, nt = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int row0 = mt * BM, col0 = nt * BN;
  const int nc_count = (N + BK - 1) / BK;

  float acc[kRm][kRn];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kRn; ++j) acc[i][j] = 0.0f;

  for (int nc = 0; nc < nc_count; ++nc) {
    if (gflags[(size_t)mt * nc_count + nc] == 0) continue;
    const int n0 = nc * BK;
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = n0 + c;
      sm.g[r][c] = (gr < M && gc < N) ? G[(size_t)gr * N + gc] : 0.0f;
    }
    // W^T's tile (n0.., col0..) read from W's rows col0.. along n, so
    // neighbouring threads read neighbouring addresses
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e % BK, c = e / BK;
      const int gn = n0 + r, gk = col0 + c;
      sm.w[r][c] = (gn < N && gk < K) ? W[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < BK; ++nn) {
      float a[kRm], b[kRn];
#pragma unroll
      for (int i = 0; i < kRm; ++i) a[i] = sm.g[ty + kTy * i][nn];
#pragma unroll
      for (int j = 0; j < kRn; ++j) b[j] = sm.w[nn][tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kRn; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = row0 + ty + kTy * i;
#pragma unroll
    for (int j = 0; j < kRn; ++j) {
      const int c = col0 + tx + kTx * j;
      if (r < M && c < K) out[(size_t)r * K + c] = acc[i][j];
    }
  }
}

// dW over `splits` ranges of M.  With one split the partials are the result
// and go straight to `out`; otherwise `part` holds splits x K x N floats.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int spike_gemm_dw_launch(const void* S, const void* G,
                                   const void* flags, void* part, void* out,
                                   int M, int N, int K, int splits,
                                   void* stream) {
  if (K == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((K + BK - 1) / BK), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  spike_gemm_dw_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)S, (const float*)G, (const int*)flags,
      (float*)(splits == 1 ? out : part), M, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  dw_reduce((const float*)part, (float*)out, splits, (size_t)K * N, st);
  return (int)cudaGetLastError();
}

// dS = g @ W^T.  Launches on `stream` and returns cudaGetLastError().
extern "C" int spike_gemm_ds_launch(const void* G, const void* W,
                                   const void* gflags, void* out, int M,
                                   int K, int N, void* stream) {
  if (M == 0 || K == 0) return (int)cudaSuccess;
  spike_gemm_ds_kernel<<<tile_grid(M, K), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)G, (const float*)W, (const int*)gflags, (float*)out, M, K,
      N);
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

static inline cudaError_t allow_conv_dw_smem() {
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && allowed[device])) return err;
  err = cudaFuncSetAttribute(spike_conv_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  if (err == cudaSuccess && device < 64) allowed[device] = true;
  return err;
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
  cudaError_t err = allow_conv_dw_smem();
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
