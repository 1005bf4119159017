// Block-skip backward of the spike GEMM, the two cotangent products of BPTT
// through out = S @ W (Dense layers, and Conv layers on their im2col patch
// matrix):
//
//   dW[K,N] = S[M,K]^T @ g[M,N]   skipping the spike tiles whose FORWARD
//                                 flag is 0 (flags[m-tile, k-tile], read
//                                 with the reduction index first)
//   dS[M,K] = g[M,N] @ W[K,N]^T   skipping the BM x BK tiles of g whose
//                                 any-nonzero flag is 0
//
// Both accumulate in fp32 with fmaf on CUDA cores; no TF32, no tensor cores.
// An empty tile adds exactly zero, so skipping changes no result.
//
// ---- dW -------------------------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_dw_pallas
// (_dw_kernel), which walks M as the TPU's sequential innermost grid axis
// with a VMEM accumulator.
//
// What bounds it on the H100: bytes.  The reduction runs over M, which for
// a convolution is every output pixel of the batch: net-5's conv1 at B = 64
// reduces a 1,048,576 x 18 patch matrix and a 1,048,576 x 32 cotangent
// (200 MiB, about 63 us at 3.35 TB/s) into an 18 x 32 output.  A block that
// owned an output tile and walked all of M would put that on one SM.  So M
// is split: block (kt, nt, split) owns the BK x BN output tile (kt, nt) and a
// contiguous range of BM-row chunks of M, and writes its partial sums to a
// workspace (splits x K x N); a second kernel adds the partials of each
// output in ascending split order.  No float atomics: the order of every
// sum is fixed by the shapes, so two runs give the same bytes (deterministic
// training is what lets the trace cache republish a cell bit for bit).
// The reduction chunk is BM rows and the output-row tile BK, the forward
// flags' own tile, so one flag gates one whole spike tile.
//
// ---- dS -------------------------------------------------------------------
// Replaces src/repro/kernels/spike_gemm_bwd.py:spike_gemm_ds_pallas
// (_ds_kernel).
//
// The block-skip accumulate of the forward kernels (block_skip.cuh) with
// g as the flagged left operand and W read as W^T in place: block (mt, nt)
// owns the BM x BN tile of dS, i.e. BM rows of M and BN columns of K, and
// walks N in chunks of BK.  Its flags are the any-nonzero occupancy of g
// at that (BM, BK) tile over (M, N), computed by the wrapper
// (ops.cotangent_block_flags, a `!= 0` test, never `sum > 0`: a tile of
// +x and -x sums to zero and still holds work).  The loop is written out
// here rather than shared with block_skip.cuh: a template over the
// transposed read, shared with the forward kernels, made nvcc compile them
// with 32 registers instead of 64, and fc1's fused forward went from 2.7
// to 6.0 ms on the H100.
//
// What bounds it on the H100: bytes.  net-5's conv2 writes a 262,144 x 288
// dS (288 MiB, about 100 us at 3.35 TB/s) from a 262,144 x 32 cotangent;
// fc1 reads a 32,768 x 512 W (64 MiB, about 20 us).  The design skips empty
// cotangent tiles and reads each W tile from L2 for every row tile; as in
// the forward kernels, fc1's 64 rows give it only 2 x 512 blocks and no
// split of the reduction.  conv1's dS is never launched: its input spikes
// are the encoded events and need no gradient (the autograd Functions ask
// for dS only where ctx.needs_input_grad does).
#include "block_skip.cuh"

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

// out[i] = part[0][i] + part[1][i] + ... in ascending split order.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                 int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = part[i];
  for (int s = 1; s < splits; ++s) sum += part[(size_t)s * n + i];
  out[i] = sum;
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
  const size_t n = (size_t)K * N;
  dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>((const float*)part, (float*)out, splits, n);
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
