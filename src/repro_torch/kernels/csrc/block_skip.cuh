// Block-skip fp32 accumulate of the spike convolution (spike_conv.cu), the
// only kernel that runs it now; spike_gemm_bwd.cu takes only its thread
// layout and tile grid.  The dense spike GEMM and the fused GEMM+LIF step
// have their own split-K accumulate in dense_split.cuh.
//
// One thread block owns one BM x BN output tile and walks the whole K
// reduction itself, with the partial sums in registers: blocks run in no
// order on the SMs, so nothing may be carried from one block to the next
// (the TPU kernels walk K as a sequential grid axis with a VMEM accumulator
// instead).  Before loading a BM x BK tile of spikes the block reads that
// tile's occupancy flag and, when it is 0, skips the tile's loads and FMAs:
// an all-zero spike tile adds exactly zero.  The flag is the same for every
// thread of the block, so the skip never splits a __syncthreads.
//
// Each output is summed over k in ascending order with fmaf on CUDA cores;
// spikes are 0 or 1, so every product is exact.  No TF32, no tensor cores.
//
// The tile shape comes from the build as -DBM=.. -DBN=.. -DBK=.. so that
// it has one definition, repro_torch/kernels/build.py:TILE.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#if !defined(BM) || !defined(BN) || !defined(BK)
#error "compile with -DBM=<rows> -DBN=<cols> -DBK=<depth> (see build.py)"
#endif

constexpr int kThreads = 256;
constexpr int kTy = 16;                 // thread rows
constexpr int kTx = 16;                 // thread columns
constexpr int kRm = BM / kTy;           // outputs per thread, rows
constexpr int kRn = BN / kTx;           // outputs per thread, columns
static_assert(kTy * kTx == kThreads, "thread grid must cover the block");
static_assert(BM % kTy == 0 && BN % kTx == 0, "tile must divide the threads");

struct TileSmem {
  float s[BM][BK + 1];                  // +1: rows fall on different banks
  float w[BK][BN];
};

// Thread (ty, tx) owns outputs (ty + kTy*i, tx + kTx*j) of the tile.
__device__ __forceinline__ void block_skip_accumulate(
    const float* __restrict__ S, const float* __restrict__ W,
    const int* __restrict__ flags, int M, int N, int K, int mt, int nt,
    TileSmem& sm, float (&acc)[kRm][kRn]) {
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int row0 = mt * BM, col0 = nt * BN;
  const int kt_count = (K + BK - 1) / BK;

#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kRn; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < kt_count; ++kt) {
    if (flags[(size_t)mt * kt_count + kt] == 0) continue;
    const int k0 = kt * BK;
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      sm.s[r][c] = (gr < M && gc < K) ? S[(size_t)gr * K + gc] : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      sm.w[r][c] = (gr < K && gc < N) ? W[(size_t)gr * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[kRm], b[kRn];
#pragma unroll
      for (int i = 0; i < kRm; ++i) a[i] = sm.s[ty + kTy * i][kk];
#pragma unroll
      for (int j = 0; j < kRn; ++j) b[j] = sm.w[kk][tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kRm; ++i)
#pragma unroll
        for (int j = 0; j < kRn; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Grid of one block per output tile: row tiles on x (up to 2^31-1 of them,
// the convolution's patch matrix has ~10^6 rows), column tiles on y.
static inline dim3 tile_grid(int M, int N) {
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
}
