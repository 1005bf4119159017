// Thread layout and tile grid of the two matrix kernels of the backward
// (spike_gemm_bwd.cu): the block-skip dW of the Dense layers and dS.  Each
// writes its own loop (a template shared between kernels changed how nvcc
// allocated their registers and slowed them on the H100).
//
// One thread block owns one BM x BN output tile; a thread (ty, tx) of the
// kTy x kTx grid owns outputs (ty + kTy*i, tx + kTx*j) of it.  The tile
// shape comes from the build as -DBM=.. -DBN=.. -DBK=.. so that it has one
// definition, repro_torch/kernels/build.py:TILE.
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

// Grid of one block per output tile: row tiles on x (up to 2^31-1 of them),
// column tiles on y.
static inline dim3 tile_grid(int M, int N) {
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
}
