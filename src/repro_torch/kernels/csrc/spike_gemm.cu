// Block-skip spike GEMM: out[M,N] = S[M,K] @ W[K,N] in fp32, skipping every
// BM x BK tile of S whose occupancy flag is 0.
//
// Replaces src/repro/kernels/spike_gemm.py:spike_gemm_pallas
// (_spike_gemm_kernel), the TPU kernel with a sequential K grid axis, a VMEM
// accumulator and scalar-prefetched flags.
//
// What bounds it on the H100: on net-5's dense layers M is the batch (64
// rows) and fc1 has K = 32,768, so the least work is streaming W (64 MiB
// for fc1) once, about 20 us at 3.35 TB/s; the fp32 FMAs of the tiles that
// hold spikes are fewer than that at 67 TFLOP/s.  This first design does
// not reach that bound: a (64, 512) output is 16 tiles, so 16 of the 132
// SMs each walk all 1,024 K-tiles in turn, with no loads in flight across
// the barrier.  It does skip the loads of empty spike tiles, which is what
// spiking traffic pays for.  Split-K or a persistent stream-K walk, and
// wgmma on an exact split of the fp32 weights, are later work.
#include "block_skip.cuh"

__global__ void __launch_bounds__(kThreads)
spike_gemm_kernel(const float* __restrict__ S, const float* __restrict__ W,
                  const int* __restrict__ flags, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ TileSmem sm;
  const int mt = blockIdx.x, nt = blockIdx.y;
  float acc[kRm][kRn];
  block_skip_accumulate(S, W, flags, M, N, K, mt, nt, sm, acc);
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int r = mt * BM + ty + kTy * i;
#pragma unroll
    for (int j = 0; j < kRn; ++j) {
      const int c = nt * BN + tx + kTx * j;
      if (r < M && c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int spike_gemm_launch(const void* S, const void* W,
                                 const void* flags, void* out, int M, int N,
                                 int K, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  spike_gemm_kernel<<<tile_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)W, (const int*)flags, (float*)out, M, N,
      K);
  return (int)cudaGetLastError();
}
