// Block-skip spike convolution over the im2col patch matrix:
// out[M,F] = P[M,K] @ W[K,F] with M = B*OH*OW receptive fields and
// K = KH*KW*C features in (dy, dx, c) order, skipping every BM x BK tile of
// P whose occupancy flag is 0.  The wrapper (kernels/spike_conv.py) builds P
// and its flags in PyTorch; the patches are copies of spike bits, so P is
// itself a {0,1} spike matrix and the sum>0 flag is exact.
//
// Replaces src/repro/kernels/spike_conv.py:spike_conv_pallas
// (_spike_conv_kernel).
//
// What bounds it on the H100: reading P.  On net-5 at B = 64, conv1's P is
// 1,048,576 x 18 fp32 (72 MiB) and conv2's is 262,144 x 288 (288 MiB) per
// time step, against a few MFLOP of FMAs, so the kernel is bound by bytes
// at 3.35 TB/s, and so is the wrapper that writes P.  This design reads
// each P tile once and skips the empty ones; it still pays for P in device
// memory.  Gathering the patches inside the kernel from the NHWC spikes
// (an implicit GEMM), so that P never exists, is later work.  With F = 32
// and BN = 64 half of each block's columns are masked off.
#include "block_skip.cuh"

__global__ void __launch_bounds__(kThreads)
spike_conv_kernel(const float* __restrict__ P, const float* __restrict__ W,
                  const int* __restrict__ flags, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ TileSmem sm;
  const int mt = blockIdx.x, nt = blockIdx.y;
  float acc[kRm][kRn];
  block_skip_accumulate(P, W, flags, M, N, K, mt, nt, sm, acc);
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
extern "C" int spike_conv_launch(const void* P, const void* W,
                                 const void* flags, void* out, int M, int N,
                                 int K, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  spike_conv_kernel<<<tile_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)W, (const int*)flags, (float*)out, M, N,
      K);
  return (int)cudaGetLastError();
}
