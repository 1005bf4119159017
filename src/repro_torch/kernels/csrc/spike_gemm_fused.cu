// Fused spike GEMM + LIF scan step: the block-skip accumulate of
// spike_gemm.cu, then, while the accumulator is still in registers,
//   cur = acc + b
//   subtract reset: u = ((beta * u_prev) + cur) - (thr * s_prev)
//   zero reset:     u = ((beta * u_prev) * (1 - s_prev)) + cur
//   s = (u > thr)
// so the (B, N) current never goes to device memory.
//
// Replaces src/repro/kernels/spike_gemm_fused.py:spike_gemm_lif_pallas
// (_fused_kernel).
//
// Rounding.  The epilogue is written with __fmul_rn / __fadd_rn / __fsub_rn,
// in the operation order of spike_gemm_fused.py:46-56.  nvcc contracts a
// plain `beta * u + cur` into one FMA (it does by default, like XLA under
// jit on the CPU), which rounds once where the plain PyTorch version
// (kernels/ref.py:lif_step_ref, one elementwise kernel per operation)
// rounds twice; one ulp of u near the threshold flips a spike.  The _rn
// intrinsics are never contracted, so whenever the currents are equal this
// kernel's (u, s) equal the plain version's on the card bit for bit.
//
// What bounds it on the H100: as spike_gemm.cu (streaming W once at
// 3.35 TB/s); the epilogue adds 4 reads and 2 writes of (B, N) fp32, which
// at net-5's B = 64 is under 1 MiB.  The same 16-of-132-SM occupancy limit
// as spike_gemm.cu holds on fc1.
#include "block_skip.cuh"

__global__ void __launch_bounds__(kThreads)
spike_gemm_lif_kernel(const float* __restrict__ S, const float* __restrict__ W,
                      const int* __restrict__ flags,
                      const float* __restrict__ bias,
                      const float* __restrict__ u_prev,
                      const float* __restrict__ s_prev,
                      float* __restrict__ u_out, float* __restrict__ s_out,
                      int M, int N, int K, float beta, float thr,
                      int subtract_reset) {
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
      if (r >= M || c >= N) continue;
      const size_t idx = (size_t)r * N + c;
      const float cur = __fadd_rn(acc[i][j], bias[c]);
      const float up = u_prev[idx], sp = s_prev[idx];
      float u;
      if (subtract_reset) {
        u = __fsub_rn(__fadd_rn(__fmul_rn(beta, up), cur), __fmul_rn(thr, sp));
      } else {
        u = __fadd_rn(__fmul_rn(__fmul_rn(beta, up), __fsub_rn(1.0f, sp)),
                      cur);
      }
      u_out[idx] = u;
      s_out[idx] = u > thr ? 1.0f : 0.0f;
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int spike_gemm_lif_launch(const void* S, const void* W,
                                     const void* flags, const void* bias,
                                     const void* u_prev, const void* s_prev,
                                     void* u_out, void* s_out, int M, int N,
                                     int K, float beta, float thr,
                                     int subtract_reset, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  spike_gemm_lif_kernel<<<tile_grid(M, N), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)S, (const float*)W, (const int*)flags,
      (const float*)bias, (const float*)u_prev, (const float*)s_prev,
      (float*)u_out, (float*)s_out, M, N, K, beta, thr, subtract_reset);
  return (int)cudaGetLastError();
}
