// Fused spike GEMM + LIF scan step: the split-K, event-driven accumulate of
// spike_gemm.cu (dense_split.cuh), then, on the sum of the splits,
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
// What bounds it on the H100: as spike_gemm.cu, streaming W once at
// 3.35 TB/s; the epilogue adds 4 reads and 2 writes of (B, N) fp32, under
// 1 MiB at net-5's B = 64.  With one split the split pass runs the epilogue
// on its registers; with more, it writes partial sums and the reduction
// kernel adds the splits in ascending order and runs the epilogue.  Both
// launch from spike_gemm_lif_launch: one op call, one counted launch.  A
// slab of `cells` steps of one shape runs in the same launch, each cell on
// the solo shape's split plan (dense_split.cuh, "A cell axis"), with its
// own bias and membranes.
#include "dense_split.cuh"

struct Lif {
  const float* bias;
  const float* u_prev;
  const float* s_prev;
  float* u_out;
  float* s_out;
  float beta, thr;
  int subtract_reset;
  int vec;                              // N whole float4s, bases aligned
};

// The cell's own bias and (M, N) membranes.
__device__ __forceinline__ Lif cell_lif(Lif p, int cell, int M, int N) {
  const size_t mn = (size_t)M * N;
  p.bias += (size_t)cell * N;
  p.u_prev += cell * mn;
  p.s_prev += cell * mn;
  p.u_out += cell * mn;
  p.s_out += cell * mn;
  return p;
}

__device__ __forceinline__ float lif_u(const Lif& p, float cur, float up,
                                       float sp) {
  if (p.subtract_reset)
    return __fsub_rn(__fadd_rn(__fmul_rn(p.beta, up), cur),
                     __fmul_rn(p.thr, sp));
  return __fadd_rn(__fmul_rn(__fmul_rn(p.beta, up), __fsub_rn(1.0f, sp)),
                   cur);
}

// The update of output idx (column c) from its sum.
__device__ __forceinline__ void lif_update(const Lif& p, float acc, int c,
                                           size_t idx) {
  const float u = lif_u(p, __fadd_rn(acc, p.bias[c]), p.u_prev[idx],
                        p.s_prev[idx]);
  p.u_out[idx] = u;
  p.s_out[idx] = u > p.thr ? 1.0f : 0.0f;
}

// The update of outputs (r, c .. c+3) from their sums: every operand read
// before anything is written (the outputs may not alias the inputs, but
// the compiler cannot know), a float4 at a time where p.vec allows.
__device__ __forceinline__ void lif_update4(const Lif& p, const float4& acc,
                                            int N, int r, int c) {
  const size_t idx = (size_t)r * N + c;
  float up[4], sp[4], b[4];
  if (p.vec) {
    const float4 u4 = *reinterpret_cast<const float4*>(p.u_prev + idx);
    const float4 s4 = *reinterpret_cast<const float4*>(p.s_prev + idx);
    const float4 b4 = *reinterpret_cast<const float4*>(p.bias + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      up[j] = dense::lane_of(u4, j);
      sp[j] = dense::lane_of(s4, j);
      b[j] = dense::lane_of(b4, j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = c + j < N;
      up[j] = in ? p.u_prev[idx + j] : 0.0f;
      sp[j] = in ? p.s_prev[idx + j] : 0.0f;
      b[j] = in ? p.bias[c + j] : 0.0f;
    }
  }
  float u[4], s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = lif_u(p, __fadd_rn(dense::lane_of(acc, j), b[j]), up[j], sp[j]);
    s[j] = u[j] > p.thr ? 1.0f : 0.0f;
  }
  if (p.vec) {
    *reinterpret_cast<float4*>(p.u_out + idx) =
        make_float4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<float4*>(p.s_out + idx) =
        make_float4(s[0], s[1], s[2], s[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + j < N) {
      p.u_out[idx + j] = u[j];
      p.s_out[idx + j] = s[j];
    }
  }
}

__global__ void __launch_bounds__(dense::kThreads, 1)
spike_gemm_lif_split_kernel(const float* __restrict__ S,
                            const float* __restrict__ W,
                            const __grid_constant__ dense::Maps maps,
                            const int* __restrict__ flags,
                            float* __restrict__ part, Lif lif, int M, int N,
                            int K, int splits, int slabs_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  dense::Smem& sm = *reinterpret_cast<dense::Smem*>(smem);
  float4 acc[dense::kRowsPerWarp][dense::kQuads];
  if (!dense::accumulate(S, W, maps, flags, M, N, K, splits, slabs_per_split,
                         sm, acc))
    return;                             // the producer warp
  if (splits > 1) {
    dense::store(part + (size_t)blockIdx.z * M * N, M, N, acc);
    return;
  }
  lif = cell_lif(lif, (int)blockIdx.z, M, N);
#pragma unroll
  for (int i = 0; i < dense::kRowsPerWarp; ++i) {
    const int r = dense::row_of(i);
    if (r >= M) continue;
#pragma unroll
    for (int q = 0; q < dense::kQuads; ++q) {
      const int c = dense::col_of(q, 0);
      if (c < N) lif_update4(lif, acc[i][q], N, r, c);
    }
  }
}

// Grid (outputs, cells): the cell's splits, added in ascending order, then
// its epilogue.
__global__ void __launch_bounds__(256)
spike_gemm_lif_reduce_kernel(const float* __restrict__ part, Lif lif,
                             int splits, int M, int N) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  part += (size_t)blockIdx.y * splits * mn;
  if (i < mn)
    lif_update(cell_lif(lif, (int)blockIdx.y, M, N),
               dense::sum_splits(part, splits, mn, i), (int)(i % N), i);
}

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// `cells` steps, each over `splits` ranges of `slabs_per_split` slabs of K
// (kernels/spike_gemm.py:split_plan): S cells x M x K, W cells x K x N,
// flags cells x ceil(M/BM) x ceil(K/BK), bias cells x N, the membranes
// cells x M x N; with more than one split, `part` holds cells x splits x M
// x N floats.  Launches on `stream` and returns the first CUDA error (0 on
// success).
extern "C" int spike_gemm_lif_launch(const void* S, const void* W,
                                     const void* flags, const void* bias,
                                     const void* u_prev, const void* s_prev,
                                     void* part, void* u_out, void* s_out,
                                     int cells, int M, int N, int K,
                                     int splits, int slabs_per_split,
                                     float beta, float thr,
                                     int subtract_reset, void* stream) {
  if (cells == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  if ((long long)cells * splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = N % 4 == 0 && aligned16(bias) && aligned16(u_prev) &&
                  aligned16(s_prev) && aligned16(u_out) && aligned16(s_out);
  const Lif lif{(const float*)bias, (const float*)u_prev,
                (const float*)s_prev, (float*)u_out, (float*)s_out, beta, thr,
                subtract_reset, vec};
  dense::Maps maps;
  cudaError_t err = dense::host_maps(&maps, S, W, cells, M, N, K);
  if (err == cudaSuccess)
    err = dense::allow_smem<spike_gemm_lif_split_kernel>();
  if (err != cudaSuccess) return (int)err;
  spike_gemm_lif_split_kernel<<<dense::grid(cells, M, N, splits),
                                dense::kThreads, dense::kSmemBytes, st>>>(
      (const float*)S, (const float*)W, maps, (const int*)flags,
      (float*)part, lif, M, N, K, splits, slabs_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  spike_gemm_lif_reduce_kernel<<<dim3((unsigned)((mn + 255) / 256),
                                      (unsigned)cells),
                                 256, 0, st>>>((const float*)part, lif,
                                               splits, M, N);
  return (int)cudaGetLastError();
}
