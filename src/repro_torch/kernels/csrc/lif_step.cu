// Elementwise LIF membrane update on (B, N), fp32 or bf16, both resets:
//   subtract reset: u = ((beta * u_prev) + cur) - (thr * s_prev)
//   zero reset:     u = ((beta * u_prev) * (1 - s_prev)) + cur
//   s = (u > thr)
//
// Replaces src/repro/kernels/lif_step.py:lif_step_pallas (_lif_kernel), the
// TPU kernel over (block_b, block_n) VMEM tiles.  Here the (B, N) arrays
// are contiguous, so the kernel walks them flat: a grid-stride loop over
// 16-byte vectors (4 fp32 or 8 bf16 values) when every pointer is 16-byte
// aligned, then a scalar loop over the tail that does not fill a vector.
//
// Rounding.  Each operation is written with __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA, in the operation order
// of kernels/ref.py:lif_step_ref (one PyTorch elementwise op each).  In
// bf16 each operation runs in fp32 and its result is rounded to bf16 at
// once (round_to), as PyTorch's eager bf16 ops do, and beta and thr are
// rounded to bf16 first.  So (u, s) equal the plain version on the card bit
// for bit in both dtypes.  This is a copy of the epilogue of
// spike_gemm_fused.cu on purpose: a shared header changed the forward
// kernels' register allocation once (PERF.md).
//
// What bounds it on the H100: bytes.  Three reads and two writes of each
// element (20 bytes in fp32, 10 in bf16) at 3.35 TB/s; at net-5's conv1
// membrane (64, 524,288) in fp32 that is 671 MB, about 0.2 ms.  Against it:
// 16-byte loads and stores, enough blocks to cover every SM several times,
// and no shared memory or synchronisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// An fp32 result rounded to T and widened again: the identity for fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T>
__device__ __forceinline__ void lif_one(T up, T sp, T cur, float beta,
                                        float thr, int subtract_reset, T& u,
                                        T& s) {
  const float u0 = to_float(up), s0 = to_float(sp), c = to_float(cur);
  float v;
  if (subtract_reset) {
    const float a = round_to<T>(__fmul_rn(beta, u0));
    const float b = round_to<T>(__fadd_rn(a, c));
    const float r = round_to<T>(__fmul_rn(thr, s0));
    v = round_to<T>(__fsub_rn(b, r));
  } else {
    const float a = round_to<T>(__fmul_rn(beta, u0));
    const float keep = round_to<T>(__fsub_rn(1.0f, s0));
    const float b = round_to<T>(__fmul_rn(a, keep));
    v = round_to<T>(__fadd_rn(b, c));
  }
  u = from_float<T>(v);
  s = from_float<T>(v > thr ? 1.0f : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const T* __restrict__ u_prev, const T* __restrict__ s_prev,
                const T* __restrict__ cur, T* __restrict__ u_out,
                T* __restrict__ s_out, long long n, float beta, float thr,
                int subtract_reset, int vectorized) {
  constexpr int kVec = 16 / sizeof(T);
  beta = round_to<T>(beta);
  thr = round_to<T>(thr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = vectorized ? n / kVec : 0;
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 a = reinterpret_cast<const uint4*>(u_prev)[i];
    const uint4 b = reinterpret_cast<const uint4*>(s_prev)[i];
    const uint4 c = reinterpret_cast<const uint4*>(cur)[i];
    const T* pa = reinterpret_cast<const T*>(&a);
    const T* pb = reinterpret_cast<const T*>(&b);
    const T* pc = reinterpret_cast<const T*>(&c);
    uint4 ou, os;
    T* pu = reinterpret_cast<T*>(&ou);
    T* ps = reinterpret_cast<T*>(&os);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      lif_one<T>(pa[j], pb[j], pc[j], beta, thr, subtract_reset, pu[j],
                 ps[j]);
    reinterpret_cast<uint4*>(u_out)[i] = ou;
    reinterpret_cast<uint4*>(s_out)[i] = os;
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride)
    lif_one<T>(u_prev[i], s_prev[i], cur[i], beta, thr, subtract_reset,
               u_out[i], s_out[i]);
}

template <typename T>
int launch(const void* u_prev, const void* s_prev, const void* cur,
           void* u_out, void* s_out, long long n, float beta, float thr,
           int subtract_reset, int vectorized, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  // enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  lif_step_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u_prev, (const T*)s_prev, (const T*)cur, (T*)u_out,
      (T*)s_out, n, beta, thr, subtract_reset, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// `vectorized` may be 1 only when every pointer is 16-byte aligned.
extern "C" int lif_step_f32_launch(const void* u_prev, const void* s_prev,
                                   const void* cur, void* u_out, void* s_out,
                                   long long n, float beta, float thr,
                                   int subtract_reset, int vectorized,
                                   void* stream) {
  return launch<float>(u_prev, s_prev, cur, u_out, s_out, n, beta, thr,
                       subtract_reset, vectorized, stream);
}

extern "C" int lif_step_bf16_launch(const void* u_prev, const void* s_prev,
                                    const void* cur, void* u_out, void* s_out,
                                    long long n, float beta, float thr,
                                    int subtract_reset, int vectorized,
                                    void* stream) {
  return launch<__nv_bfloat16>(u_prev, s_prev, cur, u_out, s_out, n, beta,
                               thr, subtract_reset, vectorized, stream);
}
