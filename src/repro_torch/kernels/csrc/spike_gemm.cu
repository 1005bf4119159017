// Spike GEMM: out[M,N] = S[M,K] @ W[K,N] in fp32, skipping every BM x BK
// tile of S whose occupancy flag is 0 and, inside the tiles it reads, every
// zero spike.
//
// Replaces src/repro/kernels/spike_gemm.py:spike_gemm_pallas
// (_spike_gemm_kernel), the TPU kernel with a sequential K grid axis, a VMEM
// accumulator and scalar-prefetched flags.
//
// What bounds it on the H100 is streaming W once (64 MiB at net-5's fc1,
// about 20 us at 3.35 TB/s); dense_split.cuh says how the design reaches
// for that: K split across blocks so a (64, 512) output fills the card, a
// producer warp that keeps tensor copies of W's slabs in flight, and
// consumer warps whose ballots walk only the nonzero spikes.  Two kernels:
// the split pass, which writes `out` itself when there is one split and
// (splits, M, N) partial sums otherwise, and a reduction that adds the
// splits in ascending order.  Both launch from spike_gemm_launch, so one
// op call is one counted launch.
//
// A slab of `cells` products of one shape (distributed/cellstack.py) runs in
// the same launch: the cell is the outermost grid index, and each cell runs
// the solo shape's split plan (dense_split.cuh, "A cell axis").
#include "dense_split.cuh"

__global__ void __launch_bounds__(dense::kThreads, 1)
spike_gemm_split_kernel(const float* __restrict__ S,
                        const float* __restrict__ W,
                        const __grid_constant__ dense::Maps maps,
                        const int* __restrict__ flags, float* __restrict__ out,
                        float* __restrict__ part, int M, int N, int K,
                        int splits, int slabs_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  dense::Smem& sm = *reinterpret_cast<dense::Smem*>(smem);
  float4 acc[dense::kRowsPerWarp][dense::kQuads];
  if (!dense::accumulate(S, W, maps, flags, M, N, K, splits, slabs_per_split,
                         sm, acc))
    return;                             // the producer warp
  dense::store(dense::split_dst(out, part, M, N, splits), M, N, acc);
}

// Grid (outputs, cells): the cell's splits, added in ascending order.
__global__ void __launch_bounds__(256)
spike_gemm_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ out, int splits, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  part += (size_t)blockIdx.y * splits * mn;
  if (i < mn)
    out[(size_t)blockIdx.y * mn + i] = dense::sum_splits(part, splits, mn, i);
}

// `cells` products S[c] @ W[c] (S: cells x M x K, W: cells x K x N, flags:
// cells x ceil(M/BM) x ceil(K/BK), out: cells x M x N), each over `splits`
// ranges of `slabs_per_split` slabs of K (kernels/spike_gemm.py:
// split_plan).  With one split the block writes `out` and `part` is unused;
// otherwise `part` holds cells x splits x M x N floats.  Launches on
// `stream` and returns the first CUDA error (0 on success).
extern "C" int spike_gemm_launch(const void* S, const void* W,
                                 const void* flags, void* part, void* out,
                                 int cells, int M, int N, int K, int splits,
                                 int slabs_per_split, void* stream) {
  if (cells == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  if ((long long)cells * splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dense::Maps maps;
  cudaError_t err = dense::host_maps(&maps, S, W, cells, M, N, K);
  if (err == cudaSuccess) err = dense::allow_smem<spike_gemm_split_kernel>();
  if (err != cudaSuccess) return (int)err;
  spike_gemm_split_kernel<<<dense::grid(cells, M, N, splits), dense::kThreads,
                            dense::kSmemBytes, st>>>(
      (const float*)S, (const float*)W, maps, (const int*)flags, (float*)out,
      (float*)part, M, N, K, splits, slabs_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  spike_gemm_reduce_kernel<<<dim3((unsigned)((mn + 255) / 256),
                                  (unsigned)cells),
                             256, 0, st>>>((const float*)part, (float*)out,
                                           splits, mn);
  return (int)cudaGetLastError();
}
