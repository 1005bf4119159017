// PENC spike-address compaction: per row of (B, N) fp32 spikes, the
// ascending column indices of the entries > 0, packed to the front of a
// (B, capacity) int32 row, -1 padded and cut at `capacity`; and each row's
// true spike count, not cut, as (B,) int32.
//
// Replaces src/repro/kernels/penc_compact.py:penc_compact_pallas
// (_penc_kernel).  The TPU kernel builds an (N x capacity) one-hot
// selection matrix and runs the scatter as a matmul on the MXU, O(N *
// capacity) work per row.  This kernel does O(N): one block per row walks
// the row in chunks of kThreads * kItems entries (each thread reads kItems
// neighbours, as one 16-byte load when the rows are aligned).  Within a
// warp, __ballot_sync and __popc give each spike its slot; warp 0 scans the
// warps' totals into offsets; a running base carries the count from chunk
// to chunk.  So the addresses come out ascending by construction, and no
// order across blocks is needed.  Once the base reaches `capacity` no
// address can be written any more, and the rest of the row is only
// counted, per thread and without barriers, then summed once at the end.
//
// What bounds it on the H100: bytes.  Read B * N * 4, write B * (capacity
// + 1) * 4 at 3.35 TB/s.  Against it: 16-byte loads, two barriers per
// chunk only while addresses are still written.  With one block per row a
// small B leaves SMs idle (net-5's 64 rows fill 64 of 132 SMs); that is
// the first thing a faster version would change (several blocks per row
// and a scan of their counts).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;               // neighbouring entries per thread
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
penc_compact_kernel(const float* __restrict__ spikes, int* __restrict__ idx,
                    int* __restrict__ counts, int N, int capacity,
                    int vectorized) {
  __shared__ int warp_total[kWarps];
  __shared__ int warp_offset[kWarps];
  __shared__ int chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_before = (1u << lane) - 1u;
  const float* s = spikes + (size_t)blockIdx.x * N;
  int* out = idx + (size_t)blockIdx.x * capacity;
  int base = 0;   // spikes of the earlier chunks: the same in every thread
  int tail = 0;   // this thread's spikes after `base` reached `capacity`
  for (int start = 0; start < N; start += kThreads * kItems) {
    const int col0 = start + kItems * threadIdx.x;
    float v[kItems];
    if (vectorized && col0 < N) {
      const float4 q = *reinterpret_cast<const float4*>(s + col0);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        v[j] = col0 + j < N ? s[col0 + j] : 0.0f;
    }
    unsigned mine = 0;    // bit j: entry col0 + j fired
#pragma unroll
    for (int j = 0; j < kItems; ++j) mine |= (v[j] > 0.0f ? 1u : 0u) << j;
    if (base >= capacity) {               // uniform across the block
      tail += __popc(mine);
      continue;
    }
    // spikes of the lanes before this one, and of the whole warp
    int before = 0, total = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned b = __ballot_sync(kFull, (mine >> j) & 1u);
      before += __popc(b & lanes_before);
      total += __popc(b);
    }
    if (lane == 0) warp_total[warp] = total;
    __syncthreads();
    if (warp == 0) {
      const int t = warp_total[lane];     // kWarps == 32: one per lane
      int incl = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      warp_offset[lane] = incl - t;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    int pos = base + warp_offset[warp] + before;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((mine >> j) & 1u) {
        if (pos < capacity) out[pos] = col0 + j;
        ++pos;
      }
    }
    // the next chunk rewrites warp_total only after its first barrier,
    // which every thread reaches after reading warp_offset and chunk_total
    base += chunk_total;
  }
  for (int j = (base < capacity ? base : capacity) + threadIdx.x;
       j < capacity; j += kThreads)
    out[j] = -1;
  // the uncut count: base plus every thread's tail
  const int warp_tail = (int)__reduce_add_sync(kFull, (unsigned)tail);
  if (lane == 0) warp_total[warp] = warp_tail;
  __syncthreads();
  if (warp == 0) {
    const int t = (int)__reduce_add_sync(kFull, (unsigned)warp_total[lane]);
    if (lane == 0) counts[blockIdx.x] = base + t;
  }
}

}  // namespace

static_assert(kWarps == 32, "warp 0 scans one warp total per lane");

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `vectorized` may be 1 only when the spikes are 16-byte aligned and N is
// a multiple of 4, so that every row starts on a 16-byte boundary.
extern "C" int penc_compact_launch(const void* spikes, void* idx,
                                   void* counts, int B, int N, int capacity,
                                   int vectorized, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  penc_compact_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)spikes, (int*)idx, (int*)counts, N, capacity,
      vectorized);
  return (int)cudaGetLastError();
}
