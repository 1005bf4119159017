// PENC spike-address compaction: per row of (B, N) fp32 spikes, the
// ascending column indices of the entries > 0, packed to the front of a
// (B, capacity) int32 row, -1 padded and cut at `capacity`; and each row's
// true spike count, not cut, as (B,) int32.
//
// Replaces src/repro/kernels/penc_compact.py:penc_compact_pallas
// (_penc_kernel).  The TPU kernel builds an (N x capacity) one-hot
// selection matrix and runs the scatter as a matmul on the MXU, O(N *
// capacity) work per row.  These kernels do O(N).
//
// What bounds it on the H100: bytes.  Read B * N * 4, write B * (capacity
// + 1) * 4 at 3.35 TB/s: about 0.02 ms for net-5's conv2 input (64,
// 131072) at capacity N.  A block a row walking its row in serial chunks
// (the first version) was bound by latency instead: 64 rows filled 64 of
// 132 SMs with one 16-byte load a thread in flight.
//
// The design splits each row across blocks, in two passes over tiles of
// `tile` entries (kernels/penc_compact.py:penc_plan; a tile is a whole
// number of rounds of kRound entries, a round being 256 threads x 4 loads
// of 4 neighbours).  The grid is (row, tile) flattened onto blockIdx.x.
//  1. penc_mask_kernel reads its tile with every thread's 4 16-byte loads
//     in flight at once, turns each 128 entries into 4 __ballot_sync words
//     of a bitmask and writes its tile's spike count.  The bitmask of chunk
//     c (entries 128c .. 128c + 127) is 4 words; bit l of word j is entry
//     128c + 4l + j, the j-th of lane l's 4 neighbours.  Traffic: 4N bytes
//     read and N / 8 written a row.
//  2. penc_address_kernel takes the same tile, sums its row's tile counts
//     before it (its first slot) and in all (the row's count, written by
//     tile 0's block), and pads with -1 its own share of [0, capacity) at
//     or beyond the count, with 16-byte stores: each tile owns `pad` slots,
//     so every slot of the row is written exactly once and no memset is
//     needed.  A tile whose first slot is at or beyond `capacity` writes no
//     address.  Otherwise each warp reads a chunk's 4 words, a lane's
//     spikes before it are popcounts of the words masked to the lanes
//     below, warp 0 scans the round's 32 chunk totals, and the addresses
//     are staged in shared memory and stored as one contiguous, coalesced
//     run from the tile's first slot.
// So the addresses come out ascending and the outputs are fully
// determined: nothing is written by atomics.  Rows of one tile (net-5's
// fc2 and fc3, small shapes) take one launch instead, penc_row_kernel: a
// block a row, which takes its ballot words from its own loads and runs
// the address pass's round on them (put_round) with no workspace.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;                   // 16-byte loads a thread a round
constexpr int kChunk = 128;                 // entries of 4 bitmask words
constexpr int kRound = kThreads * kLoads * 4;
constexpr int kChunks = kRound / kChunk;    // chunks a round: one a lane
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunks == 32, "warp 0 scans one chunk total per lane");

// The 4 neighbours from column col0 (0 past the row's end), one 16-byte
// load when `vectorized`.
__device__ __forceinline__ float4 load4(const float* __restrict__ s,
                                        long long col0, long long n,
                                        int vectorized) {
  if (vectorized) {
    if (col0 >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(s + col0);
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col0 + j >= n ? 0.f : s[col0 + j];
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The chunk's 4 words: word j holds each lane's j-th neighbour.  NaN and
// -0.0 are not > 0, as in the plain version.
__device__ __forceinline__ uint4 ballot4(float4 v) {
  return make_uint4(__ballot_sync(kFull, v.x > 0.f),
                    __ballot_sync(kFull, v.y > 0.f),
                    __ballot_sync(kFull, v.z > 0.f),
                    __ballot_sync(kFull, v.w > 0.f));
}

__device__ __forceinline__ int popc4(uint4 w, unsigned mask) {
  return __popc(w.x & mask) + __popc(w.y & mask) + __popc(w.z & mask) +
         __popc(w.w & mask);
}

// Writes the columns of lane `lane`'s spikes in `w` to dst[0], dst[1], ...
// in ascending order, the first at column col0.
__device__ __forceinline__ void put_columns(int* dst, uint4 w, int lane,
                                            int col0) {
  const unsigned bits[4] = {w.x, w.y, w.z, w.w};
  int k = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((bits[j] >> lane) & 1u) dst[k++] = col0 + j;
}

// -1 over p[0, n), by the `count` threads numbered `tid` of a group:
// scalar stores up to a 16-byte boundary, then 16-byte stores.
__device__ __forceinline__ void fill_pad(int* p, long long n, int tid,
                                         int count) {
  if (n <= 0) return;
  const long long head = min(
      n, (long long)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2));
  const long long vecs = (n - head) >> 2;
  for (long long i = tid; i < head; i += count) p[i] = -1;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (long long i = tid; i < vecs; i += count)
    q[i] = make_int4(-1, -1, -1, -1);
  for (long long i = head + 4 * vecs + tid; i < n; i += count) p[i] = -1;
}

// What a block stages for one round of addresses.
struct RoundSmem {
  int stage[kRound];
  int chunk_total[kChunks];
  int chunk_offset[kChunks];
  int round_total;
};

// Every thread of the block: stores the addresses of the round from column
// r0, whose chunk q * kWarps + warp has the bitmask words w[q] in each lane
// of the warp, to out[base], out[base + 1], ... below `capacity`, as one
// coalesced run; returns the round's spike count.  A warp scan of the
// chunks' popcounts and a lane's popcount of the words masked to the lanes
// below give each spike its place in the staged run.
__device__ __forceinline__ int put_round(const uint4 (&w)[kLoads],
                                         long long r0, int base, int* out,
                                         int capacity, RoundSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    if (lane == 0) sm.chunk_total[q * kWarps + warp] = popc4(w[q], kFull);
  __syncthreads();
  if (warp == 0) {
    const int c = sm.chunk_total[lane];
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    sm.chunk_offset[lane] = incl - c;
    if (lane == 31) sm.round_total = incl;
  }
  __syncthreads();
  const unsigned lanes_before = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    put_columns(sm.stage + sm.chunk_offset[q * kWarps + warp] +
                    popc4(w[q], lanes_before),
                w[q], lane, (int)(r0 + 4 * (q * kThreads + threadIdx.x)));
  __syncthreads();
  const int total = sm.round_total;
  const int n_out = min(total, capacity - base);
  for (int i = threadIdx.x; i < n_out; i += kThreads)
    out[base + i] = sm.stage[i];
  __syncthreads();     // the caller's next round reuses sm
  return total;
}

// Pass 1: the bitmask words and the spike count of tile blockIdx.x % tiles
// of row blockIdx.x / tiles.
__global__ void __launch_bounds__(kThreads)
penc_mask_kernel(const float* __restrict__ spikes, uint4* __restrict__ mask,
                 int* __restrict__ tile_counts, int N, int chunks, int tile,
                 int tiles, int vectorized) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / tiles;
  const long long t = blockIdx.x % tiles;
  const float* s = spikes + row * N;
  uint4* m = mask + row * chunks;
  const long long end = min((long long)N, (t + 1) * tile);
  int count = 0;
  for (long long r0 = t * tile; r0 < end; r0 += kRound) {
    float4 v[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      v[q] = load4(s, r0 + 4 * (q * kThreads + threadIdx.x), end, vectorized);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const uint4 w = ballot4(v[q]);
      count += (v[q].x > 0.f) + (v[q].y > 0.f) + (v[q].z > 0.f) +
               (v[q].w > 0.f);
      const long long chunk = r0 / kChunk + q * kWarps + warp;
      if (lane == q && chunk < chunks) m[chunk] = w;
    }
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += warp_count[i];
    tile_counts[blockIdx.x] = total;
  }
}

// Pass 2: the count, the -1 pad and the addresses of the same tile.
__global__ void __launch_bounds__(kThreads)
penc_address_kernel(const uint4* __restrict__ mask,
                    const int* __restrict__ tile_counts, int* __restrict__ idx,
                    int* __restrict__ counts, int N, int chunks, int capacity,
                    int tile, int tiles, int pad) {
  __shared__ RoundSmem sm;
  __shared__ int sums[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / tiles;
  const int t = (int)(blockIdx.x % tiles);
  // the row's spikes in the tiles before this one, and in all
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    const int c = tile_counts[row * tiles + i];
    total += c;
    if (i < t) before += c;
  }
  before = __reduce_add_sync(kFull, before);
  total = __reduce_add_sync(kFull, total);
  if (lane == 0) sums[0][warp] = before, sums[1][warp] = total;
  __syncthreads();
  before = total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) before += sums[0][i], total += sums[1][i];
  if (t == 0 && threadIdx.x == 0) counts[row] = total;
  int* out = idx + row * capacity;
  // this tile's share of the pad: its slots at or beyond the count
  const long long lo = (long long)t * pad;
  const long long hi = min(lo + pad, (long long)capacity);
  const long long from = max(lo, (long long)total);
  fill_pad(out + from, hi - from, threadIdx.x, kThreads);
  const uint4* m = mask + row * chunks;
  const long long end = min((long long)N, ((long long)t + 1) * tile);
  int base = before;     // the slot of the round's first spike
  for (long long r0 = (long long)t * tile; r0 < end && base < capacity;
       r0 += kRound) {
    uint4 w[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const long long chunk = r0 / kChunk + q * kWarps + warp;
      w[q] = chunk < chunks ? m[chunk] : make_uint4(0u, 0u, 0u, 0u);
    }
    base += put_round(w, r0, base, out, capacity, sm);
  }
}

// Rows of one tile (N <= kRound), in one launch: block blockIdx.x takes
// row blockIdx.x in one round, its ballot words from its own loads, and
// writes the addresses, the count and the pad.
__global__ void __launch_bounds__(kThreads)
penc_row_kernel(const float* __restrict__ spikes, int* __restrict__ idx,
                int* __restrict__ counts, int N, int capacity,
                int vectorized) {
  __shared__ RoundSmem sm;
  const long long row = blockIdx.x;
  const float* s = spikes + row * N;
  int* out = idx + row * capacity;
  float4 v[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    v[q] = load4(s, 4 * (q * kThreads + threadIdx.x), N, vectorized);
  uint4 w[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) w[q] = ballot4(v[q]);
  const int total = put_round(w, 0, 0, out, capacity, sm);
  if (threadIdx.x == 0) counts[row] = total;
  const int from = min(total, capacity);
  fill_pad(out + from, capacity - from, threadIdx.x, kThreads);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `tiles`, `tile` and `pad` come from kernels/penc_compact.py:penc_plan:
// one tile a row runs penc_row_kernel alone; more run the two passes over
// `workspace`, B * ceil(N / 128) uint4 bitmask words and then B * tiles
// int32 tile counts, 16-byte aligned.  `vectorized` may be 1 only when the
// spikes are 16-byte aligned and N is a multiple of 4, so that every row
// starts on a 16-byte boundary.
extern "C" int penc_compact_launch(const void* spikes, void* idx,
                                   void* counts, void* workspace, int B,
                                   int N, int capacity, int tile, int tiles,
                                   int pad, int vectorized, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tiles == 1) {
    if (N > kRound) return (int)cudaErrorInvalidValue;
    penc_row_kernel<<<(unsigned)B, kThreads, 0, st>>>(
        (const float*)spikes, (int*)idx, (int*)counts, N, capacity,
        vectorized);
    return (int)cudaGetLastError();
  }
  if (tile % kRound != 0 || (long long)tile * (tiles - 1) >= N ||
      (long long)tile * tiles < N)
    return (int)cudaErrorInvalidValue;
  const int chunks = (int)(((long long)N + kChunk - 1) / kChunk);
  uint4* mask = (uint4*)workspace;
  int* tile_counts = (int*)(mask + (size_t)B * chunks);
  const unsigned grid = (unsigned)B * (unsigned)tiles;
  penc_mask_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)spikes, mask, tile_counts, N, chunks, tile, tiles,
      vectorized);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  penc_address_kernel<<<grid, kThreads, 0, st>>>(
      mask, tile_counts, (int*)idx, (int*)counts, N, chunks, capacity, tile,
      tiles, pad);
  return (int)cudaGetLastError();
}
