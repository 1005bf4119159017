// Event-driven spike convolution on the NHWC spikes, with no patch matrix:
//
//   out[b,oh,ow,f] = sum over (dy, dx, c) of
//                    x_pad[b, oh*s+dy, ow*s+dx, c] * W[dy,dx,c,f]
//
// with XLA's SAME/VALID pads, HWIO weights, any C, F, KH, KW and stride.
//
// Replaces src/repro/kernels/spike_conv.py:spike_conv_pallas
// (_spike_conv_kernel), which runs a block-skip GEMM over the im2col patch
// matrix that its wrapper writes to memory.
//
// What bounds it on the H100: bytes.  net-5's conv1 at B = 64 writes a
// 128 MiB output (64 x 128 x 128 x 32 fp32) from 8 MiB of input spikes, so
// it is a store stream with a sparse gather on top (about 40 us at
// 3.35 TB/s); conv2 reads 32 MiB and writes 32 MiB.  A patch matrix would
// add 72 MiB (conv1) or 288 MiB (conv2) each way, so it never exists:
//
// - A block owns a tile of TR x TW output pixels of one image and walks
//   tiles in a grid-stride loop, one wave of blocks, so its 32 filters of
//   W (KH*KW*C*32 floats; F in chunks of 32 on grid.y) are staged in
//   shared memory once.  The tile's input halo and the per-pixel channel
//   bitmasks come from conv_halo.cuh: each input element is read once per
//   tile, with cp.async.
// - A lane owns one filter.  The strip kernel (KW = 3, stride 1: every
//   conv of the cells) gives a warp kStrip adjacent output pixels of a row,
//   their accumulators in registers; the warp walks the set bits of its
//   input window's masks once, and each event adds its weight to the up to
//   three outputs that see it.  The pixel kernel (any filter and stride)
//   gives a warp 32 pixels: those no event reaches are stored as zeros, and
//   for each other one the warp lists its events by ballot and popc and
//   sums their weights, four at a time.  W comes from shared memory, 32
//   lanes on 32 banks; the walk is the same for the whole warp, so nothing
//   diverges, and the work is the events' (about 1% of conv1's inputs,
//   5-20% of conv2's), not the patch matrix's.  A tile of spikes adds each
//   weight as fmaf(1, w, acc); a tile with other values reads them from
//   the halo.
// - The output is written once: a warp stores one pixel's 32 filters, 128
//   contiguous bytes, per instruction.
//
// Order of the sums.  A nonzero input is an event added with its own value
// (fmaf(value, w, acc)), so the function is the convolution of any input.
// Each output sums its terms in ascending (dy, dx, c), the patch matrix's k
// order, in one thread: on grid weights, whose partial sums are exact in
// fp32, the result equals the plain version (kernels/ref.py) bit for bit,
// and every call gives the same bytes.  fp32 FMAs on CUDA cores; no TF32.
//
// A slab of cells (distributed/cellstack.py): the cell is grid.z and each
// block first moves x, w and out to its cell's; the tiles, their sums and
// their order are a solo launch's.
#include "conv_halo.cuh"

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// ---- The strip kernel: KW = 3, stride 1 (every conv of the cells) --------
//
// A warp owns a strip of kStrip adjacent output pixels of a tile row, and a
// lane the strip's kStrip outputs of its filter, in registers.  The strip's
// input window is KH rows of kStrip + 2 pixels; the warp walks its masks
// once, and each event (dy, u, c) adds its weight to the up to three
// outputs p = u - dx that see it: one bit walk for three FMAs.  For each
// output the terms still come in ascending (dy, dx, c): rows in order, the
// window's pixels left to right (dx = u - p grows with u), then c.
constexpr int kStrip = 16;

// kOnes: every event of the tile is a 1.  kWords: the mask words of a
// pixel when C <= 32 (1), else 0 for ceil(C/32) at run time.
template <int kKW, bool kOnes, int kWords>
__device__ __forceinline__ void walk_strip(const conv::Geom& g,
                                           const uint32_t* masks,
                                           const float* halo,
                                           const float* wsm, int q, int lane,
                                           float (&acc)[kStrip]) {
  constexpr int kWindow = kStrip + kKW - 1;
  static_assert(kWindow <= 32, "a lane looks at one pixel of the window");
  const int hc = conv::halo_cols(g);
  const int cw = kWords ? kWords : conv::mask_words(g);
  for (int dy = 0; dy < g.KH; ++dy) {
    const int qrow = q + dy * hc;
    // a row of the window with no event costs one ballot
    uint32_t any = 0;
    if (lane < kWindow)
      for (int i = 0; i < cw; ++i) any |= masks[(qrow + lane) * cw + i];
    if (!__ballot_sync(0xffffffffu, any != 0)) continue;
    // W[dy][.][c][lane] for dx = 0 .. kKW-1 are kKW adjacent rows
    const float* wrow = wsm + dy * g.C * kKW * 32 + lane;
#pragma unroll
    for (int u = 0; u < kWindow; ++u) {
      const float* v = halo + (qrow + u) * g.C;
      for (int i = 0; i < cw; ++i) {
        uint32_t m = masks[(qrow + u) * cw + i];
        // two events a step, so that their loads overlap; each output
        // still adds them in ascending c
        while (m) {
          const int c0 = 32 * i + __ffs(m) - 1;
          m &= m - 1;
          const bool two = m != 0;
          const int c1 = two ? 32 * i + __ffs(m) - 1 : c0;
          m &= m - 1;
          const float v0 = kOnes ? 1.0f : v[c0];
          const float v1 = kOnes ? 1.0f : v[c1];
          const float* wc0 = wrow + c0 * kKW * 32;
          const float* wc1 = wrow + c1 * kKW * 32;
          float w0[kKW], w1[kKW];
#pragma unroll
          for (int dx = 0; dx < kKW; ++dx) {
            w0[dx] = wc0[dx * 32];
            w1[dx] = wc1[dx * 32];
          }
#pragma unroll
          for (int dx = 0; dx < kKW; ++dx)
            if (u - dx >= 0 && u - dx < kStrip) {
              acc[u - dx] = fmaf(v0, w0[dx], acc[u - dx]);
              if (two) acc[u - dx] = fmaf(v1, w1[dx], acc[u - dx]);
            }
        }
      }
    }
  }
}

template <int kKW>
__global__ void __launch_bounds__(kThreads)
spike_conv_strip_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        conv::Geom g) {
  extern __shared__ __align__(16) float smem[];
  x += blockIdx.z * conv::input_elems(g);
  w += blockIdx.z * conv::filter_elems(g);
  out += blockIdx.z * conv::output_elems(g);
  const int K = g.KH * kKW * g.C;
  const int nhalo = conv::halo_rows(g) * conv::halo_cols(g);
  float* wsm = smem;                                     // [KH][C][KW][32]
  float* halo = wsm + K * 32;                            // [HR*HC][C]
  uint32_t* masks = (uint32_t*)(halo + nhalo * g.C);     // [HR*HC][CW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * 32, f = f0 + lane;
  // the block's 32 filters of W, zeros past F, with a channel's kKW taps of
  // a row adjacent, so that an event reads them at fixed offsets
  for (int e = threadIdx.x; e < K * 32; e += kThreads) {
    const int row = e >> 5, dx = row % kKW, dc = row / kKW;
    const int dy = dc / g.C, c = dc - dy * g.C;
    const int fe = f0 + (e & 31);
    wsm[e] = fe < g.F
                 ? w[((size_t)(dy * kKW + dx) * g.C + c) * g.F + fe]
                 : 0.0f;
  }
  // TW is a multiple of kStrip, so every strip's window is in the halo
  const int per_row = g.TW / kStrip, nstrips = g.TR * per_row;
  const int ntiles = conv::num_tiles(g);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const conv::Tile t = conv::tile_at(g, tile);
    __syncthreads();          // the last tile's walks are done with the halo
    const bool ones = conv::stage_tile(x, g, t, halo, masks);
    for (int s = warp; s < nstrips; s += kWarps) {
      const int r = s / per_row, c0 = (s - r * per_row) * kStrip;
      const conv::Pixel px = conv::pixel_at(g, t, r * g.TW + c0);
      float acc[kStrip];
#pragma unroll
      for (int p = 0; p < kStrip; ++p) acc[p] = 0.0f;
      if (g.C <= 32) {
        if (ones)
          walk_strip<kKW, true, 1>(g, masks, halo, wsm, px.q, lane, acc);
        else
          walk_strip<kKW, false, 1>(g, masks, halo, wsm, px.q, lane, acc);
      } else {
        if (ones)
          walk_strip<kKW, true, 0>(g, masks, halo, wsm, px.q, lane, acc);
        else
          walk_strip<kKW, false, 0>(g, masks, halo, wsm, px.q, lane, acc);
      }
      // each output once: a warp instruction stores a pixel's 32 filters
      const int room = min(kStrip, g.OW - (t.ow0 + c0));
      if (t.oh0 + r < g.OH && f < g.F) {
        float* o = out + (size_t)px.out * g.F + f;
#pragma unroll
        for (int p = 0; p < kStrip; ++p)
          if (p < room) o[(size_t)p * g.F] = acc[p];
      }
    }
  }
}

// ---- The pixel kernel: any filter and stride ------------------------------

// The events of one busy pixel, in ascending (dy, dx, c), as the list of
// their k = (dy * KW + dx) * C + c in the warp's shared memory: for each
// word of the pixel's tap masks, lane l holds bit l, and the lanes with an
// event write their k at their rank among the word's events.  Returns the
// number of events.
__device__ __forceinline__ int list_events(const conv::Geom& g,
                                           const uint32_t* masks, int q,
                                           int* list, int lane) {
  const int hc = conv::halo_cols(g), cw = conv::mask_words(g);
  const uint32_t below = (1u << lane) - 1u;
  int n = 0;
  for (int dy = 0, t = 0; dy < g.KH; ++dy)
    for (int dx = 0; dx < g.KW; ++dx, ++t)
      for (int i = 0; i < cw; ++i) {
        const uint32_t m = masks[(q + dy * hc + dx) * cw + i];
        if (!m) continue;
        if (m >> lane & 1u)
          list[n + __popc(m & below)] = t * g.C + 32 * i + lane;
        n += __popc(m);
      }
  __syncwarp();               // the list is written before the lanes read it
  return n;
}

// The pixel's output for filter `lane`: its events' weights summed one at a
// time in list order, four list entries a step so that their loads
// overlap.  kOnes: every event of the tile is a 1, and fmaf(1, w, acc) is
// acc + w; else each event's value comes from the halo, hoff[k] past the
// pixel's tap (0, 0).
template <bool kOnes>
__device__ __forceinline__ float walk_events(const int* list, int n,
                                             const float* wsm,
                                             const int* hoff,
                                             const float* v, int lane) {
  float acc = 0.0f;
  for (int e = 0; e < n; e += 4) {
    const int4 k = *(const int4*)(list + e);
    const int ks[4] = {k.x, k.y, k.z, k.w};
    float wv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = wsm[ks[i] * 32 + lane];
      xv[i] = kOnes ? 1.0f : v[hoff[ks[i]]];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e + i < n) acc = fmaf(xv[i], wv[i], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
spike_conv_pixel_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        conv::Geom g) {
  extern __shared__ __align__(16) float smem[];
  x += blockIdx.z * conv::input_elems(g);
  w += blockIdx.z * conv::filter_elems(g);
  out += blockIdx.z * conv::output_elems(g);
  const int taps = g.KH * g.KW, K = taps * g.C;
  const int hc = conv::halo_cols(g), cw = conv::mask_words(g);
  const int nhalo = conv::halo_rows(g) * hc;
  const int cap = (K + 3) & ~3;                          // a list, padded
  float* wsm = smem;                                     // [K][32]
  int* hoff = (int*)(wsm + K * 32);                      // [cap]
  int* lists = hoff + cap;                               // [kWarps][cap]
  float* halo = (float*)(lists + kWarps * cap);          // [HR*HC][C]
  uint32_t* masks = (uint32_t*)(halo + nhalo * g.C);     // [HR*HC][CW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* list = lists + warp * cap;
  const int f0 = blockIdx.y * 32, f = f0 + lane;

  // the block's 32 filters of W, zeros past F; where event k = (tap, c)
  // sits in the halo from the pixel's tap (0, 0); the lists start as
  // valid k
  for (int e = threadIdx.x; e < K * 32; e += kThreads) {
    const int fe = f0 + (e & 31);
    wsm[e] = fe < g.F ? w[(size_t)(e >> 5) * g.F + fe] : 0.0f;
  }
  for (int k = threadIdx.x; k < cap; k += kThreads) {
    const int t = min(k, K - 1) / g.C, c = min(k, K - 1) - t * g.C;
    const int dy = t / g.KW, dx = t - dy * g.KW;
    hoff[k] = (dy * hc + dx) * g.C + c;
  }
  for (int e = threadIdx.x; e < kWarps * cap; e += kThreads) lists[e] = 0;

  const int npix = g.TR * g.TW;
  const int ntiles = conv::num_tiles(g);
  const bool vec = g.F % 4 == 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const conv::Tile t = conv::tile_at(g, tile);
    __syncthreads();          // the last tile's walk is done with the halo
    const bool ones = conv::stage_tile(x, g, t, halo, masks);
    for (int p0 = warp * 32; p0 < npix; p0 += kWarps * 32) {
      // lane j: whether pixel p0 + j sees any event
      const conv::Pixel px = conv::pixel_at(g, t, p0 + lane);
      uint32_t any = 0;
      if (px.inside)
        for (int dy = 0; dy < g.KH; ++dy)
          for (int dx = 0; dx < g.KW; ++dx)
            for (int i = 0; i < cw; ++i)
              any |= masks[(px.q + dy * hc + dx) * cw + i];
      const uint32_t live = __ballot_sync(0xffffffffu, px.inside);
      const uint32_t busy = __ballot_sync(0xffffffffu, any != 0);
      // the pixels that see no event are zeros: with F a multiple of 4, a
      // lane stores one float4 of filters of 8 of them, 512 bytes a warp
      // instruction
      if (vec) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = i * 4 + (lane >> 3), col = f0 + (lane & 7) * 4;
          const int oj = __shfl_sync(0xffffffffu, px.out, j);
          if ((live & ~busy) >> j & 1u && col < g.F)
            *(float4*)(out + (size_t)oj * g.F + col) =
                make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (uint32_t left = live & ~busy; left; left &= left - 1) {
          const int oj = __shfl_sync(0xffffffffu, px.out, __ffs(left) - 1);
          if (f < g.F) out[(size_t)oj * g.F + f] = 0.0f;
        }
      }
      // the others: the warp lists the pixel's events, sums them and
      // stores its 32 filters, 128 bytes, at once
      for (uint32_t left = busy; left; left &= left - 1) {
        const int j = __ffs(left) - 1;
        const int oj = __shfl_sync(0xffffffffu, px.out, j);
        const int qj = __shfl_sync(0xffffffffu, px.q, j);
        __syncwarp();         // the last walk is done with the list
        const int n = list_events(g, masks, qj, list, lane);
        const float* v = halo + qj * g.C;
        const float acc = ones ? walk_events<true>(list, n, wsm, hoff, v, lane)
                               : walk_events<false>(list, n, wsm, hoff, v,
                                                    lane);
        if (f < g.F) out[(size_t)oj * g.F + f] = acc;
      }
    }
  }
}

// Launches `kernel` on one wave of blocks over the tiles of `cells` cells
// (the sums do not depend on how many), after allowing it the H100's 227 KiB
// of dynamic
// shared memory; the host sizes each launch's own and refuses more.  The
// statics are per kernel and per device: launches come from one host
// thread.
template <auto kernel>
static cudaError_t launch(const conv::Geom& g, int cells, const float* x,
                          const float* w, float* out, int smem,
                          cudaStream_t st) {
  // the attribute is set and the card's SMs read once per device, and the
  // blocks that fit an SM once per shared-memory size (a net's few layers)
  struct Seen {
    bool allowed = false;
    int sms = 0, n = 0, smem[8] = {}, per_sm[8] = {};
  };
  static Seen seen[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  Seen& d = seen[device];
  if (!d.allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    d.allowed = true;
  }
  int i = 0;
  while (i < min(d.n, 8) && d.smem[i] != smem) ++i;
  if (i == min(d.n, 8)) {
    i = d.n++ % 8;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm[i], kernel,
                                                        kThreads,
                                                        (size_t)smem);
    if (err != cudaSuccess) return err;
    d.smem[i] = smem;
  }
  const long long tiles = (long long)g.B * ((g.OH + g.TR - 1) / g.TR) *
                          ((g.OW + g.TW - 1) / g.TW);
  const int chunks = (g.F + 31) / 32;
  const long long wave =
      max(1LL, (long long)d.sms * max(d.per_sm[i], 1) / (chunks * cells));
  const dim3 grid((unsigned)min(tiles, wave), (unsigned)chunks,
                  (unsigned)cells);
  kernel<<<grid, kThreads, (size_t)smem, st>>>(x, w, out, g);
  return cudaGetLastError();
}

// `cells` convolutions of one shape: x cells x (B, H, W, C), w cells x (KH,
// KW, C, F), out cells x (B, OH, OW, F).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  `strip` picks the strip kernel, which
// takes KW = 3 and stride 1 and a TW that is a multiple of kStrip; `smem`
// is the block's dynamic shared memory in bytes, words of 4 bytes: K*32 (W) + HR*HC*C (the halo) +
// HR*HC*ceil(C/32) (its masks), K = KH*KW*C, and for the pixel kernel also
// 9*P (the offsets in the halo and 8 warps' event lists), P = K rounded up
// to a multiple of 4 (kernels/spike_conv.py:conv_geometry).
extern "C" int spike_conv_launch(const void* x, const void* w, void* out,
                                 int cells, int B, int H, int W, int C,
                                 int OH, int OW, int F, int KH, int KW,
                                 int stride, int pad_t, int pad_l, int TR,
                                 int TW, int smem, int strip, void* stream) {
  if ((long long)cells * B * OH * OW == 0 || F == 0) return (int)cudaSuccess;
  if (cells > 65535) return (int)cudaErrorInvalidValue;
  const conv::Geom g{B, H, W, C, OH, OW, F, KH, KW, stride, pad_t, pad_l,
                     TR, TW};
  cudaStream_t st = (cudaStream_t)stream;
  if (strip && (KW != 3 || stride != 1 || TW % kStrip != 0))
    return (int)cudaErrorInvalidValue;
  return (int)(strip ? launch<spike_conv_strip_kernel<3>>(
                              g, cells, (const float*)x, (const float*)w,
                              (float*)out, smem, st)
                     : launch<spike_conv_pixel_kernel>(
                              g, cells, (const float*)x, (const float*)w,
                              (float*)out, smem, st));
}
