// The input halo of a tile of output pixels and its spike bitmasks, shared
// by the two conv kernels: the forward (spike_conv.cu) and dW of a conv
// layer (spike_gemm_bwd.cu).
//
// Both read the NHWC input spikes themselves; no patch matrix exists.  A
// block owns a tile of TR x TW output pixels of one image.  The input
// pixels within reach of the tile, its halo of HR = (TR-1)*stride+KH rows
// and HC = (TW-1)*stride+KW columns, are copied to shared memory once per
// tile with cp.async (16-byte copies where C is a multiple of 4, zeros
// where the halo falls in the padding): a halo row is one contiguous run of
// x, so the copies take a few instructions a thread and are all in flight
// at once.  Then every halo pixel gets its channel bitmask, bit c set where
// x[c] != 0, in CW = ceil(C/32) words, from __ballot_sync over 32
// consecutive floats of the halo (one word of a pixel, or floor(32/C)
// whole pixels where C < 32).  A kernel walks the set bits of a mask in
// ascending c: the work follows the events, and a pixel with no event
// costs one word.
//
// The value of an event is 1 in a tile of spikes, so a kernel adds its
// weight as fmaf(1, w, acc), which is acc + w.  A tile that holds any
// other nonzero value is flagged, and there the kernel reads each event's
// value from the halo: the function is the convolution of any input.
//
// The tile's shape comes from the host (kernels/spike_conv.py:conv_geometry),
// which also sizes the shared memory and refuses a layer that does not fit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv {

// The layer and its tiling, as the host computes them.
struct Geom {
  int B, H, W, C;           // input spikes, NHWC
  int OH, OW, F;            // output, NHWC
  int KH, KW, stride;       // HWIO filter
  int pad_t, pad_l;         // XLA's SAME/VALID pads before row 0 / column 0
  int TR, TW;               // output tile: rows x columns
};

struct Tile {
  int b, oh0, ow0;          // image, first output row and column
};

__device__ __forceinline__ int halo_rows(const Geom& g) {
  return (g.TR - 1) * g.stride + g.KH;
}
__device__ __forceinline__ int halo_cols(const Geom& g) {
  return (g.TW - 1) * g.stride + g.KW;
}
__device__ __forceinline__ int mask_words(const Geom& g) {
  return (g.C + 31) / 32;
}
__device__ __forceinline__ int tiles_h(const Geom& g) {
  return (g.OH + g.TR - 1) / g.TR;
}
__device__ __forceinline__ int tiles_w(const Geom& g) {
  return (g.OW + g.TW - 1) / g.TW;
}
__device__ __forceinline__ int num_tiles(const Geom& g) {
  return g.B * tiles_h(g) * tiles_w(g);
}

// Tiles in raster order: image, then tile row, then tile column.
__device__ __forceinline__ Tile tile_at(const Geom& g, int tile) {
  const int tw = tiles_w(g), th = tiles_h(g);
  Tile t;
  t.ow0 = (tile % tw) * g.TW;
  t.oh0 = (tile / tw % th) * g.TR;
  t.b = tile / (tw * th);
  return t;
}

// Output pixel p of the tile (row-major), as the lane that owns it sees it.
struct Pixel {
  bool inside;              // p is in the tile and in the output
  int q;                    // halo index of its tap (0, 0)
  int out;                  // its index in the (B, OH, OW) output
};

__device__ __forceinline__ Pixel pixel_at(const Geom& g, const Tile& t,
                                          int p) {
  const int r = p / g.TW, c = p - r * g.TW;
  Pixel px;
  px.inside = p < g.TR * g.TW && t.oh0 + r < g.OH && t.ow0 + c < g.OW;
  px.q = (r * halo_cols(g) + c) * g.stride;
  px.out = (t.b * g.OH + t.oh0 + r) * g.OW + t.ow0 + c;
  return px;
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool valid) {
  // src-size 0 copies nothing and fills the 4 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Queue the copies of the tile's halo, halo[HR][HC][C], zeros outside the
// image; the caller waits with cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_halo(const float* __restrict__ x,
                                           const Geom& g, const Tile& t,
                                           float* halo) {
  const int hr = halo_rows(g), hc = halo_cols(g);
  const int ih0 = t.oh0 * g.stride - g.pad_t;
  const int iw0 = t.ow0 * g.stride - g.pad_l;
  // the floats of a halo row inside the image: [lo, hi)
  const int lo = max(0, -iw0) * g.C, hi = min(hc, g.W - iw0) * g.C;
  const int row = hc * g.C;
  const bool vec = g.C % 4 == 0;      // whole pixels are whole float4s
  for (int r = 0; r < hr; ++r) {
    const int ih = ih0 + r;
    const bool row_in = ih >= 0 && ih < g.H;
    const float* src =
        x + (row_in ? (((long long)t.b * g.H + ih) * g.W + iw0) * g.C : 0);
    float* dst = halo + r * row;
    if (vec) {
      for (int e = threadIdx.x * 4; e < row; e += blockDim.x * 4) {
        const bool in = row_in && e >= lo && e < hi;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(dst + e)),
                     "l"(in ? src + e : x), "r"(in ? 16 : 0)
                     : "memory");
      }
    } else {
      for (int e = threadIdx.x; e < row; e += blockDim.x) {
        const bool in = row_in && e >= lo && e < hi;
        cp_async4(dst + e, in ? src + e : x, in);
      }
    }
  }
}

// masks[p * CW + k] = bit j set where halo[p][32 k + j] != 0, for the
// npix halo pixels.  Reads the staged halo (a barrier after its copies);
// returns whether this thread saw a nonzero value other than 1.  The caller
// ORs that over the block (__syncthreads_or), which is also the barrier
// before the masks are read.
__device__ __forceinline__ bool build_masks(const Geom& g, const float* halo,
                                            uint32_t* masks, int npix) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = g.C;
  bool odd = false;
  if (c < 32) {
    const int per = 32 / c;               // pixels per ballot
    const uint32_t low = (1u << c) - 1u;
    for (int p0 = warp * per; p0 < npix; p0 += nwarps * per) {
      const int e = p0 * c + lane;
      const float v = (lane < per * c && e < npix * c) ? halo[e] : 0.0f;
      const uint32_t bits = __ballot_sync(0xffffffffu, v != 0.0f);
      odd |= v != 0.0f && v != 1.0f;
      if (lane < per && p0 + lane < npix)
        masks[p0 + lane] = (bits >> (lane * c)) & low;
    }
  } else {
    // four pixels a step, so that their loads overlap
    const int cw = mask_words(g);
    for (int p0 = warp; p0 < npix; p0 += 4 * nwarps)
      for (int k = 0; k < cw; ++k) {
        const int ch = k * 32 + lane;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + i * nwarps;
          v[i] = ch < c && p < npix ? halo[p * c + ch] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + i * nwarps;
          const uint32_t bits = __ballot_sync(0xffffffffu, v[i] != 0.0f);
          odd |= v[i] != 0.0f && v[i] != 1.0f;
          if (lane == 0 && p < npix) masks[p * cw + k] = bits;
        }
      }
  }
  return odd;
}

// Stage the tile's halo and build its masks.  Returns whether every event
// of the tile is a 1 (the same answer in every thread).
__device__ __forceinline__ bool stage_tile(const float* __restrict__ x,
                                           const Geom& g, const Tile& t,
                                           float* halo, uint32_t* masks) {
  stage_halo(x, g, t, halo);
  cp_async_wait_all();
  __syncthreads();
  return !__syncthreads_or(
      build_masks(g, halo, masks, halo_rows(g) * halo_cols(g)));
}

}  // namespace conv
