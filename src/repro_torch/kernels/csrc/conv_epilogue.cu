// The conv layer's elementwise epilogue, one pass each way, over NHWC
// (B, H, W, F) fp32 maps (C x B images for a slab of C cells).
//
// Forward, on the bias-free output `cur` of the conv:
//   x = cur + b
//   subtract reset: u = ((beta * u_prev) + x) - (thr * s_prev)
//   zero reset:     u = ((beta * u_prev) * (1 - s_prev)) + x
//   s = (u - thr) > 0
// and, where a MaxPool of window k follows, over each VALID k x k window
// the max of s and the index of its FIRST maximum in row-major (dy, dx)
// order, one byte (k <= 16).  A ragged right or bottom edge belongs to no
// window: its u and s are written, and nothing is pooled from it.
//
// Backward, from the cotangents gu, gs of (u, s) and gp of the pooled map
// (each may be absent):
//   gs_total = scatter(gp, first) + gs        (zero on the ragged edge)
//   g = gu + gs_total * 1 / (1 + slope * |u - thr|)^2
//   d_cur = g
//   subtract reset: d_u_prev = g * beta,             d_s_prev = (-g) * thr
//   zero reset:     d_u_prev = (g * (1 - s_prev)) * beta,
//                   d_s_prev = -(g * (beta * u_prev))
//   d_b[c] = sum of g over (B, H, W) at channel c
// writing each of d_cur, d_u_prev, d_s_prev only where it is asked for.
//
// No TPU kernel does this: the JAX package leaves these ops to XLA's
// fusions.  Unfused, they are a chain of PyTorch elementwise passes, one
// full read and write of the map each; kernels/ref.py:conv_lif_ref and
// conv_lif_bwd_ref are that chain, the plain version.
//
// Rounding.  Every operation is written with __fadd_rn / __fmul_rn /
// __fsub_rn, which nvcc never contracts into an FMA, in the order in which
// the plain version's PyTorch ops run, one rounding each; the surrogate's
// 1 / x is __frcp_rn, correctly rounded as PyTorch's reciprocal is (and its
// `* 1.0` is exact).  Where the plain version accumulates two cotangents,
// the sum of two terms is the same in either order.  So u, s, the pooled
// map, the first index and the three cotangents equal the plain version's
// bit for bit.  The bias gradient is summed in another order than
// PyTorch's reduction: each thread in the order of its windows, each
// block's threads in ascending order, then the blocks in a fixed tree
// (conv_epilogue_bias_kernel).  No float atomics: a run gives the same
// bits every time, and a slab's cell, run on the solo shape's plan, gives
// its solo call's.
//
// Layout.  A block is (tx channel groups of VEC channels) x (ty windows);
// VEC = 4 where F is whole float4s (16-byte loads and stores along C),
// else 1.  blockIdx.y = cell * chunks + chunk (the channel groups past tx
// fall in further chunks); blockIdx.x walks the cell's windows with a
// grid stride.  The plan is kernels/conv_epilogue.py:epilogue_plan.
//
// What bounds it on the H100: bytes.  Forward (subtract reset, pooled at
// k = 2) reads cur, u_prev, s_prev and writes u, s and a quarter map of
// pooled fp32 and first bytes: 21.25 bytes an element; backward reads gu,
// gs, u and a quarter map of gp and first and writes d_cur, d_u_prev,
// d_s_prev: 25.25.  At net-5's conv1 (64 x 128 x 128 x 32) that is 0.71 and
// 0.85 GB, 0.21 and 0.25 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBiasThreads = 128;

struct Geo {
  int n_img;            // images of one cell (B)
  int H, W, F;
  int win;              // the pool's window; 1 where none follows
  int oh, ow;           // the pooled map (0 x 0 where none)
  int wh, ww;           // windows down and across: ceil(H / win), ...
  int groups;           // channel groups of VEC
  int chunks;           // blockIdx.y = cell * chunks + chunk
};

template <int V>
__device__ __forceinline__ void ld(const float* __restrict__ p,
                                   float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st(float* __restrict__ p,
                                   const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

template <int V>
__device__ __forceinline__ void ld_first(const uint8_t* __restrict__ p,
                                         int (&x)[V]) {
  if constexpr (V == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st_first(uint8_t* __restrict__ p,
                                         const int (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uchar4*>(p) =
        make_uchar4((uint8_t)x[0], (uint8_t)x[1], (uint8_t)x[2],
                    (uint8_t)x[3]);
  } else {
    *p = (uint8_t)x[0];
  }
}

// Where this thread works: its cell, its channel group (-1 past the
// last), and the cell's offsets into the full and the pooled maps.
struct Place {
  int cell, ch;
  size_t map, pool;
};

__device__ __forceinline__ Place place(const Geo& g, int vec) {
  Place p;
  p.cell = blockIdx.y / g.chunks;
  const int group = (blockIdx.y % g.chunks) * blockDim.x + threadIdx.x;
  p.ch = group < g.groups ? group * vec : -1;
  p.map = (size_t)p.cell * g.n_img * g.H * g.W * g.F;
  p.pool = (size_t)p.cell * g.n_img * g.oh * g.ow * g.F;
  return p;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
conv_epilogue_fwd_kernel(const float* __restrict__ cur,
                         const float* __restrict__ bias,
                         const float* __restrict__ u_prev,
                         const float* __restrict__ s_prev,
                         float* __restrict__ u_out, float* __restrict__ s_out,
                         float* __restrict__ pooled,
                         uint8_t* __restrict__ first, Geo g, float beta,
                         float thr, int subtract_reset) {
  const Place at = place(g, V);
  if (at.ch < 0) return;
  float b[V];
  ld<V>(bias + (size_t)at.cell * g.F + at.ch, b);
  const long long windows = (long long)g.n_img * g.wh * g.ww;
  for (long long w = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       w < windows; w += (long long)gridDim.x * blockDim.y) {
    const int wx = (int)(w % g.ww);
    const long long r = w / g.ww;
    const int wy = (int)(r % g.wh);
    const int n = (int)(r / g.wh);
    float best[V];
    int arg[V];
    for (int dy = 0; dy < g.win; ++dy) {
      const int y = wy * g.win + dy;
      if (y >= g.H) break;
      for (int dx = 0; dx < g.win; ++dx) {
        const int x = wx * g.win + dx;
        if (x >= g.W) break;
        const size_t off =
            at.map + (((size_t)n * g.H + y) * g.W + x) * g.F + at.ch;
        float c[V], up[V], sp[V], u[V], s[V];
        ld<V>(cur + off, c);
        ld<V>(u_prev + off, up);
        ld<V>(s_prev + off, sp);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xin = __fadd_rn(c[v], b[v]);
          const float a = __fmul_rn(beta, up[v]);
          u[v] = subtract_reset
                     ? __fsub_rn(__fadd_rn(a, xin), __fmul_rn(thr, sp[v]))
                     : __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, sp[v])), xin);
          s[v] = __fsub_rn(u[v], thr) > 0.0f ? 1.0f : 0.0f;
          const int i = dy * g.win + dx;
          if (i == 0 || s[v] > best[v]) {
            best[v] = s[v];
            arg[v] = i;
          }
        }
        st<V>(u_out + off, u);
        st<V>(s_out + off, s);
      }
    }
    if (pooled != nullptr && wy < g.oh && wx < g.ow) {
      const size_t po =
          at.pool + (((size_t)n * g.oh + wy) * g.ow + wx) * g.F + at.ch;
      st<V>(pooled + po, best);
      if (first != nullptr) st_first<V>(first + po, arg);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
conv_epilogue_bwd_kernel(const float* __restrict__ gu,
                         const float* __restrict__ gs,
                         const float* __restrict__ gp,
                         const uint8_t* __restrict__ first,
                         const float* __restrict__ u,
                         const float* __restrict__ u_prev,
                         const float* __restrict__ s_prev,
                         float* __restrict__ d_cur,
                         float* __restrict__ d_u_prev,
                         float* __restrict__ d_s_prev,
                         float* __restrict__ partial, Geo g, float beta,
                         float thr, float slope, int subtract_reset) {
  __shared__ float red[kMaxThreads * V];
  const Place at = place(g, V);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  const long long windows = (long long)g.n_img * g.wh * g.ww;
  if (at.ch >= 0) {
    for (long long w = (long long)blockIdx.x * blockDim.y + threadIdx.y;
         w < windows; w += (long long)gridDim.x * blockDim.y) {
      const int wx = (int)(w % g.ww);
      const long long r = w / g.ww;
      const int wy = (int)(r % g.wh);
      const int n = (int)(r / g.wh);
      // a window of the pooled map: its cotangent and first maximum
      const bool whole = wy < g.oh && wx < g.ow;
      float gpv[V];
      int arg[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        gpv[v] = 0.0f;
        arg[v] = -1;
      }
      if (gp != nullptr && whole) {
        const size_t po =
            at.pool + (((size_t)n * g.oh + wy) * g.ow + wx) * g.F + at.ch;
        ld<V>(gp + po, gpv);
        ld_first<V>(first + po, arg);
      }
      for (int dy = 0; dy < g.win; ++dy) {
        const int y = wy * g.win + dy;
        if (y >= g.H) break;
        for (int dx = 0; dx < g.win; ++dx) {
          const int x = wx * g.win + dx;
          if (x >= g.W) break;
          const int i = dy * g.win + dx;
          const size_t off =
              at.map + (((size_t)n * g.H + y) * g.W + x) * g.F + at.ch;
          float guv[V], gsv[V], uv[V], upv[V], spv[V], out[V];
          if (gu != nullptr) ld<V>(gu + off, guv);
          if (gs != nullptr) ld<V>(gs + off, gsv);
          ld<V>(u + off, uv);
          if (!subtract_reset) {
            ld<V>(u_prev + off, upv);
            ld<V>(s_prev + off, spv);
          }
          float gv[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            // the cotangent of s: the pool's scatter (zero off the first
            // maximum and on the ragged edge), plus the reset's
            float gst = 0.0f;
            if (gp != nullptr) gst = arg[v] == i ? gpv[v] : 0.0f;
            if (gs != nullptr) gst = gp != nullptr ? __fadd_rn(gst, gsv[v])
                                                   : gsv[v];
            if (gp != nullptr || gs != nullptr) {
              const float q = __fadd_rn(
                  __fmul_rn(slope, fabsf(__fsub_rn(uv[v], thr))), 1.0f);
              const float grad_v = __fmul_rn(gst, __frcp_rn(__fmul_rn(q, q)));
              gv[v] = gu != nullptr ? __fadd_rn(guv[v], grad_v) : grad_v;
            } else {
              gv[v] = guv[v];
            }
            acc[v] = __fadd_rn(acc[v], gv[v]);
          }
          if (d_cur != nullptr) st<V>(d_cur + off, gv);
          if (d_u_prev != nullptr) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              out[v] = subtract_reset
                           ? __fmul_rn(gv[v], beta)
                           : __fmul_rn(__fmul_rn(gv[v],
                                                 __fsub_rn(1.0f, spv[v])),
                                       beta);
            st<V>(d_u_prev + off, out);
          }
          if (d_s_prev != nullptr) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              out[v] = subtract_reset
                           ? __fmul_rn(-gv[v], thr)
                           : -__fmul_rn(gv[v], __fmul_rn(beta, upv[v]));
            st<V>(d_s_prev + off, out);
          }
        }
      }
    }
  }
  if (partial == nullptr) return;
  // the block's sum of each of its channels: threads in ascending order
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int v = 0; v < V; ++v) red[t * V + v] = acc[v];
  __syncthreads();
  if (threadIdx.y != 0 || at.ch < 0) return;
  float sum[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sum[v] = 0.0f;
    for (int ty = 0; ty < (int)blockDim.y; ++ty)
      sum[v] = __fadd_rn(sum[v], red[(ty * blockDim.x + threadIdx.x) * V + v]);
  }
  st<V>(partial + ((size_t)at.cell * gridDim.x + blockIdx.x) * g.F + at.ch,
        sum);
}

// d_b[cell][c]: the `blocks` partial sums of one (cell, channel), each
// thread over a fixed stride of them, then a fixed tree.
__global__ void __launch_bounds__(kBiasThreads)
conv_epilogue_bias_kernel(const float* __restrict__ partial,
                          float* __restrict__ d_b, int blocks, int F) {
  __shared__ float red[kBiasThreads];
  const int c = blockIdx.x, cell = blockIdx.y;
  const float* p = partial + (size_t)cell * blocks * F + c;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += kBiasThreads)
    sum = __fadd_rn(sum, p[(size_t)i * F]);
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int half = kBiasThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) d_b[(size_t)cell * F + c] = red[0];
}

// The geometry of one cell; `win` is 0 where no pool follows.
Geo geometry(int n_img, int H, int W, int F, int win, int vec, int tx) {
  Geo g;
  g.n_img = n_img;
  g.H = H;
  g.W = W;
  g.F = F;
  g.win = win > 0 ? win : 1;
  g.oh = win > 0 ? H / win : 0;
  g.ow = win > 0 ? W / win : 0;
  g.wh = (H + g.win - 1) / g.win;
  g.ww = (W + g.win - 1) / g.win;
  g.groups = F / vec;
  g.chunks = (g.groups + tx - 1) / tx;
  return g;
}

}  // namespace

// The forward: one launch.  `win` is the pool's window, 0 where no pool
// follows (then `pooled` and `first` are null); `first` is null under
// no_grad.  `vec` is 4 or 1, (tx, ty) the block, gx the blocks of a cell.
extern "C" int conv_epilogue_fwd_launch(
    const void* cur, const void* bias, const void* u_prev, const void* s_prev,
    void* u_out, void* s_out, void* pooled, void* first, int cells,
    int n_img, int H, int W, int F, int win, int vec, int tx, int ty, int gx,
    float beta, float thr, int subtract_reset, void* stream) {
  const Geo g = geometry(n_img, H, W, F, win, vec, tx);
  if ((long long)cells * n_img * H * W * F == 0) return (int)cudaSuccess;
  const dim3 grid(gx, cells * g.chunks), block(tx, ty);
  auto s = (cudaStream_t)stream;
  if (vec == 4)
    conv_epilogue_fwd_kernel<4><<<grid, block, 0, s>>>(
        (const float*)cur, (const float*)bias, (const float*)u_prev,
        (const float*)s_prev, (float*)u_out, (float*)s_out, (float*)pooled,
        (uint8_t*)first, g, beta, thr, subtract_reset);
  else
    conv_epilogue_fwd_kernel<1><<<grid, block, 0, s>>>(
        (const float*)cur, (const float*)bias, (const float*)u_prev,
        (const float*)s_prev, (float*)u_out, (float*)s_out, (float*)pooled,
        (uint8_t*)first, g, beta, thr, subtract_reset);
  return (int)cudaGetLastError();
}

// The backward: the elementwise pass with the bias's per-block partial
// sums, then, where `d_b` is not null, their reduction: two kernels, one
// call.  Any of gu, gs, gp (with first) may be null, as may d_cur,
// d_u_prev and d_s_prev (not asked for); u_prev and s_prev are read only
// by the zero reset.  `partial` holds cells x gx x F floats.
extern "C" int conv_epilogue_bwd_launch(
    const void* gu, const void* gs, const void* gp, const void* first,
    const void* u, const void* u_prev, const void* s_prev, void* d_cur,
    void* d_u_prev, void* d_s_prev, void* partial, void* d_b, int cells,
    int n_img, int H, int W, int F, int win, int vec, int tx, int ty, int gx,
    float beta, float thr, float slope, int subtract_reset, void* stream) {
  const Geo g = geometry(n_img, H, W, F, win, vec, tx);
  auto s = (cudaStream_t)stream;
  if ((long long)cells * n_img * H * W * F == 0) {
    if (d_b != nullptr)
      return (int)cudaMemsetAsync(d_b, 0, sizeof(float) * cells * F, s);
    return (int)cudaSuccess;
  }
  const dim3 grid(gx, cells * g.chunks), block(tx, ty);
  float* part = d_b != nullptr ? (float*)partial : nullptr;
  if (vec == 4)
    conv_epilogue_bwd_kernel<4><<<grid, block, 0, s>>>(
        (const float*)gu, (const float*)gs, (const float*)gp,
        (const uint8_t*)first, (const float*)u, (const float*)u_prev,
        (const float*)s_prev, (float*)d_cur, (float*)d_u_prev,
        (float*)d_s_prev, part, g, beta, thr, slope, subtract_reset);
  else
    conv_epilogue_bwd_kernel<1><<<grid, block, 0, s>>>(
        (const float*)gu, (const float*)gs, (const float*)gp,
        (const uint8_t*)first, (const float*)u, (const float*)u_prev,
        (const float*)s_prev, (float*)d_cur, (float*)d_u_prev,
        (float*)d_s_prev, part, g, beta, thr, slope, subtract_reset);
  const int err = (int)cudaGetLastError();
  if (err != 0 || d_b == nullptr) return err;
  conv_epilogue_bias_kernel<<<dim3(F, cells), kBiasThreads, 0, s>>>(
      part, (float*)d_b, gx, F);
  return (int)cudaGetLastError();
}
