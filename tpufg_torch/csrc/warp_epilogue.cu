// The engine warp's blend options: the occlusion blend and the MC ->
// crossfade fallback, on a warped pair.
//
// Replaces tpufg/kernels/warp_matmul.py:warp_blend_matmul's blend tail
// (:420-453, constants :37-55), an XLA op of the reference, not a Pallas
// kernel.  Computes what
// tpufg_torch/kernels/warp_matmul.py::warp_epilogue_plain computes,
// bitwise.  Input: the pair [2C + 2, H, W] f32 that warp_matmul.cu or
// warp_obmc.cu wrote in pair mode (wp: prev warped by -t, C planes,
// unmasked; wc: curr warped by 1 - t; mask_p; mask_c), and the unwarped
// prev and curr [C, H, W].  Per pixel, channels c:
//
//   out_c = wp_c*mask_p*(1-t) + wc_c*mask_c*t
//   occlusion: d = mean_c |wp_c - wc_c|, k = clip((d - 0.08) * 8, 0, 1),
//     out_c = out_c*(1-k) + chosen_c*k, chosen = the masked side t picks
//     (prev where t <= 0.5);
//   fallback: d_mc = mean over the RGB channels of |wp_c*mask_p -
//     wc_c*mask_c|, d_cf = the same of |prev_c - curr_c|, each as its 8x8
//     cell means resized back to every pixel (jax.image.resize's linear
//     weights: along x, then y, each tap pair the lower product rounded,
//     plus 0, the upper fused into it as an f64 sum rounded to f32; the
//     wrapper passes the taps), or per pixel where 8 does not divide H and
//     W; rel = d_mc / (d_cf + 0.015), wfb = clip((rel - 0.5) / 0.5, 0, 1),
//     out_c = out_c*(1-wfb) + (prev_c*(1-t) + curr_c*t)*wfb.
//
// A mean adds the channels in turn and multiplies by fl(1/n); a cell adds
// each row's 8 values left to right, then the 8 row sums top to bottom,
// times 1/64.  Every operation is one _rn intrinsic in that order.
//
// Two launches when the fallback has cells: tpufg_warp_fallback_cells (a
// thread per cell: [2, H/8, W/8], d_mc then d_cf) and tpufg_warp_epilogue
// (a thread per output pixel of the top-left out_h x out_w window).
// Bound on the H100: device memory.  The blend reads the pair and prev
// and curr once ((3C + 2) values a pixel) and writes C; the cells pass
// reads the RGB planes of both again (8 values a pixel): at [4, 1088,
// 1920] 117 + 67 MB, 0.055 ms at 3.35 TB/s.  Design (a first, plain form):
// one thread per pixel, channels in a loop, the cells' means read back
// from L2; no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCell = 8;
constexpr float kOccD0 = 0.08f, kOccSlope = 8.0f;
constexpr float kFbFloor = 0.015f, kFbLo = 0.5f, kFbSpan = 0.5f;

struct EpArgs {
  const float *pair, *prev, *curr, *cells;
  const int *ty_i0, *tx_i0;
  const float *ty_w0, *ty_w1, *tx_w0, *tx_w1;
  float* out;
  int n_ch, h, w;
  float t, omt;
  int out_h, out_w, occlusion, fallback, pick_prev;
};

// torch.clamp's min(max(v, lo), hi)
__device__ __forceinline__ float clamp01(float v) {
  v = v < 0.0f ? 0.0f : v;
  return 1.0f < v ? 1.0f : v;
}

// b * w1 fused into fl(a * w0) + 0 with one rounding (kernels/resize.py)
__device__ __forceinline__ float fused_lerp(float a, float w0, float b,
                                            float w1) {
  const float p = __fadd_rn(__fmul_rn(a, w0), 0.0f);
  return __double2float_rn(
      __dadd_rn(static_cast<double>(p),
                __dmul_rn(static_cast<double>(b), static_cast<double>(w1))));
}

// the fallback's two terms at one pixel (index at of a plane)
__device__ __forceinline__ void fallback_terms(const float* __restrict__ pair,
                                               const float* __restrict__ prev,
                                               const float* __restrict__ curr,
                                               int n_ch, int64_t plane,
                                               int64_t at, float& d_mc,
                                               float& d_cf) {
  const int nc = min(3, n_ch);
  const float inv = __fdiv_rn(1.0f, static_cast<float>(nc));
  const float mp = pair[2 * n_ch * plane + at];
  const float mc = pair[(2 * n_ch + 1) * plane + at];
  float s_mc = 0.f, s_cf = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float a = fabsf(__fsub_rn(__fmul_rn(pair[c * plane + at], mp),
                                    __fmul_rn(pair[(n_ch + c) * plane + at],
                                              mc)));
    const float b = fabsf(__fsub_rn(prev[c * plane + at],
                                    curr[c * plane + at]));
    s_mc = c ? __fadd_rn(s_mc, a) : a;
    s_cf = c ? __fadd_rn(s_cf, b) : b;
  }
  d_mc = __fmul_rn(s_mc, inv);
  d_cf = __fmul_rn(s_cf, inv);
}

__global__ void cells_kernel(const float* __restrict__ pair,
                             const float* __restrict__ prev,
                             const float* __restrict__ curr,
                             float* __restrict__ cells, int n_ch, int h,
                             int w) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = w / kCell, ny = h / kCell;
  if (cx >= nx || cy >= ny) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  float t_mc = 0.f, t_cf = 0.f;
  for (int r = 0; r < kCell; ++r) {
    float r_mc = 0.f, r_cf = 0.f;
    const int64_t row = static_cast<int64_t>(cy * kCell + r) * w + cx * kCell;
#pragma unroll
    for (int k = 0; k < kCell; ++k) {
      float d_mc, d_cf;
      fallback_terms(pair, prev, curr, n_ch, plane, row + k, d_mc, d_cf);
      r_mc = k ? __fadd_rn(r_mc, d_mc) : d_mc;
      r_cf = k ? __fadd_rn(r_cf, d_cf) : d_cf;
    }
    t_mc = r ? __fadd_rn(t_mc, r_mc) : r_mc;
    t_cf = r ? __fadd_rn(t_cf, r_cf) : r_cf;
  }
  const int64_t at = static_cast<int64_t>(cy) * nx + cx;
  const float inv = 1.0f / (kCell * kCell);   // exact
  cells[at] = __fmul_rn(t_mc, inv);
  cells[static_cast<int64_t>(ny) * nx + at] = __fmul_rn(t_cf, inv);
}

// one cell-mean plane resized to pixel (y, x): along x, then y
__device__ __forceinline__ float resized(const float* __restrict__ m, int ny,
                                         int nx, const EpArgs& a, int y,
                                         int x) {
  const int ya = a.ty_i0[y], yb = min(ya + 1, ny - 1);
  const int xa = a.tx_i0[x], xb = min(xa + 1, nx - 1);
  const float wx0 = a.tx_w0[x], wx1 = a.tx_w1[x];
  const float ra = fused_lerp(m[static_cast<int64_t>(ya) * nx + xa], wx0,
                              m[static_cast<int64_t>(ya) * nx + xb], wx1);
  const float rb = fused_lerp(m[static_cast<int64_t>(yb) * nx + xa], wx0,
                              m[static_cast<int64_t>(yb) * nx + xb], wx1);
  return fused_lerp(ra, a.ty_w0[y], rb, a.ty_w1[y]);
}

__global__ void epilogue_kernel(const EpArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.out_w || y >= a.out_h) return;
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  const int64_t at = static_cast<int64_t>(y) * a.w + x;
  const int n = a.n_ch;
  const float mp = a.pair[2 * n * plane + at];
  const float mc = a.pair[(2 * n + 1) * plane + at];
  float k = 0.f;
  if (a.occlusion) {
    float s = 0.f;
    for (int c = 0; c < n; ++c) {
      const float d = fabsf(__fsub_rn(a.pair[c * plane + at],
                                      a.pair[(n + c) * plane + at]));
      s = c ? __fadd_rn(s, d) : d;
    }
    const float d = __fmul_rn(s, __fdiv_rn(1.0f, static_cast<float>(n)));
    k = clamp01(__fmul_rn(__fsub_rn(d, kOccD0), kOccSlope));
  }
  float wfb = 0.f;
  if (a.fallback) {
    float d_mc, d_cf;
    if (a.fallback == 2) {
      const int ny = a.h / kCell, nx = a.w / kCell;
      d_mc = resized(a.cells, ny, nx, a, y, x);
      d_cf = resized(a.cells + static_cast<int64_t>(ny) * nx, ny, nx, a, y,
                     x);
    } else {
      fallback_terms(a.pair, a.prev, a.curr, n, plane, at, d_mc, d_cf);
    }
    const float rel = __fdiv_rn(d_mc, __fadd_rn(d_cf, kFbFloor));
    wfb = clamp01(__fdiv_rn(__fsub_rn(rel, kFbLo), kFbSpan));
  }
  const int64_t out_plane = static_cast<int64_t>(a.out_h) * a.out_w;
  const int64_t out_at = static_cast<int64_t>(y) * a.out_w + x;
  for (int c = 0; c < n; ++c) {
    const float pm = __fmul_rn(a.pair[c * plane + at], mp);
    const float cm = __fmul_rn(a.pair[(n + c) * plane + at], mc);
    float o = __fadd_rn(__fmul_rn(pm, a.omt), __fmul_rn(cm, a.t));
    if (a.occlusion) {
      o = __fadd_rn(__fmul_rn(o, __fsub_rn(1.0f, k)),
                    __fmul_rn(a.pick_prev ? pm : cm, k));
    }
    if (a.fallback) {
      const float cf = __fadd_rn(__fmul_rn(a.prev[c * plane + at], a.omt),
                                 __fmul_rn(a.curr[c * plane + at], a.t));
      o = __fadd_rn(__fmul_rn(o, __fsub_rn(1.0f, wfb)), __fmul_rn(cf, wfb));
    }
    a.out[c * out_plane + out_at] = o;
  }
}

}  // namespace

// pair f32 [2 n_ch + 2, h, w]; prev, curr f32 [n_ch, h, w]; cells f32
// [2, h/8, w/8] out (h and w multiples of 8: the wrapper checks).
extern "C" int tpufg_warp_fallback_cells(const void* pair, const void* prev,
                                         const void* curr, void* cells,
                                         int n_ch, int h, int w, int device,
                                         cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h % kCell || w % kCell) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 threads(32, 4);
  const dim3 blocks((w / kCell + 31) / 32, (h / kCell + 3) / 4);
  cells_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(pair), static_cast<const float*>(prev),
      static_cast<const float*>(curr), static_cast<float*>(cells), n_ch, h,
      w);
  return static_cast<int>(cudaGetLastError());
}

// pair, prev, curr as above; cells from tpufg_warp_fallback_cells (read
// where fallback == 2) with the row taps ty_* (h/8 -> h) and column taps
// tx_* (w/8 -> w); out f32 [n_ch, out_h, out_w], the top-left window; t
// and omt = fl(1 - t); occlusion 0/1; fallback 0 off, 1 per pixel, 2 by
// cells; pick_prev 1 where t <= 0.5 (the occlusion's chosen side).
extern "C" int tpufg_warp_epilogue(const void* pair, const void* prev,
                                   const void* curr, const void* cells,
                                   const void* ty_i0, const void* ty_w0,
                                   const void* ty_w1, const void* tx_i0,
                                   const void* tx_w0, const void* tx_w1,
                                   void* out, int n_ch, int h, int w, float t,
                                   float omt, int out_h, int out_w,
                                   int occlusion, int fallback, int pick_prev,
                                   int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EpArgs a{static_cast<const float*>(pair),
                 static_cast<const float*>(prev),
                 static_cast<const float*>(curr),
                 static_cast<const float*>(cells),
                 static_cast<const int*>(ty_i0),
                 static_cast<const int*>(tx_i0),
                 static_cast<const float*>(ty_w0),
                 static_cast<const float*>(ty_w1),
                 static_cast<const float*>(tx_w0),
                 static_cast<const float*>(tx_w1),
                 static_cast<float*>(out),
                 n_ch, h, w, t, omt, out_h, out_w, occlusion, fallback,
                 pick_prev};
  const dim3 threads(64, 4);
  const dim3 blocks((out_w + 63) / 64, (out_h + 3) / 4);
  epilogue_kernel<<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
