// The engine's per-pixel (OBMC) warp: warp_blend_matmul(bilinear=True).
//
// Replaces the obmc branch of tpufg/kernels/warp_matmul.py:_warp_one
// (:136-161, 216-251) and its offsets and mask (:378-404), an XLA op of
// the reference, not a Pallas kernel.  Computes what
// tpufg_torch/kernels/warp_matmul.py::warp_obmc_plain computes, bitwise:
//
// - planar f32 prev and curr [C, H, W]; per side (prev moved by -t, curr by
//   1 - t; single mode: prev by 1) the per-column offsets of every band j,
//   offs [2 sides][dx, dy][H/g][W] f32, made on the host side by
//   jax.image.resize's linear weights (the clipped MVs times the side's
//   scale, resized along x; kernels/resize.py), so this kernel does no
//   resize weights of its own;
// - band j warps image rows j*g - g/2 .. j*g + 3g/2 by its offsets: at
//   each column the offset splits into floor and fraction, the centred
//   values fl(x - 0.5) in the moving type are lerped horizontally (an f32
//   sum rounded once to the type) on two tap rows, then vertically in the
//   type (MatmulPolicy<true, false, BF16> of warp_matmul_policy.cuh);
// - output row y = j*g + g/2 + k blends band j and band j + 1 in the type,
//   a * fl(1 - w) + b * w with w = fl((k + 0.5) / g), each product and the
//   sum rounded to the type; the first and last g/2 rows take the edge
//   band alone; back by fl(o + 0.5);
// - the blend masks each side where its sample point leaves [-0.5,
//   valid_w - 0.5] x [-0.5, H - 0.5], the displacement being the offsets
//   resized along y too (taps ty_*: row y reads offset rows i0[y] and
//   min(i0[y] + 1, H/g - 1); the lower product rounded, plus 0, the upper
//   one fused into it: an f64 sum rounded to f32, as
//   kernels/resize.py::fused_lerp), and returns
//   wp*mask_p*(1-t) + wc*mask_c*t;
// - mode 2 (pair) writes the blend's operands instead, [2C + 2, H, W]: wp
//   unmasked (C planes), wc unmasked, mask_p, mask_c (warp_epilogue.cu).
// Every operation is one _rn intrinsic in the plain version's order.
//
// Bound on the H100: device memory, each input read once and each output
// written once (prev, curr, the offsets, the output: 100 MB for a 1080p
// blend, 0.030 ms at 3.35 TB/s; the pair 134 MB).  Design (a first, plain
// form): a thread owns one column and kRows consecutive output rows, which
// lie between the same two band sites (kRows divides g/2), so each band's
// offsets, split and weights are made once per thread and each of its
// kRows + 1 tap rows is read once (two taps) and serves two output rows.
// The two bands read overlapping rows again; neighbouring threads' taps
// are neighbouring columns (coalesced, L1 hits).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_matmul_policy.cuh"
#include "warp_tile.cuh"

namespace {

constexpr int kRows = 4;       // output rows a thread; divides g/2
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

struct ObmcArgs {
  const float *prev, *curr, *offs;
  const int* ty_i0;
  const float *ty_w0, *ty_w1;
  float* out;
  int n_ch, h, w, g, valid_w;
  float t, omt;
  int out_h, out_w;
};

// b * w1 fused into fl(a * w0) + 0 with one rounding (kernels/resize.py)
__device__ __forceinline__ float fused_lerp(float a, float w0, float b,
                                            float w1) {
  const float p = __fadd_rn(__fmul_rn(a, w0), 0.0f);
  return __double2float_rn(
      __dadd_rn(static_cast<double>(p),
                __dmul_rn(static_cast<double>(b), static_cast<double>(w1))));
}

// One band's offset at one column, split, with its lerp weights.
template <class P>
struct Band {
  int ix0, iy0;
  warp_tile::Weights wx, wy;

  __device__ __forceinline__ Band(const float* __restrict__ side, int n_by,
                                  int w, int j, int x) {
    const int64_t plane = static_cast<int64_t>(n_by) * w;
    const warp_tile::Split sx =
        warp_tile::split(side[static_cast<int64_t>(j) * w + x]);
    const warp_tile::Split sy =
        warp_tile::split(side[plane + static_cast<int64_t>(j) * w + x]);
    ix0 = sx.i0;
    iy0 = sy.i0;
    wx = P::weights(sx.f);
    wy = P::weights(sy.f);
  }
};

// The band's values (in the moving type, not finished) at output rows
// y0 .. y0 + kRows - 1 of column x of one plane.
template <class P>
__device__ __forceinline__ void band_rows(const float* __restrict__ plane,
                                          int h, int w, int x, int y0,
                                          const Band<P>& b,
                                          float (&v)[kRows]) {
  const int c0 = min(max(x + b.ix0, 0), w - 1);
  const int c1 = min(max(x + b.ix0 + 1, 0), w - 1);
  float prev_sum = 0.f;
#pragma unroll
  for (int r = 0; r <= kRows; ++r) {
    const float* row =
        plane + static_cast<int64_t>(min(max(y0 + r + b.iy0, 0), h - 1)) * w;
    const float s = P::hlerp(P::load(row[c0]), P::load(row[c1]), b.wx);
    if (r) v[r - 1] = P::vlerp(prev_sum, s, b.wy);
    prev_sum = s;
  }
}

// mode: 0 single, 1 blend, 2 pair
template <bool BF16, int MODE>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    obmc_kernel(const ObmcArgs a) {
  using P = MatmulPolicy<true, false, BF16>;
  constexpr int kSides = MODE == 0 ? 1 : 2;
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y0 = (blockIdx.y * kThreadsY + threadIdx.y) * kRows;
  const int lim_w = MODE == 2 ? a.w : a.out_w;
  const int lim_h = MODE == 2 ? a.h : a.out_h;
  if (x >= lim_w || y0 >= lim_h) return;
  const int g = a.g, n_by = a.h / g, half = g / 2;
  // the two bands of these rows and band b's weight per row
  const bool alone = y0 < half || y0 >= n_by * g - half;
  const int j = alone ? (y0 < half ? 0 : n_by - 1) : (y0 - half) / g;
  const int k0 = alone ? 0 : (y0 - half) % g;
  float wb[kRows], wa[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float wy = warp_tile::to_dt<BF16>(__fdiv_rn(
        __fadd_rn(static_cast<float>(k0 + r), 0.5f), static_cast<float>(g)));
    wb[r] = wy;
    wa[r] = warp_tile::to_dt<BF16>(__fsub_rn(1.0f, wy));
  }
  const int64_t side_stride = 2 * static_cast<int64_t>(n_by) * a.w;
  // each side's masks of the kRows pixels
  float mask[kSides][kRows];
#pragma unroll
  for (int s = 0; s < kSides; ++s) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      mask[s][r] = 1.f;
      if constexpr (MODE != 0) {
        const int y = y0 + r;
        const float* dxp = a.offs + s * side_stride;
        const float* dyp = dxp + static_cast<int64_t>(n_by) * a.w;
        const int i0 = a.ty_i0[y], i1 = min(i0 + 1, n_by - 1);
        const float w0 = a.ty_w0[y], w1 = a.ty_w1[y];
        const float fx = fused_lerp(dxp[static_cast<int64_t>(i0) * a.w + x],
                                    w0,
                                    dxp[static_cast<int64_t>(i1) * a.w + x],
                                    w1);
        const float fy = fused_lerp(dyp[static_cast<int64_t>(i0) * a.w + x],
                                    w0,
                                    dyp[static_cast<int64_t>(i1) * a.w + x],
                                    w1);
        mask[s][r] = __fmul_rn(warp_tile::in_range(x, fx, a.valid_w),
                               warp_tile::in_range(y, fy, a.h));
      }
    }
  }
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  const int64_t out_plane = static_cast<int64_t>(lim_h) * lim_w;
  for (int c = 0; c < a.n_ch; ++c) {
    float val[kSides][kRows];
#pragma unroll
    for (int s = 0; s < kSides; ++s) {
      const float* src = (s ? a.curr : a.prev) + c * plane;
      const float* side = a.offs + s * side_stride;
      float va[kRows];
      band_rows<P>(src, a.h, a.w, x, y0, Band<P>(side, n_by, a.w, j, x), va);
      if (alone) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) val[s][r] = P::finish(va[r]);
      } else {
        float vb[kRows];
        band_rows<P>(src, a.h, a.w, x, y0,
                     Band<P>(side, n_by, a.w, j + 1, x), vb);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          val[s][r] = P::finish(warp_tile::to_dt<BF16>(__fadd_rn(
              warp_tile::to_dt<BF16>(__fmul_rn(va[r], wa[r])),
              warp_tile::to_dt<BF16>(__fmul_rn(vb[r], wb[r])))));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 + r;
      if (y >= lim_h) break;
      const int64_t at = static_cast<int64_t>(y) * lim_w + x;
      if constexpr (MODE == 0) {
        a.out[c * out_plane + at] = val[0][r];
      } else if constexpr (MODE == 1) {
        a.out[c * out_plane + at] =
            __fadd_rn(__fmul_rn(__fmul_rn(val[0][r], mask[0][r]), a.omt),
                      __fmul_rn(__fmul_rn(val[1][r], mask[1][r]), a.t));
      } else {
        a.out[c * out_plane + at] = val[0][r];
        a.out[(a.n_ch + c) * out_plane + at] = val[1][r];
      }
    }
  }
  if constexpr (MODE == 2) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t at = static_cast<int64_t>(y0 + r) * lim_w + x;
      a.out[2 * a.n_ch * out_plane + at] = mask[0][r];
      a.out[(2 * a.n_ch + 1) * out_plane + at] = mask[1][r];
    }
  }
}

template <bool BF16>
cudaError_t launch_mode(const ObmcArgs& a, int mode, cudaStream_t stream) {
  const int lim_w = mode == 2 ? a.w : a.out_w;
  const int lim_h = mode == 2 ? a.h : a.out_h;
  const dim3 threads(kThreadsX, kThreadsY);
  const dim3 blocks((lim_w + kThreadsX - 1) / kThreadsX,
                    (lim_h + kThreadsY * kRows - 1) / (kThreadsY * kRows));
  if (mode == 0) {
    obmc_kernel<BF16, 0><<<blocks, threads, 0, stream>>>(a);
  } else if (mode == 1) {
    obmc_kernel<BF16, 1><<<blocks, threads, 0, stream>>>(a);
  } else {
    obmc_kernel<BF16, 2><<<blocks, threads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// prev, curr f32 [n_ch, h, w]; offs f32 [2 * sides, h/g, w] (dx, dy per
// side; one side in single mode); ty_i0 i32 [h], ty_w0, ty_w1 f32 [h]; out
// f32 [n_ch, out_h, out_w] (mode 2: [2 n_ch + 2, h, w]); g a multiple of 8
// dividing h and w (the wrapper checks); valid_w the masks' right edge;
// t and omt = fl(1 - t) the blend weights; mode 0 single, 1 blend, 2 pair;
// bf16 (the moving type) as 0/1.
extern "C" int tpufg_warp_obmc(const void* prev, const void* curr,
                               const void* offs, const void* ty_i0,
                               const void* ty_w0, const void* ty_w1,
                               void* out, int n_ch, int h, int w, int g,
                               int valid_w, float t, float omt, int out_h,
                               int out_w, int mode, int bf16, int device,
                               cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g % (2 * kRows) || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ObmcArgs a{static_cast<const float*>(prev),
                   static_cast<const float*>(curr),
                   static_cast<const float*>(offs),
                   static_cast<const int*>(ty_i0),
                   static_cast<const float*>(ty_w0),
                   static_cast<const float*>(ty_w1),
                   static_cast<float*>(out),
                   n_ch, h, w, g, valid_w, t, omt, out_h, out_w};
  return static_cast<int>(bf16 ? launch_mode<true>(a, mode, stream)
                               : launch_mode<false>(a, mode, stream));
}
