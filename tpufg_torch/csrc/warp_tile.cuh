// The tile walk shared by the two block-granular warps (warp_block.cu,
// warp_matmul.cu).
//
// Both warps move every pixel of a g x g block by the block's one offset,
// with edge-clamped taps and, in blend mode, an out-of-range mask per side.
// So a thread owns a cell of V consecutive output columns x RT consecutive
// output rows inside one MV block: the offset, its integer part and
// fraction, the lerp weights and the column clamp are computed once per
// cell, and each row of taps is read once and serves every output that
// needs it.
//
// - Integer offsets (warp_matmul.cu's whole-pixel moves): V taps per output
//   row, one row.
// - Fractional offsets: V + 1 taps of each of the RT + 1 tap rows; output
//   row j lerps the horizontal sums of tap rows j and j + 1, and tap row
//   j + 1 serves output row j + 1 too (the same offset, so the same
//   columns and weights: bitwise the value a per-pixel walk computes).
//   At V = 4, RT = 2 that is 15 loads per 8 outputs and frame, against 32
//   for one thread per pixel.
//
// NCH channels (compile-time, up to WARP_NCH = 2; a runtime loop over
// groups of NCH covers the rest) and both frames of a tap row are loaded
// before any of their arithmetic, so a thread keeps up to 20 loads in
// flight.  Stores are 16 bytes where the row is aligned, scalar at a
// ragged or cropped edge.
// A block is 32 x WARP_ROWS threads: a warp covers 32 * V columns of one
// row band, and a block 32 * V columns x WARP_ROWS * RT rows (128 x 8 at
// the defaults).  No shared memory: the taps neighbouring threads share
// are L1 hits.
//
// What each warp computes is its policy P (see the .cu files):
//   P::kFrac             bilinear (true) or one tap per output (false)
//   P::weights(f)        (weight of tap k, weight of tap k + 1) of fraction f
//   P::load(x)           a tap's value in the domain the warp moves it in
//   P::hlerp(a, b, w)    horizontal lerp of taps a, b
//   P::vlerp(t, b, w)    vertical lerp of two horizontal sums
//   P::finish(o)         back from the moving domain to f32
// each with one _rn intrinsic per operation, in its plain version's order.
// launch<P> runs the warp in one launch (Args: its operands and sizes).
//
// The knobs are compile-time: WARP_V (outputs of one row per thread),
// WARP_RT (rows per thread), WARP_ROWS (thread rows per block) and
// WARP_NCH (the most channels walked together).  A g that WARP_V or
// WARP_RT does not divide runs the V = 1, RT = 1 walk.  The defaults are
// the fastest of the variants timed on the H100 (PERF.md section 6): two
// channels walked together, not four, and blocks of 128 threads, not 256,
// let more blocks share an SM (the fractional blend needs 128 registers a
// thread at two channels, 221 at four).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef WARP_V
#define WARP_V 4
#endif
#ifndef WARP_RT
#define WARP_RT 2
#endif
#ifndef WARP_ROWS
#define WARP_ROWS 4
#endif
#ifndef WARP_NCH
#define WARP_NCH 2
#endif

namespace warp_tile {

constexpr int kThreadsX = 32;

// The offset o of one axis split into its integer part and fraction.
struct Split {
  int i0;
  float f;
};

__device__ __forceinline__ Split split(float o) {
  const float fl = floorf(o);
  return {static_cast<int>(fl), __fsub_rn(o, fl)};
}

// 1 where the sample point pos + o lies in [-0.5, size - 0.5], else 0
__device__ __forceinline__ float in_range(int pos, float o, int size) {
  const float p = __fadd_rn(static_cast<float>(pos), o);
  return (p >= -0.5f && p <= __fsub_rn(static_cast<float>(size), 0.5f))
             ? 1.0f
             : 0.0f;
}

// x rounded to bf16 (round to nearest even) and back where BF16, else x
template <bool BF16>
__device__ __forceinline__ float to_dt(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Lerp weights of one axis: w0 for tap k, w1 for tap k + 1.
struct Weights {
  float w0, w1;
};

// One side of the warp (prev or curr): its offset in both axes, the lerp
// weights, and the mask of each of the cell's columns and rows (1 in
// single mode).
template <class P, int V, int RT>
struct Side {
  Split sx, sy;
  Weights wx, wy;
  float mx[V], my[RT];

  __device__ __forceinline__ Side(float ox, float oy, int x0, int y0, int w,
                                  int h, bool masked) {
    sx = split(ox);
    sy = split(oy);
    wx = P::weights(sx.f);
    wy = P::weights(sy.f);
#pragma unroll
    for (int k = 0; k < V; ++k) mx[k] = masked ? in_range(x0 + k, ox, w) : 1.f;
#pragma unroll
    for (int j = 0; j < RT; ++j) my[j] = masked ? in_range(y0 + j, oy, h) : 1.f;
  }
};

// The N taps of one plane's row `row` (clamped to the frame) from column
// c0 on, each column clamped to the frame, as loaded (no arithmetic).
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ plane,
                                         int h, int w, int row, int c0,
                                         float (&t)[N]) {
  const float* p = plane + static_cast<int64_t>(min(max(row, 0), h - 1)) * w;
  if (c0 >= 0 && c0 + N <= w) {
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = p[c0 + k];
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = p[min(max(c0 + k, 0), w - 1)];
  }
}

// V values to dst: 16-byte stores where aligned, else scalar; only the
// first n (the columns left of a cropped or ragged edge) are written.
template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int n,
                                          const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    if (n >= V && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < n) dst[k] = v[k];
  }
}

// One output row j of the cell: blend or single, then store.  PAIR
// stores the blend's operands instead: prev's warped value to plane c,
// curr's to plane n_ch + c (both unmasked, relative to out, the cell's
// first channel), and from the cell's first channel group the masks of
// both sides to planes 2 n_ch and 2 n_ch + 1.
template <int V, int RT, int NCH, bool SINGLE, bool PAIR>
__device__ __forceinline__ void emit_row(float* __restrict__ out,
                                         int64_t out_plane, int row_off,
                                         int n, const float (&vp)[NCH][V],
                                         const float (&vc)[NCH][V],
                                         const float (&mpx)[V], float mpy,
                                         const float (&mcx)[V], float mcy,
                                         float t, float omt, int n_ch,
                                         int c_first) {
  if constexpr (PAIR) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      store_row<V>(out + c * out_plane + row_off, n, vp[c]);
      store_row<V>(out + (n_ch + c) * out_plane + row_off, n, vc[c]);
    }
    if (c_first == 0) {
      float pm[V], cm[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        pm[k] = __fmul_rn(mpx[k], mpy);
        cm[k] = __fmul_rn(mcx[k], mcy);
      }
      store_row<V>(out + 2 * n_ch * out_plane + row_off, n, pm);
      store_row<V>(out + (2 * n_ch + 1) * out_plane + row_off, n, cm);
    }
  } else {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (SINGLE) {
          o[k] = vp[c][k];
        } else {
          // p * pmask * (1 - t) + q * cmask * t, the mask the product of
          // the column's and the row's 0/1 (exact)
          const float pm = __fmul_rn(mpx[k], mpy);
          const float cm = __fmul_rn(mcx[k], mcy);
          o[k] = __fadd_rn(__fmul_rn(__fmul_rn(vp[c][k], pm), omt),
                           __fmul_rn(__fmul_rn(vc[c][k], cm), t));
        }
      }
      store_row<V>(out + c * out_plane + row_off, n, o);
    }
  }
}

// The walk of one cell for NCH channels from channel c_first on.
//   prev, curr, out: planar f32 [n_ch, h, w] in, [n_ch, out_h, out_w] out
//   (out_h <= h, out_w <= w: the crop's top-left window; PAIR: [2 n_ch +
//   2, h, w], see emit_row)
//   sp, sc: each side's offsets, weights and masks (single: sp only)
template <class P, int V, int RT, int NCH, bool SINGLE, bool PAIR>
__device__ __forceinline__ void walk_cell(
    const float* __restrict__ prev, const float* __restrict__ curr,
    float* __restrict__ out, int n_ch, int c_first, int h, int w, int out_h,
    int out_w, int x0, int y0, const Side<P, V, RT>& sp,
    const Side<P, V, RT>& sc, float t, float omt) {
  constexpr int kTaps = P::kFrac ? V + 1 : V;
  constexpr int kRows = P::kFrac ? RT + 1 : RT;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  const float* pp = prev + c_first * plane;
  const float* cp = curr + c_first * plane;
  float* op = out + c_first * out_plane;
  const int n = min(V, out_w - x0);
  const int pc0 = x0 + sp.sx.i0, cc0 = x0 + sc.sx.i0;
  const int pr0 = y0 + sp.sy.i0, cr0 = y0 + sc.sy.i0;

  float hp[NCH][V], hc[NCH][V];  // the last tap row's horizontal sums
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // every channel's and both frames' taps of this tap row first
    float tp[NCH][kTaps], tc[NCH][kTaps];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      load_row<kTaps>(pp + c * plane, h, w, pr0 + r, pc0, tp[c]);
      if constexpr (!SINGLE) {
        load_row<kTaps>(cp + c * plane, h, w, cr0 + r, cc0, tc[c]);
      }
    }
    float vp[NCH][V], vc[NCH][V];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (P::kFrac) {
          const float sp_k = P::hlerp(P::load(tp[c][k]), P::load(tp[c][k + 1]),
                                      sp.wx);
          vp[c][k] = r ? P::finish(P::vlerp(hp[c][k], sp_k, sp.wy)) : 0.f;
          hp[c][k] = sp_k;
          if constexpr (!SINGLE) {
            const float sc_k = P::hlerp(P::load(tc[c][k]),
                                        P::load(tc[c][k + 1]), sc.wx);
            vc[c][k] = r ? P::finish(P::vlerp(hc[c][k], sc_k, sc.wy)) : 0.f;
            hc[c][k] = sc_k;
          } else {
            vc[c][k] = 0.f;
          }
        } else {
          vp[c][k] = P::finish(P::load(tp[c][k]));
          vc[c][k] = SINGLE ? 0.f : P::finish(P::load(tc[c][k]));
        }
      }
    }
    // the output row this tap row completes
    const int j = P::kFrac ? r - 1 : r;
    if (j >= 0 && y0 + j < out_h) {
      emit_row<V, RT, NCH, SINGLE, PAIR>(
          op, out_plane, (y0 + j) * out_w + x0, n, vp, vc, sp.mx,
          sp.my[j < 0 ? 0 : j], sc.mx, sc.my[j < 0 ? 0 : j], t, omt, n_ch,
          c_first);
    }
  }
}

// A warp's launch: planar f32 prev and curr [n_ch, h, w] (curr unread in
// single mode), mv f32 [2, h/g, w/g] (dx, dy), out f32 [n_ch, out_h,
// out_w] (out_h <= h, out_w <= w: the top-left window), h and w multiples
// of g, r the clip radius, t and omt = fl(1 - t) the blend weights.
struct Args {
  const float *prev, *curr, *mv;
  float* out;
  int n_ch, h, w, g;
  float r, t, omt;
  int out_h, out_w;
  int valid_w;  // the blend masks' right edge (w, or less before a pad)
};

// The whole warp: each thread one cell, all channels.  MVs clipped to
// +-r; blend offsets m * (-t) for prev and m * omt for curr, single mode
// m itself.
template <class P, int V, int RT, int NCH, bool SINGLE, bool PAIR>
__global__ void __launch_bounds__(kThreadsX * WARP_ROWS)
    walk_kernel(const Args a) {
  const int x0 = (blockIdx.x * kThreadsX + threadIdx.x) * V;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * RT;
  if (x0 >= a.out_w || y0 >= a.out_h) return;
  const int nbx = a.w / a.g;
  const int64_t blk = static_cast<int64_t>(y0 / a.g) * nbx + x0 / a.g;
  const int64_t mv_plane = static_cast<int64_t>(a.h / a.g) * nbx;
  const float mdx = fminf(fmaxf(a.mv[blk], -a.r), a.r);
  const float mdy = fminf(fmaxf(a.mv[mv_plane + blk], -a.r), a.r);
  const Side<P, V, RT> sp =
      SINGLE ? Side<P, V, RT>(mdx, mdy, x0, y0, a.w, a.h, false)
             : Side<P, V, RT>(__fmul_rn(mdx, -a.t), __fmul_rn(mdy, -a.t), x0,
                              y0, a.valid_w, a.h, true);
  const Side<P, V, RT> sc =
      SINGLE ? sp
             : Side<P, V, RT>(__fmul_rn(mdx, a.omt), __fmul_rn(mdy, a.omt),
                              x0, y0, a.valid_w, a.h, true);
  for (int c = 0; c < a.n_ch; c += NCH) {
    walk_cell<P, V, RT, NCH, SINGLE, PAIR>(a.prev, a.curr, a.out, a.n_ch, c,
                                           a.h, a.w, a.out_h, a.out_w, x0,
                                           y0, sp, sc, a.t, a.omt);
  }
}

template <class P, int V, int RT, int NCH>
cudaError_t launch_cells(const Args& a, bool single, bool pair,
                         cudaStream_t stream) {
  const int cols = kThreadsX * V, rows = WARP_ROWS * RT;
  const dim3 threads(kThreadsX, WARP_ROWS);
  const dim3 blocks((a.out_w + cols - 1) / cols, (a.out_h + rows - 1) / rows);
  if (single) {
    walk_kernel<P, V, RT, NCH, true, false><<<blocks, threads, 0, stream>>>(a);
  } else if (pair) {
    walk_kernel<P, V, RT, NCH, false, true><<<blocks, threads, 0, stream>>>(a);
  } else {
    walk_kernel<P, V, RT, NCH, false, false><<<blocks, threads, 0, stream>>>(
        a);
  }
  return cudaGetLastError();
}

// NCH, the channels a cell walks together: the most up to WARP_NCH that
// divide n_ch
template <class P, int V, int RT, int NCH = WARP_NCH>
cudaError_t launch_channels(const Args& a, bool single, bool pair,
                            cudaStream_t stream) {
  if constexpr (NCH > 1) {
    if (a.n_ch % NCH) {
      return launch_channels<P, V, RT, NCH - 1>(a, single, pair, stream);
    }
  }
  return launch_cells<P, V, RT, NCH>(a, single, pair, stream);
}

// The warp of policy P, one launch on `stream`: cells of WARP_V x WARP_RT
// where they divide g, else of one pixel.  pair (blend mode, out [2 n_ch +
// 2, h, w], out_h = h, out_w = w): the blend's operands, not the blend.
template <class P>
cudaError_t launch(const Args& a, bool single, cudaStream_t stream,
                   bool pair = false) {
  if (a.g % WARP_V == 0 && a.g % WARP_RT == 0) {
    return launch_channels<P, WARP_V, WARP_RT>(a, single, pair, stream);
  }
  return launch_channels<P, 1, 1>(a, single, pair, stream);
}

}  // namespace warp_tile
