// The engine's per-pixel (OBMC) warp: warp_blend_matmul(bilinear=True).
//
// Replaces the obmc branch of tpufg/kernels/warp_matmul.py:_warp_one
// (:136-161, 216-251) and its offsets and mask (:378-404), an XLA op of
// the reference, not a Pallas kernel.  Computes what
// tpufg_torch/kernels/warp_matmul.py::warp_obmc_plain computes, bitwise:
//
// - planar f32 prev and curr [C, H, W] and the MV lattice mv [2, H/g, W/g];
//   per side (prev moved by -t, curr by 1 - t; single mode: prev by 1) the
//   per-column offset of band j at column x is the clipped MV times the
//   side's scale at lattice columns i0[x] and i1[x] = min(i0[x] + 1, W/g -
//   1), resized along x by jax.image.resize's linear weights (taps tx_*:
//   the lower product rounded, plus 0, the upper one fused into it, an f64
//   sum rounded to f32, as kernels/resize.py::fused_lerp): what
//   warp_matmul.py::obmc_offsets makes in torch, made here;
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
//   resized along y too (taps ty_*: row y reads band rows i0[y] and
//   min(i0[y] + 1, H/g - 1), fused as above), and returns
//   wp*mask_p*(1-t) + wc*mask_c*t;
// - mode 2 (pair) writes the blend's operands instead, [2C + 2, H, W]: wp
//   unmasked (C planes), wc unmasked, mask_p, mask_c (warp_epilogue.cu);
// - mode 3 writes the pair and the MC fallback's cell means [2, H/8, W/8]
//   of it (warp_epilogue.cu's cells pass, fallback_cells_plain): d_mc, the
//   mean over the RGB channels of |wp*mask_p - wc*mask_c|, and d_cf, that
//   of |prev - curr|, each pixel's; a cell adds its rows' 8 values left to
//   right, the 8 row sums top to bottom, times 1/64.
// Every operation is one _rn intrinsic in the plain version's order.
//
// Bound on the H100: device memory, each input read once and each output
// written once (prev, curr, the MVs, the output: the pair at [4, 1088,
// 1920] is 151 MB, 0.045 ms at 3.35 TB/s).  Design, a tile walk that makes
// its own offsets:
// - a block of 32 x OBMC_ROWS threads covers 32 * OBMC_V columns x
//   OBMC_ROWS * OBMC_RT rows.  It first makes the offsets of every band its
//   rows read (at most (rows - 1) / 8 + 3 bands, g >= 8), both sides and
//   axes, one per column, into shared memory: the wrapper runs no torch op
//   before the launch, and a call is one kernel;
// - a thread owns OBMC_V columns x OBMC_RT rows that lie between the same
//   two band sites (OBMC_RT divides g / 2): per side it splits each band's
//   offset of each column once, for every channel.  Per group of OBMC_NCH
//   channels it walks the OBMC_RT + 1 tap rows once: both bands' taps of
//   every column and channel of a tap row are loaded before any
//   arithmetic, each tap row's horizontal sums serve the two output rows
//   they lie between, and a row is stored as soon as it is complete;
// - in bf16 the roundings, not the loads, set the time (the f32 walk took
//   0.108 ms, the bf16 one 0.148 with a conversion per rounding): a
//   thread rounds two channels at once (cvt.rn.bf16x2.f32) and does the
//   vertical lerp and the band blend on bf16 pairs (mul.rn and add.rn
//   .bf16x2), bitwise the same values (bf2_lerp below);
// - the sides run one after the other: pair mode writes each side's
//   planes, blend mode writes prev's masked term and adds curr's to it
//   (the same thread reads back what it wrote);
// - mode 3: a tile holds whole 8 x 8 cells.  On prev's side a thread keeps
//   its pixels' wp*mask_p of the RGB channels in shared memory, on curr's
//   side it adds |that - wc*mask_c| channel by channel; then each pixel's
//   two means, a barrier, one thread per (term, row, cell) for the row
//   sums, another barrier, one per (term, cell) for the columns.  The
//   separate cells pass re-read 8 of the pair's planes (0.112 ms for it
//   and the blend; 0.069 for the blend alone, the warp 0.107 -> 0.133).
// The defaults (one column, 4 rows and all 4 channels a thread, 128
// threads a block, the tap rows' loop rolled) are the fastest of the
// variants timed on the H100 (tools/torch_kernel_variants.py --variants
// obmc; PERF.md section 6).  The taps come through L1: a window of the
// source in shared memory (staged per channel group, sized from the
// block's offsets) lost by 2x.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_matmul_policy.cuh"
#include "warp_tile.cuh"

#ifndef OBMC_V
#define OBMC_V 1
#endif
#ifndef OBMC_RT
#define OBMC_RT 4
#endif
#ifndef OBMC_ROWS
#define OBMC_ROWS 4
#endif
#ifndef OBMC_NCH
#define OBMC_NCH 4
#endif

namespace {

constexpr int kThreadsX = 32;
constexpr int kV = OBMC_V;                  // columns a thread
constexpr int kRT = OBMC_RT;                // rows a thread
constexpr int kRows = OBMC_ROWS;            // thread rows a block
constexpr int kTileW = kThreadsX * kV;      // a block's columns
constexpr int kTileH = kRows * kRT;         // a block's rows
// band rows a block stages: its rows' bands (floor((y - g/2) / g),
// clipped) span at most (kTileH - 1) / g + 2 values for g >= 8, and each
// row also reads the band after its own
constexpr int kBands = (kTileH - 1) / 8 + 3;
// the launch bound's blocks per SM: at most 128 registers a thread (the
// fastest variants fit; more registers spilled or cost blocks)
constexpr int kMinBlocks = 65536 / (kThreadsX * kRows * 128);
static_assert(kRT == 1 || kRT == 2 || kRT == 4,
              "OBMC_RT must divide g / 2 for every g that 8 divides");

struct ObmcArgs {
  const float *prev, *curr, *mv;
  const int *tx_i0, *ty_i0;
  const float *tx_w0, *tx_w1, *ty_w0, *ty_w1;
  float* out;
  int n_ch, h, w, g, valid_w;
  float r, t, omt;
  int out_h, out_w;
  float* cells;   // mode 3: the MC fallback's cell means [2, h/8, w/8]
};

// b * w1 fused into fl(a * w0) + 0 with one rounding (kernels/resize.py)
__device__ __forceinline__ float fused_lerp(float a, float w0, float b,
                                            float w1) {
  const float p = __fadd_rn(__fmul_rn(a, w0), 0.0f);
  return __double2float_rn(
      __dadd_rn(static_cast<double>(p),
                __dmul_rn(static_cast<double>(b), static_cast<double>(w1))));
}

// The band row y reads first: floor((y - g/2) / g) clipped to the lattice
// (the row taps' i0[y] of H/g -> H, and the plain version's ja).
__device__ __forceinline__ int band_of(int y, int g, int n_by) {
  return y < g / 2 ? 0 : min((y - g / 2) / g, n_by - 1);
}

// V values to dst: 16- or 8-byte stores where aligned and whole, else
// scalar; only the first n are written.
template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ dst, int n,
                                           const float (&v)[V]) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  if constexpr (V % 4 == 0) {
    if (n >= V && (at & 15) == 0) {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
      return;
    }
  }
  if constexpr (V % 2 == 0) {
    if (n >= V && (at & 7) == 0) {
#pragma unroll
      for (int k = 0; k < V; k += 2) {
        *reinterpret_cast<float2*>(dst + k) = make_float2(v[k], v[k + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < n) dst[k] = v[k];
  }
}

// One band's offsets at a thread's V columns, split once: the tap
// columns and the tap row offset, clamped to the frame, and both axes'
// lerp weights.
template <class P>
struct BandCols {
  int c0[kV], c1[kV], iy0[kV];
  warp_tile::Weights wx[kV], wy[kV];

  __device__ __forceinline__ BandCols(const float* __restrict__ dx,
                                      const float* __restrict__ dy, int x0,
                                      int w) {
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const warp_tile::Split sx = warp_tile::split(dx[k]);
      const warp_tile::Split sy = warp_tile::split(dy[k]);
      c0[k] = min(max(x0 + k + sx.i0, 0), w - 1);
      c1[k] = min(max(x0 + k + sx.i0 + 1, 0), w - 1);
      iy0[k] = sy.i0;
      wx[k] = P::weights(sx.f);
      wy[k] = P::weights(sy.f);
    }
  }

  // the taps of tap row y0 + r (rows clamped) of NCH planes from src on,
  // as stored (not yet in the moving domain)
  template <int NCH>
  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int64_t plane, int h, int w, int y0,
                                       int r, float (&t)[NCH][kV][2]) const {
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const float* row =
          src + static_cast<int64_t>(min(max(y0 + r + iy0[k], 0), h - 1)) * w;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        t[c][k][0] = row[c * plane + c0[k]];
        t[c][k][1] = row[c * plane + c1[k]];
      }
    }
  }
};

// bf16 pairs: two values of the moving type in one register, the lower
// half the first.  cvt rounds each f32 to bf16 (to nearest even); mul and
// add round once, and their .rn keeps the compiler from fusing them into
// an fma.  A product of two bf16 values is exact in f32, and an f32 sum of
// two bf16 values rounds to the bf16 of their exact sum, so a pair's
// operation gives what the plain version's f32 operation rounded to bf16
// gives.
__device__ __forceinline__ unsigned bf2_pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf2_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf2_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// a * w0 + b * w1 of bf16 pairs and bf16 weights (both halves the same):
// MatmulPolicy<true, false, true>::vlerp, and the band blend
__device__ __forceinline__ unsigned bf2_lerp(unsigned a, unsigned w0,
                                             unsigned b, unsigned w1) {
  return bf2_add(bf2_mul(a, w0), bf2_mul(b, w1));
}

// The horizontal sums of one band's tap row in bf16 pairs of channels (2p,
// 2p + 1; an odd NCH's last pair repeats its channel): the centred taps
// fl(x - 0.5) rounded to bf16 two at a time, each channel's f32 lerp
// a * w0 + b * w1, the pair of sums rounded to bf16 (MatmulPolicy<true,
// false, true>::load and ::hlerp).
template <int NCH>
__device__ __forceinline__ void hsums_bf16(const float (&t)[NCH][kV][2],
                                           const warp_tile::Weights (&wx)[kV],
                                           unsigned (&s)[(NCH + 1) / 2][kV]) {
#pragma unroll
  for (int p = 0; p < (NCH + 1) / 2; ++p) {
    const int lo = 2 * p, hi = min(2 * p + 1, NCH - 1);
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const unsigned a = bf2_pack(__fsub_rn(t[lo][k][0], 0.5f),
                                  __fsub_rn(t[hi][k][0], 0.5f));
      const unsigned b = bf2_pack(__fsub_rn(t[lo][k][1], 0.5f),
                                  __fsub_rn(t[hi][k][1], 0.5f));
      s[p][k] = bf2_pack(
          __fadd_rn(__fmul_rn(bf2_lo(a), wx[k].w0),
                    __fmul_rn(bf2_lo(b), wx[k].w1)),
          __fadd_rn(__fmul_rn(bf2_hi(a), wx[k].w0),
                    __fmul_rn(bf2_hi(b), wx[k].w1)));
    }
  }
}

// One side's masks at row y of a thread's V columns: the staged band
// offsets resized along y (the row taps' two band rows), the sample
// point's range test in both axes.
template <class Args>
__device__ __forceinline__ void row_mask(const float (&off)[2][kBands][kTileW],
                                         const Args& a, int jlo, int n_by,
                                         int cx, int x0, int y,
                                         float (&m)[kV]) {
  const int i0 = a.ty_i0[y];
  const int r0 = i0 - jlo, r1 = min(i0 + 1, n_by - 1) - jlo;
  const float w0 = a.ty_w0[y], w1 = a.ty_w1[y];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const float fx = fused_lerp(off[0][r0][cx + k], w0, off[0][r1][cx + k],
                                w1);
    const float fy = fused_lerp(off[1][r0][cx + k], w0, off[1][r1][cx + k],
                                w1);
    m[k] = __fmul_rn(warp_tile::in_range(x0 + k, fx, a.valid_w),
                     warp_tile::in_range(y, fy, a.h));
  }
}

// mode: 0 single, 1 blend, 2 pair, 3 pair and the MC fallback's cell
// means; NCH channels walked together
template <bool BF16, int MODE, int NCH>
__global__ void __launch_bounds__(kThreadsX * kRows, kMinBlocks)
    obmc_kernel(const ObmcArgs a) {
  using P = MatmulPolicy<true, false, BF16>;
  constexpr int kSides = MODE == 0 ? 1 : 2;
  constexpr bool kPair = MODE >= 2, kCells = MODE == 3;
  constexpr int kThreads = kThreadsX * kRows;
  constexpr int kCellW = kTileW / 8;   // cells across a tile
  static_assert(!kCells || (kTileW % 8 == 0 && kTileH % 8 == 0),
                "the cell means need tiles of whole 8 x 8 cells");
  // [side][dx, dy][band - jlo][column - bx0]
  __shared__ float s_off[kSides][2][kBands][kTileW];
  // mode 3, [.][tile row][tile column]: the side's masks, prev's masked
  // RGB values, each pixel's d_mc and d_cf (rows padded to 33 floats, so
  // the row sums' reads hit 32 banks), and each row's sum per cell
  constexpr int kC = kCells ? 1 : 0;
  __shared__ float s_m[kC * kTileH + 1 - kC][kTileW];
  __shared__ float s_pm[3 * kC + 1 - kC][kC * kTileH + 1 - kC][kTileW];
  __shared__ float s_d[2][kC * kTileH + 1 - kC][kTileW + 1];
  __shared__ float s_row[2][kC * kTileH + 1 - kC][kCellW];
  const int lim_w = kPair ? a.w : a.out_w;
  const int lim_h = kPair ? a.h : a.out_h;
  const int g = a.g, n_by = a.h / g, n_bx = a.w / g, half = g / 2;
  const int bx0 = blockIdx.x * kTileW, by0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int jlo = band_of(by0, g, n_by);
  // (every row of the tile, cropped or not: a thread's masks cover all
  // its rows)
  const int jhi =
      min(band_of(min(by0 + kTileH, a.h) - 1, g, n_by) + 1, n_by - 1);
  const int nb = jhi - jlo + 1;

  // the block's band offsets, every side and axis: clip(mv, +-r) * scale
  // at the two lattice columns of each column, resized along x
  const int64_t mv_plane = static_cast<int64_t>(n_by) * n_bx;
#pragma unroll
  for (int side = 0; side < kSides; ++side) {
    const float scale = MODE == 0 ? 1.0f : (side ? a.omt : -a.t);
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      for (int i = tid; i < nb * kTileW; i += kThreads) {
        const int col = i % kTileW, b = i / kTileW;
        const int x = bx0 + col;
        float o = 0.f;
        if (x < a.w) {
          const float* m =
              a.mv + axis * mv_plane + static_cast<int64_t>(jlo + b) * n_bx;
          const int i0 = a.tx_i0[x], i1 = min(i0 + 1, n_bx - 1);
          o = fused_lerp(__fmul_rn(fminf(fmaxf(m[i0], -a.r), a.r), scale),
                         a.tx_w0[x],
                         __fmul_rn(fminf(fmaxf(m[i1], -a.r), a.r), scale),
                         a.tx_w1[x]);
        }
        s_off[side][axis][b][col] = o;
      }
    }
  }
  __syncthreads();

  const int x0 = bx0 + threadIdx.x * kV;
  const int y0 = by0 + threadIdx.y * kRT;
  // (mode 3: every thread stays for the cell sums' barriers)
  const bool active = x0 < lim_w && y0 < lim_h;
  if (!kCells && !active) return;
  const int cx = x0 - bx0, ry = y0 - by0;
  const int nc = min(3, a.n_ch);   // the fallback's RGB channels
  // the two bands of these rows (band b's weight per row: wb below)
  const bool alone = y0 < half || y0 >= n_by * g - half;
  const int la = band_of(y0, g, n_by) - jlo;
  const int lb = alone ? la : la + 1;
  const int k0 = alone ? 0 : (y0 - half) % g;
  const int n = min(kV, lim_w - x0);
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  const int64_t out_plane = static_cast<int64_t>(lim_h) * lim_w;

#pragma unroll 1
  for (int s = 0; s < (active ? kSides : 0); ++s) {
    const float* src = s ? a.curr : a.prev;
    // pair mode: the side's masks, a plane of their own
    if constexpr (kPair) {
#pragma unroll 1
      for (int j = 0; j < kRT; ++j) {
        float m[kV];
        row_mask(s_off[s], a, jlo, n_by, cx, x0, y0 + j, m);
        store_cols<kV>(a.out + (2 * a.n_ch + s) * out_plane +
                           static_cast<int64_t>(y0 + j) * lim_w + x0,
                       n, m);
        if constexpr (kCells) {
#pragma unroll
          for (int k = 0; k < kV; ++k) s_m[ry + j][cx + k] = m[k];
        }
      }
    }
    const BandCols<P> ba(&s_off[s][0][la][cx], &s_off[s][1][la][cx], x0,
                         a.w);
    const BandCols<P> bb(&s_off[s][0][lb][cx], &s_off[s][1][lb][cx], x0,
                         a.w);
    // bf16: both bands' vertical weights as pairs
    unsigned wya[kV][2], wyb[kV][2];
    if constexpr (BF16) {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        wya[k][0] = bf2_pack(ba.wy[k].w0, ba.wy[k].w0);
        wya[k][1] = bf2_pack(ba.wy[k].w1, ba.wy[k].w1);
        wyb[k][0] = bf2_pack(bb.wy[k].w0, bb.wy[k].w0);
        wyb[k][1] = bf2_pack(bb.wy[k].w1, bb.wy[k].w1);
      }
    }
#pragma unroll 1
    for (int c0 = 0; c0 < a.n_ch; c0 += NCH) {
      const float* sp = src + c0 * plane;
      // the last tap row's horizontal sums: per channel in f32, or in
      // bf16 pairs of channels
      constexpr int NP = (NCH + 1) / 2;
      float ha[NCH][kV], hb[NCH][kV];
      unsigned ha2[NP][kV], hb2[NP][kV];
#pragma unroll 1
      for (int r = 0; r <= kRT; ++r) {
        // both bands' taps of this tap row, every column and channel
        float ta[NCH][kV][2], tb[NCH][kV][2];
        ba.template load<NCH>(sp, plane, a.h, a.w, y0, r, ta);
        if (!alone) bb.template load<NCH>(sp, plane, a.h, a.w, y0, r, tb);
        // the output row this tap row completes (r > 0), and band b's
        // weight fl((k + 0.5) / g) and band a's fl(1 - w) there, each
        // rounded to the type
        const int j = r - 1, y = y0 + j;
        const float wb = warp_tile::to_dt<BF16>(
            __fdiv_rn(__fadd_rn(static_cast<float>(k0 + j), 0.5f),
                      static_cast<float>(g)));
        const float wa = warp_tile::to_dt<BF16>(__fsub_rn(1.0f, wb));
        float o[NCH][kV];   // the row's values, finished
        if constexpr (BF16) {
          unsigned sa[NP][kV], sb[NP][kV];
          hsums_bf16<NCH>(ta, ba.wx, sa);
          if (!alone) hsums_bf16<NCH>(tb, bb.wx, sb);
          const unsigned wa2 = bf2_pack(wa, wa), wb2 = bf2_pack(wb, wb);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
#pragma unroll
            for (int k = 0; k < kV; ++k) {
              if (r) {
                unsigned v = bf2_lerp(ha2[p][k], wya[k][0], sa[p][k],
                                      wya[k][1]);
                if (!alone) {
                  v = bf2_lerp(v, wa2,
                               bf2_lerp(hb2[p][k], wyb[k][0], sb[p][k],
                                        wyb[k][1]),
                               wb2);
                }
                o[2 * p][k] = P::finish(bf2_lo(v));
                if (2 * p + 1 < NCH) o[2 * p + 1][k] = P::finish(bf2_hi(v));
              }
              ha2[p][k] = sa[p][k];
              if (!alone) hb2[p][k] = sb[p][k];
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
#pragma unroll
            for (int k = 0; k < kV; ++k) {
              const float sa = P::hlerp(P::load(ta[c][k][0]),
                                        P::load(ta[c][k][1]), ba.wx[k]);
              const float va = P::vlerp(ha[c][k], sa, ba.wy[k]);
              ha[c][k] = sa;
              if (alone) {
                o[c][k] = P::finish(va);
              } else {
                const float sb = P::hlerp(P::load(tb[c][k][0]),
                                          P::load(tb[c][k][1]), bb.wx[k]);
                const float vb = P::vlerp(hb[c][k], sb, bb.wy[k]);
                hb[c][k] = sb;
                o[c][k] = P::finish(__fadd_rn(__fmul_rn(va, wa),
                                              __fmul_rn(vb, wb)));
              }
            }
          }
        }
        if (r == 0 || y >= lim_h) continue;
        float m[kV];
        if constexpr (MODE == 1) {
          row_mask(s_off[s], a, jlo, n_by, cx, x0, y, m);
        }
        const int64_t row_off = static_cast<int64_t>(y) * lim_w + x0;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if constexpr (MODE == 0) {
            store_cols<kV>(a.out + (c0 + c) * out_plane + row_off, n, o[c]);
          } else if constexpr (kPair) {
            store_cols<kV>(
                a.out + (s * a.n_ch + c0 + c) * out_plane + row_off, n, o[c]);
            if constexpr (kCells) {
              // d_mc's sum over the RGB channels in turn of |wp * mask_p -
              // wc * mask_c|: prev's products kept, curr's taken from them
              const int ch = c0 + c;
              if (ch < nc) {
#pragma unroll
                for (int k = 0; k < kV; ++k) {
                  const float v = __fmul_rn(o[c][k], s_m[ry + j][cx + k]);
                  if (s == 0) {
                    s_pm[ch][ry + j][cx + k] = v;
                  } else {
                    const float d = fabsf(__fsub_rn(s_pm[ch][ry + j][cx + k],
                                                    v));
                    float& acc = s_d[0][ry + j][cx + k];
                    acc = ch ? __fadd_rn(acc, d) : d;
                  }
                }
              }
            }
          } else {
            // blend: prev's term v * mask * (1 - t) first, then curr's
            // v * mask * t added to it
            float* dst = a.out + (c0 + c) * out_plane + row_off;
#pragma unroll
            for (int k = 0; k < kV; ++k) {
              const float term =
                  __fmul_rn(__fmul_rn(o[c][k], m[k]), s ? a.t : a.omt);
              o[c][k] = s ? __fadd_rn(k < n ? dst[k] : 0.f, term) : term;
            }
            store_cols<kV>(dst, n, o[c]);
          }
        }
      }
    }
  }
  if constexpr (kCells) {
    // each pixel's means: d_mc's sum times fl(1/n), and d_cf, the mean of
    // |prev - curr| over the RGB channels (the unwarped frames)
    if (active) {
      const float inv = __fdiv_rn(1.0f, static_cast<float>(nc));
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          const int64_t at = static_cast<int64_t>(y0 + j) * a.w + x0 + k;
          float cf = 0.f;
          for (int c = 0; c < nc; ++c) {
            const float d = fabsf(
                __fsub_rn(a.prev[c * plane + at], a.curr[c * plane + at]));
            cf = c ? __fadd_rn(cf, d) : d;
          }
          s_d[0][ry + j][cx + k] = __fmul_rn(s_d[0][ry + j][cx + k], inv);
          s_d[1][ry + j][cx + k] = __fmul_rn(cf, inv);
        }
      }
    }
    __syncthreads();
    // a cell's rows: 8 values left to right, one thread per (term, row,
    // cell)
    for (int i = tid; i < 2 * kTileH * kCellW; i += kThreads) {
      const int cell = i % kCellW, row = (i / kCellW) % kTileH;
      const int term = i / (kCellW * kTileH);
      if (by0 + row < a.h && bx0 + cell * 8 < a.w) {
        const float* v = &s_d[term][row][cell * 8];
        float sum = v[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) sum = __fadd_rn(sum, v[k]);
        s_row[term][row][cell] = sum;
      }
    }
    __syncthreads();
    // the 8 row sums top to bottom, times 1/64 (exact)
    const int nx = a.w / 8, ny = a.h / 8;
    for (int i = tid; i < 2 * (kTileH / 8) * kCellW; i += kThreads) {
      const int cell = i % kCellW, crow = (i / kCellW) % (kTileH / 8);
      const int term = i / (kCellW * (kTileH / 8));
      const int gx = bx0 / 8 + cell, gy = by0 / 8 + crow;
      if (gx < nx && gy < ny) {
        float sum = s_row[term][crow * 8][cell];
#pragma unroll
        for (int r = 1; r < 8; ++r) {
          sum = __fadd_rn(sum, s_row[term][crow * 8 + r][cell]);
        }
        a.cells[(static_cast<int64_t>(term) * ny + gy) * nx + gx] =
            __fmul_rn(sum, 1.0f / 64);
      }
    }
  }
}

template <bool BF16, int MODE, int NCH = OBMC_NCH>
const void* kernel_for(int n_ch) {
  if constexpr (NCH > 1) {
    if (n_ch % NCH) return kernel_for<BF16, MODE, NCH - 1>(n_ch);
  }
  return reinterpret_cast<const void*>(obmc_kernel<BF16, MODE, NCH>);
}

// the kernel of a launch: NCH, the most channels up to OBMC_NCH that
// divide n_ch
template <bool BF16>
const void* kernel_of_type(int mode, int n_ch) {
  switch (mode) {
    case 0: return kernel_for<BF16, 0>(n_ch);
    case 1: return kernel_for<BF16, 1>(n_ch);
    case 2: return kernel_for<BF16, 2>(n_ch);
    default: return kernel_for<BF16, 3>(n_ch);
  }
}

const void* kernel_of(int mode, int bf16, int n_ch) {
  return bf16 ? kernel_of_type<true>(mode, n_ch)
              : kernel_of_type<false>(mode, n_ch);
}

}  // namespace

// prev, curr f32 [n_ch, h, w]; mv f32 [2, h/g, w/g] (dx, dy); the column
// taps of w/g -> w (tx_i0 i32 [w], tx_w0, tx_w1 f32 [w]) and the row taps
// of h/g -> h (ty_*, [h]); out f32 [n_ch, out_h, out_w] (mode 2: [2 n_ch +
// 2, h, w]); cells f32 [2, h/8, w/8] (mode 3, else unread); g a multiple
// of 8 dividing h and w (the wrapper checks); valid_w the masks' right
// edge; r the MVs' clip; t and omt = fl(1 - t) the blend weights; mode 0
// single, 1 blend, 2 pair, 3 pair and the fallback's cell means; bf16 (the
// moving type) as 0/1.
extern "C" int tpufg_warp_obmc(const void* prev, const void* curr,
                               const void* mv, const void* tx_i0,
                               const void* tx_w0, const void* tx_w1,
                               const void* ty_i0, const void* ty_w0,
                               const void* ty_w1, void* out, void* cells,
                               int n_ch, int h,
                               int w, int g, int valid_w, float r, float t,
                               float omt, int out_h, int out_w, int mode,
                               int bf16, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g % 8 || mode < 0 || mode > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ObmcArgs a{static_cast<const float*>(prev),
             static_cast<const float*>(curr),
             static_cast<const float*>(mv),
             static_cast<const int*>(tx_i0),
             static_cast<const int*>(ty_i0),
             static_cast<const float*>(tx_w0),
             static_cast<const float*>(tx_w1),
             static_cast<const float*>(ty_w0),
             static_cast<const float*>(ty_w1),
             static_cast<float*>(out),
             n_ch, h, w, g, valid_w, r, t, omt, out_h, out_w,
             static_cast<float*>(cells)};
  const int lim_w = mode >= 2 ? w : out_w;
  const int lim_h = mode >= 2 ? h : out_h;
  const dim3 threads(kThreadsX, kRows);
  const dim3 blocks((lim_w + kTileW - 1) / kTileW,
                    (lim_h + kTileH - 1) / kTileH);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchKernel(kernel_of(mode, bf16, n_ch),
                                           blocks, threads, params, 0,
                                           stream));
}

// The kernel of (mode, bf16, n_ch): which 0 its registers a thread, 1 its
// blocks per SM (the occupancy calculator's answer for the current
// device), 2 its local memory a thread in bytes (spills); -1 on error.
extern "C" int tpufg_warp_obmc_occupancy(int mode, int bf16, int n_ch,
                                         int which) {
  const void* fn = kernel_of(mode, bf16, n_ch);
  if (which == 1) {
    int n = -1;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, fn, kThreadsX * kRows, 0) == cudaSuccess
               ? n
               : -1;
  }
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  return which == 0 ? attr.numRegs : static_cast<int>(attr.localSizeBytes);
}
