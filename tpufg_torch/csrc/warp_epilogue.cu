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
// Two launches when the fallback has cells: tpufg_warp_fallback_cells
// ([2, H/8, W/8], d_mc then d_cf) and tpufg_warp_epilogue (the top-left
// out_h x out_w window); one where the cell means come with the pair (the
// per-pixel warp makes them in its pair pass, warp_obmc.cu mode 3: config
// 4q's path).  Bound on the H100: device memory.  The blend reads the
// pair and prev and curr once ((3C + 2) values a pixel) and writes C: at
// [4, 1088, 1920] cropped to 1080, 184 MB, 0.055 ms at 3.35 TB/s; the
// cells pass reads 8 of the pair's planes and the RGB planes of both
// frames again.  Design:
// - the cells pass: a block owns one row of cells, 8 image rows x a strip
//   of 32 cells (256 columns); its 512 threads read 4 neighbouring pixels
//   each with 16-byte loads (coalesced: a warp reads 512 contiguous bytes
//   of a row), form each pixel's two terms, and put them in shared memory
//   (a cell's 8 values padded to 9 floats, so the sums' reads hit 32
//   banks); then one thread per (term, row, cell) adds a row's 8 values
//   left to right, and one per (term, cell) the 8 row sums top to bottom;
// - the blend: a block owns 8 rows x 128 columns; it first resizes along x
//   the (at most 3) rows of cell means its rows read, for its columns, into
//   shared memory, so a pixel does only the resize along y (one fused lerp
//   per term, not three); a thread owns 4 neighbouring pixels of a row and
//   reads and writes them with 16-byte loads and stores where W and the
//   window's width are multiples of 4 (scalar otherwise).

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

// true where every pointer is 16-byte aligned
bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0;
}

constexpr int kCell = 8;
constexpr float kOccD0 = 0.08f, kOccSlope = 8.0f;
constexpr float kFbFloor = 0.015f, kFbLo = 0.5f, kFbSpan = 0.5f;

// the cells pass: a strip of kStripCells cells a block, 64 x 8 threads
constexpr int kStripCells = 32;
constexpr int kCellsTx = kStripCells * kCell / 4;   // 64: 4 columns each
constexpr int kCellPad = kCell + 1;                 // a cell's row in smem
// the blend: 32 x 8 threads, 4 columns each
constexpr int kEpTx = 32, kEpTy = 8, kEpV = 4;
constexpr int kEpTileW = kEpTx * kEpV;
// cell rows the blend's rows read: 8 rows span at most 2 of them, plus
// the one after
constexpr int kEpCellRows = (kEpTy - 1) / kCell + 3;

struct EpArgs {
  const float *pair, *prev, *curr, *cells;
  const int *ty_i0, *tx_i0;
  const float *ty_w0, *ty_w1, *tx_w0, *tx_w1;
  float* out;
  int n_ch, h, w;
  float t, omt;
  int out_h, out_w, pick_prev;
  int vec;   // W % 4 == 0 and every plane 16-byte aligned: float4 access
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

// Four neighbouring values from p: one 16-byte load where vec, else the
// first n scalar (the rest 0).
struct Four {
  float v[4];
};

__device__ __forceinline__ Four load4(const float* __restrict__ p, bool vec,
                                      int n) {
  Four r;
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) r.v[k] = k < n ? p[k] : 0.f;
  }
  return r;
}

// the fallback's two terms at four pixels (at: their first index in a
// plane): the channel means over the RGB channels of |wp*mp - wc*mc| and
// |prev - curr|
__device__ __forceinline__ void fallback_terms4(
    const float* __restrict__ pair, const float* __restrict__ prev,
    const float* __restrict__ curr, int n_ch, int64_t plane, int64_t at,
    bool vec, int n, const Four& mp, const Four& mc, float (&d_mc)[4],
    float (&d_cf)[4]) {
  const int nc = min(3, n_ch);
  const float inv = __fdiv_rn(1.0f, static_cast<float>(nc));
  float s_mc[4], s_cf[4];
  for (int c = 0; c < nc; ++c) {
    const Four p = load4(pair + c * plane + at, vec, n);
    const Four q = load4(pair + (n_ch + c) * plane + at, vec, n);
    const Four u = load4(prev + c * plane + at, vec, n);
    const Four v = load4(curr + c * plane + at, vec, n);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = fabsf(__fsub_rn(__fmul_rn(p.v[k], mp.v[k]),
                                      __fmul_rn(q.v[k], mc.v[k])));
      const float b = fabsf(__fsub_rn(u.v[k], v.v[k]));
      s_mc[k] = c ? __fadd_rn(s_mc[k], a) : a;
      s_cf[k] = c ? __fadd_rn(s_cf[k], b) : b;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d_mc[k] = __fmul_rn(s_mc[k], inv);
    d_cf[k] = __fmul_rn(s_cf[k], inv);
  }
}

__global__ void __launch_bounds__(kCellsTx * kCell)
    cells_kernel(const float* __restrict__ pair,
                 const float* __restrict__ prev,
                 const float* __restrict__ curr, float* __restrict__ cells,
                 int n_ch, int h, int w, bool vec) {
  // each pixel's terms, [term][row][cell * kCellPad + column in the cell]
  __shared__ float s_d[2][kCell][kStripCells * kCellPad];
  __shared__ float s_row[2][kCell][kStripCells];   // each row's sum
  const int nx = w / kCell, ny = h / kCell;
  const int cy = blockIdx.y, cx0 = blockIdx.x * kStripCells;
  const int x = cx0 * kCell + threadIdx.x * 4;
  const int y = cy * kCell + threadIdx.y;
  if (x < w) {
    const int64_t plane = static_cast<int64_t>(h) * w;
    const int64_t at = static_cast<int64_t>(y) * w + x;
    const Four mp = load4(pair + 2 * n_ch * plane + at, vec, 4);
    const Four mc = load4(pair + (2 * n_ch + 1) * plane + at, vec, 4);
    float d_mc[4], d_cf[4];
    fallback_terms4(pair, prev, curr, n_ch, plane, at, vec, 4, mp, mc, d_mc,
                    d_cf);
    const int cell = threadIdx.x / 2, k0 = (threadIdx.x % 2) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_d[0][threadIdx.y][cell * kCellPad + k0 + k] = d_mc[k];
      s_d[1][threadIdx.y][cell * kCellPad + k0 + k] = d_cf[k];
    }
  }
  __syncthreads();
  // a row's 8 values left to right: one thread per (term, row, cell)
  const int tid = threadIdx.y * kCellsTx + threadIdx.x;
  {
    const int cell = tid % kStripCells, row = (tid / kStripCells) % kCell;
    const int term = tid / (kStripCells * kCell);
    if (cx0 + cell < nx) {
      const float* v = &s_d[term][row][cell * kCellPad];
      float s = v[0];
#pragma unroll
      for (int k = 1; k < kCell; ++k) s = __fadd_rn(s, v[k]);
      s_row[term][row][cell] = s;
    }
  }
  __syncthreads();
  // the 8 row sums top to bottom, times 1/64 (exact)
  if (tid < 2 * kStripCells) {
    const int cell = tid % kStripCells, term = tid / kStripCells;
    if (cx0 + cell < nx) {
      float s = s_row[term][0][cell];
#pragma unroll
      for (int r = 1; r < kCell; ++r) s = __fadd_rn(s, s_row[term][r][cell]);
      cells[static_cast<int64_t>(term) * ny * nx +
            static_cast<int64_t>(cy) * nx + cx0 + cell] =
          __fmul_rn(s, 1.0f / (kCell * kCell));
    }
  }
}

// OCC: the occlusion blend; FALLBACK: 0 off, 1 per pixel, 2 by cells
template <bool OCC, int FALLBACK>
__global__ void __launch_bounds__(kEpTx * kEpTy)
    epilogue_kernel(const EpArgs a) {
  // the cell means resized along x: [d_mc, d_cf][cell row - clo][column]
  __shared__ float s_rx[FALLBACK == 2 ? 2 : 1][kEpCellRows][kEpTileW];
  const int bx0 = blockIdx.x * kEpTileW, by0 = blockIdx.y * kEpTy;
  const int ny = a.h / kCell, nx = a.w / kCell;
  int clo = 0;
  if constexpr (FALLBACK == 2) {
    clo = a.ty_i0[by0];
    const int last = min(by0 + kEpTy, a.out_h) - 1;
    const int nr = min(a.ty_i0[last] + 1, ny - 1) - clo + 1;
    for (int i = threadIdx.y * kEpTx + threadIdx.x; i < 2 * nr * kEpTileW;
         i += kEpTx * kEpTy) {
      const int col = i % kEpTileW, rr = (i / kEpTileW) % nr;
      const int term = i / (kEpTileW * nr);
      const int x = bx0 + col;
      float v = 0.f;
      if (x < a.out_w) {
        const float* m = a.cells + static_cast<int64_t>(term) * ny * nx +
                         static_cast<int64_t>(clo + rr) * nx;
        const int xa = a.tx_i0[x], xb = min(xa + 1, nx - 1);
        v = fused_lerp(m[xa], a.tx_w0[x], m[xb], a.tx_w1[x]);
      }
      s_rx[term][rr][col] = v;
    }
    __syncthreads();
  }
  const int x0 = bx0 + threadIdx.x * kEpV;
  const int y = by0 + threadIdx.y;
  if (x0 >= a.out_w || y >= a.out_h) return;
  const int n = min(kEpV, a.out_w - x0);
  const bool vec = a.vec;              // then x0 + 4 <= w, rows aligned
  const int nc = a.n_ch;
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  const int64_t at = static_cast<int64_t>(y) * a.w + x0;
  const Four mp = load4(a.pair + 2 * nc * plane + at, vec, n);
  const Four mc = load4(a.pair + (2 * nc + 1) * plane + at, vec, n);
  float k_occ[4], wfb[4];
  if constexpr (OCC) {
    float s[4];
    for (int c = 0; c < nc; ++c) {
      const Four p = load4(a.pair + c * plane + at, vec, n);
      const Four q = load4(a.pair + (nc + c) * plane + at, vec, n);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = fabsf(__fsub_rn(p.v[k], q.v[k]));
        s[k] = c ? __fadd_rn(s[k], d) : d;
      }
    }
    const float inv = __fdiv_rn(1.0f, static_cast<float>(nc));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      k_occ[k] = clamp01(
          __fmul_rn(__fsub_rn(__fmul_rn(s[k], inv), kOccD0), kOccSlope));
    }
  }
  if constexpr (FALLBACK != 0) {
    float d_mc[4], d_cf[4];
    if constexpr (FALLBACK == 2) {
      const int i0 = a.ty_i0[y];
      const int r0 = i0 - clo, r1 = min(i0 + 1, ny - 1) - clo;
      const float w0 = a.ty_w0[y], w1 = a.ty_w1[y];
      const int col = x0 - bx0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d_mc[k] = fused_lerp(s_rx[0][r0][col + k], w0, s_rx[0][r1][col + k],
                             w1);
        d_cf[k] = fused_lerp(s_rx[1][r0][col + k], w0, s_rx[1][r1][col + k],
                             w1);
      }
    } else {
      fallback_terms4(a.pair, a.prev, a.curr, nc, plane, at, vec, n, mp, mc,
                      d_mc, d_cf);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float rel = __fdiv_rn(d_mc[k], __fadd_rn(d_cf[k], kFbFloor));
      wfb[k] = clamp01(__fdiv_rn(__fsub_rn(rel, kFbLo), kFbSpan));
    }
  }
  const int64_t out_plane = static_cast<int64_t>(a.out_h) * a.out_w;
  float* dst = a.out + static_cast<int64_t>(y) * a.out_w + x0;
  const bool vec_out = a.vec && n == 4 && a.out_w % 4 == 0;
  for (int c = 0; c < nc; ++c) {
    const Four p = load4(a.pair + c * plane + at, vec, n);
    const Four q = load4(a.pair + (nc + c) * plane + at, vec, n);
    Four u, v;
    if constexpr (FALLBACK != 0) {
      u = load4(a.prev + c * plane + at, vec, n);
      v = load4(a.curr + c * plane + at, vec, n);
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pm = __fmul_rn(p.v[k], mp.v[k]);
      const float cm = __fmul_rn(q.v[k], mc.v[k]);
      o[k] = __fadd_rn(__fmul_rn(pm, a.omt), __fmul_rn(cm, a.t));
      if constexpr (OCC) {
        o[k] = __fadd_rn(__fmul_rn(o[k], __fsub_rn(1.0f, k_occ[k])),
                         __fmul_rn(a.pick_prev ? pm : cm, k_occ[k]));
      }
      if constexpr (FALLBACK != 0) {
        const float cf = __fadd_rn(__fmul_rn(u.v[k], a.omt),
                                   __fmul_rn(v.v[k], a.t));
        o[k] = __fadd_rn(__fmul_rn(o[k], __fsub_rn(1.0f, wfb[k])),
                         __fmul_rn(cf, wfb[k]));
      }
    }
    float* d = dst + c * out_plane;
    if (vec_out) {
      *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n) d[k] = o[k];
      }
    }
  }
}

const void* epilogue_of(int occlusion, int fallback) {
  if (occlusion) {
    return fallback == 2 ? reinterpret_cast<const void*>(
                               epilogue_kernel<true, 2>)
           : fallback == 1
               ? reinterpret_cast<const void*>(epilogue_kernel<true, 1>)
               : reinterpret_cast<const void*>(epilogue_kernel<true, 0>);
  }
  return fallback == 2
             ? reinterpret_cast<const void*>(epilogue_kernel<false, 2>)
         : fallback == 1
             ? reinterpret_cast<const void*>(epilogue_kernel<false, 1>)
             : reinterpret_cast<const void*>(epilogue_kernel<false, 0>);
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
  const dim3 threads(kCellsTx, kCell);
  const dim3 blocks((w / kCell + kStripCells - 1) / kStripCells, h / kCell);
  cells_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(pair), static_cast<const float*>(prev),
      static_cast<const float*>(curr), static_cast<float*>(cells), n_ch, h,
      w, aligned16({pair, prev, curr}));
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
  if (fallback < 0 || fallback > 2 ||
      (fallback == 2 && (h % kCell || w % kCell))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpArgs a{static_cast<const float*>(pair),
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
           n_ch, h, w, t, omt, out_h, out_w, pick_prev,
           w % 4 == 0 && aligned16({pair, prev, curr, out})};
  const dim3 threads(kEpTx, kEpTy);
  const dim3 blocks((out_w + kEpTileW - 1) / kEpTileW,
                    (out_h + kEpTy - 1) / kEpTy);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchKernel(epilogue_of(occlusion, fallback),
                                           blocks, threads, params, 0,
                                           stream));
}

// kernel 0 the cells pass, 1 the blend with both options by cells: which
// 0 its registers a thread, 1 its blocks per SM, 2 its local memory a
// thread in bytes (spills); -1 on error.
extern "C" int tpufg_warp_epilogue_occupancy(int kernel, int which) {
  const void* fn = kernel ? epilogue_of(1, 2)
                          : reinterpret_cast<const void*>(cells_kernel);
  const int threads = kernel ? kEpTx * kEpTy : kCellsTx * kCell;
  if (which == 1) {
    int n = -1;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                         0) == cudaSuccess
               ? n
               : -1;
  }
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  return which == 0 ? attr.numRegs : static_cast<int>(attr.localSizeBytes);
}
