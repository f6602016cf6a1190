// The Lanczos tap stencil shared by lanczos_packed.cu and lanczos_planar.cu.
//
// The host plans each axis once (tpufg_torch/kernels/lanczos.py:axis_taps):
// for output index o, TAPS = 2a input indices idx[o][k] (clamped into
// range) and weights w[o][k] (0 for taps outside the image, renormalised to
// sum to 1).  The resampled value of one channel at one output pixel is,
// for each of the TAPS rows, the horizontal tap sum h, then the vertical tap
// sum of those, in table order and with one rounding per operation
// (explicit _rn intrinsics, so nvcc cannot contract them into FMAs): the
// order of the plain torch version, tpufg_torch/kernels/lanczos.py::
// lanczos_scale, so the f32 result is bitwise equal to it.  A tap of weight
// 0 is multiplied and added like any other (h * 0 can be -0), and the first
// tap starts each sum without an add.
//
// Two routines form that value.  tap_sum is the direct stencil: one output
// pixel, TAPS^2 loads from device memory.  separable_tile computes a tile of
// outputs the way the plain version does, each h once: h(input row, output
// column) does not depend on the output row, and at 2x every input row
// feeds the taps of about 2 TAPS output rows.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpufg_lanczos {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Tap table row o of one axis into registers (TAPS is a template parameter
// so the arrays stay in registers).
template <int TAPS>
__device__ __forceinline__ void load_taps(const int32_t* __restrict__ idx,
                                          const float* __restrict__ w, int o,
                                          int (&i)[TAPS], float (&wt)[TAPS]) {
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    i[k] = idx[o * TAPS + k];
    wt[k] = w[o * TAPS + k];
  }
}

// The resampled value of the plane `src` (row length iw) at the output
// pixel whose taps are (yi, yw) and (xi, xw).
template <int TAPS, typename T>
__device__ __forceinline__ float tap_sum(const T* __restrict__ src, int iw,
                                         const int (&yi)[TAPS],
                                         const float (&yw)[TAPS],
                                         const int (&xi)[TAPS],
                                         const float (&xw)[TAPS]) {
  float v = 0.0f;
#pragma unroll
  for (int ky = 0; ky < TAPS; ++ky) {
    const T* row = src + static_cast<int64_t>(yi[ky]) * iw;
    float h = __fmul_rn(to_f32(row[xi[0]]), xw[0]);
#pragma unroll
    for (int kx = 1; kx < TAPS; ++kx) {
      h = __fadd_rn(h, __fmul_rn(to_f32(row[xi[kx]]), xw[kx]));
    }
    const float term = __fmul_rn(h, yw[ky]);
    v = ky == 0 ? term : __fadd_rn(v, term);
  }
  return v;
}

// ---- the separable tile walk
//
// A block of TW threads owns TW output columns (blockIdx.x) and `tile_rows`
// output rows (blockIdx.y).  idx[o][k] is clamp(start[o] + k) with start[o]
// the unclamped first tap (lanczos.py:axis_starts; the CPU tests hold the
// tables to that), so the tile reads the "virtual" input rows start_y[first
// row] .. start_y[last row] + TAPS - 1 and columns likewise, every range
// taken from the tables and never from the scale.
//
// 1. Stage: the tile's virtual rows x NCH channels x virtual columns go to
//    shared memory as f32, fetched at the clamped position.  Columns start
//    at a multiple of 4 so that, with `vec` (iw % 4 == 0 and an image
//    aligned to four values: 16 bytes in f32, 8 in bf16), interior quads
//    move as one load and one 16-byte store.
// 2. Walk: thread t owns output column ox0 + t and walks down the staged
//    rows.  For each row that a pending output row still needs it forms the
//    NCH horizontal sums h from TAPS shared-memory loads each, and keeps
//    the last TAPS rows' h in a ring of registers (the row loop is unrolled
//    by TAPS, so ring slots are compile-time).  When the row that holds an
//    output row's last tap has arrived, the thread forms the NCH vertical
//    sums from the ring, in tap order, and hands them to `emit(oy, ox, v)`,
//    the epilogue: quantize and pack, or a store per channel.
//
// Shared memory (floats): rows_cap * NCH * cols_cap staged values, then
// tile_rows ints (the tile's start_y) and tile_rows * TAPS weights;
// rows_cap, cols_cap (a multiple of 4) and the byte count come from
// lanczos.py:lanczos_plan.

template <int TAPS, int NCH, int TW, typename T, typename Emit>
__device__ __forceinline__ void separable_tile(
    const T* __restrict__ img, int ih, int iw,
    const int32_t* __restrict__ start_y, const float* __restrict__ w_y,
    const int32_t* __restrict__ start_x, const float* __restrict__ w_x,
    int oh, int ow, int tile_rows, int rows_cap, int cols_cap, bool vec,
    float* smem, Emit emit) {
  const int t = threadIdx.x;
  const int ox0 = blockIdx.x * TW;
  const int oy0 = blockIdx.y * tile_rows;
  const int oy1 = min(oy0 + tile_rows, oh);  // one past the tile's last row
  const int xv0 = start_x[ox0] & ~3;         // first staged virtual column
  const int ncols = start_x[min(ox0 + TW, ow) - 1] + TAPS - xv0;
  const int yv0 = start_y[oy0];              // first staged virtual row
  const int nrows = start_y[oy1 - 1] + TAPS - yv0;
  float* stage = smem;                       // [nrows][NCH][cols_cap]
  int* ys_s = reinterpret_cast<int*>(stage + rows_cap * NCH * cols_cap);
  float* yw_s = reinterpret_cast<float*>(ys_s + tile_rows);

  for (int i = t; i < oy1 - oy0; i += TW) ys_s[i] = start_y[oy0 + i];
  for (int i = t; i < (oy1 - oy0) * TAPS; i += TW) {
    yw_s[i] = w_y[oy0 * TAPS + i];
  }
  const int64_t plane = static_cast<int64_t>(ih) * iw;
  const uint32_t nq = (ncols + 3) / 4;       // quads per staged row
  // i / nq as a multiply: exact while i * nq < 2^32 (a tile stages far
  // fewer values); with one quad per row the magic number overflows
  const uint32_t magic = 0xffffffffu / nq + 1;
  for (uint32_t i = t; i < nq * NCH * nrows; i += TW) {
    const uint32_t pc = nq == 1 ? i : __umulhi(i, magic);  // row, channel
    const int xq = xv0 + 4 * static_cast<int>(i - pc * nq);
    const int y = min(max(yv0 + static_cast<int>(pc / NCH), 0), ih - 1);
    const T* src = img + (pc % NCH) * plane + static_cast<int64_t>(y) * iw;
    float4 v;
    const bool quad = vec && xq >= 0 && xq + 3 < iw;
    if (quad) {
      if constexpr (std::is_same<T, float>::value) {
        v = *reinterpret_cast<const float4*>(src + xq);
      } else {
        // four bf16 values in 8 bytes; a bf16 is the high half of its f32
        const uint2 raw = *reinterpret_cast<const uint2*>(src + xq);
        v.x = __uint_as_float(raw.x << 16);
        v.y = __uint_as_float(raw.x & 0xffff0000u);
        v.z = __uint_as_float(raw.y << 16);
        v.w = __uint_as_float(raw.y & 0xffff0000u);
      }
    } else {
      v.x = to_f32(src[min(max(xq, 0), iw - 1)]);
      v.y = to_f32(src[min(max(xq + 1, 0), iw - 1)]);
      v.z = to_f32(src[min(max(xq + 2, 0), iw - 1)]);
      v.w = to_f32(src[min(max(xq + 3, 0), iw - 1)]);
    }
    *reinterpret_cast<float4*>(stage + pc * cols_cap + (xq - xv0)) = v;
  }

  const int ox = min(ox0 + t, ow - 1);
  const float* mine = stage + (start_x[ox] - xv0);
  float xw[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) xw[k] = w_x[ox * TAPS + k];
  __syncthreads();

  float ring[TAPS][NCH];
  int oy = oy0;              // the next output row to emit
  int need = ys_s[0];        // its first virtual row
  for (int base = 0; base < nrows; base += TAPS) {
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int p = base + j;  // staged row; ring slot j
      if (p >= nrows) break;
      if (yv0 + p >= need) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float* row = mine + (p * NCH + c) * cols_cap;
          float h = __fmul_rn(row[0], xw[0]);
#pragma unroll
          for (int k = 1; k < TAPS; ++k) {
            h = __fadd_rn(h, __fmul_rn(row[k], xw[k]));
          }
          ring[j][c] = h;
        }
      }
      // the output rows whose last tap is this row: tap k sits in ring
      // slot (j + 1 + k) % TAPS
      while (need + TAPS - 1 == yv0 + p) {
        const float* yw = yw_s + (oy - oy0) * TAPS;
        float v[NCH];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          const float wk = yw[k];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float term = __fmul_rn(ring[(j + 1 + k) % TAPS][c], wk);
            v[c] = k == 0 ? term : __fadd_rn(v[c], term);
          }
        }
        if (ox0 + t < ow) emit(oy, ox, v);
        ++oy;
        // past the tile's last row: a start no row reaches
        need = oy < oy1 ? ys_s[oy - oy0] : 0x40000000;
      }
    }
  }
}

}  // namespace tpufg_lanczos
