// The Lanczos tap stencil shared by lanczos_packed.cu and lanczos_planar.cu.
//
// The host plans each axis once (tpufg_torch/kernels/lanczos.py:axis_taps):
// for output index o, TAPS = 2a input indices idx[o][k] (clamped into
// range) and weights w[o][k] (0 for taps outside the image, renormalised to
// sum to 1).  lanczos_tap_sum forms, at one output pixel of one channel,
// for each of the TAPS rows the horizontal tap sum, then the vertical tap
// sum of those, in table order and with one rounding per operation
// (explicit _rn intrinsics, so nvcc cannot contract them into FMAs): the
// order of the plain torch version, tpufg_torch/kernels/lanczos.py::
// lanczos_scale, so the f32 result is bitwise equal to it.

#pragma once

#include <cstdint>
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

}  // namespace tpufg_lanczos
