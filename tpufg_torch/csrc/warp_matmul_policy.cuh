// The engine warp's roundings (tpufg/kernels/warp_matmul.py, an XLA op of
// the reference), shared by warp_matmul.cu (block MVs) and warp_obmc.cu
// (the per-pixel warp): the value domain, the lerp weights and the two
// lerps, each operation one _rn intrinsic in the order of
// tpufg_torch/kernels/warp_matmul.py::warp_blend_matmul_plain.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

using warp_tile::to_dt;
using warp_tile::Weights;

template <bool FRAC, bool U8, bool BF16>
struct MatmulPolicy {
  static constexpr bool kFrac = FRAC;
  // (1 - f, f), f and 1 - f each rounded to the moving type
  __device__ __forceinline__ static Weights weights(float f) {
    const float b = to_dt<BF16>(f);
    return {to_dt<BF16>(__fsub_rn(1.0f, b)), b};
  }
  __device__ __forceinline__ static float load(float x) {
    if constexpr (U8) {
      return to_dt<BF16>(__fsub_rn(rintf(__fmul_rn(x, 255.0f)), 128.0f));
    } else {
      return to_dt<BF16>(__fsub_rn(x, 0.5f));
    }
  }
  // an f32 sum of two products, rounded once to the type
  __device__ __forceinline__ static float hlerp(float a, float b, Weights w) {
    return to_dt<BF16>(__fadd_rn(__fmul_rn(a, w.w0), __fmul_rn(b, w.w1)));
  }
  // elementwise in the type: each product and the sum rounded to it
  __device__ __forceinline__ static float vlerp(float t, float b, Weights w) {
    return to_dt<BF16>(__fadd_rn(to_dt<BF16>(__fmul_rn(t, w.w0)),
                                 to_dt<BF16>(__fmul_rn(b, w.w1))));
  }
  __device__ __forceinline__ static float finish(float o) {
    if constexpr (U8) {
      // tpufg's / 255 as XLA compiles it: a multiply by fl(1/255)
      return __fmul_rn(__fadd_rn(o, 128.0f), static_cast<float>(1.0 / 255.0));
    } else {
      return __fadd_rn(o, 0.5f);
    }
  }
};

}  // namespace
