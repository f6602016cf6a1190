// The roundings of tpufg's exact path as XLA's CPU compiler leaves them,
// shared by csrc/oracle_scale.cu and csrc/oracle_warp.cu and spelt out in
// tpufg_torch/ops/oracle.py (the plain versions).
//
// Every operation is a correctly rounded intrinsic, so nvcc cannot
// contract a multiply and an add into an FMA of its own (it does so by
// default for plain `a * b + c`).  Where XLA fuses `a * b + c`, the
// kernels round it as the plain versions do: the f64 product of the two
// f32 operands (exact), plus the addend in f64 (one rounding), then to f32.

#pragma once

#include <cuda_runtime.h>

namespace oracle {

// a * b + c, the product exact, the sum rounded in f64, then to f32
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// GLSL mix(a, b, f) = a * (1 - f) + b * f, a's product fused into the sum
__device__ __forceinline__ float mix(float a, float b, float f, float omf) {
  return fma_once(a, omf, __fmul_rn(b, f));
}

// a kernel's registers a thread (what 0), blocks of `threads` per SM (1) or
// local memory bytes a thread (2, spills); -1 on error
inline int occupancy(const void* fn, int threads, int what) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  if (what == 0) return attr.numRegs;
  if (what == 2) return static_cast<int>(attr.localSizeBytes);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    0) != cudaSuccess) {
    return -1;
  }
  return per_sm;
}

}  // namespace oracle
