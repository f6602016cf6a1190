// The exact path's Lanczos resample and UNORM8 store (scale.comp).
//
// Replaces tpufg/ops/oracle.py:lanczos_scale followed by quantize_unorm8,
// XLA ops of the reference (its exact precision path reaches no Pallas
// kernel): f32 RGBA [ih, iw, 4] -> uint8 RGBA [oh, ow, 4].  Each output
// pixel sums the 2a x 2a window at floor(pos) - (a - 1): w = wx * wy, a tap
// outside the image weighs 0 (its clamped texel is still read, as the plain
// version reads it), y outer and x inner, the colour sum with XLA's fused
// multiply-adds (the first two products summed with the first fused, then
// color + texel * w fused), the weight sum one rounding an add, then one
// division by the weight sum, a clamp to [0, 1], x 255 and round to
// nearest even.  The tap tables (clamped index, Lanczos weight, valid flag
// per output row and column) come from the same torch ops as the plain
// version (tpufg_torch/ops/oracle.py:axis_tables), so the kernel is bitwise
// to it (csrc/oracle_round.cuh).
//
// Bound on the H100: operations.  1080p -> 4K moves 33 MB in and 33 MB out,
// but every output pixel does 36 taps x 4 channels of an f64 multiply and
// add (the roundings' form), ~2.3 G f64 operations against the card's 34
// TFLOP/s in f64.  Design, simple first: one thread per output pixel, all 4
// channels, a 32 x 8 block over the output; each tap is one 16-byte load
// (neighbouring threads read neighbouring texels, so L1 serves the overlap
// of their windows), the output one 4-byte store.

#include <cstdint>
#include <cuda_runtime.h>

#include "oracle_round.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ unsigned char unorm8(float v) {
  // jnp.clip then round: a NaN stays NaN through the clamp
  v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
  return static_cast<unsigned char>(rintf(__fmul_rn(v, 255.f)));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
    oracle_scale_kernel(const float4* __restrict__ img,
                        const int* __restrict__ iy,
                        const float* __restrict__ wy,
                        const unsigned char* __restrict__ vy,
                        const int* __restrict__ ix,
                        const float* __restrict__ wx,
                        const unsigned char* __restrict__ vx,
                        uchar4* __restrict__ out, int iw, int oh, int ow,
                        int taps) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const int* rx = ix + x * taps;
  const float* gx = wx + x * taps;
  const unsigned char* okx = vx + x * taps;
  float4 color = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 t0 = color;
  float w0 = 0.f, total = 0.f;
  int k = 0;
  for (int ky = 0; ky < taps; ++ky) {
    const int j = y * taps + ky;
    const float4* row = img + static_cast<int64_t>(__ldg(iy + j)) * iw;
    const float wyk = __ldg(wy + j);
    const bool oky = __ldg(vy + j) != 0;
    for (int kx = 0; kx < taps; ++kx, ++k) {
      float w = __fmul_rn(__ldg(gx + kx), wyk);
      if (!(oky && __ldg(okx + kx) != 0)) w = 0.f;
      const float4 t = __ldg(row + __ldg(rx + kx));
      if (k == 0) {
        total = w;
        t0 = t;
        w0 = w;
        continue;
      }
      total = __fadd_rn(total, w);
      if (k == 1) {
        color.x = oracle::fma_once(t0.x, w0, __fmul_rn(t.x, w));
        color.y = oracle::fma_once(t0.y, w0, __fmul_rn(t.y, w));
        color.z = oracle::fma_once(t0.z, w0, __fmul_rn(t.z, w));
        color.w = oracle::fma_once(t0.w, w0, __fmul_rn(t.w, w));
      } else {
        color.x = oracle::fma_once(t.x, w, color.x);
        color.y = oracle::fma_once(t.y, w, color.y);
        color.z = oracle::fma_once(t.z, w, color.z);
        color.w = oracle::fma_once(t.w, w, color.w);
      }
    }
  }
  out[static_cast<int64_t>(y) * ow + x] =
      make_uchar4(unorm8(__fdiv_rn(color.x, total)),
                  unorm8(__fdiv_rn(color.y, total)),
                  unorm8(__fdiv_rn(color.z, total)),
                  unorm8(__fdiv_rn(color.w, total)));
}

}  // namespace

// (img f32 [ih, iw, 4], iy i32 [oh, taps], wy f32 [oh, taps], vy u8 [oh,
// taps], ix i32 [ow, taps], wx f32 [ow, taps], vx u8 [ow, taps], out u8
// [oh, ow, 4], ih, iw, oh, ow, taps, device, stream); taps >= 2, the
// indices clamped into the image, img and out 16- and 4-byte aligned
extern "C" int tpufg_oracle_scale(const void* img, const void* iy,
                                  const void* wy, const void* vy,
                                  const void* ix, const void* wx,
                                  const void* vx, void* out, int ih, int iw,
                                  int oh, int ow, int taps, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (taps < 2 || ih < 1 || iw < 1 || oh < 1 || ow < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY);
  oracle_scale_kernel<<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const float4*>(img), static_cast<const int*>(iy),
      static_cast<const float*>(wy), static_cast<const unsigned char*>(vy),
      static_cast<const int*>(ix), static_cast<const float*>(wx),
      static_cast<const unsigned char*>(vx), static_cast<uchar4*>(out), iw,
      oh, ow, taps);
  return static_cast<int>(cudaGetLastError());
}

// what 0 registers a thread, 1 blocks of 256 threads per SM, 2 local
// memory bytes a thread (spills); -1 on error
extern "C" int tpufg_oracle_scale_occupancy(int what) {
  return oracle::occupancy(reinterpret_cast<const void*>(oracle_scale_kernel),
                           kBlockX * kBlockY, what);
}
