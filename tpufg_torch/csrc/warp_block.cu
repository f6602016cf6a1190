// Block-granular motion-compensated warp and blend.
//
// Replaces tpufg/kernels/warp.py:_warp_kernel (the Pallas kernel behind
// warp_blend_block): planar f32 prev and curr [C, H, W], one pixel-unit
// forward-flow MV per block x block tile (mv [2, H/block, W/block], plane 0
// dx, plane 1 dy), f32 out [C, H, W].  Per output pixel, with m its block's
// MV clipped to +-r:
//
//   blend:  out = prev(p + m*(-t)) * pmask * (1-t) + curr(p + m*(1-t)) * cmask * t
//   single: out = prev(p + m)       (no mask)
//
// where src(p + o) is the bilinear sample at o = floor(o) + frac: four taps
// clamped to the edge, top = c00*(1-fx) + c10*fx, bot = c01*(1-fx) +
// c11*fx, top*(1-fy) + bot*fy; and a mask is 0 where the sample point
// p + o leaves [-0.5, size - 0.5] in either axis (the shader's transparent
// black outside uv [0, 1]).  tpufg's edge-padded halo of round_up(r+2, 8)
// is exactly this clamp, since an offset never passes +-r.  Every operation
// is an explicit _rn intrinsic in the plain version's order
// (tpufg_torch/kernels/warp.py::warp_blend_block_plain), so the kernel is
// bitwise equal to it.
//
// Bound on the H100: device memory (each of prev and curr read once, out
// written once: 12 B per pixel and channel; 100 MB at [4,1088,1920],
// 0.030 ms at 3.35 TB/s).  The TPU kernel's aligned row windows, 8-way
// switch and lane rolls exist because the TPU has no dynamic gather.  The
// first form here (one thread per pixel, a runtime channel loop, four
// scalar loads per value and frame, 64-bit addressing per tap) reached
// 1.24 TB/s.  Design: the tile walk of warp_tile.cuh, a thread per cell of
// V columns x RT rows of one MV block, every tap row read once per cell
// and its horizontal sums shared by the two output rows it serves, all
// channels and both frames loaded before the arithmetic, 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

using warp_tile::Weights;

// warp.py's bilinear sample in f32: gx = 1 - fx, top = a*gx + b*fx, then
// top*gy + bot*fy; values taken as they are
struct BlockPolicy {
  static constexpr bool kFrac = true;
  __device__ __forceinline__ static Weights weights(float f) {
    return {__fsub_rn(1.0f, f), f};
  }
  __device__ __forceinline__ static float load(float x) { return x; }
  __device__ __forceinline__ static float hlerp(float a, float b, Weights w) {
    return __fadd_rn(__fmul_rn(a, w.w0), __fmul_rn(b, w.w1));
  }
  __device__ __forceinline__ static float vlerp(float t, float b, Weights w) {
    return __fadd_rn(__fmul_rn(t, w.w0), __fmul_rn(b, w.w1));
  }
  __device__ __forceinline__ static float finish(float o) { return o; }
};

}  // namespace

// prev, curr, out f32 [n_ch, h, w]; mv f32 [2, h/g, w/g]; h and w multiples
// of g (the wrapper checks); r the clip radius; t the blend factor.
extern "C" int tpufg_warp_block(const void* prev, const void* curr,
                                const void* mv, void* out, int n_ch, int h,
                                int w, int g, float r, float t, int single,
                                int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float omt = 1.0f - t;  // host f32: rounded once, as _blend_weights
  const warp_tile::Args a{static_cast<const float*>(prev),
                          static_cast<const float*>(curr),
                          static_cast<const float*>(mv),
                          static_cast<float*>(out),
                          n_ch, h, w, g, r, t, omt, h, w, w};
  return static_cast<int>(
      warp_tile::launch<BlockPolicy>(a, single != 0, stream));
}
