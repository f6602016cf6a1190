// The exact path's motion-compensated blend (interpolate.comp).
//
// Replaces tpufg/ops/oracle.py:warp_blend with a per-pixel MV field, an XLA
// op of the reference (its exact precision path reaches no Pallas kernel):
// f32 RGBA prev and curr [h, w, 4] and the MV field f32 [h, w, 2] in pixels
// (or none: a crossfade) -> f32 [h, w, 4].  Per output pixel: the pixel
// centre uv = (p + 0.5) * fl(1/size); prev sampled at uv - t * mv / size,
// curr at uv + (1 - t) * mv / size; a sample whose uv leaves [0, 1] on
// either axis reads 0; otherwise a bilinear fetch at uv * size - 0.5 with
// clamped indices; the result mix(prev, curr, t).  The roundings are those
// XLA leaves in tpufg's jitted oracle (tpufg_torch/ops/oracle.py): the uv
// step of the MV a folded constant k = fl(fl(1/size) * s), u + m * k one
// FMA unless prev's and curr's steps are one product (t = 0.5), the
// position uv * size - 0.5 one FMA, each lerp and the blend with the first
// product fused (csrc/oracle_round.cuh).  The pixel-centre tables (u, v
// and, for the crossfade, the positions x, y) and the constants come from
// the same torch ops as the plain version (ops/oracle.py:warp_tables), so
// the kernel is bitwise to it.
//
// Bound on the H100: memory.  At 1080p a call reads prev, curr (33 MB each)
// and the MV field (17 MB) and writes 33 MB; its ~72 f64 and ~50 f32
// operations a pixel take a tenth of that time.  Design, simple first: one
// thread per pixel, all 4 channels, a 32 x 8 block; each bilinear tap a
// 16-byte load, the MV one 8-byte load, the output one 16-byte store.  A
// sample outside [0, 1] loads nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "oracle_round.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float4 mix4(float4 a, float4 b, float f,
                                       float omf) {
  return make_float4(oracle::mix(a.x, b.x, f, omf),
                     oracle::mix(a.y, b.y, f, omf),
                     oracle::mix(a.z, b.z, f, omf),
                     oracle::mix(a.w, b.w, f, omf));
}

// bilinear fetch at texel-space (x, y), indices clamped to the edge
__device__ __forceinline__ float4 bilinear(const float4* __restrict__ img,
                                           int h, int w, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
  const float4* ra = img + static_cast<int64_t>(ya) * w;
  const float4* rb = img + static_cast<int64_t>(yb) * w;
  const float omfx = __fsub_rn(1.f, fx), omfy = __fsub_rn(1.f, fy);
  const float4 top = mix4(__ldg(ra + xa), __ldg(ra + xb), fx, omfx);
  const float4 bot = mix4(__ldg(rb + xa), __ldg(rb + xb), fx, omfx);
  return mix4(top, bot, fy, omfy);
}

// one sample of sampleWithMotion: uv moved by m * k, 0 outside [0, 1]
__device__ __forceinline__ float4 moved(const float4* __restrict__ img,
                                        int h, int w, float u, float v,
                                        float mdx, float mdy, float kx,
                                        float ky, bool fuse_x, bool fuse_y) {
  const float su = fuse_x ? oracle::fma_once(mdx, kx, u)
                          : __fadd_rn(u, __fmul_rn(mdx, kx));
  const float sv = fuse_y ? oracle::fma_once(mdy, ky, v)
                          : __fadd_rn(v, __fmul_rn(mdy, ky));
  if (su < 0.f || su > 1.f || sv < 0.f || sv > 1.f) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return bilinear(img, h, w,
                  oracle::fma_once(su, static_cast<float>(w), -0.5f),
                  oracle::fma_once(sv, static_cast<float>(h), -0.5f));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
    oracle_warp_kernel(const float4* __restrict__ prev,
                       const float4* __restrict__ curr,
                       const float2* __restrict__ mv,
                       const float* __restrict__ u_tab,
                       const float* __restrict__ v_tab,
                       const float* __restrict__ x_tab,
                       const float* __restrict__ y_tab,
                       float4* __restrict__ out, int h, int w, float t,
                       float omt, float kx0, float kx1, float ky0, float ky1,
                       int fuse_x, int fuse_y) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t i = static_cast<int64_t>(y) * w + x;
  float4 pc, cc;
  if (mv == nullptr) {
    // a crossfade: both samples at the pixel centre, never outside
    const float sx = __ldg(x_tab + x), sy = __ldg(y_tab + y);
    pc = bilinear(prev, h, w, sx, sy);
    cc = bilinear(curr, h, w, sx, sy);
  } else {
    const float2 m = __ldg(mv + i);
    const float u = __ldg(u_tab + x), v = __ldg(v_tab + y);
    pc = moved(prev, h, w, u, v, m.x, m.y, kx0, ky0, fuse_x, fuse_y);
    cc = moved(curr, h, w, u, v, m.x, m.y, kx1, ky1, fuse_x, fuse_y);
  }
  out[i] = mix4(pc, cc, t, omt);
}

}  // namespace

// (prev f32 [h, w, 4], curr, mv f32 [h, w, 2] or null, u f32 [w], v f32
// [h], x f32 [w], y f32 [h], out f32 [h, w, 4], h, w, t, 1 - t, prev's and
// curr's uv steps in x (kx0, kx1) and y (ky0, ky1), fuse_x, fuse_y,
// device, stream); frames 16-byte and the MV field 8-byte aligned
extern "C" int tpufg_oracle_warp(const void* prev, const void* curr,
                                 const void* mv, const void* u,
                                 const void* v, const void* xs,
                                 const void* ys, void* out, int h, int w,
                                 float t, float omt, float kx0, float kx1,
                                 float ky0, float ky1, int fuse_x, int fuse_y,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  oracle_warp_kernel<<<grid, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const float4*>(prev), static_cast<const float4*>(curr),
      static_cast<const float2*>(mv), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<float4*>(out), h, w, t, omt,
      kx0, kx1, ky0, ky1, fuse_x, fuse_y);
  return static_cast<int>(cudaGetLastError());
}

// what 0 registers a thread, 1 blocks of 256 threads per SM, 2 local
// memory bytes a thread (spills); -1 on error
extern "C" int tpufg_oracle_warp_occupancy(int what) {
  return oracle::occupancy(reinterpret_cast<const void*>(oracle_warp_kernel),
                           kBlockX * kBlockY, what);
}
