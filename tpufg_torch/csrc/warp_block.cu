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
// written once: 12 B per pixel and channel; 100 MB at [4,1088,1920]).  The
// TPU kernel's aligned row windows, 8-way switch and lane rolls exist
// because the TPU has no dynamic gather; here a thread gathers its four
// taps directly.  Design: one thread per output pixel looping over the
// channels, 32x8 threads per block; a block's MV is read once per thread
// (a warp of 32 columns spans two 16-px blocks), the offsets, fractions and
// masks are computed once and serve every channel, and the taps of
// neighbouring threads are neighbouring addresses of the same rows, so the
// gathers coalesce as well as the stores.  No shared memory or tiling yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// Bilinear sample of the plane src [h, w] at (y + sy.i0 + sy.f, x + sx.i0
// + sx.f), taps clamped to the edge.
__device__ __forceinline__ float sample(const float* __restrict__ src, int h,
                                        int w, int y, int x, Split sy,
                                        Split sx) {
  const int y0 = min(max(y + sy.i0, 0), h - 1);
  const int y1 = min(max(y + sy.i0 + 1, 0), h - 1);
  const int x0 = min(max(x + sx.i0, 0), w - 1);
  const int x1 = min(max(x + sx.i0 + 1, 0), w - 1);
  const float* r0 = src + static_cast<int64_t>(y0) * w;
  const float* r1 = src + static_cast<int64_t>(y1) * w;
  const float gx = __fsub_rn(1.0f, sx.f);
  const float gy = __fsub_rn(1.0f, sy.f);
  const float top = __fadd_rn(__fmul_rn(r0[x0], gx), __fmul_rn(r0[x1], sx.f));
  const float bot = __fadd_rn(__fmul_rn(r1[x0], gx), __fmul_rn(r1[x1], sx.f));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, sy.f));
}

__global__ void warp_block_kernel(const float* __restrict__ prev,
                                  const float* __restrict__ curr,
                                  const float* __restrict__ mv,
                                  float* __restrict__ out, int n_ch, int h,
                                  int w, int g, float r, float t, int single) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;

  const int nbx = w / g;
  const int64_t blk = static_cast<int64_t>(y / g) * nbx + x / g;
  const int64_t mv_plane = static_cast<int64_t>(h / g) * nbx;
  const float mdx = fminf(fmaxf(mv[blk], -r), r);
  const float mdy = fminf(fmaxf(mv[mv_plane + blk], -r), r);

  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t o = static_cast<int64_t>(y) * w + x;
  if (single) {
    const Split sx = split(mdx), sy = split(mdy);
    for (int c = 0; c < n_ch; ++c) {
      out[c * plane + o] = sample(prev + c * plane, h, w, y, x, sy, sx);
    }
    return;
  }
  const float omt = __fsub_rn(1.0f, t);
  const float pox = __fmul_rn(mdx, -t), poy = __fmul_rn(mdy, -t);
  const float cox = __fmul_rn(mdx, omt), coy = __fmul_rn(mdy, omt);
  const Split psx = split(pox), psy = split(poy);
  const Split csx = split(cox), csy = split(coy);
  const float pmask = in_range(x, pox, w) * in_range(y, poy, h);
  const float cmask = in_range(x, cox, w) * in_range(y, coy, h);
  for (int c = 0; c < n_ch; ++c) {
    const float p = sample(prev + c * plane, h, w, y, x, psy, psx);
    const float q = sample(curr + c * plane, h, w, y, x, csy, csx);
    out[c * plane + o] = __fadd_rn(__fmul_rn(__fmul_rn(p, pmask), omt),
                                   __fmul_rn(__fmul_rn(q, cmask), t));
  }
}

}  // namespace

// prev, curr, out f32 [n_ch, h, w]; mv f32 [2, h/g, w/g]; h and w multiples
// of g (the wrapper checks); r the clip radius; t the blend factor.
extern "C" int tpufg_warp_block(const void* prev, const void* curr,
                                const void* mv, void* out, int n_ch, int h,
                                int w, int g, float r, float t, int single,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 threads(32, 8);
  const dim3 blocks((w + threads.x - 1) / threads.x,
                    (h + threads.y - 1) / threads.y);
  warp_block_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(prev), static_cast<const float*>(curr),
      static_cast<const float*>(mv), static_cast<float*>(out), n_ch, h, w, g,
      r, t, single);
  return static_cast<int>(cudaGetLastError());
}
