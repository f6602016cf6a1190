// RIFE's backward warp (model/warplayer.py) in one pass: the sampling grid
// made from the flow and the bilinear, border-clamped, align_corners=True
// sample of every channel.
//
// PyTorch runs warplayer's warp as five or more passes over the frame: the
// flow divided by (W - 1) / 2 and (H - 1) / 2 (a multiply by the f32
// reciprocal, as PyTorch divides by a host scalar on the card), the two
// halves concatenated, added to the linspace grid, then grid_sample; the
// IFNet's bf16 features take a copy to f32 before and a copy to bf16 after.
// Here a thread takes one output pixel (or 8 of its channels): it reads the
// flow, forms the grid value with the same roundings (__fmul_rn, __fadd_rn:
// nothing fused that PyTorch rounds apart), unnormalises and clamps it as
// grid_sample does, and accumulates the four corners per channel in
// grid_sample's order.
//
// Two layouts (kernels/warp_grid.py): f32 planar frames ([n, C, H, W],
// any channel and batch strides, a channel at a time) and channels-last
// bf16 features ([1, H, W, C], C a multiple of 8, a thread per pixel and
// 8 channels with 16-byte loads and stores, written straight into a wider
// channels-last buffer at a channel offset).
//
// Bound on the H100: memory.  A pixel reads its flow (8 bytes), each
// corner's channels (cached: neighbouring threads share corners) and
// writes its channels once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  int x0, y0;
  float nw, ne, sw, se;
  bool in_ne, in_sw, in_se;
};

// grid_sample's source index for align_corners=True and border padding,
// and its bilinear surfaces (ATen's GridSampler.cuh)
__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  float ix = ((gx + 1.f) / 2) * (w - 1);
  float iy = ((gy + 1.f) / 2) * (h - 1);
  ix = fminf(static_cast<float>(w - 1), fmaxf(ix, 0.f));
  iy = fminf(static_cast<float>(h - 1), fmaxf(iy, 0.f));
  Corners c;
  c.x0 = static_cast<int>(floorf(ix));
  c.y0 = static_cast<int>(floorf(iy));
  const int x1 = c.x0 + 1, y1 = c.y0 + 1;
  c.nw = (x1 - ix) * (y1 - iy);
  c.ne = (ix - c.x0) * (y1 - iy);
  c.sw = (x1 - ix) * (iy - c.y0);
  c.se = (ix - c.x0) * (iy - c.y0);
  c.in_ne = x1 < w;
  c.in_sw = y1 < h;
  c.in_se = c.in_ne && c.in_sw;
  return c;
}

__device__ __forceinline__ Corners pixel_corners(
    const float* flow, int64_t fs_c, int64_t f_off, const float* base_x,
    const float* base_y, int x, int y, int h, int w, float inv_dx,
    float inv_dy) {
  const float fx = flow[f_off];
  const float fy = flow[f_off + fs_c];
  const float gx = __fadd_rn(base_x[x], __fmul_rn(fx, inv_dx));
  const float gy = __fadd_rn(base_y[y], __fmul_rn(fy, inv_dy));
  return corners(gx, gy, h, w);
}

__global__ void warp_planar_f32(
    const float* __restrict__ src, int64_t xs_n, int64_t xs_c, int64_t xs_h,
    const float* __restrict__ flow, int64_t fs_n, int64_t fs_c, int64_t fs_h,
    const float* __restrict__ base_x, const float* __restrict__ base_y,
    float* __restrict__ out, int64_t os_n, int64_t os_c, int64_t os_h,
    int n, int channels, int h, int w, float inv_dx, float inv_dy) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  if (p >= n * hw) return;
  const int b = static_cast<int>(p / hw);
  const int y = static_cast<int>((p % hw) / w);
  const int x = static_cast<int>(p % w);
  const Corners c = pixel_corners(flow, fs_c, b * fs_n + y * fs_h + x,
                                  base_x, base_y, x, y, h, w, inv_dx,
                                  inv_dy);
  const float* s = src + b * xs_n + c.y0 * xs_h + c.x0;
  float* o = out + b * os_n + y * os_h + x;
  for (int ch = 0; ch < channels; ++ch, s += xs_c, o += os_c) {
    float acc = 0;
    acc += s[0] * c.nw;
    if (c.in_ne) acc += s[1] * c.ne;
    if (c.in_sw) acc += s[xs_h] * c.sw;
    if (c.in_se) acc += s[xs_h + 1] * c.se;
    *o = acc;
  }
}

__device__ __forceinline__ void add8(float* acc, const uint4& raw, float wt) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] += __bfloat162float(e[k]) * wt;
}

// a thread per (pixel, 8 channels): consecutive threads on a pixel's
// consecutive 16-byte channel groups, so each corner's read and the
// output's write are coalesced across a warp
__global__ void warp_nhwc_bf16(
    const __nv_bfloat16* __restrict__ src, int64_t xs_h,
    const float* __restrict__ flow, int64_t fs_c, int64_t fs_h,
    const float* __restrict__ base_x, const float* __restrict__ base_y,
    __nv_bfloat16* __restrict__ out, int64_t os_h, int64_t os_w,
    int channels, int h, int w, float inv_dx, float inv_dy) {
  const int groups = channels / 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(h) * w * groups) return;
  const int64_t p = t / groups;
  const int g = static_cast<int>(t % groups) * 8;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p % w);
  const Corners c = pixel_corners(flow, fs_c, y * fs_h + x, base_x, base_y,
                                  x, y, h, w, inv_dx, inv_dy);
  // xs_h: a source row in elements; a source pixel holds `channels`
  const __nv_bfloat16* s =
      src + c.y0 * xs_h + static_cast<int64_t>(c.x0) * channels + g;
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  add8(acc, *reinterpret_cast<const uint4*>(s), c.nw);
  if (c.in_ne) add8(acc, *reinterpret_cast<const uint4*>(s + channels), c.ne);
  if (c.in_sw) add8(acc, *reinterpret_cast<const uint4*>(s + xs_h), c.sw);
  if (c.in_se) {
    add8(acc, *reinterpret_cast<const uint4*>(s + xs_h + channels), c.se);
  }
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(acc[k]);
  *reinterpret_cast<uint4*>(out + y * os_h + x * os_w + g) = raw;
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// (src f32, its batch, channel and row strides; flow f32 [n, 2, h, w], its
//  batch, channel and row strides; base_x f32 [w], base_y f32 [h]; out f32,
//  its batch, channel and row strides; n, channels, h, w, the flow's f32
//  multipliers 1 / ((w - 1) / 2) and 1 / ((h - 1) / 2), device, stream).
//  Columns are contiguous in every operand.
extern "C" int tpufg_warp_grid_f32(
    const void* src, int64_t xs_n, int64_t xs_c, int64_t xs_h,
    const void* flow, int64_t fs_n, int64_t fs_c, int64_t fs_h,
    const void* base_x, const void* base_y, void* out, int64_t os_n,
    int64_t os_c, int64_t os_h, int n, int channels, int h, int w,
    float inv_dx, float inv_dy, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_planar_f32<<<blocks_for(static_cast<int64_t>(n) * h * w), kThreads,
                    0, stream>>>(
      static_cast<const float*>(src), xs_n, xs_c, xs_h,
      static_cast<const float*>(flow), fs_n, fs_c, fs_h,
      static_cast<const float*>(base_x), static_cast<const float*>(base_y),
      static_cast<float*>(out), os_n, os_c, os_h, n, channels, h, w, inv_dx,
      inv_dy);
  return static_cast<int>(cudaGetLastError());
}

// (src bf16 channels-last [1, h, w, channels], its row stride; flow f32
//  [1, 2, h, w] (any channel and row strides); base_x, base_y; out bf16
//  channels-last (at the channel offset), its row and pixel strides;
//  channels (a multiple of 8), h, w, the multipliers, device, stream).
//  Every pointer and stride 16-byte aligned.
extern "C" int tpufg_warp_grid_bf16(
    const void* src, int64_t xs_h, const void* flow, int64_t fs_c,
    int64_t fs_h, const void* base_x, const void* base_y, void* out,
    int64_t os_h, int64_t os_w, int channels, int h, int w, float inv_dx,
    float inv_dy, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (channels % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  warp_nhwc_bf16<<<blocks_for(static_cast<int64_t>(h) * w * (channels / 8)),
                   kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(src), xs_h,
      static_cast<const float*>(flow), fs_c, fs_h,
      static_cast<const float*>(base_x), static_cast<const float*>(base_y),
      static_cast<__nv_bfloat16*>(out), os_h, os_w, channels, h, w, inv_dx,
      inv_dy);
  return static_cast<int>(cudaGetLastError());
}
