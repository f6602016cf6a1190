// RAFT's correlation lookup (core/corr.py, CorrBlock.__call__) in one pass:
// for every pixel of the 1/8 grid, the 9 x 9 window of radius 4 around its
// current coordinates on each of the 4 levels of its all-pairs correlation
// pyramid, sampled bilinearly, written as the 324 (+ 4 zero) bf16 channels
// of the channels-last input of the motion encoder's first conv.
//
// The published form is four grid_sample calls over an (N, 1, h, w) view of
// each level with an (N, 9, 9, 2) grid, then cat and permute: five or more
// passes, and an f32 copy of the whole 324-channel map.  No TPU kernel:
// tpufg has no RAFT; this kernel replaces those library calls.
//
// Arithmetic (kernels/corr_lookup.py::corr_lookup_plain is the published
// form, run through ATen's own sampler): level l's centre is coords * 2^-l
// (exact); tap (a, b) sits at x + (a - 4), y + (b - 4) (corr.py's
// meshgrid(dy, dx) puts the x offset in the first index), then
// bilinear_sampler's normalise, 2 * x / (W - 1) - 1, the divide a multiply
// by fl(1 / (W - 1)) as PyTorch divides by a host scalar on the card, and
// grid_sample's unnormalise, ((g + 1) / 2) * (W - 1) (align_corners=True),
// each rounded as ATen rounds it; the four corners (zeros outside) summed
// in grid_sample's order as its compiled code sums them (fused
// multiply-adds from 0).  So every sample is bitwise the plain version's,
// and rounds to bf16 to nearest, ties to even.
//
// Bound on the H100: memory.  Each lookup reads a 10 x 10 patch of each
// level's map for every pixel (no reuse between pixels: each has its own
// map) and writes 656 bytes a pixel.  Design: a warp per pixel; a lane
// takes two neighbouring channels and writes them as one 4-byte store, so a
// warp's stores cover 128 contiguous bytes; a level's taps share the
// patch, which stays in L1 while the warp walks it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 4;
constexpr int kSide = 2 * kRadius + 1;          // 9
constexpr int kLevelTaps = kSide * kSide;       // 81
constexpr int kLevels = 4;
constexpr int kTaps = kLevels * kLevelTaps;     // 324
constexpr int kThreads = 256;

struct Pyramid {
  const float* map[kLevels];   // [n, h_l, w_l] each
  int h[kLevels];
  int w[kLevels];
  float inv_x[kLevels];        // fl(1 / (w_l - 1))
  float inv_y[kLevels];        // fl(1 / (h_l - 1))
};

__device__ __forceinline__ float unnormalize(float g, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.f), 0.5f),
                   static_cast<float>(size - 1));
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int h,
                                        int w, float x, float y,
                                        float inv_x, float inv_y) {
  const float gx = __fadd_rn(__fmul_rn(__fmul_rn(x, 2.f), inv_x), -1.f);
  const float gy = __fadd_rn(__fmul_rn(__fmul_rn(y, 2.f), inv_y), -1.f);
  const float ix = unnormalize(gx, w);
  const float iy = unnormalize(gy, h);
  const int x0 = static_cast<int>(floorf(ix));
  const int y0 = static_cast<int>(floorf(iy));
  const int x1 = x0 + 1, y1 = y0 + 1;
  const float nw = __fmul_rn(__fsub_rn(static_cast<float>(x1), ix),
                             __fsub_rn(static_cast<float>(y1), iy));
  const float ne = __fmul_rn(__fsub_rn(ix, static_cast<float>(x0)),
                             __fsub_rn(static_cast<float>(y1), iy));
  const float sw = __fmul_rn(__fsub_rn(static_cast<float>(x1), ix),
                             __fsub_rn(iy, static_cast<float>(y0)));
  const float se = __fmul_rn(__fsub_rn(ix, static_cast<float>(x0)),
                             __fsub_rn(iy, static_cast<float>(y0)));
  const bool x0_in = x0 >= 0 && x0 < w, x1_in = x1 >= 0 && x1 < w;
  const bool y0_in = y0 >= 0 && y0 < h, y1_in = y1 >= 0 && y1 < h;
  float acc = 0.f;
  if (y0_in && x0_in) acc = fmaf(__ldg(img + y0 * w + x0), nw, acc);
  if (y0_in && x1_in) acc = fmaf(__ldg(img + y0 * w + x1), ne, acc);
  if (y1_in && x0_in) acc = fmaf(__ldg(img + y1 * w + x0), sw, acc);
  if (y1_in && x1_in) acc = fmaf(__ldg(img + y1 * w + x1), se, acc);
  return acc;
}

__device__ __forceinline__ float tap(const Pyramid& pyr, int64_t p, float cx,
                                     float cy, int ch) {
  const int l = ch / kLevelTaps;
  const int k = ch - l * kLevelTaps;
  const int a = k / kSide, b = k - (k / kSide) * kSide;
  const float s = 1.f / static_cast<float>(1 << l);
  const float x = __fadd_rn(__fmul_rn(cx, s), static_cast<float>(a - kRadius));
  const float y = __fadd_rn(__fmul_rn(cy, s), static_cast<float>(b - kRadius));
  const int h = pyr.h[l], w = pyr.w[l];
  return sample(pyr.map[l] + p * h * w, h, w, x, y, pyr.inv_x[l],
                pyr.inv_y[l]);
}

// coords f32 [2, n] (x plane, then y); out bf16 [n, out_c], out_c >= 324
// even, the channels past 324 written as zeros
__global__ void corr_lookup_kernel(Pyramid pyr,
                                   const float* __restrict__ coords,
                                   int64_t n, int out_c,
                                   __nv_bfloat16* __restrict__ out) {
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= n) return;
  const float cx = coords[p];
  const float cy = coords[n + p];
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + p * out_c);
  for (int q = lane; q < out_c / 2; q += 32) {
    const int ch = 2 * q;
    const float v0 = ch < kTaps ? tap(pyr, p, cx, cy, ch) : 0.f;
    const float v1 = ch + 1 < kTaps ? tap(pyr, p, cx, cy, ch + 1) : 0.f;
    o[q] = __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace

// (the 4 levels' maps f32 [n, h_l, w_l], their heights and widths as
//  int32 host arrays of 4, the x and y multipliers fl(1 / (w_l - 1)) and
//  fl(1 / (h_l - 1)) as float host arrays of 4, coords f32 [2, n], n
//  pixels, out bf16 [n, out_c] (out_c even, >= 324), out_c, device,
//  stream)
extern "C" int tpufg_corr_lookup(const void* const* maps, const int* hs,
                                 const int* ws, const float* inv_x,
                                 const float* inv_y, const void* coords,
                                 int64_t n, void* out, int out_c,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || out_c < kTaps || out_c % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid pyr;
  for (int l = 0; l < kLevels; ++l) {
    pyr.map[l] = static_cast<const float*>(maps[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.inv_x[l] = inv_x[l];
    pyr.inv_y[l] = inv_y[l];
  }
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  corr_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      pyr, static_cast<const float*>(coords), n, out_c,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
