// The engine's block-granular warp and blend.
//
// Replaces tpufg/kernels/warp_matmul.py:warp_blend_matmul (an XLA op of the
// reference, not a Pallas kernel: the TPU moves pixels with one-hot shift
// matmuls because it has no gather).  Computes what
// tpufg_torch/kernels/warp_matmul.py::warp_blend_matmul_plain computes,
// bitwise: planar f32 prev and curr [C, H, W], one pixel-unit MV per g x g
// block (mv [2, H/g, W/g], dx then dy) clipped to +-r, f32 out [C, out_h,
// out_w] (the top-left window of the warped frame: the engine's crop).
//
// - The value domain: centred reals fl(x - 0.5), or with U8 (the blend's
//   u8_exact on whole-pixel moves) centred codes rint(255 x) - 128 (round
//   half to even), each rounded to the moving type (f32, or bf16 round to
//   nearest even); back by fl(o + 0.5), or (o + 128) * fl(1/255).
// - Integer offsets: one tap per value at floor(o).
// - Fractional offsets o = floor(o) + f: the weights f and 1 - f rounded to
//   the moving type; the horizontal lerp a*(1-f) + b*f an f32 sum rounded
//   once to the type (tpufg's one-hot matmul); the vertical lerp
//   elementwise in the type (each product and the sum rounded to it).
// - Blend: prev moved by m*(-t), curr by m*(1-t), each masked where its
//   sample point leaves [-0.5, size - 0.5], wp*mask_p*(1-t) +
//   wc*mask_c*t in f32.  Single: prev moved by m, no mask.
// Every operation is one _rn intrinsic in the plain version's order (nvcc
// would otherwise contract multiply-adds).
//
// Bound on the H100: device memory.  Each input value read once, each
// output written once: 100 MB for a 1080p blend (0.030 ms at 3.35 TB/s),
// 265 MB for a 4K single warp (0.079 ms).  The plain version builds int64
// index planes and gathers up to four times per frame, dozens of launches
// per warp.  Design: the tile walk of warp_tile.cuh (a thread per cell of
// V columns x RT rows of one MV block, each tap row read once per cell,
// all channels and frames loaded before the arithmetic, 16-byte stores),
// one launch per warp; the mode is compile-time.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_matmul_policy.cuh"
#include "warp_tile.cuh"

namespace {

template <bool BF16>
cudaError_t launch_mode(const warp_tile::Args& a, bool single, bool integer,
                        bool u8, bool pair, cudaStream_t stream) {
  if (!integer) {
    return warp_tile::launch<MatmulPolicy<true, false, BF16>>(a, single,
                                                              stream, pair);
  }
  if (u8) {
    return warp_tile::launch<MatmulPolicy<false, true, BF16>>(a, single,
                                                              stream, pair);
  }
  return warp_tile::launch<MatmulPolicy<false, false, BF16>>(a, single,
                                                             stream, pair);
}

}  // namespace

// prev, curr f32 [n_ch, h, w]; mv f32 [2, h/g, w/g]; out f32 [n_ch, out_h,
// out_w] with out_h <= h, out_w <= w; h and w multiples of g (the wrapper
// checks); r the clip radius; t and omt = fl(1 - t) the blend weights;
// single, integer (whole-pixel offsets), u8 (the integer-code domain, with
// integer only), bf16 (the moving type) and pair as 0/1.  pair (blend
// mode): out is [2 n_ch + 2, h, w] (out_h = h, out_w = w), the warped prev
// and curr unmasked, then their masks (warp_epilogue.cu blends them).
// valid_w: the blend masks' right edge (w, or the width before tpufg's
// column pad).
extern "C" int tpufg_warp_matmul(const void* prev, const void* curr,
                                 const void* mv, void* out, int n_ch, int h,
                                 int w, int g, float r, float t, float omt,
                                 int out_h, int out_w, int single,
                                 int integer, int u8, int bf16, int pair,
                                 int valid_w, int device,
                                 cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const warp_tile::Args a{static_cast<const float*>(prev),
                          static_cast<const float*>(curr),
                          static_cast<const float*>(mv),
                          static_cast<float*>(out),
                          n_ch, h, w, g, r, t, omt, out_h, out_w,
                          valid_w};
  const bool u8_codes = u8 && integer;
  const bool pair_out = pair && !single;
  return static_cast<int>(
      bf16 ? launch_mode<true>(a, single, integer, u8_codes, pair_out, stream)
           : launch_mode<false>(a, single, integer, u8_codes, pair_out,
                                stream));
}
