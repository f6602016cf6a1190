// The IFNet's last step in one pass (tpufg_torch/models/ifnet.py): the
// U-Net's sigmoid, the residual, the mask-weighted merge of both warped
// frames, the clamp, and the crop back from the padded frame.
//
//   out[c, y, x] = clamp(w0[c] s + w1[c] (1 - s) + r[c], 0, 1),
//   s = sigmoid(mask) (given), r[c] = 2 sigmoid(u[c]) - 1 for RGB, 0 for
//   alpha, u the final conv's bf16 output, space-to-depth by 2
//   (channels-last [1, >= 12, H / 2, W / 2], channel 3 phase + c).
//
// PyTorch runs it as about ten elementwise passes over 4K planes.  Every
// operation here rounds as PyTorch's op does (each product and sum with
// __fmul_rn / __fadd_rn / __fsub_rn, nothing fused; the sigmoid as ATen's
// 1 / (1 + exp(-x)) with IEEE division), so it is bitwise the plain
// version (kernels/merge.py::ifnet_merge_plain).
//
// Bound on the H100: memory: a pixel reads 2 x 4 f32, the mask's
// sigmoid and 3 bf16 and writes 4 f32.  A thread a pixel, consecutive
// threads on consecutive columns, so the planar reads and writes are
// coalesced.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ifnet_merge_kernel(const float* __restrict__ warped,
                                   int64_t ws_n, int64_t ws_c, int64_t ws_h,
                                   const float* __restrict__ sig, int64_t ss_h,
                                   const __nv_bfloat16* __restrict__ u, int u_ch,
                                   int64_t us_h, float* __restrict__ out, int h,
                                   int w) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= static_cast<int64_t>(h) * w) return;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p % w);
  const float s = sig[y * ss_h + x];
  const float s1 = __fsub_rn(1.0f, s);
  const float* w0 = warped + y * ws_h + x;
  const float* w1 = w0 + ws_n;
  // u is space-to-depth by 2: pixel (y, x)'s RGB at (y / 2, x / 2), channel
  // 3 (2 (y % 2) + x % 2) + c
  const __nv_bfloat16* up = u + (y >> 1) * us_h +
                            static_cast<int64_t>(x >> 1) * u_ch +
                            3 * (2 * (y & 1) + (x & 1));
  const int64_t plane = static_cast<int64_t>(h) * w;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float m = __fadd_rn(__fmul_rn(w0[c * ws_c], s), __fmul_rn(w1[c * ws_c],
                                                              s1));
    if (c < 3) {
      const float sg = 1.0f / (1.0f + expf(-__bfloat162float(up[c])));
      m = __fadd_rn(m, __fsub_rn(__fmul_rn(sg, 2.0f), 1.0f));
    }
    out[c * plane + p] = fminf(fmaxf(m, 0.0f), 1.0f);
  }
}

}  // namespace

// (warped f32 [2, 4, hp, wp], its batch, channel and row strides (columns
//  contiguous); sig f32 [hp, wp] (its row stride); u bf16 channels-last
//  [1, u_ch, hp / 2, wp / 2] (u_ch channels a pixel, its row stride); out f32
//  [4, h, w] contiguous; h, w (the crop), device, stream)
extern "C" int tpufg_ifnet_merge(const void* warped, int64_t ws_n,
                                 int64_t ws_c, int64_t ws_h, const void* sig,
                                 int64_t ss_h, const void* u, int u_ch,
                                 int64_t us_h, void* out, int h, int w,
                                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(h) * w;
  ifnet_merge_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      static_cast<const float*>(warped), ws_n, ws_c, ws_h,
      static_cast<const float*>(sig), ss_h,
      static_cast<const __nv_bfloat16*>(u), u_ch, us_h,
      static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
