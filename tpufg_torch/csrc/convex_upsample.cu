// RAFT's convex upsampling (core/raft.py, RAFT.upsample_flow) in one pass:
// each full-size pixel's flow is a convex combination of 8 x the 3 x 3
// coarse flows around its 8 x 8 cell, weighted by the softmax over 9 of its
// mask logits, 0.25 times the mask head's bf16 output (exact in f32).
//
// The published form is the 0.25 scale, view, softmax over the 9 taps,
// unfold of 8 * flow, the weighted sum and a permute: six passes, four of
// them over the 576-channel mask.  No TPU kernel: tpufg has no RAFT; this kernel
// replaces those library calls.
//
// Arithmetic (kernels/convex_upsample.py::convex_upsample_plain): 0.25 m in
// f32, the softmax as exp(m - max) / sum, the sum over the taps in tap order, then
// sum_k w_k * 8 flow_k in tap order, one rounding per operation (no fused
// multiply-add), expf as ATen's exp calls it: bitwise the plain version.
//
// Bound on the H100: memory: the bf16 mask is read once (576 channels a
// coarse pixel), the flow is read (cached: 64 pixels share a cell), the
// full-size flow written once.  Design: a thread per full-size pixel and
// both flow channels; a warp covers 32 consecutive columns of a row (4
// cells), so its stores are 128 contiguous bytes a channel and its mask
// reads 4 runs of 8 consecutive bf16 values a tap.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCell = 8;
constexpr int kTaps = 9;
constexpr int kMaskC = kTaps * kCell * kCell;   // 576

// flow f32 [2, h, w]; mask bf16 [h, w, 576] (channel k * 64 + i * 8 + j);
// out f32 [2, 8h, 8w]
__global__ void convex_upsample_kernel(const float* __restrict__ flow,
                                       const __nv_bfloat16* __restrict__ mask,
                                       int h, int w,
                                       float* __restrict__ out) {
  const int ow = w * kCell;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(h) * kCell * ow) return;
  const int oy = static_cast<int>(t / ow), ox = static_cast<int>(t % ow);
  const int y = oy / kCell, i = oy % kCell;
  const int x = ox / kCell, j = ox % kCell;
  const __nv_bfloat16* m = mask + (static_cast<int64_t>(y) * w + x) *
                                       kMaskC + i * kCell + j;
  float e[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    e[k] = __fmul_rn(0.25f, __bfloat162float(__ldg(m + k * kCell * kCell)));
  float mx = e[0];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) mx = fmaxf(mx, e[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    e[k] = expf(__fsub_rn(e[k], mx));
    s = k == 0 ? e[0] : __fadd_rn(s, e[k]);
  }
  const int64_t plane = static_cast<int64_t>(h) * w;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int yy = y + k / 3 - 1, xx = x + k % 3 - 1;
    float f0 = 0.f, f1 = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const int64_t at = static_cast<int64_t>(yy) * w + xx;
      f0 = __fmul_rn(8.f, __ldg(flow + at));
      f1 = __fmul_rn(8.f, __ldg(flow + plane + at));
    }
    const float wk = __fdiv_rn(e[k], s);
    const float p0 = __fmul_rn(wk, f0), p1 = __fmul_rn(wk, f1);
    acc0 = k == 0 ? p0 : __fadd_rn(acc0, p0);
    acc1 = k == 0 ? p1 : __fadd_rn(acc1, p1);
  }
  const int64_t o = static_cast<int64_t>(oy) * ow + ox;
  out[o] = acc0;
  out[plane * kCell * kCell + o] = acc1;
}

}  // namespace

// (flow f32 [2, h, w], mask bf16 [h, w, 576] (channels-last), out f32
//  [2, 8h, 8w], h, w, device, stream)
extern "C" int tpufg_convex_upsample(const void* flow, const void* mask,
                                     void* out, int h, int w, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(h) * w * kCell * kCell;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  convex_upsample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<const float*>(flow),
                                     static_cast<const __nv_bfloat16*>(mask),
                                     h, w,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
