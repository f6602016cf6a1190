// An IFBlock's output added into the IFNet's flow and mask in one pass
// (tpufg_torch/models/ifnet.py): the block's last transposed conv gives
// t (bf16, channels-last, 5 of its 8 channels read) at 1 / (2S) of the
// frame; the published network resizes it by 2S (bilinear,
// align_corners=False) and adds it, the flow's 4 channels times 2S, into
// the f32 state [1, 5, H, W] (flow, then the mask logit).
//
//   state[c] (+)= up(t)[c] * (c < 4 ? 2S : 1)
//
// PyTorch runs it as a copy to f32, F.interpolate's upsample_bilinear2d
// kernel, and an addcmul, each a pass over the full-size state.  Here a
// thread takes one output pixel: the source index and the four lambdas as
// ATen's upsample_bilinear2d_out_frame computes them (area_pixel_compute_
// source_index with the scale 1 / (2S)), the bilinear sum in ATen's
// expression, then the sum into the state (2S a power of two, so the
// product is exact and the sum rounds once, as addcmul's).  The lambdas
// are multiples of 1 / (4S) and t is bf16, so each product is exact and
// only the contraction of the outer sum could move a bit: compiled as ATen
// writes it, the sum is bitwise upsample_bilinear2d's on the H100 (the
// cuda lane of tests/test_torch_cuda.py holds it there).
//
// Bound on the H100: memory: the state is read and written once (f32, 5
// channels a pixel), t is 1 / (4S^2) of it and cached.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ifnet_accum_kernel(const __nv_bfloat16* __restrict__ t,
                                   int t_ch, int th, int tw,
                                   float* __restrict__ state, int h, int w,
                                   float rscale, float flow_mult,
                                   int first) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= static_cast<int64_t>(h) * w) return;
  const int h2 = static_cast<int>(p / w);
  const int w2 = static_cast<int>(p % w);
  float h1r = rscale * (h2 + 0.5f) - 0.5f;
  h1r = h1r < 0.f ? 0.f : h1r;
  const int h1 = static_cast<int>(h1r);
  const int h1p = (h1 < th - 1) ? 1 : 0;
  const float h1l = h1r - h1;
  const float h0l = 1.f - h1l;
  float w1r = rscale * (w2 + 0.5f) - 0.5f;
  w1r = w1r < 0.f ? 0.f : w1r;
  const int w1 = static_cast<int>(w1r);
  const int w1p = (w1 < tw - 1) ? 1 : 0;
  const float w1l = w1r - w1;
  const float w0l = 1.f - w1l;
  const __nv_bfloat16* r0 = t + (static_cast<int64_t>(h1) * tw + w1) * t_ch;
  const __nv_bfloat16* r1 = r0 + static_cast<int64_t>(h1p) * tw * t_ch;
  const int dx = w1p * t_ch;
  const int64_t plane = static_cast<int64_t>(h) * w;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    // upsample_bilinear2d_out_frame's expression, as ATen writes it
    const float v =
        h0l * (w0l * __bfloat162float(r0[c]) +
               w1l * __bfloat162float(r0[c + dx])) +
        h1l * (w0l * __bfloat162float(r1[c]) +
               w1l * __bfloat162float(r1[c + dx]));
    const float add = c < 4 ? __fmul_rn(v, flow_mult) : v;
    float* s = state + c * plane + p;
    *s = first ? add : __fadd_rn(*s, add);
  }
}

}  // namespace

// (t bf16 channels-last [1, t_ch, th, tw], t_ch, th, tw; state f32
//  [1, 5, h, w] contiguous (written, or added to); h, w; the resize's
//  f32 scale 1 / (2S), the flow's multiplier 2S; first (write, not add);
//  device, stream)
extern "C" int tpufg_ifnet_accum(const void* t, int t_ch, int th, int tw,
                                 void* state, int h, int w, float rscale,
                                 float flow_mult, int first, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t_ch < 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = static_cast<int64_t>(h) * w;
  ifnet_accum_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(t), t_ch, th, tw,
      static_cast<float*>(state), h, w, rscale, flow_mult, first);
  return static_cast<int>(cudaGetLastError());
}
