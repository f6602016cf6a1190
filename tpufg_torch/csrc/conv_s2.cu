// SAME-padded 3x3 stride-2 convolution with bias in f32, planar layout.
//
// Replaces tpufg/kernels/conv.py:_conv_s2_kernel (the Pallas kernel behind
// conv3x3_s2) for compute_dtype = float32; the bf16 form, which the learned
// head's first encoder layer (enc1) runs, is conv_s2_mma.cu on the tensor
// cores.  Planar
// f32 x [Cin, H, W] (H, W even) -> f32 [Cout, H/2, W/2], with
//   out[co][oy][ox] = b[co] + sum_{dy,dx,ci} w[co][ci][dy][dx] *
//                                             x[ci][2oy + dy][2ox + dx]
// and x read as 0 past the last row and column: XLA's SAME padding for a
// stride-2 window of 3 on an even size is (0, 1), so nothing pads in front.
// The products are summed in f32, tap by tap (dy, dx outer, ci inner), as
// the Pallas kernel does; the bias is added last and the relu stays with
// the caller.  The wrapper (tpufg_torch/kernels/conv.py) hands the weights
// over laid out as [ci][dy][dx][co], Cout padded with zeros to kCout = 32
// (the encoder's width, h/2 of a 64-wide head).
//
// Bound on the H100: memory.  At the bf16 path's shape, [4, 2160, 3840] ->
// [32, 1080, 1920], a stride-2 conv reads 133 MB and writes 265 MB for 4.8
// GFLOP, about 12 flops per byte.  The TPU kernel turns the strided tap
// gather into selection matmuls because Mosaic refuses strided slices;
// here a thread simply reads its taps.  Design: one thread per output
// pixel computes all kCout channels in registers; a block of 32 x 8
// threads covers 32 output columns of 8 rows, so a warp's stores of one
// channel are one contiguous 128-byte segment and its tap reads (stride 2)
// hit L1 for the overlapping taps.  The 9 * Cin * kCout weights sit in
// shared memory and are read as float4 broadcasts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kCout = 32;

template <int CIN>
__global__ void __launch_bounds__(kBlockX * kBlockY)
conv_s2_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ out,
               int cout, int h, int w) {
  __shared__ __align__(16) float w_s[CIN * 9 * kCout];
  __shared__ float b_s[kCout];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < CIN * 9 * kCout; i += kBlockX * kBlockY) {
    w_s[i] = wt[i];
  }
  if (tid < kCout) b_s[tid] = bias[tid];
  __syncthreads();

  const int oh = h / 2, ow = w / 2;
  const int ox = blockIdx.x * kBlockX + threadIdx.x;
  const int oy = blockIdx.y * kBlockY + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const int64_t plane = static_cast<int64_t>(h) * w;

  float acc[kCout];
#pragma unroll
  for (int co = 0; co < kCout; ++co) acc[co] = 0.0f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int y = 2 * oy + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = 2 * ox + dx;
      const bool in = y < h && xx < w;
      const float* src = x + static_cast<int64_t>(y) * w + xx;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const float v = in ? __ldg(src + ci * plane) : 0.0f;
        const float4* wv = reinterpret_cast<const float4*>(
            w_s + ((ci * 3 + dy) * 3 + dx) * kCout);
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 k = wv[q];
          acc[4 * q] = fmaf(k.x, v, acc[4 * q]);
          acc[4 * q + 1] = fmaf(k.y, v, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(k.z, v, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(k.w, v, acc[4 * q + 3]);
        }
      }
    }
  }
  const int64_t oplane = static_cast<int64_t>(oh) * ow;
  float* dst = out + static_cast<int64_t>(oy) * ow + ox;
#pragma unroll
  for (int co = 0; co < kCout; ++co) {
    if (co < cout) dst[co * oplane] = __fadd_rn(acc[co], b_s[co]);
  }
}

template <int CIN>
int launch_s2(const float* x, const float* wt, const float* b, float* out,
              int cout, int h, int w, cudaStream_t stream) {
  const int oh = h / 2, ow = w / 2;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY);
  conv_s2_kernel<CIN><<<grid, block, 0, stream>>>(x, wt, b, out, cout, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32 [cin, h, w]; wt f32 [cin * 9, 32] (zero past cout); b f32 [32];
// out f32 [cout, h/2, w/2].  cin in {4, 8}, cout <= 32, h and w even.
extern "C" int tpufg_conv_s2(const void* x, const void* wt, const void* b,
                             void* out, int cin, int cout, int h, int w,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cout < 1 || cout > kCout) return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  const float* ws = static_cast<const float*>(wt);
  const float* bs = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  switch (cin) {
    case 4: return launch_s2<4>(xs, ws, bs, o, cout, h, w, stream);
    case 8: return launch_s2<8>(xs, ws, bs, o, cout, h, w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
