// Aligned 2x2 box downsample of planar f32 frames.
//
// Replaces tpufg/kernels/resize.py:_box2_kernel (the Pallas kernel behind
// box_downsample2): [C, H, W] -> [C, H/2, W/2], each output the mean of its
// 2x2 input cell.  The TPU computes it as two banded 0.5-weight matmuls,
// the vertical pair first and then the horizontal pair; this kernel keeps
// exactly that order and rounding:
//   v0  = 0.5*x[2i][2j]   + 0.5*x[2i+1][2j]
//   v1  = 0.5*x[2i][2j+1] + 0.5*x[2i+1][2j+1]
//   out = 0.5*v0 + 0.5*v1
// with explicit _rn intrinsics so no FMA contraction changes a bit.  The
// result is bitwise equal to the plain torch version and to tpufg.
//
// Bound on the H100: memory (16 bytes read, 4 written, 6 flops per output).
// Design: one thread per output element, consecutive threads on consecutive
// output columns, so each warp reads two contiguous 256-byte row segments
// per input row and writes one contiguous 128-byte segment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void box2_kernel(const float* __restrict__ src,
                            float* __restrict__ dst, int c, int h, int w) {
  const int oh = h / 2, ow = w / 2;
  int64_t n = static_cast<int64_t>(c) * oh * ow;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = static_cast<int>(i % ow);
  int64_t rest = i / ow;
  int r = static_cast<int>(rest % oh);
  int ch = static_cast<int>(rest / oh);
  const float* top = src + (static_cast<int64_t>(ch) * h + 2 * r) * w + 2 * j;
  const float* bot = top + w;
  float v0 = __fadd_rn(__fmul_rn(0.5f, top[0]), __fmul_rn(0.5f, bot[0]));
  float v1 = __fadd_rn(__fmul_rn(0.5f, top[1]), __fmul_rn(0.5f, bot[1]));
  dst[i] = __fadd_rn(__fmul_rn(0.5f, v0), __fmul_rn(0.5f, v1));
}

}  // namespace

extern "C" int tpufg_box2(const void* src, void* dst, int c, int h, int w,
                          int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t n = static_cast<int64_t>(c) * (h / 2) * (w / 2);
  constexpr int kThreads = 256;
  unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  box2_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), c, h, w);
  return static_cast<int>(cudaGetLastError());
}
