// Packed RGBA wire -> planar f32 unpack.
//
// Replaces tpufg/kernels/convert.py:_unpack_kernel (the Pallas kernel behind
// frames_to_planar): an int32 [H, W] frame whose byte c is channel c becomes
// four f32 planes [4, H, W] holding byte * fl(1/255).
//
// Bound on the H100: memory.  Each pixel reads 4 bytes and writes 16, with
// one shift, mask, convert and multiply per channel.  Design: one thread per
// pixel, consecutive threads on consecutive pixels, so the int32 read and
// each plane's f32 write are fully coalesced; no shared memory is needed.
//
// The scale is a correctly rounded multiply by the f32 reciprocal of 255
// (__fmul_rn), as in the TPU kernel and in what XLA compiles tpufg's
// `x / 255` into; a true divide differs in the last bit for 126 of the 256
// codes.  The plain torch version multiplies the same way, so the two are
// bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kInv255 = 1.0f / 255.0f;  // fl(1/255), folded in f32

__global__ void unpack_kernel(const int32_t* __restrict__ src,
                              float* __restrict__ dst, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t q = static_cast<uint32_t>(src[i]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = static_cast<float>((q >> (8 * c)) & 0xFFu);
    dst[c * n + i] = __fmul_rn(v, kInv255);
  }
}

}  // namespace

extern "C" int tpufg_unpack(const void* src, void* dst, int h, int w,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t n = static_cast<int64_t>(h) * w;
  constexpr int kThreads = 256;
  unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  unpack_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(src), static_cast<float*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

// Shared by every wrapper to turn a launcher's return code into a message.
extern "C" const char* tpufg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
