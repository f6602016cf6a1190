// Per-channel bias add and PReLU of a channels-last bf16 tensor, in place
// or into channel slices of wider ones.
//
// The IFNet's convs (tpufg_torch/models/ifnet.py) run on cuDNN without
// their bias; PyTorch would add the bias in one elementwise pass and PReLU
// in another, each reading and writing the whole bf16 output.  This kernel
// does both in one pass: y[p, c] = q(prelu(q(y[p, c] + b[c]), a[c])), q the
// round to bf16, every operation in f32 on bf16 operands (the sum of two
// bf16 values rounded once, the slope's product exact in f32), so it is
// bitwise the two PyTorch passes it replaces and the plain version
// (kernels/prelu.py::bias_prelu_plain).
//
// Bound on the H100: memory.  Each element reads and writes 2 bytes; the
// C biases and slopes are staged in shared memory once a block.  Design:
// channels-last rows of C channels, C a multiple of 8, so a thread takes
// 16-byte loads and stores of 8 consecutive channels (one thread each,
// grid-stride); the network's channel counts are all padded to multiples
// of 8 (models/ifnet.py).  The result may go, instead
// of back into y, into a channel slice of one or two wider channels-last
// tensors (the U-Net's concatenations: the next level's input and the skip
// of the way up), so that no concatenation copies it again.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ float apply(float y, float b, float a) {
  float x = __bfloat162float(__float2bfloat16_rn(y + b));
  return x > 0.0f ? x : a * x;
}

// y is read at p * c + ch; the result goes to out (p * os + ch) and, where
// given, out2 (p * os2 + ch): in place when out is y
__global__ void bias_prelu_vec8(const __nv_bfloat16* y,
                                const __nv_bfloat16* __restrict__ bias,
                                const __nv_bfloat16* __restrict__ slope,
                                int64_t n_vec, int c, __nv_bfloat16* out,
                                int64_t os, __nv_bfloat16* out2,
                                int64_t os2) {
  __shared__ float sb[kMaxChannels], sa[kMaxChannels];
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    sb[i] = __bfloat162float(bias[i]);
    sa[i] = __bfloat162float(slope[i]);
  }
  __syncthreads();
  const int groups = c / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_vec; i += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(y)[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
    const int64_t p = i / groups;
    const int c0 = static_cast<int>(i % groups) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      e[k] = __float2bfloat16_rn(
          apply(__bfloat162float(e[k]), sb[c0 + k], sa[c0 + k]));
    }
    *reinterpret_cast<uint4*>(out + p * os + c0) = raw;
    if (out2 != nullptr) *reinterpret_cast<uint4*>(out2 + p * os2 + c0) = raw;
  }
}

}  // namespace

// (y bf16 [n / c, c] channels-last; bias bf16 [c]; slope bf16 [c]; n
//  elements, c channels (a multiple of 8, at most 1024); out and its pixel
//  stride (null: in place); out2 and its pixel stride (null: none); device,
//  stream).  Every pointer and pixel stride 16-byte aligned.
extern "C" int tpufg_bias_prelu(void* y, const void* bias, const void* slope,
                                int64_t n, int c, void* out, int64_t os,
                                void* out2, int64_t os2, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c <= 0 || c > kMaxChannels || n % c != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (c % 8 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const int64_t work = n / 8;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  bias_prelu_vec8<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      yp, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(slope), work, c,
      out != nullptr ? static_cast<__nv_bfloat16*>(out) : yp,
      out != nullptr ? os : c, static_cast<__nv_bfloat16*>(out2), os2);
  return static_cast<int>(cudaGetLastError());
}
