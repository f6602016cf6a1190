// Planes of f32 -> one channels-last bf16 tensor, the channels past them
// zero: the input of one of the IFNet's convs (tpufg_torch/models/ifnet.py)
// built in one pass.
//
// Or the planes space-to-depth by 2 behind a zero row and column: the
// input of a stride-2 conv rewritten as a 2x2 one (models/ifnet.py).
//
// PyTorch builds such an input as a concatenation, a conversion to bf16
// channels-last, and (for a channel count that 8 does not divide) cuDNN's
// own padding pass; written channel slice by channel slice into a
// channels-last buffer it is a strided scalar copy a slice.  Here a thread
// takes one pixel and 8 of its channels: it reads each channel's value from
// its plane (the threads of a channel group on consecutive columns, so each
// plane's read is coalesced), rounds to bf16 (round to nearest even, as
// PyTorch converts) and writes the 8 as one 16-byte store.
//
// Bound on the H100: memory: 4 bytes a plane read and 2 bytes a channel
// written, for each pixel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 32;
constexpr int kThreads = 256;

struct Planes {
  const float* ptr[kMaxChannels];  // channel k's [0, 0]
  int64_t row[kMaxChannels];       // its row stride in elements
};

// a thread per (pixel, 8 channels): consecutive threads on a pixel's
// consecutive 16-byte channel groups, so the stores are coalesced
__global__ void pack_nhwc_kernel(Planes planes, int n_planes, int channels,
                                 int s2d, __nv_bfloat16* __restrict__ out,
                                 int h, int w) {
  const int groups = channels / 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(h) * w * groups) return;
  const int64_t p = t / groups;
  const int g = static_cast<int>(t % groups) * 8;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p % w);
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ch = g + k;
    float v = 0.f;
    if (!s2d) {
      if (ch < n_planes) v = planes.ptr[ch][y * planes.row[ch] + x];
    } else {
      // channel (phase, plane), phase = 2 row parity + column parity;
      // output row and column 0 are the zero pad
      const int phase = ch / n_planes, c = ch % n_planes;
      if (phase < 4 && y > 0 && x > 0) {
        v = planes.ptr[c][(2 * (y - 1) + phase / 2) * planes.row[c] +
                          2 * (x - 1) + phase % 2];
      }
    }
    e[k] = __float2bfloat16_rn(v);
  }
  *reinterpret_cast<uint4*>(out + p * channels + g) = raw;
}

}  // namespace

// (the planes' pointers [n_planes] and row strides [n_planes] as host
//  arrays, n_planes, s2d, out bf16 channels-last [1, channels, h, w]
//  (channels a multiple of 8, at most 32), channels, h, w, device, stream).
//  s2d: the planes space-to-depth by 2 (channel phase * n_planes + plane,
//  phase = 2 row parity + column parity) behind a zero row and column, so
//  out is [1, channels, H / 2 + 1, W / 2 + 1] of planes [H, W].
extern "C" int tpufg_pack_nhwc(const int64_t* ptrs, const int64_t* rows,
                               int n_planes, int s2d, void* out, int channels,
                               int h, int w, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (channels % 8 != 0 || channels > kMaxChannels || n_planes < 1 ||
      (s2d ? 4 * n_planes : n_planes) > channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes{};
  for (int k = 0; k < n_planes; ++k) {
    planes.ptr[k] = reinterpret_cast<const float*>(ptrs[k]);
    planes.row[k] = rows[k];
  }
  const int64_t n = static_cast<int64_t>(h) * w * (channels / 8);
  pack_nhwc_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(
      planes, n_planes, channels, s2d, static_cast<__nv_bfloat16*>(out), h,
      w);
  return static_cast<int>(cudaGetLastError());
}
