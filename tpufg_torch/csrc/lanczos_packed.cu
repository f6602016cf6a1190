// Separable Lanczos resample fused with UNORM8 quantize and RGBA pack.
//
// Replaces tpufg/kernels/lanczos.py:_scale_packed_kernel (the Pallas kernel
// behind lanczos_scale_packed): planar f32 [4, H, W] -> int32 [oh, ow] whose
// byte c is round_half_even(clamp(v_c, 0, 1) * 255), v_c the Lanczos-a
// resample of channel c with per-axis renormalised weights.
//
// Per output pixel this kernel forms each channel's tap sum with the stencil
// of lanczos_stencil.cuh (the plain torch version's order and roundings),
// then quantizes and packs the four channels.  The TPU kernel's banded MXU
// products, bf16 split-dot and +-1/2 centring are workarounds for the TPU's
// matrix unit and are not carried over: everything here is f32.
//
// Bound on the H100: memory traffic through L1/L2.  Compulsory DRAM traffic
// is small (16 B per input pixel in, 4 B per output pixel out), but the
// direct stencil issues taps^2 = 36 loads per channel per output pixel,
// which the cache has to absorb.  Design: one thread per output pixel and
// all four channels, 32x8 threads per block, consecutive threads on
// consecutive output columns, so a warp's taps hit a few neighbouring cache
// lines of the same input rows; tap tables are read once per thread into
// registers (TAPS is a template parameter so the arrays stay in registers).
// The quantized codes leave as one packed int32 store per pixel, so the f32
// resample never reaches device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanczos_stencil.cuh"

namespace {

using tpufg_lanczos::load_taps;
using tpufg_lanczos::tap_sum;

template <int TAPS>
__global__ void lanczos_packed_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ idx_y,
    const float* __restrict__ w_y, const int32_t* __restrict__ idx_x,
    const float* __restrict__ w_x, int32_t* __restrict__ out, int ih, int iw,
    int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;

  int xi[TAPS], yi[TAPS];
  float xw[TAPS], yw[TAPS];
  load_taps<TAPS>(idx_x, w_x, ox, xi, xw);
  load_taps<TAPS>(idx_y, w_y, oy, yi, yw);

  const int64_t plane = static_cast<int64_t>(ih) * iw;
  uint32_t packed = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = tap_sum<TAPS>(img + c * plane, iw, yi, yw, xi, xw);
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    // pack through uint32 so the alpha byte's << 24 cannot overflow an int
    const uint32_t q = static_cast<uint32_t>(rintf(__fmul_rn(v, 255.0f)));
    packed |= q << (8 * c);
  }
  out[static_cast<int64_t>(oy) * ow + ox] = static_cast<int32_t>(packed);
}

template <int TAPS>
void launch(const void* img, const void* idx_y, const void* w_y,
            const void* idx_x, const void* w_x, void* out, int ih, int iw,
            int oh, int ow, cudaStream_t stream) {
  const dim3 threads(32, 8);
  const dim3 blocks((ow + threads.x - 1) / threads.x,
                    (oh + threads.y - 1) / threads.y);
  lanczos_packed_kernel<TAPS><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(img), static_cast<const int32_t*>(idx_y),
      static_cast<const float*>(w_y), static_cast<const int32_t*>(idx_x),
      static_cast<const float*>(w_x), static_cast<int32_t*>(out), ih, iw, oh,
      ow);
}

}  // namespace

extern "C" int tpufg_lanczos_packed(const void* img, const void* idx_y,
                                    const void* w_y, const void* idx_x,
                                    const void* w_x, void* out, int ih, int iw,
                                    int oh, int ow, int taps, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (taps) {
    case 2: launch<2>(img, idx_y, w_y, idx_x, w_x, out, ih, iw, oh, ow, stream); break;
    case 4: launch<4>(img, idx_y, w_y, idx_x, w_x, out, ih, iw, oh, ow, stream); break;
    case 6: launch<6>(img, idx_y, w_y, idx_x, w_x, out, ih, iw, oh, ow, stream); break;
    case 8: launch<8>(img, idx_y, w_y, idx_x, w_x, out, ih, iw, oh, ow, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
