// Separable Lanczos resample of a planar frame stack, float output.
//
// Replaces tpufg/kernels/lanczos.py:_scale_kernel (the Pallas kernel behind
// lanczos_scale_fast): planar [C, H, W] f32 or bf16, any C -> [C, oh, ow]
// in the input's type, each channel the Lanczos-a resample with per-axis
// renormalised weights.
//
// Per output pixel and channel the value is the tap sum of
// lanczos_stencil.cuh (the plain torch version's order and roundings, in
// f32 whatever the input type: a bf16 input widens exactly), stored as f32
// or rounded once to bf16 (__float2bfloat16_rn, round to nearest even, as
// the plain version's final cast), so the kernel is bitwise equal to
// tpufg_torch/kernels/lanczos.py::lanczos_scale_fast_plain.  The TPU
// kernel's banded MXU products, its bf16 split-dot and the +-1/2 centring
// it takes for compute_dtype=bf16 feed the TPU's matrix unit and are not
// carried over.
//
// Bound on the H100: device memory.  Compulsory traffic is each input value
// read once and each output value written once (at [4,1080,1920] -> 4K in
// f32, 33 MB in and 133 MB out); the direct stencil's taps^2 = 36 loads per
// output value hit L1/L2, since a warp's 32 neighbouring output columns
// read a few neighbouring cache lines of the same input rows.  Design: one
// thread per output pixel looping over the channels, 32x8 threads per
// block, consecutive threads on consecutive output columns so every store
// is coalesced; the pixel's tap tables are read once into registers and
// serve every channel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanczos_stencil.cuh"

namespace {

using tpufg_lanczos::load_taps;
using tpufg_lanczos::tap_sum;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int TAPS, typename T>
__global__ void lanczos_planar_kernel(
    const T* __restrict__ img, const int32_t* __restrict__ idx_y,
    const float* __restrict__ w_y, const int32_t* __restrict__ idx_x,
    const float* __restrict__ w_x, T* __restrict__ out, int n_ch, int ih,
    int iw, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;

  int xi[TAPS], yi[TAPS];
  float xw[TAPS], yw[TAPS];
  load_taps<TAPS>(idx_x, w_x, ox, xi, xw);
  load_taps<TAPS>(idx_y, w_y, oy, yi, yw);

  const int64_t in_plane = static_cast<int64_t>(ih) * iw;
  const int64_t out_plane = static_cast<int64_t>(oh) * ow;
  const int64_t o = static_cast<int64_t>(oy) * ow + ox;
  for (int c = 0; c < n_ch; ++c) {
    store(out + c * out_plane + o,
          tap_sum<TAPS>(img + c * in_plane, iw, yi, yw, xi, xw));
  }
}

template <int TAPS, typename T>
void launch(const void* img, const void* idx_y, const void* w_y,
            const void* idx_x, const void* w_x, void* out, int n_ch, int ih,
            int iw, int oh, int ow, cudaStream_t stream) {
  const dim3 threads(32, 8);
  const dim3 blocks((ow + threads.x - 1) / threads.x,
                    (oh + threads.y - 1) / threads.y);
  lanczos_planar_kernel<TAPS, T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const int32_t*>(idx_y),
      static_cast<const float*>(w_y), static_cast<const int32_t*>(idx_x),
      static_cast<const float*>(w_x), static_cast<T*>(out), n_ch, ih, iw, oh,
      ow);
}

template <typename T>
int dispatch(int taps, const void* img, const void* idx_y, const void* w_y,
             const void* idx_x, const void* w_x, void* out, int n_ch, int ih,
             int iw, int oh, int ow, cudaStream_t stream) {
  switch (taps) {
    case 2: launch<2, T>(img, idx_y, w_y, idx_x, w_x, out, n_ch, ih, iw, oh, ow, stream); break;
    case 4: launch<4, T>(img, idx_y, w_y, idx_x, w_x, out, n_ch, ih, iw, oh, ow, stream); break;
    case 6: launch<6, T>(img, idx_y, w_y, idx_x, w_x, out, n_ch, ih, iw, oh, ow, stream); break;
    case 8: launch<8, T>(img, idx_y, w_y, idx_x, w_x, out, n_ch, ih, iw, oh, ow, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img and out are [n_ch, ih, iw] and [n_ch, oh, ow], both f32 (bf16 == 0)
// or both bf16 (bf16 == 1).
extern "C" int tpufg_lanczos_planar(const void* img, const void* idx_y,
                                    const void* w_y, const void* idx_x,
                                    const void* w_x, void* out, int n_ch,
                                    int ih, int iw, int oh, int ow, int taps,
                                    int bf16, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    return dispatch<__nv_bfloat16>(taps, img, idx_y, w_y, idx_x, w_x, out,
                                   n_ch, ih, iw, oh, ow, stream);
  }
  return dispatch<float>(taps, img, idx_y, w_y, idx_x, w_x, out, n_ch, ih,
                         iw, oh, ow, stream);
}
