// Separable Lanczos resample fused with UNORM8 quantize and RGBA pack.
//
// Replaces tpufg/kernels/lanczos.py:_scale_packed_kernel (the Pallas kernel
// behind lanczos_scale_packed): planar f32 [4, H, W] -> int32 [oh, ow] whose
// byte c is round_half_even(clamp(v_c, 0, 1) * 255), v_c the Lanczos-a
// resample of channel c with per-axis renormalised weights.
//
// Each channel's value is formed with the operations of
// lanczos_stencil.cuh (the plain torch version's order and roundings), then
// quantized and packed.  The TPU kernel's banded MXU products, bf16
// split-dot and +-1/2 centring are workarounds for the TPU's matrix unit and
// are not carried over: everything here is f32.
//
// Bound on the H100: compulsory DRAM traffic is small (16 B per input pixel
// in, 4 B per output pixel out), so what a design spends is arithmetic
// and load issue.  The direct stencil recomputes every horizontal tap sum
// for each output row that uses it (taps^2 = 36 loads and ~110 operations
// per channel and output pixel; at 1080p -> 4K each sum about 12 times).
// Design: the separable tile walk of lanczos_stencil.cuh.  A block of 128
// threads stages the input rows and columns its tile of 128 columns x
// `tile_rows` rows touches into shared memory with coalesced loads, each
// thread walks down one output column, forms each horizontal sum once from
// shared memory and keeps the last `taps` of them per channel in registers,
// and emits an output row when its last tap arrives: about a sixth of the
// direct stencil's operations at 2x, and no gather from device memory.
// The quantized codes leave as one packed int32 store per pixel, so the f32
// resample never reaches device memory.  Tile sizes and the shared-memory
// bytes come from the host (lanczos.py:lanczos_plan), derived from the tap
// tables for any ratio; where no tile fits in shared memory (a strong
// downscale: the 128 columns of a tile spread over too many input columns)
// the plan picks the direct stencil, one thread per output pixel, instead.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanczos_stencil.cuh"

namespace {

using tpufg_lanczos::load_taps;
using tpufg_lanczos::separable_tile;
using tpufg_lanczos::tap_sum;

// output columns (= threads) of a tile; overridable so that
// tools/torch_kernel_variants.py can time other widths
#ifndef LANCZOS_TILE_W
#define LANCZOS_TILE_W 128
#endif
constexpr int kTileW = LANCZOS_TILE_W;

// UNORM8 codes of four channel values in one int32, channel c in byte c
__device__ __forceinline__ int32_t pack_unorm8(const float (&v)[4]) {
  uint32_t packed = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float u = fminf(fmaxf(v[c], 0.0f), 1.0f);
    // pack through uint32 so the alpha byte's << 24 cannot overflow an int
    const uint32_t q = static_cast<uint32_t>(rintf(__fmul_rn(u, 255.0f)));
    packed |= q << (8 * c);
  }
  return static_cast<int32_t>(packed);
}

// The direct stencil: one thread per output pixel.
template <int TAPS>
__global__ void lanczos_packed_direct_kernel(
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
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = tap_sum<TAPS>(img + c * plane, iw, yi, yw, xi, xw);
  }
  out[static_cast<int64_t>(oy) * ow + ox] = pack_unorm8(v);
}

// The separable tile walk with the quantize-and-pack epilogue.
template <int TAPS>
__global__ void __launch_bounds__(kTileW)
lanczos_packed_tile_kernel(
    const float* __restrict__ img, const int32_t* __restrict__ start_y,
    const float* __restrict__ w_y, const int32_t* __restrict__ start_x,
    const float* __restrict__ w_x, int32_t* __restrict__ out, int ih, int iw,
    int oh, int ow, int tile_rows, int rows_cap, int cols_cap, bool vec) {
  extern __shared__ float4 smem4[];
  separable_tile<TAPS, 4, kTileW>(
      img, ih, iw, start_y, w_y, start_x, w_x, oh, ow, tile_rows, rows_cap,
      cols_cap, vec, reinterpret_cast<float*>(smem4),
      [out, ow](int oy, int ox, const float (&v)[4]) {
        out[static_cast<int64_t>(oy) * ow + ox] = pack_unorm8(v);
      });
}

struct Args {
  const float* img;
  const int32_t *idx_y, *idx_x, *start_y, *start_x;
  const float *w_y, *w_x;
  int32_t* out;
  int ih, iw, oh, ow, tile_rows, rows_cap, cols_cap, smem;
};

template <int TAPS>
int launch(const Args& a, cudaStream_t stream) {
  if (a.tile_rows == 0) {
    const dim3 threads(32, 8);
    const dim3 blocks((a.ow + threads.x - 1) / threads.x,
                      (a.oh + threads.y - 1) / threads.y);
    lanczos_packed_direct_kernel<TAPS><<<blocks, threads, 0, stream>>>(
        a.img, a.idx_y, a.w_y, a.idx_x, a.w_x, a.out, a.ih, a.iw, a.oh, a.ow);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      lanczos_packed_tile_kernel<TAPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((a.ow + kTileW - 1) / kTileW,
                    (a.oh + a.tile_rows - 1) / a.tile_rows);
  const bool vec = a.iw % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.img) % 16 == 0;
  lanczos_packed_tile_kernel<TAPS><<<blocks, kTileW, a.smem, stream>>>(
      a.img, a.start_y, a.w_y, a.start_x, a.w_x, a.out, a.ih, a.iw, a.oh,
      a.ow, a.tile_rows, a.rows_cap, a.cols_cap, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_w must be the tile width compiled in.  tile_rows, rows_cap, cols_cap
// and smem (dynamic shared memory in bytes) from tpufg_torch/kernels/
// lanczos.py:lanczos_plan; tile_rows == 0 runs the direct stencil, which
// reads idx_y / idx_x; the tile walk reads start_y / start_x instead.
extern "C" int tpufg_lanczos_packed(
    const void* img, const void* idx_y, const void* w_y, const void* idx_x,
    const void* w_x, const void* start_y, const void* start_x, void* out,
    int ih, int iw, int oh, int ow, int taps, int tile_w, int tile_rows,
    int rows_cap, int cols_cap, int smem, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_rows < 0 || (tile_rows > 0 && (tile_w != kTileW || cols_cap % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {static_cast<const float*>(img),
                  static_cast<const int32_t*>(idx_y),
                  static_cast<const int32_t*>(idx_x),
                  static_cast<const int32_t*>(start_y),
                  static_cast<const int32_t*>(start_x),
                  static_cast<const float*>(w_y),
                  static_cast<const float*>(w_x),
                  static_cast<int32_t*>(out),
                  ih, iw, oh, ow, tile_rows, rows_cap, cols_cap, smem};
  switch (taps) {
    case 2: return launch<2>(a, stream);
    case 4: return launch<4>(a, stream);
    case 6: return launch<6>(a, stream);
    case 8: return launch<8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the tile walk that fit on one SM with `smem` bytes each (the
// occupancy calculator's answer for the current device), or -1.
extern "C" int tpufg_lanczos_packed_blocks_per_sm(int taps, int smem) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (taps) {
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lanczos_packed_tile_kernel<2>, kTileW, smem);
      break;
    case 4:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lanczos_packed_tile_kernel<4>, kTileW, smem);
      break;
    case 6:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lanczos_packed_tile_kernel<6>, kTileW, smem);
      break;
    case 8:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, lanczos_packed_tile_kernel<8>, kTileW, smem);
      break;
  }
  return err == cudaSuccess ? n : -1;
}
