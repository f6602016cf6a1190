// Separable Lanczos resample of a planar frame stack, float output.
//
// Replaces tpufg/kernels/lanczos.py:_scale_kernel (the Pallas kernel behind
// lanczos_scale_fast): planar [C, H, W] f32 or bf16, any C -> [C, oh, ow]
// in the input's type, each channel the Lanczos-a resample with per-axis
// renormalised weights.
//
// Per output pixel and channel the value is formed with the operations of
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
// f32, 33 MB in and 133 MB out, 0.050 ms at 3.35 TB/s); whatever a design
// spends beyond that is arithmetic and load instructions.  The direct
// stencil recomputes every horizontal tap sum for each output row that uses
// it (taps^2 = 36 loads and ~110 operations per channel and output pixel)
// and needs 168 registers: 16 times the bound.
// Design: the separable tile walk of lanczos_stencil.cuh, as in
// lanczos_packed.cu, with a store per channel as its epilogue.  A block of
// 128 threads stages the input rows and columns its tile of 128 columns x
// `tile_rows` rows touches, for NCH channels, into shared memory (16-byte
// loads in f32, 8-byte loads of four values in bf16), each thread walks
// down one output column, forms each horizontal sum once and keeps the last
// `taps` of them per channel in registers.  A warp's 32 threads own 32
// neighbouring columns, so each channel's store is one 128-byte segment (64
// bytes in bf16).  NCH is compile-time (the ring lives in registers), so
// the channels are walked in groups: blockIdx.z names a group of NCH
// channels, and the host launches the full groups and then the remainder
// with its own NCH (lanczos.py:channel_groups).  Tile sizes come from
// lanczos.py:lanczos_plan for the group's channel count; where no tile fits
// in shared memory or staging would read more than the direct stencil (a
// downscale by 4 and more) the plan picks the direct stencil, one thread
// per output pixel looping over the channels, instead.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lanczos_stencil.cuh"

namespace {

using tpufg_lanczos::load_taps;
using tpufg_lanczos::separable_tile;
using tpufg_lanczos::tap_sum;

// output columns (= threads) of a tile, as in lanczos_packed.cu
#ifndef LANCZOS_TILE_W
#define LANCZOS_TILE_W 128
#endif
constexpr int kTileW = LANCZOS_TILE_W;
constexpr int kMaxGroup = 4;  // channels a block walks together at most

// 1: the output leaves with streaming stores (st.global.cs; nothing here
// reads it again, and an upscale's output is 4 times its input);
// overridable so that tools/torch_kernel_variants.py can time plain stores
#ifndef PLANAR_STORE_CS
#define PLANAR_STORE_CS 1
#endif

__device__ __forceinline__ void store(float* p, float v) {
#if PLANAR_STORE_CS
  __stcs(p, v);
#else
  *p = v;
#endif
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
#if PLANAR_STORE_CS
  __stcs(p, __float2bfloat16_rn(v));
#else
  *p = __float2bfloat16_rn(v);
#endif
}

// The direct stencil: one thread per output pixel, every channel in turn.
template <int TAPS, typename T>
__global__ void lanczos_planar_direct_kernel(
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

// The separable tile walk over the NCH channels of group blockIdx.z, with
// the store-per-channel epilogue.
template <int TAPS, int NCH, typename T>
__global__ void __launch_bounds__(kTileW)
lanczos_planar_tile_kernel(
    const T* __restrict__ img, const int32_t* __restrict__ start_y,
    const float* __restrict__ w_y, const int32_t* __restrict__ start_x,
    const float* __restrict__ w_x, T* __restrict__ out, int ih, int iw,
    int oh, int ow, int tile_rows, int rows_cap, int cols_cap, bool vec) {
  extern __shared__ float4 smem4[];
  const int64_t out_plane = static_cast<int64_t>(oh) * ow;
  const T* src = img + blockIdx.z * NCH * (static_cast<int64_t>(ih) * iw);
  T* dst = out + blockIdx.z * NCH * out_plane;
  separable_tile<TAPS, NCH, kTileW>(
      src, ih, iw, start_y, w_y, start_x, w_x, oh, ow, tile_rows, rows_cap,
      cols_cap, vec, reinterpret_cast<float*>(smem4),
      [dst, ow, out_plane](int oy, int ox, const float (&v)[NCH]) {
        T* p = dst + static_cast<int64_t>(oy) * ow + ox;
#pragma unroll
        for (int c = 0; c < NCH; ++c) store(p + c * out_plane, v[c]);
      });
}

struct Args {
  const void* img;
  const int32_t *idx_y, *idx_x, *start_y, *start_x;
  const float *w_y, *w_x;
  void* out;
  int groups, nch, ih, iw, oh, ow, tile_rows, rows_cap, cols_cap, smem;
};

// with_tile calls f(Tile<taps, nch, T>()): Tile::kernel() is that
// instantiation of the tile kernel
template <int TAPS, int NCH, typename T>
struct Tile {
  static auto kernel() { return &lanczos_planar_tile_kernel<TAPS, NCH, T>; }
};

template <int TAPS, typename T, typename F>
int with_nch(int nch, F f) {
  switch (nch) {
    case 1: return f(Tile<TAPS, 1, T>());
    case 2: return f(Tile<TAPS, 2, T>());
    case 3: return f(Tile<TAPS, 3, T>());
    case 4: return f(Tile<TAPS, 4, T>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename F>
int with_tile(int taps, int nch, F f) {
  switch (taps) {
    case 2: return with_nch<2, T>(nch, f);
    case 4: return with_nch<4, T>(nch, f);
    case 6: return with_nch<6, T>(nch, f);
    case 8: return with_nch<8, T>(nch, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int TAPS, typename T>
int launch_direct(const Args& a, cudaStream_t stream) {
  const dim3 threads(32, 8);
  const dim3 blocks((a.ow + threads.x - 1) / threads.x,
                    (a.oh + threads.y - 1) / threads.y);
  lanczos_planar_direct_kernel<TAPS, T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(a.img), a.idx_y, a.w_y, a.idx_x, a.w_x,
      static_cast<T*>(a.out), a.groups * a.nch, a.ih, a.iw, a.oh, a.ow);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int taps, cudaStream_t stream) {
  if (a.tile_rows == 0) {
    switch (taps) {
      case 2: return launch_direct<2, T>(a, stream);
      case 4: return launch_direct<4, T>(a, stream);
      case 6: return launch_direct<6, T>(a, stream);
      case 8: return launch_direct<8, T>(a, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return with_tile<T>(taps, a.nch, [&](auto tile) {
    const auto kernel = decltype(tile)::kernel();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 blocks((a.ow + kTileW - 1) / kTileW,
                      (a.oh + a.tile_rows - 1) / a.tile_rows, a.groups);
    // quads of four values move as one load: 16 bytes in f32, 8 in bf16
    const bool vec = a.iw % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.img) % (4 * sizeof(T)) == 0;
    kernel<<<blocks, kTileW, a.smem, stream>>>(
        static_cast<const T*>(a.img), a.start_y, a.w_y, a.start_x, a.w_x,
        static_cast<T*>(a.out), a.ih, a.iw, a.oh, a.ow, a.tile_rows,
        a.rows_cap, a.cols_cap, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// img and out are [groups * nch, ih, iw] and [groups * nch, oh, ow], both
// f32 (bf16 == 0) or both bf16 (bf16 == 1): `groups` groups of `nch`
// channels (1 <= nch <= 4) walked by one block each.  tile_w must be the
// tile width compiled in.  tile_rows, rows_cap, cols_cap and smem (dynamic
// shared memory in bytes, for nch channels) from tpufg_torch/kernels/
// lanczos.py:lanczos_plan; tile_rows == 0 runs the direct stencil over all
// groups * nch channels, which reads idx_y / idx_x; the tile walk reads
// start_y / start_x instead.
extern "C" int tpufg_lanczos_planar(
    const void* img, const void* idx_y, const void* w_y, const void* idx_x,
    const void* w_x, const void* start_y, const void* start_x, void* out,
    int groups, int nch, int ih, int iw, int oh, int ow, int taps, int bf16,
    int tile_w, int tile_rows, int rows_cap, int cols_cap, int smem,
    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 1 || groups > 65535 || nch < 1 || tile_rows < 0 ||
      (tile_rows > 0 &&
       (nch > kMaxGroup || tile_w != kTileW || cols_cap % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {img,
                  static_cast<const int32_t*>(idx_y),
                  static_cast<const int32_t*>(idx_x),
                  static_cast<const int32_t*>(start_y),
                  static_cast<const int32_t*>(start_x),
                  static_cast<const float*>(w_y),
                  static_cast<const float*>(w_x),
                  out,
                  groups, nch, ih, iw, oh, ow, tile_rows, rows_cap, cols_cap,
                  smem};
  return bf16 ? launch<__nv_bfloat16>(a, taps, stream)
              : launch<float>(a, taps, stream);
}

// Blocks of the tile walk over `nch` channels that fit on one SM with
// `smem` bytes each (the occupancy calculator's answer for the current
// device), or -1.
extern "C" int tpufg_lanczos_planar_blocks_per_sm(int taps, int nch, int bf16,
                                                  int smem) {
  int n = -1;
  auto ask = [&](auto tile) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decltype(tile)::kernel(), kTileW, smem));
  };
  const int rc = bf16 ? with_tile<__nv_bfloat16>(taps, nch, ask)
                      : with_tile<float>(taps, nch, ask);
  return rc == 0 ? n : -1;
}
