// A chain of SAME-padded 3x3 stride-1 convolutions in bf16, fused in one
// launch, each layer an implicit GEMM on the tensor cores.
//
// Replaces tpufg/kernels/conv.py:_chain_kernel (the Pallas kernel behind
// conv3x3_chain) for compute_dtype = bfloat16; the f32 chain stays on the
// CUDA cores (conv_chain.cu), since the tensor cores have no f32 product.
// The learned head's stage 2 runs it as r_in -> relu -> r_body -> relu ->
// r_head on the quarter-resolution features: [17 (or 13), H, W] -> 64 -> 64
// -> [5, H, W], f32 in and out.  Layer i computes
//   a_{i+1}[co][y][x] = b_i[co] + sum_{dy,dx,ci} w_i[co][ci][dy][dx] *
//                                       a_i[ci][y + dy - 1][x + dx - 1]
// with a_i read as 0 outside the image, then the relu where asked.  Both
// operands are bf16 values (the wrapper rounds the weights, this kernel the
// input and every intermediate), a bf16 x bf16 product is exact in f32 and
// the sums are f32, so the tensor cores compute the function of the plain
// version up to the order of the f32 sums.  After the sum: the bias, the
// relu, the zero outside the image, the rounding to bf16, in that order.
//
// Bound on the H100: arithmetic (about 25 G multiply-adds per frame pair
// against ~55 MB moved, some 900 flops per byte), so the products belong on
// the bf16 tensor cores (989 TFLOP/s against 67 on the CUDA cores) and the
// two 64-channel intermediates stay in shared memory.
//
// Design.
// - The instruction: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//   M = the pixels of a layer's output region in the tile, N = the output
//   channels, K = 9 taps x the input channels.  A comes from shared memory
//   through ldmatrix.x4; B is read as plain 16-byte shared loads, because
//   the wrapper stores the weights in the fragment order of the B operand
//   ([tap][k16 chunk][n8-tile pair][lane][2 tiles][2 registers] of bf16
//   pairs; tpufg_torch/kernels/conv.py:pack_chain_weights_bf16).
// - Activations are channels-last in shared memory, [pixel][Cpad] bf16,
//   Cpad a power of two >= 16 (17 -> 32, 13 -> 16, 5 -> 8 for the last
//   layer's N), padded channels and padded weights zero.  Every buffer of a
//   tile uses one row pitch P = tile cols + 2 * layers, so pixel (R, C) of
//   the tile is index R * P + C in every layer and a tap (dy, dx) is the
//   constant offset (dy - 1) * P + (dx - 1) on every ldmatrix row address:
//   a layer is one GEMM over a contiguous range of M, no division per row.
//   The two columns per row where that range wraps are computed and never
//   read by a valid output (~6% more work).
// - Bank conflicts: a 64-channel pixel is 128 bytes, so the eight rows of an
//   ldmatrix would hit the same banks.  The 16-byte chunks of a pixel are
//   XOR-swizzled by the pixel index (chunk ^ (pixel / pixels-per-128-bytes)),
//   which makes eight consecutive pixels conflict-free for ldmatrix and for
//   the epilogue's stores; no padding, the budget has no room for it.
// - The budget: an 8 x 32 output tile.  For 17 -> 64 -> 64 -> 5: P = 38,
//   input 14 x 38 x 32 ch = 34,048 bytes, layer 1 out 12 x 38 x 64 = 58,368,
//   layer 2 out 10 x 38 x 64 = 48,640 (in the input's buffer), 107,008 in
//   two buffers; all three layers' weights, 36,864 + 73,728 + 9,216 bytes,
//   stay resident: 226,816 of the 232,448 bytes a block may use.  The halo costs
//   1.69x / 1.33x the multiply-adds of layers 1 / 2 (a 16 x 32 tile would
//   cost 1.41x / 1.20x, but does not fit beside the weights).  The grid is
//   persistent, one block of 16 warps per SM walking over the tiles, so the
//   weights are loaded once per SM, not once per tile.
// - 16 warps.  A warp holds up to 2 m16 tiles x all N in registers (64 f32
//   at N = 64) and, per tap and k16 chunk, loads the B fragments once
//   (2 KB), two A fragments (1 KB) and issues 16 mma.  4 m16 tiles a warp
//   would halve the B traffic per mma, but at 255 registers only 8 warps
//   fit, and 16 warps with the heavier traffic were timed faster.  The m16
//   tiles of a layer are dealt evenly over the warps (2 each), and the tap
//   loop is unrolled by 3 so that the next tap's loads overlap this one's
//   mma.
// - The last layer pads N = 5 to 8, adds the bias and stores its 5 f32
//   planes to device memory, inside the image only.
// Not used: wgmma and TMA (the route to the full tensor-core rate).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// warps per block, m16 tiles a warp holds at once and taps unrolled together
// in a layer's loop; overridable so that tools/torch_kernel_variants.py can
// time other splits
#ifndef CHAIN_WARPS
#define CHAIN_WARPS 16
#endif
#ifndef CHAIN_MT
#define CHAIN_MT 2
#endif
#ifndef CHAIN_TAP_UNROLL
#define CHAIN_TAP_UNROLL 3
#endif

namespace {

constexpr int kWarps = CHAIN_WARPS;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 3;
constexpr int kMT = CHAIN_MT;
constexpr int kTapUnroll = CHAIN_TAP_UNROLL;

struct MmaChainArgs {
  const uint4* wpack;      // every layer's packed weights, layer after layer
  const float* bias;       // every layer's bias, padded with zeros to 8 * nt
  int c_out[kMaxLayers];   // true output channels
  int kc[kMaxLayers];      // k16 chunks of the layer's input (Cpad / 16)
  int nt[kMaxLayers];      // n8 tiles of the layer's output (Npad / 8)
  int w_off[kMaxLayers];   // byte offset of the layer's weights in wpack
  int b_off[kMaxLayers];   // offset of the layer's bias in `bias`
  int c_in, n_layers, relu_mask, h, w, th, tw;
  int buf1_off, w_smem_off, w_bytes;  // shared memory layout, bytes
  int tiles_x, n_tiles;
};

__host__ __device__ constexpr int pow2_at_least(int x, int lo) {
  int p = lo;
  while (p < x) p *= 2;
  return p;
}

// Byte offset of 16-byte chunk `chunk` of pixel `pix` in a channels-last
// buffer of CP chunks per pixel (CP = 2, 4 or 8), swizzled so that eight
// consecutive pixels' chunks of one index fall into eight different
// 16-byte bank groups.
template <int CP>
__device__ __forceinline__ int act_offset(int pix, int chunk) {
  constexpr int kShift = CP == 8 ? 0 : (CP == 4 ? 1 : 2);
  return pix * (CP * 16) + (((chunk ^ (pix >> kShift)) & (CP - 1)) << 4);
}

__device__ __forceinline__ int act_offset_rt(int cp, int pix, int chunk) {
  const int shift = cp == 8 ? 0 : (cp == 4 ? 1 : 2);
  return pix * (cp * 16) + (((chunk ^ (pix >> shift)) & (cp - 1)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TileGeom {
  int rows, pitch;  // tile rows and columns with the halo of L pixels
  int oy0, ox0;     // image position of the tile's first output pixel
  int halo;         // L
  int h, w;
};

// One layer (1-based index `layer`) as a GEMM over the contiguous pixel
// range of its output region.  `in_s` holds the previous activation from
// tile row layer - 1 on, KC k16 chunks per pixel; intermediate layers write
// bf16 to `out_s` (from tile row `layer` on, NT chunks per pixel), the last
// layer f32 planes to `out_g`.
template <int NT, int KC>
__device__ __forceinline__ void mma_layer(
    const unsigned char* in_s, const unsigned char* w_s,
    const float* __restrict__ bias, int c_out, bool relu,
    unsigned char* out_s, float* __restrict__ out_g, int layer,
    const TileGeom& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow = lane & 15, lhi = lane >> 4;  // ldmatrix row, k half
  const int grp = lane >> 2, tig = lane & 3;    // accumulator row, col pair
  const int P = g.pitch;
  const int lo = layer * P + layer;
  const int hi = (g.rows - 1 - layer) * P + (P - layer);
  const int n_mt = (hi - lo + 15) >> 4;
  const int rounds = (n_mt + kWarps * kMT - 1) / (kWarps * kMT);
  const int per = (n_mt + kWarps * rounds - 1) / (kWarps * rounds);
  const uint32_t in_base = static_cast<uint32_t>(
      __cvta_generic_to_shared(in_s));
  const int in_first = (layer - 1) * P;  // tile index of in_s's first pixel

  for (int round = 0; round < rounds; ++round) {
    const int mt0 = (round * kWarps + warp) * per;
    const int cnt = min(per, n_mt - mt0);
    if (cnt <= 0) continue;  // the same for the whole warp

    float acc[kMT][NT][4];
    int pixrow[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      // rows past the range re-read its last pixel; they are never stored
      pixrow[i] = min(lo + (mt0 + i) * 16 + lrow, hi - 1) - in_first;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.0f;
    }

#pragma unroll kTapUnroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3 - 1) * P + (tap % 3 - 1);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        // B fragments of every n8 tile for this tap and k16 chunk
        uint32_t b[NT][2];
        const unsigned char* wp = w_s + (tap * KC + kc) * NT * 256;
        if constexpr (NT == 1) {
          const uint2 v = reinterpret_cast<const uint2*>(wp)[lane];
          b[0][0] = v.x;
          b[0][1] = v.y;
        } else {
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            const uint4 v = reinterpret_cast<const uint4*>(wp)[j * 32 + lane];
            b[2 * j][0] = v.x;
            b[2 * j][1] = v.y;
            b[2 * j + 1][0] = v.z;
            b[2 * j + 1][1] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (i < cnt) {
            uint32_t a[4];
            ldmatrix_x4(a, in_base + act_offset<2 * KC>(pixrow[i] + toff,
                                                        kc * 2 + lhi));
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mma_bf16(acc[i][n], a, b[n][0], b[n][1]);
            }
          }
        }
      }
    }

    // epilogue: bias, relu, zero outside the image, then bf16 to shared
    // memory or f32 to device memory
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (i >= cnt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = lo + (mt0 + i) * 16 + grp + half * 8;
        if (m >= hi) continue;
        const int R = m / P;
        const int C = m - R * P;
        const int gy = g.oy0 - g.halo + R;
        const int gx = g.ox0 - g.halo + C;
        const bool inside = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
        if (out_s != nullptr) {
          const int opix = m - layer * P;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 bv = __ldg(reinterpret_cast<const float2*>(
                bias + n * 8 + 2 * tig));
            float v0 = __fadd_rn(acc[i][n][half * 2], bv.x);
            float v1 = __fadd_rn(acc[i][n][half * 2 + 1], bv.y);
            if (relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            if (!inside) v0 = v1 = 0.0f;
            *reinterpret_cast<uint32_t*>(out_s + act_offset<NT>(opix, n)
                                         + 4 * tig) = pack_bf16(v0, v1);
          }
        } else if (inside && C >= g.halo && C < P - g.halo) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int co = n * 8 + 2 * tig + j;
              if (co >= c_out) continue;
              float v = __fadd_rn(acc[i][n][half * 2 + j], __ldg(bias + co));
              if (relu) v = fmaxf(v, 0.0f);
              out_g[(static_cast<int64_t>(co) * g.h + gy) * g.w + gx] = v;
            }
          }
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void mma_layer_kc(
    int kc, const unsigned char* in_s, const unsigned char* w_s,
    const float* bias, int c_out, bool relu, unsigned char* out_s,
    float* out_g, int layer, const TileGeom& g) {
  switch (kc) {
    case 1:
      mma_layer<NT, 1>(in_s, w_s, bias, c_out, relu, out_s, out_g, layer, g);
      break;
    case 2:
      mma_layer<NT, 2>(in_s, w_s, bias, c_out, relu, out_s, out_g, layer, g);
      break;
    default:
      mma_layer<NT, 4>(in_s, w_s, bias, c_out, relu, out_s, out_g, layer, g);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv_chain_mma_kernel(const float* __restrict__ x, float* __restrict__ out,
                      MmaChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const bufs[2] = {smem, smem + a.buf1_off};
  unsigned char* const w_s = smem + a.w_smem_off;
  const int L = a.n_layers;

  // every layer's weights, once per block (the first barrier below covers
  // them)
  for (int i = threadIdx.x; i < a.w_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(w_s)[i] = __ldg(a.wpack + i);
  }

  TileGeom g;
  g.rows = a.th + 2 * L;
  g.pitch = a.tw + 2 * L;
  g.halo = L;
  g.h = a.h;
  g.w = a.w;
  const int n_pix = g.rows * g.pitch;
  const int cp0 = 2 * a.kc[0];
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int ty = tile / a.tiles_x;
    g.oy0 = ty * a.th;
    g.ox0 = (tile - ty * a.tiles_x) * a.tw;

    // the input tile with its halo: planar f32 -> channels-last bf16, eight
    // channels (one 16-byte chunk) per task, zero outside the image and in
    // the padded channels; consecutive threads take consecutive pixels
    for (int task = threadIdx.x; task < n_pix * cp0; task += kThreads) {
      const int chunk = task / n_pix;
      const int pix = task - chunk * n_pix;
      const int R = pix / g.pitch;
      const int gy = g.oy0 - L + R;
      const int gx = g.ox0 - L + (pix - R * g.pitch);
      const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const float* src = x + static_cast<int64_t>(gy) * a.w + gx;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = chunk * 8 + j;
        v[j] = (inside && ch < a.c_in) ? __ldg(src + ch * plane) : 0.0f;
      }
      uint4 q;
      q.x = pack_bf16(v[0], v[1]);
      q.y = pack_bf16(v[2], v[3]);
      q.z = pack_bf16(v[4], v[5]);
      q.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(bufs[0] + act_offset_rt(cp0, pix, chunk)) = q;
    }
    __syncthreads();

    for (int i = 0; i < L; ++i) {
      const bool last = i == L - 1;
      const bool relu = (a.relu_mask >> i) & 1;
      const unsigned char* in_s = bufs[i & 1];
      unsigned char* out_s = last ? nullptr : bufs[(i + 1) & 1];
      float* out_g = last ? out : nullptr;
      const unsigned char* wl = w_s + a.w_off[i];
      const float* bl = a.bias + a.b_off[i];
      switch (a.nt[i]) {
        case 1:
          mma_layer_kc<1>(a.kc[i], in_s, wl, bl, a.c_out[i], relu, out_s,
                          out_g, i + 1, g);
          break;
        case 2:
          mma_layer_kc<2>(a.kc[i], in_s, wl, bl, a.c_out[i], relu, out_s,
                          out_g, i + 1, g);
          break;
        case 4:
          mma_layer_kc<4>(a.kc[i], in_s, wl, bl, a.c_out[i], relu, out_s,
                          out_g, i + 1, g);
          break;
        default:
          mma_layer_kc<8>(a.kc[i], in_s, wl, bl, a.c_out[i], relu, out_s,
                          out_g, i + 1, g);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// x f32 [c0, h, w]; out f32 [c_L, h, w]; wpack and bias from
// tpufg_torch/kernels/conv.py:pack_chain_weights_bf16 (every layer's bf16
// weights in B-fragment order, every layer's f32 bias padded to its n8
// tiles); 1 <= n_layers <= 3, channels up to 64; bit i of relu_mask applies
// a relu after layer i; tile_h x tile_w outputs per tile; buf1_off, w_off
// and smem from tpufg_torch/kernels/conv.py:chain_mma_layout.
extern "C" int tpufg_conv_chain_bf16(const void* x, void* out,
                                     const void* wpack, const void* bias,
                                     int n_layers, int c0, int c1, int c2,
                                     int c3, int relu_mask, int h, int w,
                                     int tile_h, int tile_w, int buf1_off,
                                     int w_off, int smem, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c[kMaxLayers + 1] = {c0, c1, c2, c3};
  MmaChainArgs a;
  a.wpack = static_cast<const uint4*>(wpack);
  a.bias = static_cast<const float*>(bias);
  a.c_in = c0;
  int kc = pow2_at_least(c0, 16) / 16, w_bytes = 0, b_floats = 0;
  for (int i = 0; i < n_layers; ++i) {
    if (c[i] < 1 || c[i] > 64 || c[i + 1] < 1 || c[i + 1] > 64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool last = i == n_layers - 1;
    const int n_pad = pow2_at_least(c[i + 1], last ? 8 : 16);
    a.c_out[i] = c[i + 1];
    a.kc[i] = kc;
    a.nt[i] = n_pad / 8;
    a.w_off[i] = w_bytes;
    a.b_off[i] = b_floats;
    w_bytes += 9 * kc * a.nt[i] * 256;
    b_floats += n_pad;
    kc = n_pad / 16;
  }
  for (int i = n_layers; i < kMaxLayers; ++i) {
    a.c_out[i] = a.kc[i] = a.nt[i] = a.w_off[i] = a.b_off[i] = 0;
  }
  if (w_off + w_bytes > smem) return static_cast<int>(cudaErrorInvalidValue);
  a.n_layers = n_layers;
  a.relu_mask = relu_mask;
  a.h = h;
  a.w = w;
  a.th = tile_h;
  a.tw = tile_w;
  a.buf1_off = buf1_off;
  a.w_smem_off = w_off;
  a.w_bytes = w_bytes;
  a.tiles_x = (w + tile_w - 1) / tile_w;
  a.n_tiles = a.tiles_x * ((h + tile_h - 1) / tile_h);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv_chain_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  conv_chain_mma_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}
