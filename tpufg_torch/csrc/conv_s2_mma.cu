// SAME-padded 3x3 stride-2 convolution with bias in bf16, planar layout, as
// an implicit GEMM on the tensor cores.
//
// Replaces tpufg/kernels/conv.py:_conv_s2_kernel (the Pallas kernel behind
// conv3x3_s2) for compute_dtype = bfloat16, the only form the learned head
// runs (enc1, its first encoder layer); the f32 form stays on the CUDA
// cores (conv_s2.cu), since the tensor cores have no f32 product.  Planar
// f32 x [Cin, H, W] (H, W even) -> f32 [Cout, H/2, W/2], with
//   out[co][oy][ox] = b[co] + sum_{dy,dx,ci} w[co][ci][dy][dx] *
//                                             x[ci][2oy + dy][2ox + dx]
// and x read as 0 past the last row and column (XLA's SAME padding for a
// stride-2 window of 3 on an even size is (0, 1)).  Both operands are bf16
// values (the wrapper rounds the weights, this kernel the input, each value
// once), a bf16 x bf16 product is exact in f32 and the sums are f32, so the
// tensor cores compute the plain version's function up to the order of the
// f32 sums; the bias is added last (__fadd_rn), the relu stays with the
// caller.
//
// Bound on the H100: memory.  At the path's shape, [4, 2160, 3840] ->
// [32, 1080, 1920], 133 MB in and 265 MB out (0.119 ms at 3.35 TB/s) for
// 4.8 GFLOP.  One thread per output pixel on the CUDA cores spent as long
// again on instruction slots (1152 FMAs, 288 shared weight loads and 36
// rounded taps a pixel); on the tensor cores the arithmetic is 12 mma per
// 16 pixels and the kernel is a copy with a small GEMM inside.
//
// Design.
// - A block of kRows warps owns a tile of kCols x kRows output pixels.  It
//   stages the input rows 2 oy0 .. 2 oy0 + 2 kRows and columns 2 ox0 ..
//   2 ox0 + 2 kCols + 3 of all Cin planes with 16-byte loads (scalar loads
//   where W % 4 != 0 or the base is not aligned), rounds each value to bf16
//   once and writes it channels-last to shared memory: Cin bf16 per pixel
//   (8 bytes at Cin = 4, 16 at Cin = 8), zeros past the image (the SAME
//   pad).  With the shipped 64 x 4 tile that is 9.5 KB a block at Cin = 4,
//   beside 10 KB of epilogue scratch: six blocks of 128 threads an SM.
// - The GEMM: M = output pixels, N = 32 output channels (4 n8 tiles, the
//   ones past Cout skipped), K ordered (dy, dx, ci), so that one pixel's
//   taps of one dy are contiguous in the tile: 3 Cin bf16 from column 2 ox.
//   Each dy slice is padded to a multiple of 16 values (12 -> 16 at Cin =
//   4, 24 -> 32 at Cin = 8) with the next pixel's channels times zero
//   weights, so K = 48 (96): one m16n8k16 step per dy at Cin = 4, two at
//   Cin = 8.  The padded operand is staged data and finite for any finite
//   input; a non-finite input value reaches one output column more than in
//   the plain version (0 x inf).
// - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  A comes through
//   ldmatrix.x4 straight from the tile: the 8 rows of each 8x8 matrix are 8
//   neighbouring output pixels, 16 bytes apart at Cin = 4 (two staged pixels),
//   so the eight addresses cover 128 contiguous bytes and need no swizzle
//   (32 bytes apart at Cin = 8: a two-way bank conflict, which no path
//   pays yet).  B (K x 32, 3 KB at Cin = 4) arrives packed in fragment
//   order (tpufg_torch/kernels/conv.py:pack_s2_weights_bf16) and stays in
//   registers for the whole block: 24 registers at Cin = 4, 48 at Cin = 8.
//   No weights in shared memory.
// - Warp r of the block computes tile row r, one m16 tile (16 pixels x 32
//   channels, 16 accumulators a thread) at a time.
// - Epilogue: a thread holds two neighbouring channels of pixel g and of
//   pixel g + 8.  Stored as they lie (S2_EPILOGUE 0), one store instruction
//   writes 4 channel planes x 32 bytes.  The shipped form (S2_EPILOGUE 1)
//   takes the m16 tile through a per-warp scratch in shared memory,
//   [channel][16 pixels], and stores 16 bytes (4 neighbouring pixels of one
//   channel) per thread: runs of 64 bytes per channel and a quarter of the
//   store instructions, measured 10% faster.  tools/torch_kernel_variants.py
//   times both and other tile shapes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// output rows (= warps) and columns (a multiple of 16) of a block's tile,
// and the epilogue (0: as the accumulators lie, 1: through shared memory);
// overridable so that tools/torch_kernel_variants.py can time other choices
#ifndef S2_TILE_ROWS
#define S2_TILE_ROWS 4
#endif
#ifndef S2_TILE_COLS
#define S2_TILE_COLS 64
#endif
#ifndef S2_EPILOGUE
#define S2_EPILOGUE 1
#endif

namespace {

constexpr int kRows = S2_TILE_ROWS;
constexpr int kCols = S2_TILE_COLS;
constexpr int kThreads = kRows * 32;
constexpr int kInRows = 2 * kRows + 1;  // staged input rows
constexpr int kPitch = 2 * kCols + 4;   // staged pixels per row, in quads
constexpr int kCout = 32;
constexpr int kNT = kCout / 8;          // n8 tiles
// the epilogue's scratch of a warp: [channel][16 pixels], rows 4 floats
// longer so that the accumulators' stores hit 32 different banks
constexpr int kScrPitch = 20;
constexpr int kScratch = S2_EPILOGUE ? kCout * kScrPitch * 4 : 0;  // bytes
static_assert(kCols % 16 == 0 && kRows >= 1 && kRows <= 32, "tile shape");

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

template <int CIN>
__host__ __device__ constexpr int tile_bytes() {
  return kInRows * kPitch * 2 * CIN;
}

// blocks per SM to leave registers for: 768 threads at Cin = 4 (85
// registers a thread; 64 spill and were timed a third slower), 512 at
// Cin = 8, whose B fragments take 48 registers
template <int CIN>
constexpr int min_blocks() {
  constexpr int threads = CIN == 4 ? 768 : 512;
  return threads / kThreads > 0 ? threads / kThreads : 1;
}

template <int CIN>
__global__ void __launch_bounds__(kThreads, min_blocks<CIN>())
conv_s2_mma_kernel(const float* __restrict__ x,
                   const uint4* __restrict__ wpack,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int cout, int h, int w, bool vec_in, bool vec_out) {
  constexpr int kPix = 2 * CIN;       // bytes of a staged pixel
  constexpr int kStepsDy = CIN / 4;   // k16 steps per dy
  constexpr int kSteps = 3 * kStepsDy;
  extern __shared__ __align__(128) unsigned char smem[];
  const int oh = h / 2, ow = w / 2;
  const int ox0 = blockIdx.x * kCols, oy0 = blockIdx.y * kRows;
  const int64_t plane = static_cast<int64_t>(h) * w;

  // stage: a task is one quad of columns of one row, all Cin channels
  constexpr int kQuads = kPitch / 4;
  for (int task = threadIdx.x; task < kInRows * kQuads; task += kThreads) {
    const int r = task / kQuads;
    const int q = task - r * kQuads;
    const int gy = 2 * oy0 + r, gx = 2 * ox0 + 4 * q;
    const float* src = x + static_cast<int64_t>(gy) * w + gx;
    float v[CIN][4];
    if (gy < h && vec_in && gx < w) {  // w % 4 == 0: the quad is inside
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(
            src + c * plane));
        v[c][0] = f.x;
        v[c][1] = f.y;
        v[c][2] = f.z;
        v[c][3] = f.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CIN; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[c][i] = (gy < h && gx + i < w) ? __ldg(src + c * plane + i) : 0.0f;
        }
    }
    // four pixels, Cin bf16 each, as 16-byte stores
    uint32_t words[2 * CIN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CIN; c += 2) {
        words[(i * CIN + c) / 2] = pack_bf16(v[c][i], v[c + 1][i]);
      }
    uint4* dst = reinterpret_cast<uint4*>(smem + (r * kPitch + 4 * q) * kPix);
#pragma unroll
    for (int j = 0; j < CIN / 2; ++j) {
      dst[j] = make_uint4(words[4 * j], words[4 * j + 1], words[4 * j + 2],
                          words[4 * j + 3]);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lrow = lane & 15, lhi = lane >> 4;  // ldmatrix row, k half
  const int grp = lane >> 2, tig = lane & 3;    // accumulator row, col pair
  const int n_used = (cout + 7) >> 3;           // n8 tiles that hold channels

  // the B fragments of every k16 step and n8 tile, and this thread's biases
  uint32_t b[kSteps][kNT][2];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint4 lo = __ldg(wpack + (s * 32 + lane) * 2);
    const uint4 hi = __ldg(wpack + (s * 32 + lane) * 2 + 1);
    b[s][0][0] = lo.x;
    b[s][0][1] = lo.y;
    b[s][1][0] = lo.z;
    b[s][1][1] = lo.w;
    b[s][2][0] = hi.x;
    b[s][2][1] = hi.y;
    b[s][3][0] = hi.z;
    b[s][3][1] = hi.w;
  }
  float bv[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    bv[n][0] = __ldg(bias + n * 8 + 2 * tig);
    bv[n][1] = __ldg(bias + n * 8 + 2 * tig + 1);
  }
  __syncthreads();

  const int oy = oy0 + warp;
  if (oy >= oh) return;  // no barrier follows
  const int64_t oplane = static_cast<int64_t>(oh) * ow;
  float* const orow = out + static_cast<int64_t>(oy) * ow;
  // row `lrow` of an m16 tile is output pixel ox, whose taps of one dy start
  // at staged pixel 2 ox; lanes 16 .. 31 address the k half 8 .. 15
  const uint32_t a_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
      (2 * warp * kPitch + 2 * lrow) * kPix + lhi * 16;
#if S2_EPILOGUE
  float* const scr = reinterpret_cast<float*>(smem + tile_bytes<CIN>() +
                                              warp * kScratch);
#endif

  for (int mt = 0; mt < kCols / 16; ++mt) {
    const int oxm = ox0 + mt * 16;
    if (oxm >= ow) break;
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int kk = 0; kk < kStepsDy; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + (dy * kPitch + mt * 32) * kPix + kk * 32);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n < n_used) {
            mma_bf16(acc[n], a, b[dy * kStepsDy + kk][n][0],
                     b[dy * kStepsDy + kk][n][1]);
          }
        }
      }

#if S2_EPILOGUE == 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = oxm + grp + 8 * half;
      if (ox >= ow) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n * 8 + 2 * tig + j;
          if (co < cout) {
            orow[co * oplane + ox] = __fadd_rn(acc[n][half * 2 + j], bv[n][j]);
          }
        }
    }
#else
    // [channel][16 pixels] in the warp's scratch, then a channel's four
    // neighbouring pixels per thread
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        scr[(n * 8 + 2 * tig + (j & 1)) * kScrPitch + grp + 8 * (j >> 1)] =
            __fadd_rn(acc[n][j], bv[n][j & 1]);
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kCout / 8; ++it) {
      const int co = it * 8 + (lane >> 2);
      const int ox = oxm + 4 * (lane & 3);
      if (co >= cout || ox >= ow) continue;
      const float4 f = *reinterpret_cast<const float4*>(
          scr + co * kScrPitch + 4 * (lane & 3));
      float* dst = orow + co * oplane + ox;
      if (vec_out) {  // ow % 4 == 0: the quad is inside
        *reinterpret_cast<float4*>(dst) = f;
      } else {
        dst[0] = f.x;
        if (ox + 1 < ow) dst[1] = f.y;
        if (ox + 2 < ow) dst[2] = f.z;
        if (ox + 3 < ow) dst[3] = f.w;
      }
    }
    __syncwarp();
#endif
  }
}

template <int CIN>
int launch_s2(const float* x, const uint4* wpack, const float* b, float* out,
              int cout, int h, int w, cudaStream_t stream) {
  const int oh = h / 2, ow = w / 2;
  const int smem = tile_bytes<CIN>() + kRows * kScratch;
  cudaError_t err = cudaFuncSetAttribute(
      conv_s2_mma_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ow + kCols - 1) / kCols, (oh + kRows - 1) / kRows);
  const bool vec_in = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = ow % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  conv_s2_mma_kernel<CIN><<<grid, kThreads, smem, stream>>>(
      x, wpack, b, out, cout, h, w, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32 [cin, h, w]; wpack the bf16 weights in mma B-fragment order and b
// f32 [32] (zero past cout), both from tpufg_torch/kernels/conv.py:
// pack_s2_weights_bf16; out f32 [cout, h/2, w/2].  cin in {4, 8}, cout <=
// 32, h and w even.
extern "C" int tpufg_conv_s2_bf16(const void* x, const void* wpack,
                                  const void* b, void* out, int cin, int cout,
                                  int h, int w, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cout < 1 || cout > kCout || h < 2 || w < 2 || h % 2 || w % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xs = static_cast<const float*>(x);
  const uint4* ws = static_cast<const uint4*>(wpack);
  const float* bs = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  switch (cin) {
    case 4: return launch_s2<4>(xs, ws, bs, o, cout, h, w, stream);
    case 8: return launch_s2<8>(xs, ws, bs, o, cout, h, w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
