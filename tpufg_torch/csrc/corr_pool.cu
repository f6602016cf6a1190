// RAFT's correlation pyramid (core/corr.py, CorrBlock.__init__): levels
// 1-3 of the all-pairs correlation volume, each avg_pool2d(2, 2) of the
// level before, in one pass over level 0.
//
// The published form is three avg_pool2d calls over an (N, 1, h, w) view:
// the first reads the whole f32 level 0 (4.2 GB at 1080p) and the next two
// read the levels they made.  No TPU kernel: tpufg has no RAFT; this
// kernel replaces those library calls.
//
// Arithmetic (kernels/corr_pool.py::corr_pool_plain is the published form):
// each output is ATen's avg_pool2d sum, ((((0 + a00) + a01) + a10) + a11)
// over its 2 x 2 window in row order, divided by 4, one rounding per
// operation; level l + 1 is made from level l's rounded values, so every
// level is bitwise the plain version's.  Rows and columns past twice the
// pooled size (an odd size's last one) are never read.
//
// Bound on the H100: memory: level 0 read once, the three levels written
// once.  Design: a thread per 8 x 8 block of one pixel's level-0 map: it
// pools the block's 4 x 4 level-1 cells row pair by row pair (16-byte
// loads where the width allows), then its 2 x 2 level-2 cells and its
// level-3 cell from registers; consecutive threads take consecutive blocks
// of a row band, so a warp's loads of a row are one contiguous run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pool4(float a00, float a01, float a10,
                                       float a11) {
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.f, a00), a01),
                                      a10), a11);
  return __fdiv_rn(s, 4.f);
}

// kVec: level-0 rows and level-1 rows may be read and written as float4
// (w % 8 == 0 and w1 % 4 == 0)
template <bool kVec>
__global__ void corr_pool_kernel(const float* __restrict__ l0, int64_t n,
                                 int h, int w, float* __restrict__ l1,
                                 float* __restrict__ l2,
                                 float* __restrict__ l3, int bys, int bxs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * bys * bxs) return;
  const int bx = static_cast<int>(t % bxs);
  const int64_t rest = t / bxs;
  const int by = static_cast<int>(rest % bys);
  const int64_t p = rest / bys;
  const int h1 = h / 2, w1 = w / 2, h2 = h1 / 2, w2 = w1 / 2;
  const int h3 = h2 / 2, w3 = w2 / 2;
  const float* src = l0 + p * h * w;
  float* d1 = l1 + p * h1 * w1;
  float v1[4][4];
  const bool full_x = bx * 4 + 3 < w1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r1 = by * 4 + i;
    if (r1 >= h1) break;
    const float* a = src + (2 * r1) * w + bx * 8;
    const float* b = a + w;
    if (kVec && full_x) {
      float x[8], y[8];
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
      x[0] = a0.x; x[1] = a0.y; x[2] = a0.z; x[3] = a0.w;
      x[4] = a1.x; x[5] = a1.y; x[6] = a1.z; x[7] = a1.w;
      y[0] = b0.x; y[1] = b0.y; y[2] = b0.z; y[3] = b0.w;
      y[4] = b1.x; y[5] = b1.y; y[6] = b1.z; y[7] = b1.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v1[i][j] = pool4(x[2 * j], x[2 * j + 1], y[2 * j], y[2 * j + 1]);
      }
      *reinterpret_cast<float4*>(d1 + r1 * w1 + bx * 4) =
          make_float4(v1[i][0], v1[i][1], v1[i][2], v1[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c1 = bx * 4 + j;
        if (c1 < w1) {
          v1[i][j] = pool4(__ldg(a + 2 * j), __ldg(a + 2 * j + 1),
                           __ldg(b + 2 * j), __ldg(b + 2 * j + 1));
          d1[r1 * w1 + c1] = v1[i][j];
        }
      }
    }
  }
  float v2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r2 = by * 2 + i, c2 = bx * 2 + j;
      if (r2 < h2 && c2 < w2) {
        v2[i][j] = pool4(v1[2 * i][2 * j], v1[2 * i][2 * j + 1],
                         v1[2 * i + 1][2 * j], v1[2 * i + 1][2 * j + 1]);
        l2[p * h2 * w2 + r2 * w2 + c2] = v2[i][j];
      }
    }
  }
  if (by < h3 && bx < w3) {
    l3[p * h3 * w3 + by * w3 + bx] =
        pool4(v2[0][0], v2[0][1], v2[1][0], v2[1][1]);
  }
}

}  // namespace

// (level 0 f32 [n, h, w], n, h, w (each >= 8), levels 1-3 f32 [n, h / 2,
//  w / 2], [n, h / 4, w / 4], [n, h / 8, w / 8] (sizes floored at each
//  halving), device, stream)
extern "C" int tpufg_corr_pool(const void* l0, int64_t n, int h, int w,
                               void* l1, void* l2, void* l3, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || h < 8 || w < 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // blocks of 8 x 8 cover every level-1 cell: rows and columns up to
  // twice the level-1 size
  const int bys = (2 * (h / 2) + 7) / 8, bxs = (2 * (w / 2) + 7) / 8;
  const int64_t blocks = (n * bys * bxs + kThreads - 1) / kThreads;
  const bool vec = w % 8 == 0 && (w / 2) % 4 == 0;
  auto* out1 = static_cast<float*>(l1);
  auto* out2 = static_cast<float*>(l2);
  auto* out3 = static_cast<float*>(l3);
  const auto* in = static_cast<const float*>(l0);
  if (vec) {
    corr_pool_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(in, n, h, w, out1, out2, out3, bys,
                                       bxs);
  } else {
    corr_pool_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(in, n, h, w, out1, out2, out3, bys,
                                        bxs);
  }
  return static_cast<int>(cudaGetLastError());
}
