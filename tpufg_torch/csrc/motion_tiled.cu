// Exhaustive block matching at every pixel.
//
// Replaces tpufg/kernels/motion.py:_motion_kernel (the Pallas kernel behind
// motion_search_tiled): planar f32 prev/curr [C, H, W] -> f32 [2, H, W],
// the (dx, dy) of the best of the (2r+1)^2 candidates for the b x b block
// anchored at p - b/2 of every pixel p.  Block pixels outside the image
// weigh 0 (rows and columns are masked); the prev fetch clamps to the edge.
//
// Bitwise contract with the plain version (motion_search_tiled_plain) and
// with tpufg, kept by one rounding per operation (_rn intrinsics, no FMA
// contraction, correctly rounded sqrt):
//   dist = sqrt(((d0*d0 + d1*d1) + d2*d2) + d3*d3) * mask,  d = curr - prev
//   separable box (exact_box = 0): the b rows first, each added in turn,
//     then the b columns of that row sum, each added in turn;
//   exact box (exact_box = 1): one running sum over the block, ky outer and
//     kx inner, starting from the block's first pixel (motion.comp's loop);
//   MV = first minimum over dy = -r..r (outer), dx = -r..r (inner), by a
//     strict <, starting from cost 1e10 at (0, 0).
//
// Bound on the H100: arithmetic ((2r+1)^2 candidates x b^2 block pixels x
// C channels per pixel if done naively).  Design: one block of 128 threads
// per tile of 8 output rows x (128 - (b-1)) output columns.  Thread t owns
// block-pixel column t of the tile and computes, per candidate, the
// distances of its column's 8 + b - 1 block-pixel rows once.  Separable:
// the thread forms its column's 8 row sums in registers and shares them
// through shared memory; exact: it shares the distances themselves, and
// each output thread adds its b x b window in the exact order.  Either
// buffer is double-buffered, so a candidate costs one barrier.  curr's
// block pixels are staged once per tile, the prev rows of a dy once per dy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // block-pixel columns per tile
constexpr int kRows = 8;       // output rows per tile

template <int C, bool kExact>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ prev, const float* __restrict__ curr,
             float* __restrict__ out, int h, int w, int b, int r) {
  extern __shared__ float smem[];
  const int ext = kRows + b - 1;     // block-pixel rows of the tile
  const int pw = kThreads + 2 * r;   // staged prev columns
  const int buf_rows = kExact ? ext : kRows;
  float* cur_s = smem;                          // [C][ext][kThreads]
  float* prev_s = cur_s + C * ext * kThreads;   // [C][ext][pw]
  float* buf_s = prev_s + C * ext * pw;         // [2][buf_rows][kThreads]

  const int t = threadIdx.x;
  const int a = b / 2;
  const int out_cols = kThreads - (b - 1);
  const int x0 = blockIdx.x * out_cols;
  const int y0 = blockIdx.y * kRows;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int gx = x0 - a + t;
  const bool in_col = gx >= 0 && gx < w;

  // curr's block pixels, zero outside the image
  for (int i = t; i < C * ext * kThreads; i += kThreads) {
    const int j = i % kThreads;
    const int rest = i / kThreads;
    const int e = rest % ext;
    const int c = rest / ext;
    const int y = y0 - a + e;
    const int x = x0 - a + j;
    cur_s[i] = (y >= 0 && y < h && x >= 0 && x < w)
        ? curr[c * plane + static_cast<int64_t>(y) * w + x] : 0.0f;
  }

  const int n = 2 * r + 1;
  float best[kRows];
  int best_k[kRows];
#pragma unroll
  for (int o = 0; o < kRows; ++o) {
    best[o] = 1e10f;
    best_k[o] = r * n + r;  // (dx, dy) = (0, 0)
  }
  int cand = 0;
  int buf = 0;
  for (int dy = -r; dy <= r; ++dy) {
    // stage prev rows y0 - a + e + dy and columns x0 - a - r + j, clamped
    for (int i = t; i < C * ext * pw; i += kThreads) {
      const int j = i % pw;
      const int rest = i / pw;
      const int e = rest % ext;
      const int c = rest / ext;
      const int y = min(max(y0 - a + e + dy, 0), h - 1);
      const int x = min(max(x0 - a - r + j, 0), w - 1);
      prev_s[i] = prev[c * plane + static_cast<int64_t>(y) * w + x];
    }
    __syncthreads();
    for (int dx = -r; dx <= r; ++dx, ++cand) {
      const int col = t + r + dx;
      float* bb = buf_s + buf * buf_rows * kThreads;
      float rs[kRows];
#pragma unroll
      for (int o = 0; o < kRows; ++o) rs[o] = 0.0f;
      for (int e = 0; e < ext; ++e) {
        float d = __fsub_rn(cur_s[e * kThreads + t], prev_s[e * pw + col]);
        float acc = __fmul_rn(d, d);
#pragma unroll
        for (int c = 1; c < C; ++c) {
          d = __fsub_rn(cur_s[(c * ext + e) * kThreads + t],
                        prev_s[(c * ext + e) * pw + col]);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        const int y = y0 - a + e;
        const float mask = (in_col && y >= 0 && y < h) ? 1.0f : 0.0f;
        const float dist = __fmul_rn(__fsqrt_rn(acc), mask);
        if (kExact) {
          bb[e * kThreads + t] = dist;
        } else {
          // row sum of output row o: dist rows o .. o + b - 1 in order
#pragma unroll
          for (int o = 0; o < kRows; ++o) {
            if (e >= o && e < o + b) rs[o] = e == o ? dist : __fadd_rn(rs[o], dist);
          }
        }
      }
      if (!kExact) {
#pragma unroll
        for (int o = 0; o < kRows; ++o) bb[o * kThreads + t] = rs[o];
      }
      __syncthreads();
      if (t < out_cols) {
#pragma unroll
        for (int o = 0; o < kRows; ++o) {
          float cost;
          if (kExact) {
            const float* q = bb + o * kThreads + t;
            cost = q[0];
            for (int ky = 0; ky < b; ++ky) {
              for (int kx = 0; kx < b; ++kx) {
                if (ky | kx) cost = __fadd_rn(cost, q[ky * kThreads + kx]);
              }
            }
          } else {
            const float* q = bb + o * kThreads + t;
            cost = q[0];
            for (int kx = 1; kx < b; ++kx) cost = __fadd_rn(cost, q[kx]);
          }
          if (cost < best[o]) {
            best[o] = cost;
            best_k[o] = cand;
          }
        }
      }
      buf ^= 1;
    }
  }
  const int x = x0 + t;
  if (t < out_cols && x < w) {
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
      const int y = y0 + o;
      if (y < h) {
        const int64_t i = static_cast<int64_t>(y) * w + x;
        out[i] = static_cast<float>(best_k[o] % n - r);
        out[plane + i] = static_cast<float>(best_k[o] / n - r);
      }
    }
  }
}

template <int C, bool kExact>
int launch_tiled(const float* prev, const float* curr, float* out, int h,
                 int w, int b, int r, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_kernel<C, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_cols = kThreads - (b - 1);
  dim3 grid((w + out_cols - 1) / out_cols, (h + kRows - 1) / kRows);
  tiled_kernel<C, kExact><<<grid, kThreads, smem, stream>>>(
      prev, curr, out, h, w, b, r);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_tiled_box(const float* prev, const float* curr, float* out, int h,
                     int w, int b, int r, int exact, int smem,
                     cudaStream_t stream) {
  return exact ? launch_tiled<C, true>(prev, curr, out, h, w, b, r, smem,
                                       stream)
               : launch_tiled<C, false>(prev, curr, out, h, w, b, r, smem,
                                        stream);
}

}  // namespace

// smem: dynamic shared memory in bytes (tpufg_torch/kernels/motion.py:
// tiled_smem_bytes).  c in {3, 4}, 1 <= b < 128.
extern "C" int tpufg_motion_tiled(const void* prev, const void* curr,
                                  void* out, int c, int h, int w, int b,
                                  int r, int exact, int smem, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b >= kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(prev);
  const float* q = static_cast<const float*>(curr);
  float* o = static_cast<float*>(out);
  switch (c) {
    case 3: return launch_tiled_box<3>(p, q, o, h, w, b, r, exact, smem, stream);
    case 4: return launch_tiled_box<4>(p, q, o, h, w, b, r, exact, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
