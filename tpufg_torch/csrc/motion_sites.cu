// Exhaustive block matching at the MV lattice's site rows.
//
// Replaces tpufg/kernels/motion.py:_sites_kernel (the Pallas kernel behind
// motion_search_sites): planar f32 prev/curr [C, H, W] (H % 16 == 0) ->
// f32 [2, H/16, W], the (dx, dy) of the best of the (2r+1)^2 candidates for
// the 8x8 block around every column x of every site row s = 8 + 16k.  The
// block covers rows s-4 .. s+3 (always inside the image) and columns
// x-4 .. x+3 (masked outside it); the prev fetch clamps to the edge.
//
// Bitwise contract with the plain version (motion_search_sites_plain) and
// with tpufg, kept by one rounding per operation (_rn intrinsics, no FMA
// contraction, correctly rounded sqrt):
//   dist  = sqrt(((d0*d0 + d1*d1) + d2*d2) + d3*d3) * mask,  d = curr - prev
//   rsum  = ((dist[u=0] + dist[1]) + ...) + dist[7]    (the 8 block rows)
//   cost  = ((rsum[x-4] + rsum[x-3]) + ...) + rsum[x+3]
//   MV    = first minimum over dy = -r..r (outer), dx = -r..r (inner), by
//           a strict <, starting from cost 1e10 at (0, 0).
//
// Bound on the H100: arithmetic.  Each site column scores (2r+1)^2
// candidates x 64 block pixels x C channels (at 1080p and r = 16, 1.1e9
// distances); the frames are read from device memory about once.  Design:
// one block of 128 threads per site row and strip of 121 output columns;
// thread t owns block-pixel column t of the strip, keeps its 8 x C curr
// values in registers and computes, per candidate, its column's 8
// distances and their row sum once.  The row sums go to shared memory
// (double-buffered, one barrier per candidate) and each of the first 121
// threads adds the 8 row sums of its window, so every distance is computed
// once per candidate instead of 8 times.  The prev rows a dy reads (8 rows
// x 128 + 2r columns x C) are staged in shared memory once per dy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // block-pixel columns
constexpr int kB = 8;                          // block size
constexpr int kAnchor = kB / 2;
constexpr int kGrid = 16;                      // MV lattice pitch
constexpr int kOutCols = kThreads - (kB - 1);  // output columns per block

template <int C>
__global__ void __launch_bounds__(kThreads)
sites_kernel(const float* __restrict__ prev, const float* __restrict__ curr,
             float* __restrict__ out, int h, int w, int r) {
  extern __shared__ float smem[];
  const int pw = kThreads + 2 * r;    // staged prev columns
  float* prev_s = smem;               // [C][kB][pw]
  float* rsum_s = smem + C * kB * pw;  // [2][kThreads]

  const int t = threadIdx.x;
  const int site = blockIdx.y;
  const int m = gridDim.y;
  const int x0 = blockIdx.x * kOutCols;
  const int row0 = site * kGrid + kGrid / 2 - kAnchor;
  const int gx = x0 - kAnchor + t;    // image column of this thread
  const bool in_col = gx >= 0 && gx < w;
  const float mask = in_col ? 1.0f : 0.0f;
  const int64_t plane = static_cast<int64_t>(h) * w;

  float cur[C][kB];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      cur[c][u] = in_col
          ? curr[c * plane + static_cast<int64_t>(row0 + u) * w + gx] : 0.0f;
    }
  }

  const int n = 2 * r + 1;
  float best = 1e10f;
  int best_k = r * n + r;  // (dx, dy) = (0, 0)
  int cand = 0;
  int buf = 0;
  for (int dy = -r; dy <= r; ++dy) {
    // stage prev rows row0 + u + dy and columns x0 - 4 - r + j, clamped
    for (int i = t; i < C * kB * pw; i += kThreads) {
      const int j = i % pw;
      const int rest = i / pw;
      const int u = rest % kB;
      const int c = rest / kB;
      const int y = min(max(row0 + u + dy, 0), h - 1);
      const int x = min(max(x0 - kAnchor - r + j, 0), w - 1);
      prev_s[i] = prev[c * plane + static_cast<int64_t>(y) * w + x];
    }
    __syncthreads();
    for (int dx = -r; dx <= r; ++dx, ++cand) {
      const int col = t + r + dx;
      float rs = 0.0f;
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        float d = __fsub_rn(cur[0][u], prev_s[u * pw + col]);
        float acc = __fmul_rn(d, d);
#pragma unroll
        for (int c = 1; c < C; ++c) {
          d = __fsub_rn(cur[c][u], prev_s[(c * kB + u) * pw + col]);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        const float dist = __fmul_rn(__fsqrt_rn(acc), mask);
        rs = u == 0 ? dist : __fadd_rn(rs, dist);
      }
      float* rb = rsum_s + buf * kThreads;
      rb[t] = rs;
      __syncthreads();
      if (t < kOutCols) {
        float cost = rb[t];
#pragma unroll
        for (int kx = 1; kx < kB; ++kx) cost = __fadd_rn(cost, rb[t + kx]);
        if (cost < best) {
          best = cost;
          best_k = cand;
        }
      }
      buf ^= 1;
    }
  }
  const int x = x0 + t;
  if (t < kOutCols && x < w) {
    const int64_t o = static_cast<int64_t>(site) * w + x;
    out[o] = static_cast<float>(best_k % n - r);
    out[static_cast<int64_t>(m) * w + o] = static_cast<float>(best_k / n - r);
  }
}

template <int C>
int launch_sites(const float* prev, const float* curr, float* out, int h,
                 int w, int r, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sites_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + kOutCols - 1) / kOutCols, h / kGrid);
  sites_kernel<C><<<grid, kThreads, smem, stream>>>(prev, curr, out, h, w, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem: dynamic shared memory in bytes, 4 * (c * 8 * (128 + 2r) + 2 * 128)
// (tpufg_torch/kernels/motion.py:sites_smem_bytes).  c in {3, 4}.
extern "C" int tpufg_motion_sites(const void* prev, const void* curr,
                                  void* out, int c, int h, int w, int r,
                                  int smem, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(prev);
  const float* q = static_cast<const float*>(curr);
  float* o = static_cast<float*>(out);
  switch (c) {
    case 3: return launch_sites<3>(p, q, o, h, w, r, smem, stream);
    case 4: return launch_sites<4>(p, q, o, h, w, r, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
