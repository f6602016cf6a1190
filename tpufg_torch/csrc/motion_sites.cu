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
// The contract fixes every rounding, not the order in which candidates are
// scored: the scan's first minimum is the minimum of (cost, candidate
// index) over the candidates that cost less than 1e10, and (0, 0) if there
// is none.
//
// Bound on the H100: arithmetic.  Each site column scores (2r+1)^2
// candidates x 64 block pixels x C channels (at 1080p and r = 16, 1.1e9
// distances, each about 20 operations with its correctly rounded sqrt);
// the frames are read from device memory about once.  Design:
// - One block of 128 threads per site row and strip of 121 output columns;
//   thread t owns block-pixel column t of the strip, keeps its 8 curr
//   pixels in registers (one float4 each; C = 3 is padded with a zero plane
//   in both frames: d = 0, and acc + 0*0 is acc exactly) and computes each
//   candidate's 8 distances and their row sum once, for the 8 windows that
//   contain the column.
// - Candidates are scored kDyBlock dy at a time for each dx: the
//   8 + kDyBlock - 1 prev pixels of the thread's column feed the distances
//   of all kDyBlock candidates, so a candidate costs (7 + kDyBlock) /
//   kDyBlock 16-byte shared-memory loads instead of 8 x C scalar ones, and
//   the kDyBlock row sums cross one barrier together instead of one each.
//   The prev rows of a dy block are staged once per block (7 + kDyBlock
//   rows for kDyBlock dy instead of 8 rows for each).
// - Scoring out of scan order, each thread keeps the minimum of (cost,
//   candidate index); the start value carries index -1 so that it loses no
//   tie to a real candidate and wins none.
// - The column mask multiplies nothing: a column outside the image reads
//   curr as 0, and its row sum is replaced by +0, which is what eight
//   products finite * 0 add up to.  This is bitwise to the contract for
//   finite frames whose squared differences stay finite (|value| < 1e18);
//   beyond that the plain version yields NaN costs where this yields 0.

#include <cstdint>
#include <cuda_runtime.h>

// dy candidates scored together; overridable so that
// tools/torch_kernel_variants.py can time other splits
#ifndef SITES_DY_BLOCK
#define SITES_DY_BLOCK 4
#endif

namespace {

constexpr int kThreads = 128;                  // block-pixel columns
constexpr int kB = 8;                          // block size
constexpr int kAnchor = kB / 2;
constexpr int kGrid = 16;                      // MV lattice pitch
constexpr int kOutCols = kThreads - (kB - 1);  // output columns per block
constexpr int kDyBlock = SITES_DY_BLOCK;

// Row sums of NDY consecutive dy at one dx for one block-pixel column:
// `col` points at the column's prev pixel in the first staged row (row
// pitch pw); staged row p holds the block row u = p - j of dy index j.
template <int C, int NDY>
__device__ __forceinline__ void row_sums(const float4* col, int pw,
                                         const float4 (&cur)[kB],
                                         float (&rs)[kDyBlock]) {
#pragma unroll
  for (int p = 0; p < kB + NDY - 1; ++p) {
    const float4 q = col[p * pw];
#pragma unroll
    for (int j = 0; j < NDY; ++j) {
      const int u = p - j;
      if (u >= 0 && u < kB) {
        float d = __fsub_rn(cur[u].x, q.x);
        float acc = __fmul_rn(d, d);
        d = __fsub_rn(cur[u].y, q.y);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        d = __fsub_rn(cur[u].z, q.z);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        if (C == 4) {
          d = __fsub_rn(cur[u].w, q.w);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        const float dist = __fsqrt_rn(acc);
        rs[j] = u == 0 ? dist : __fadd_rn(rs[j], dist);
      }
    }
  }
}

// Every dx of the NDY candidates dy0 .. dy0 + NDY - 1 (indices from 0).
template <int C, int NDY>
__device__ __forceinline__ void scan_dy_block(
    const float4* prev_s, float* rsum_s, int pw, int n, int dy0, int t,
    bool in_col, const float4 (&cur)[kB], int& buf, float& best,
    int& best_k) {
  for (int dxi = 0; dxi < n; ++dxi) {
    float rs[kDyBlock];
    row_sums<C, NDY>(prev_s + t + dxi, pw, cur, rs);
    float* rb = rsum_s + buf * kDyBlock * kThreads;
#pragma unroll
    for (int j = 0; j < NDY; ++j) rb[j * kThreads + t] = in_col ? rs[j] : 0.0f;
    __syncthreads();
    if (t < kOutCols) {
#pragma unroll
      for (int j = 0; j < NDY; ++j) {
        const float* q = rb + j * kThreads + t;
        float cost = q[0];
#pragma unroll
        for (int kx = 1; kx < kB; ++kx) cost = __fadd_rn(cost, q[kx]);
        const int k = (dy0 + j) * n + dxi;
        if (cost < best || (cost == best && k < best_k)) {
          best = cost;
          best_k = k;
        }
      }
    }
    buf ^= 1;
  }
}

template <int C, int NDY>
__device__ __forceinline__ void scan_dy_block_of(
    int ndy, const float4* prev_s, float* rsum_s, int pw, int n, int dy0,
    int t, bool in_col, const float4 (&cur)[kB], int& buf, float& best,
    int& best_k) {
  if (ndy == NDY) {
    scan_dy_block<C, NDY>(prev_s, rsum_s, pw, n, dy0, t, in_col, cur, buf,
                          best, best_k);
  } else if constexpr (NDY > 1) {
    scan_dy_block_of<C, NDY - 1>(ndy, prev_s, rsum_s, pw, n, dy0, t, in_col,
                                 cur, buf, best, best_k);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sites_kernel(const float* __restrict__ prev, const float* __restrict__ curr,
             float* __restrict__ out, int h, int w, int r) {
  extern __shared__ float4 smem4[];
  const int pw = kThreads + 2 * r;    // staged prev columns
  float4* prev_s = smem4;             // [kB + kDyBlock - 1][pw]
  // [2][kDyBlock][kThreads]
  float* rsum_s = reinterpret_cast<float*>(prev_s + (kB + kDyBlock - 1) * pw);

  const int t = threadIdx.x;
  const int site = blockIdx.y;
  const int m = gridDim.y;
  const int x0 = blockIdx.x * kOutCols;
  const int row0 = site * kGrid + kGrid / 2 - kAnchor;
  const int gx = x0 - kAnchor + t;    // image column of this thread
  const bool in_col = gx >= 0 && gx < w;
  const int64_t plane = static_cast<int64_t>(h) * w;

  float4 cur[kB];
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in_col) {
      const float* p = curr + static_cast<int64_t>(row0 + u) * w + gx;
      v.x = p[0];
      v.y = p[plane];
      v.z = p[2 * plane];
      if (C == 4) v.w = p[3 * plane];
    }
    cur[u] = v;
  }

  const int n = 2 * r + 1;
  float best = 1e10f;
  int best_k = -1;  // the start value: stands for (dx, dy) = (0, 0)
  int buf = 0;
  for (int dy0 = 0; dy0 < n; dy0 += kDyBlock) {
    const int ndy = min(kDyBlock, n - dy0);
    // stage prev rows row0 + dy0 - r + p and columns x0 - 4 - r + j,
    // clamped, once every thread is done with the rows of the block before
    __syncthreads();
    for (int p = 0; p < kB + ndy - 1; ++p) {
      const int y = min(max(row0 + dy0 - r + p, 0), h - 1);
      const float* row = prev + static_cast<int64_t>(y) * w;
      for (int j = t; j < pw; j += kThreads) {
        const float* q = row + min(max(x0 - kAnchor - r + j, 0), w - 1);
        float4 v;
        v.x = q[0];
        v.y = q[plane];
        v.z = q[2 * plane];
        v.w = C == 4 ? q[3 * plane] : 0.0f;
        prev_s[p * pw + j] = v;
      }
    }
    __syncthreads();
    scan_dy_block_of<C, kDyBlock>(ndy, prev_s, rsum_s, pw, n, dy0, t, in_col,
                                  cur, buf, best, best_k);
  }
  const int x = x0 + t;
  if (t < kOutCols && x < w) {
    if (best_k < 0) best_k = r * n + r;
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

// dy_block (the dy candidates scored together, which must be the value
// compiled in) and smem (dynamic shared memory in bytes) from
// tpufg_torch/kernels/motion.py:sites_plan.  c in {3, 4}.
extern "C" int tpufg_motion_sites(const void* prev, const void* curr,
                                  void* out, int c, int h, int w, int r,
                                  int dy_block, int smem, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dy_block != kDyBlock || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(prev);
  const float* q = static_cast<const float*>(curr);
  float* o = static_cast<float*>(out);
  switch (c) {
    case 3: return launch_sites<3>(p, q, o, h, w, r, smem, stream);
    case 4: return launch_sites<4>(p, q, o, h, w, r, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the kernel that fit on one SM with `smem` bytes each (the
// occupancy calculator's answer for the current device), or -1.
extern "C" int tpufg_motion_sites_blocks_per_sm(int c, int smem) {
  int n = -1;
  cudaError_t err =
      c == 3 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, sites_kernel<3>, kThreads, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, sites_kernel<4>, kThreads, smem);
  return err == cudaSuccess ? n : -1;
}
