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
// The contract fixes every rounding, not which thread scores which
// candidate: the first minimum in scan order is the minimum of (cost,
// candidate index), so the candidates may be split and merged by that pair.
//
// Bound on the H100: arithmetic ((2r+1)^2 candidates x b^2 block pixels x
// C channels per pixel if done naively), and in practice the latency of the
// dependent load -> sub -> mul -> add -> sqrt -> add chain and of one
// barrier per candidate.  Design:
// - A block scores a tile of R output rows x (128 - (b-1)) output columns.
//   R = 16 for the block sizes the engine uses (8, 12, 16; compiled in, so
//   the box sums unroll with no predicated adds), 8 for any other: the
//   R + b - 1 rows of distances a tile needs are 1.9x its output rows at
//   R = 16, b = 16 (2.9x at R = 8).
// - The block is G groups of 128 threads (G from the wrapper, as many as
//   shared memory allows, up to 5: 20 warps on an SM).  The groups share the
//   staged curr tile and the prev rows of the current dy and take the dx of
//   that dy in turns (dx index % G); each keeps its own best (cost,
//   candidate) and its own double-buffered sum buffer, synchronised by its
//   own named barrier, one per candidate.  At the end the groups' bests
//   merge through shared memory by (cost, candidate index).
// - Channels are interleaved in shared memory, one float4 per pixel (C = 3
//   padded with zeros in both frames: d = 0, and acc + 0*0 is acc exactly),
//   so a distance costs two 16-byte loads.
// - Thread t of a group owns block-pixel column t: per candidate it
//   computes the column's R + b - 1 distances once and (separable) forms the
//   R row sums in registers, or (exact) shares the distances.  For the
//   column sums a thread takes 4 adjacent outputs x R/4 rows and reads the
//   shared rows as aligned float4, 5 loads per 4 outputs at b = 16.

#include <cstdint>
#include <cuda_runtime.h>

// output rows per tile at the compiled-in block sizes and the most groups a
// block may run; overridable so that tools/torch_kernel_variants.py can time
// other tiles
#ifndef TILED_ROWS
#define TILED_ROWS 16
#endif
#ifndef TILED_MAX_GROUPS
#define TILED_MAX_GROUPS 5
#endif

namespace {

constexpr int kCols = 128;            // block-pixel columns per tile
constexpr int kRowsFast = TILED_ROWS; // output rows per tile, b in {8, 12, 16}
constexpr int kRowsAny = 8;           // output rows per tile, any other b
constexpr int kMaxGroups = TILED_MAX_GROUPS;

// The sums over b adjacent values of `row` for the 4 outputs starting at
// row[0], each added in turn: acc[j] = row[j] + row[j+1] + ... (kFirst) or
// acc[j] += row[j] + ... in turn.  B > 0: b is compiled in and `row` is
// 16-byte aligned.
template <int B, bool kFirst>
__device__ __forceinline__ void window4(const float* row, int b,
                                        float (&acc)[4]) {
  if constexpr (B > 0) {
    constexpr int kLoads = (B + 3 + 3) / 4;
    float v[kLoads * 4];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const float4 f = reinterpret_cast<const float4*>(row)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int kx = 0; kx < B; ++kx) {
        acc[j] = (kFirst && kx == 0) ? v[j] : __fadd_rn(acc[j], v[j + kx]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int kx = 0;
      if (kFirst) {
        acc[j] = row[j];
        kx = 1;
      }
      for (; kx < b; ++kx) acc[j] = __fadd_rn(acc[j], row[j + kx]);
    }
  }
}

__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kCols) : "memory");
}

template <int B, bool kExact, int R>
__global__ void __launch_bounds__(kCols * kMaxGroups)
tiled_kernel(const float* __restrict__ prev, const float* __restrict__ curr,
             float* __restrict__ out, int n_ch, int h, int w, int b_any,
             int r) {
  extern __shared__ float4 smem4[];
  constexpr int kPer = R / 4;          // output rows per thread
  const int b = B > 0 ? B : b_any;
  const int ext = R + b - 1;           // block-pixel rows of the tile
  const int pw = kCols + 2 * r;        // staged prev columns
  const int buf_rows = kExact ? ext : R;
  const int groups = blockDim.x / kCols;
  const int grp = threadIdx.x / kCols;
  const int t = threadIdx.x % kCols;
  float4* cur_s = smem4;                       // [ext][kCols]
  float4* prev_s = cur_s + ext * kCols;        // [ext][pw]
  // [groups][2][buf_rows][kCols], then 4 floats that a float4 read of a
  // partly valid output quad may touch
  float* buf_s = reinterpret_cast<float*>(prev_s + ext * pw)
      + grp * 2 * buf_rows * kCols;

  const int a = b / 2;
  const int out_cols = kCols - (b - 1);
  const int x0 = blockIdx.x * out_cols;
  const int y0 = blockIdx.y * R;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int gx = x0 - a + t;
  const bool in_col = gx >= 0 && gx < w;
  const bool rgba = n_ch == 4;

  // curr's block pixels, zero outside the image
  for (int i = threadIdx.x; i < ext * kCols; i += blockDim.x) {
    const int e = i / kCols;
    const int y = y0 - a + e;
    const int x = x0 - a + (i - e * kCols);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float* p = curr + static_cast<int64_t>(y) * w + x;
      v.x = p[0];
      v.y = p[plane];
      v.z = p[2 * plane];
      if (rgba) v.w = p[3 * plane];
    }
    cur_s[i] = v;
  }

  // bit e: block-pixel row e of this thread's column lies in the image
  // (compiled-in block sizes: at most 32 rows)
  static_assert(B == 0 || R + B - 1 <= 32, "row mask is 32 bits");
  uint32_t valid = 0;
  if (B > 0 && in_col) {
#pragma unroll
    for (int e = 0; e < ext; ++e) {
      const int y = y0 - a + e;
      if (y >= 0 && y < h) valid |= 1u << e;
    }
  }

  const int n = 2 * r + 1;
  // this thread's outputs in the column-sum phase: 4 adjacent columns from
  // xl, rows ro .. ro + kPer - 1 of the tile
  const int xl = 4 * (t & 31);
  const int ro = (t >> 5) * kPer;
  float best[R];
  int best_k[R];
#pragma unroll
  for (int o = 0; o < R; ++o) {
    best[o] = 1e10f;
    best_k[o] = r * n + r;  // (dx, dy) = (0, 0)
  }
  int buf = 0;
  for (int dyi = 0; dyi < n; ++dyi) {
    // stage prev rows y0 - a + e + dy and columns x0 - a - r + j, clamped,
    // once every group is done with the rows of the dy before
    __syncthreads();
    for (int i = threadIdx.x; i < ext * pw; i += blockDim.x) {
      const int e = i / pw;
      const int y = min(max(y0 - a + e + dyi - r, 0), h - 1);
      const int x = min(max(x0 - a - r + (i - e * pw), 0), w - 1);
      const float* p = prev + static_cast<int64_t>(y) * w + x;
      float4 v;
      v.x = p[0];
      v.y = p[plane];
      v.z = p[2 * plane];
      v.w = rgba ? p[3 * plane] : 0.0f;
      prev_s[i] = v;
    }
    __syncthreads();
    for (int dxi = grp; dxi < n; dxi += groups) {
      const int cand = dyi * n + dxi;
      float* bb = buf_s + buf * buf_rows * kCols;
      float rs[R];
#pragma unroll
      for (int o = 0; o < R; ++o) rs[o] = 0.0f;
#pragma unroll
      for (int e = 0; e < ext; ++e) {
        const float4 c = cur_s[e * kCols + t];
        const float4 p = prev_s[e * pw + t + dxi];
        float d = __fsub_rn(c.x, p.x);
        float acc = __fmul_rn(d, d);
        d = __fsub_rn(c.y, p.y);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        d = __fsub_rn(c.z, p.z);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        d = __fsub_rn(c.w, p.w);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
        const int y = y0 - a + e;
        const float mask = (B > 0 ? (valid >> e) & 1u
                                  : in_col && y >= 0 && y < h) ? 1.0f : 0.0f;
        const float dist = __fmul_rn(__fsqrt_rn(acc), mask);
        if (kExact) {
          bb[e * kCols + t] = dist;
        } else {
          // row sum of output row o: dist rows o .. o + b - 1 in order
#pragma unroll
          for (int o = 0; o < R; ++o) {
            if (e >= o && e < o + b) {
              rs[o] = e == o ? dist : __fadd_rn(rs[o], dist);
            }
          }
        }
      }
      if (!kExact) {
#pragma unroll
        for (int o = 0; o < R; ++o) bb[o * kCols + t] = rs[o];
      }
      group_barrier(grp);
      if (xl < out_cols) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float* q = bb + (ro + i) * kCols + xl;
          float cost[4];
          window4<B, true>(q, b, cost);
          if (kExact) {
            for (int ky = 1; ky < b; ++ky) {
              window4<B, false>(q + ky * kCols, b, cost);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (cost[j] < best[4 * i + j]) {
              best[4 * i + j] = cost[j];
              best_k[4 * i + j] = cand;
            }
          }
        }
      }
      buf ^= 1;
    }
  }

  // merge the groups' bests by (cost, candidate index) into group 0
  __syncthreads();
  float* m_cost = reinterpret_cast<float*>(smem4);
  int* m_k = reinterpret_cast<int*>(m_cost + (groups - 1) * R * kCols);
  if (grp > 0) {
#pragma unroll
    for (int o = 0; o < R; ++o) {
      m_cost[((grp - 1) * R + o) * kCols + t] = best[o];
      m_k[((grp - 1) * R + o) * kCols + t] = best_k[o];
    }
  }
  __syncthreads();
  if (grp != 0) return;
  for (int g = 0; g < groups - 1; ++g) {
#pragma unroll
    for (int o = 0; o < R; ++o) {
      const float c = m_cost[(g * R + o) * kCols + t];
      const int k = m_k[(g * R + o) * kCols + t];
      if (c < best[o] || (c == best[o] && k < best_k[o])) {
        best[o] = c;
        best_k[o] = k;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int y = y0 + ro + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + xl + j;
      if (xl + j < out_cols && x < w && y < h) {
        const int64_t at = static_cast<int64_t>(y) * w + x;
        out[at] = static_cast<float>(best_k[4 * i + j] % n - r);
        out[plane + at] = static_cast<float>(best_k[4 * i + j] / n - r);
      }
    }
  }
}

template <int B, bool kExact, int R>
int launch_tiled(const float* prev, const float* curr, float* out, int n_ch,
                 int h, int w, int b, int r, int groups, int smem,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tiled_kernel<B, kExact, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_cols = kCols - (b - 1);
  dim3 grid((w + out_cols - 1) / out_cols, (h + R - 1) / R);
  tiled_kernel<B, kExact, R><<<grid, kCols * groups, smem, stream>>>(
      prev, curr, out, n_ch, h, w, b, r);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact>
int launch_tiled_rows(const float* prev, const float* curr, float* out,
                      int n_ch, int h, int w, int b, int r, int rows,
                      int groups, int smem, cudaStream_t stream) {
  if (rows == kRowsFast) {
    switch (b) {
      case 8:
        return launch_tiled<8, kExact, kRowsFast>(prev, curr, out, n_ch, h, w,
                                                  b, r, groups, smem, stream);
      case 12:
        return launch_tiled<12, kExact, kRowsFast>(prev, curr, out, n_ch, h,
                                                   w, b, r, groups, smem,
                                                   stream);
      case 16:
        return launch_tiled<16, kExact, kRowsFast>(prev, curr, out, n_ch, h,
                                                   w, b, r, groups, smem,
                                                   stream);
      default:
        break;
    }
  }
  if (rows == kRowsAny) {
    return launch_tiled<0, kExact, kRowsAny>(prev, curr, out, n_ch, h, w, b,
                                             r, groups, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rows (output rows per tile: 16 with b in {8, 12, 16}, else 8), groups
// (128-thread groups per block, 1..5) and smem (dynamic shared memory in
// bytes) from tpufg_torch/kernels/motion.py:tiled_plan.  c in {3, 4},
// 1 <= b < 128.
extern "C" int tpufg_motion_tiled(const void* prev, const void* curr,
                                  void* out, int c, int h, int w, int b,
                                  int r, int exact, int rows, int groups,
                                  int smem, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || b >= kCols || (c != 3 && c != 4) || groups < 1 ||
      groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(prev);
  const float* q = static_cast<const float*>(curr);
  float* o = static_cast<float*>(out);
  return exact ? launch_tiled_rows<true>(p, q, o, c, h, w, b, r, rows, groups,
                                         smem, stream)
               : launch_tiled_rows<false>(p, q, o, c, h, w, b, r, rows,
                                          groups, smem, stream);
}
