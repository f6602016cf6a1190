// A chain of SAME-padded 3x3 stride-1 convolutions in f32, fused in one
// launch, on the CUDA cores.
//
// Replaces tpufg/kernels/conv.py:_chain_kernel (the Pallas kernel behind
// conv3x3_chain) for compute_dtype = float32.  The bf16 chain, the one the
// learned head runs, is conv_chain_mma.cu (tensor cores); the tensor cores
// have no f32 product, and TF32 would break the f32 chain's 2e-5 contract,
// so this dtype stays here.  Layer i computes
//   a_{i+1}[co][y][x] = b_i[co] + sum_{dy,dx,ci} w_i[co][ci][dy][dx] *
//                                       a_i[ci][y + dy - 1][x + dx - 1]
// with a_i read as 0 outside the image, then the relu where asked.  Between
// layers the activation is set to 0 outside the image (the next layer's
// SAME padding), as the Pallas kernel does; products and sums are f32, taps
// in (dy, dx) order with the input channels inner, the bias added last.
//
// Bound on the H100: arithmetic, on the f32 CUDA cores (67 TFLOP/s).
// Design: a block computes a tile of TH x TW outputs; it stages the input
// tile with a halo of L pixels in shared memory, then each layer reads its
// input region from one shared buffer and writes the region it produces,
// which is 2 pixels smaller each way, to the other; only the last layer
// writes to device memory.  A 16 x 16 tile of three 64-channel layers needs
// 185 KB of dynamic shared memory (one block of 512 threads per SM).
// Inside a layer a thread owns P pixels x 8 output channels in registers
// (P = 4, or 1 for a layer of at most 8 channels); per tap and input
// channel it reads P activations from shared memory and the 8 weights as
// two float4 loads, the same address across the warp (weights are laid out
// [tap][ci][co], Cout padded to 8).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLayers = 3;

struct ChainArgs {
  const float* wt[kMaxLayers];    // [9][c_i][round_up(c_{i+1}, 8)]
  const float* bias[kMaxLayers];  // [c_{i+1}]
  int c[kMaxLayers + 1];
  int n_layers, relu_mask, h, w, th, tw, buf1_off;
};

// One layer of the chain.  `in` holds c_in planes of in_rows x in_cols;
// the layer produces out_rows x out_cols = (in_rows - 2) x (in_cols - 2)
// pixels whose top-left sits at image position (gy0, gx0).  Intermediate
// layers store to `out_s` (same planar layout), the last one to `out_g`.
template <int P>
__device__ void conv_layer(const float* __restrict__ in, int c_in, int in_cols,
                           const float* __restrict__ wt,
                           const float* __restrict__ bias, int c_out,
                           bool relu, float* __restrict__ out_s,
                           float* __restrict__ out_g, int out_rows,
                           int out_cols, int gy0, int gx0, int h, int w) {
  const int n = out_rows * out_cols;
  const int in_plane = (out_rows + 2) * in_cols;
  const int groups = (n + P - 1) / P;
  const int n_cg = (c_out + 7) / 8;
  const int c_pad = n_cg * 8;
  for (int task = threadIdx.x; task < groups * n_cg; task += blockDim.x) {
    // consecutive threads take consecutive pixels of one channel group, so
    // a warp's weight loads share one address
    const int cg = task / groups;
    const int pg = task - cg * groups;
    int off[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = min(pg + k * groups, n - 1);
      const int r = q / out_cols;
      off[k] = r * in_cols + (q - r * out_cols);
    }
    float acc[P][8];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.0f;

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wtap = wt + (dy * 3 + dx) * c_in * c_pad + cg * 8;
        const float* src = in + dy * in_cols + dx;
#pragma unroll 2
        for (int ci = 0; ci < c_in; ++ci) {
          const float4 wa = __ldg(reinterpret_cast<const float4*>(
              wtap + ci * c_pad));
          const float4 wb = __ldg(reinterpret_cast<const float4*>(
              wtap + ci * c_pad + 4));
          const float* s = src + ci * in_plane;
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float v = s[off[k]];
            acc[k][0] = fmaf(wa.x, v, acc[k][0]);
            acc[k][1] = fmaf(wa.y, v, acc[k][1]);
            acc[k][2] = fmaf(wa.z, v, acc[k][2]);
            acc[k][3] = fmaf(wa.w, v, acc[k][3]);
            acc[k][4] = fmaf(wb.x, v, acc[k][4]);
            acc[k][5] = fmaf(wb.y, v, acc[k][5]);
            acc[k][6] = fmaf(wb.z, v, acc[k][6]);
            acc[k][7] = fmaf(wb.w, v, acc[k][7]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = pg + k * groups;
      if (q >= n) continue;
      const int r = q / out_cols;
      const int gy = gy0 + r;
      const int gx = gx0 + (q - r * out_cols);
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = cg * 8 + j;
        if (co >= c_out) continue;
        float v = __fadd_rn(acc[k][j], __ldg(bias + co));
        if (relu) v = fmaxf(v, 0.0f);
        if (out_s != nullptr) {
          out_s[co * n + q] = inside ? v : 0.0f;
        } else if (inside) {
          out_g[(static_cast<int64_t>(co) * h + gy) * w + gx] = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                  ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const buf0 = reinterpret_cast<float*>(smem);
  float* const buf1 = reinterpret_cast<float*>(smem + a.buf1_off);
  const int L = a.n_layers;
  const int oy0 = blockIdx.y * a.th;
  const int ox0 = blockIdx.x * a.tw;

  // the input tile with a halo of L pixels, zero outside the image
  {
    const int rows = a.th + 2 * L, cols = a.tw + 2 * L;
    const int n = a.c[0] * rows * cols;
    const int64_t plane = static_cast<int64_t>(a.h) * a.w;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int ci = i / (rows * cols);
      const int rc = i - ci * rows * cols;
      const int r = rc / cols;
      const int gy = oy0 - L + r;
      const int gx = ox0 - L + (rc - r * cols);
      float v = 0.0f;
      if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
        v = __ldg(x + ci * plane + static_cast<int64_t>(gy) * a.w + gx);
      }
      buf0[i] = v;
    }
  }
  __syncthreads();

  for (int i = 0; i < L; ++i) {
    const int halo = L - 1 - i;  // halo of this layer's output region
    const int out_rows = a.th + 2 * halo, out_cols = a.tw + 2 * halo;
    const bool last = i == L - 1;
    const bool relu = (a.relu_mask >> i) & 1;
    const float* in = (i & 1) ? buf1 : buf0;
    float* out_s = last ? nullptr : ((i & 1) ? buf0 : buf1);
    float* out_g = last ? out : nullptr;
    if (a.c[i + 1] > 8) {
      conv_layer<4>(in, a.c[i], out_cols + 2, a.wt[i], a.bias[i],
                       a.c[i + 1], relu, out_s, out_g, out_rows, out_cols,
                       oy0 - halo, ox0 - halo, a.h, a.w);
    } else {
      conv_layer<1>(in, a.c[i], out_cols + 2, a.wt[i], a.bias[i],
                       a.c[i + 1], relu, out_s, out_g, out_rows, out_cols,
                       oy0 - halo, ox0 - halo, a.h, a.w);
    }
    __syncthreads();
  }
}

int launch_chain(const float* x, float* out, const ChainArgs& a, int smem,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.w + a.tw - 1) / a.tw, (a.h + a.th - 1) / a.th);
  conv_chain_kernel<<<grid, kThreads, smem, stream>>>(x, out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x f32 [c0, h, w]; out f32 [c_L, h, w]; w_i f32 [9][c_i][round_up(c_{i+1},
// 8)], b_i f32 [c_{i+1}], both null past the last layer; 1 <= n_layers <= 3;
// bit i of relu_mask applies a relu after layer i; tile_h x tile_w outputs
// per block; buf1_off and smem from
// tpufg_torch/kernels/conv.py:chain_smem_layout.
extern "C" int tpufg_conv_chain(const void* x, void* out, const void* w0,
                                const void* b0, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, int n_layers, int c0, int c1,
                                int c2, int c3, int relu_mask, int h, int w,
                                int tile_h, int tile_w, int buf1_off,
                                int smem, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_layers < 1 || n_layers > kMaxLayers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainArgs a;
  a.wt[0] = static_cast<const float*>(w0);
  a.wt[1] = static_cast<const float*>(w1);
  a.wt[2] = static_cast<const float*>(w2);
  a.bias[0] = static_cast<const float*>(b0);
  a.bias[1] = static_cast<const float*>(b1);
  a.bias[2] = static_cast<const float*>(b2);
  a.c[0] = c0;
  a.c[1] = c1;
  a.c[2] = c2;
  a.c[3] = c3;
  a.n_layers = n_layers;
  a.relu_mask = relu_mask;
  a.h = h;
  a.w = w;
  a.th = tile_h;
  a.tw = tile_w;
  a.buf1_off = buf1_off;
  return launch_chain(static_cast<const float*>(x), static_cast<float*>(out),
                      a, smem, stream);
}
