// The gate arithmetic of RAFT's SepConvGRU (core/update.py) around its
// convs, in two passes per half instead of eleven.
//
// Per half the published code runs z = sigmoid(convz(hx)), r =
// sigmoid(convr(hx)), q = tanh(convq(cat(r h, x))), h = (1 - z) h + z q:
// in the port (models/raft.py) the z and r convs are one cuDNN conv with 256
// outputs and both convs run without their bias, so that PyTorch's bias
// add, the f32 copies, sigmoid, tanh, the products, the sum and the bf16
// copies into the next conv's input are these two kernels:
//   raft_gru_gates:  r h, rounded to bf16, into channels 0-127 of the
//                    q conv's input (the 384-channel [h, inp, motion]);
//   raft_gru_update: h = (1 - z) h + z q in f32, and q(h) into channels
//                    0-127 of that buffer and, where given, into a
//                    contiguous bf16 copy (the flow head's input).
// Each value is rounded as the PyTorch ops round it (kernels/raft_gru.py's
// plain versions): the conv output plus its bias rounded to bf16, then
// sigmoid as ATen computes it (1 / (1 + exp(-x))) and tanh in f32, one
// rounding per product and sum (no fused multiply-add).
//
// No TPU kernel: tpufg has no RAFT.  Bound on the H100: memory (a pixel
// reads 256 + 128 bf16 conv outputs and 128 f32 states and writes as much).
// Design: channels-last rows, a thread per 8 channels of a pixel, 16-byte
// loads and stores of bf16, two float4 of f32.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHidden = 128;
constexpr int kGroups = kHidden / 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void load8f(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the gate of channels c0..c0+7 from the conv output at channel off
__device__ __forceinline__ void gate8(const __nv_bfloat16* zr,
                                      const __nv_bfloat16* bias, int off,
                                      float* g) {
  float y[8], b[8];
  load8(zr + off, y);
  load8(bias + off, b);
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = sigmoid(bf(__fadd_rn(y[k], b[k])));
}

// zr bf16 [n, 256] (z, then r); h f32 [n, 128]; out bf16 rows of stride os
__global__ void raft_gru_gates(const __nv_bfloat16* __restrict__ zr,
                               const __nv_bfloat16* __restrict__ bias_zr,
                               const float* __restrict__ h, int64_t n,
                               __nv_bfloat16* __restrict__ out, int64_t os) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * kGroups) return;
  const int64_t p = t / kGroups;
  const int c0 = static_cast<int>(t % kGroups) * 8;
  float r[8], hv[8], rh[8];
  gate8(zr + p * 2 * kHidden, bias_zr, kHidden + c0, r);
  load8f(h + p * kHidden + c0, hv);
#pragma unroll
  for (int k = 0; k < 8; ++k) rh[k] = __fmul_rn(r[k], hv[k]);
  store8(out + p * os + c0, rh);
}

// q bf16 [n, 128]; h f32 [n, 128] updated in place; out bf16 rows of
// stride os; copy (or null) bf16 [n, 128]
__global__ void raft_gru_update(const __nv_bfloat16* __restrict__ zr,
                                const __nv_bfloat16* __restrict__ bias_zr,
                                const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ bias_q,
                                float* __restrict__ h, int64_t n,
                                __nv_bfloat16* __restrict__ out, int64_t os,
                                __nv_bfloat16* __restrict__ copy) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * kGroups) return;
  const int64_t p = t / kGroups;
  const int c0 = static_cast<int>(t % kGroups) * 8;
  float z[8], qv[8], bq[8], hv[8];
  gate8(zr + p * 2 * kHidden, bias_zr, c0, z);
  load8(q + p * kHidden + c0, qv);
  load8(bias_q + c0, bq);
  float* hp = h + p * kHidden + c0;
  load8f(hp, hv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float qt = tanhf(bf(__fadd_rn(qv[k], bq[k])));
    hv[k] = __fadd_rn(__fmul_rn(__fsub_rn(1.f, z[k]), hv[k]),
                      __fmul_rn(z[k], qt));
  }
  reinterpret_cast<float4*>(hp)[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
  reinterpret_cast<float4*>(hp)[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
  store8(out + p * os + c0, hv);
  if (copy != nullptr) store8(copy + p * kHidden + c0, hv);
}

int blocks_for(int64_t n) {
  return static_cast<int>((n * kGroups + kThreads - 1) / kThreads);
}

}  // namespace

// (zr bf16 [n, 256] channels-last, its bias bf16 [256], h f32 [n, 128]
//  channels-last, n pixels, out bf16 (channel 0 of rows of stride os), os,
//  device, stream)
extern "C" int tpufg_raft_gru_gates(const void* zr, const void* bias_zr,
                                    const void* h, int64_t n, void* out,
                                    int64_t os, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || os % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  raft_gru_gates<<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(zr),
      static_cast<const __nv_bfloat16*>(bias_zr),
      static_cast<const float*>(h), n, static_cast<__nv_bfloat16*>(out), os);
  return static_cast<int>(cudaGetLastError());
}

// (zr, bias_zr as above, q bf16 [n, 128] channels-last, its bias bf16
//  [128], h f32 [n, 128] (updated in place), n, out, os, copy bf16
//  [n, 128] or null, device, stream)
extern "C" int tpufg_raft_gru_update(const void* zr, const void* bias_zr,
                                     const void* q, const void* bias_q,
                                     void* h, int64_t n, void* out,
                                     int64_t os, void* copy, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || os % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  raft_gru_update<<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(zr),
      static_cast<const __nv_bfloat16*>(bias_zr),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(bias_q), static_cast<float*>(h), n,
      static_cast<__nv_bfloat16*>(out), os,
      static_cast<__nv_bfloat16*>(copy));
  return static_cast<int>(cudaGetLastError());
}
