// Packed RGBA wire -> y4m FRAME payload (BT.601 limited range, C420/C444).
//
// Replaces tpufg/kernels/yuv.py:rgba_to_y4m_payload, an XLA op of the
// reference (not a Pallas kernel): an int32 [H, W] frame whose byte c is
// channel c becomes one uint8 payload holding the Y plane [H, W], then Cb,
// then Cr, each [H/2, W/2] (C420, 2x2 box means rounded by (s + 2) >> 2) or
// [H, W] (C444).  The arithmetic is the host egress's (io/sinks.py
// _rgb_to_bt601 / _down2x2, native/fgio.cpp): 16.16 fixed point in int32,
// an arithmetic >> 16, the limited-range offsets, a clip to [0, 255].  All
// of it is exact integer math, so the kernel, the plain torch version and
// the host egress agree byte for byte.
//
// Bound on the H100: memory.  A 4K C420 frame reads 33.2 MB and writes
// 12.4 MB with ~30 integer operations a pixel.  Design: one pass, one
// thread per 4 columns x 2 rows (C420) or 4 columns x 1 row (C444).  The
// thread reads its pixels as 16-byte loads (neighbouring threads on
// neighbouring addresses), writes 4 Y bytes a row as one 4-byte store and
// its 2 Cb and 2 Cr bytes as 2-byte stores; C444 writes one 4-byte store
// per plane.  Where the width is not a multiple of 4 or the frame is not
// 16-byte aligned, the wrapper asks for the scalar walk: 2 columns x 2
// rows (C420) or one pixel (C444) a thread, 4-byte loads, byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Yuv {
  int y, u, v;
};

__device__ __forceinline__ int clip255(int x) {
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

// one pixel's clipped codes (fgio.cpp yuv_px's constants)
__device__ __forceinline__ Yuv bt601(uint32_t q) {
  int r = static_cast<int>(q & 0xFFu);
  int g = static_cast<int>((q >> 8) & 0xFFu);
  int b = static_cast<int>((q >> 16) & 0xFFu);
  Yuv o;
  o.y = clip255(((16829 * r + 33039 * g + 6416 * b) >> 16) + 16);
  o.u = clip255(((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128);
  o.v = clip255(((28784 * r - 24103 * g - 4681 * b) >> 16) + 128);
  return o;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

// C420, 4 columns x 2 rows a thread: 2 x 16-byte loads
__global__ void yuv420_vec_kernel(const int4* __restrict__ src,
                                  uint8_t* __restrict__ out, int h, int w) {
  const int gw = w >> 2;  // 4-column groups a row
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(h >> 1) * gw) return;
  const int pr = static_cast<int>(i / gw), gx = static_cast<int>(i % gw);
  const int y0 = 2 * pr;
  const int4 a = __ldg(src + static_cast<int64_t>(y0) * gw + gx);
  const int4 b = __ldg(src + static_cast<int64_t>(y0 + 1) * gw + gx);
  const Yuv p0 = bt601(a.x), p1 = bt601(a.y), p2 = bt601(a.z),
            p3 = bt601(a.w);
  const Yuv q0 = bt601(b.x), q1 = bt601(b.y), q2 = bt601(b.z),
            q3 = bt601(b.w);
  uint32_t* yrow = reinterpret_cast<uint32_t*>(out);
  yrow[static_cast<int64_t>(y0) * gw + gx] = pack4(p0.y, p1.y, p2.y, p3.y);
  yrow[static_cast<int64_t>(y0 + 1) * gw + gx] =
      pack4(q0.y, q1.y, q2.y, q3.y);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t cw = w >> 1;
  const int64_t c_off = static_cast<int64_t>(pr) * cw + 2 * gx;
  const int u0 = (p0.u + p1.u + q0.u + q1.u + 2) >> 2;
  const int u1 = (p2.u + p3.u + q2.u + q3.u + 2) >> 2;
  const int v0 = (p0.v + p1.v + q0.v + q1.v + 2) >> 2;
  const int v1 = (p2.v + p3.v + q2.v + q3.v + 2) >> 2;
  uint16_t* cb = reinterpret_cast<uint16_t*>(out + hw);
  uint16_t* cr = reinterpret_cast<uint16_t*>(out + hw + (hw >> 2));
  cb[c_off >> 1] = static_cast<uint16_t>(u0 | (u1 << 8));
  cr[c_off >> 1] = static_cast<uint16_t>(v0 | (v1 << 8));
}

// C420, 2 columns x 2 rows a thread: 4-byte loads, byte stores
__global__ void yuv420_scalar_kernel(const int32_t* __restrict__ src,
                                     uint8_t* __restrict__ out, int h,
                                     int w) {
  const int cw = w >> 1;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(h >> 1) * cw) return;
  const int pr = static_cast<int>(i / cw), cx = static_cast<int>(i % cw);
  const int64_t r0 = static_cast<int64_t>(2 * pr) * w + 2 * cx;
  const Yuv p0 = bt601(__ldg(src + r0)), p1 = bt601(__ldg(src + r0 + 1));
  const Yuv q0 = bt601(__ldg(src + r0 + w)),
            q1 = bt601(__ldg(src + r0 + w + 1));
  out[r0] = static_cast<uint8_t>(p0.y);
  out[r0 + 1] = static_cast<uint8_t>(p1.y);
  out[r0 + w] = static_cast<uint8_t>(q0.y);
  out[r0 + w + 1] = static_cast<uint8_t>(q1.y);
  const int64_t hw = static_cast<int64_t>(h) * w;
  out[hw + i] = static_cast<uint8_t>((p0.u + p1.u + q0.u + q1.u + 2) >> 2);
  out[hw + (hw >> 2) + i] =
      static_cast<uint8_t>((p0.v + p1.v + q0.v + q1.v + 2) >> 2);
}

// C444, 4 columns a thread: one 16-byte load, one 4-byte store a plane
__global__ void yuv444_vec_kernel(const int4* __restrict__ src,
                                  uint8_t* __restrict__ out, int64_t n4) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int4 a = __ldg(src + i);
  const Yuv p0 = bt601(a.x), p1 = bt601(a.y), p2 = bt601(a.z),
            p3 = bt601(a.w);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  o[i] = pack4(p0.y, p1.y, p2.y, p3.y);
  o[n4 + i] = pack4(p0.u, p1.u, p2.u, p3.u);
  o[2 * n4 + i] = pack4(p0.v, p1.v, p2.v, p3.v);
}

// C444, one pixel a thread
__global__ void yuv444_scalar_kernel(const int32_t* __restrict__ src,
                                     uint8_t* __restrict__ out, int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Yuv p = bt601(__ldg(src + i));
  out[i] = static_cast<uint8_t>(p.y);
  out[n + i] = static_cast<uint8_t>(p.u);
  out[2 * n + i] = static_cast<uint8_t>(p.v);
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// (src i32 [h, w], out u8 payload, h, w, c420, vec, device, stream).
// C420 needs h % 2 == 0 and w % 2 == 0 (the wrapper asks h % 4 == 0, as
// tpufg does); vec needs w % 4 == 0 and 16-byte aligned src and out.
extern "C" int tpufg_yuv(const void* src, void* out, int h, int w, int c420,
                         int vec, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t hw = static_cast<int64_t>(h) * w;
  uint8_t* o = static_cast<uint8_t*>(out);
  if (c420 && vec) {
    const int64_t n = static_cast<int64_t>(h / 2) * (w / 4);
    yuv420_vec_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const int4*>(src), o, h, w);
  } else if (c420) {
    const int64_t n = static_cast<int64_t>(h / 2) * (w / 2);
    yuv420_scalar_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const int32_t*>(src), o, h, w);
  } else if (vec) {
    yuv444_vec_kernel<<<blocks_for(hw / 4), kThreads, 0, stream>>>(
        static_cast<const int4*>(src), o, hw / 4);
  } else {
    yuv444_scalar_kernel<<<blocks_for(hw), kThreads, 0, stream>>>(
        static_cast<const int32_t*>(src), o, hw);
  }
  return static_cast<int>(cudaGetLastError());
}

// (c420, vec, what) -> what 0 registers a thread, 1 blocks of kThreads per
// SM, 2 local memory bytes a thread; -1 on error
extern "C" int tpufg_yuv_occupancy(int c420, int vec, int what) {
  const void* fn =
      c420 ? (vec ? reinterpret_cast<const void*>(yuv420_vec_kernel)
                  : reinterpret_cast<const void*>(yuv420_scalar_kernel))
           : (vec ? reinterpret_cast<const void*>(yuv444_vec_kernel)
                  : reinterpret_cast<const void*>(yuv444_scalar_kernel));
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  if (what == 0) return attr.numRegs;
  if (what == 2) return static_cast<int>(attr.localSizeBytes);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return per_sm;
}
