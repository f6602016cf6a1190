// fgio — native ingest/egress runtime for tpufg.
//
// The port's own copy of tpufg/native/fgio.cpp, unchanged below this note;
// tpufg_torch/io/native.py builds it into tpufg_torch/_build/libfgio.so.
//
// TPU-native counterpart of the reference's native IO stack: where
// linux-fg moves pixels with XShm segments + Vulkan staging buffers
// (reference src/window_capture.cpp:276-303, 472-568; frame_manager.cpp
// 199-214), a TPU host's ingest hot path is disk/stream -> pixel
// conversion -> page-aligned host buffers feeding jax.device_put.  This
// library provides that path in C++:
//
//  - mmap'd raw-frame reader (zero-copy frame pointers)
//  - BGRA->RGBA swizzle and BT.601 YUV420/444 -> RGBA conversion
//    (auto-vectorized integer paths; the per-frame cost that dominated
//    python ingest)
//  - a background prefetch ring: a reader thread decodes frames ahead
//    into page-aligned slots while the device computes — the
//    double-buffered ingest that kills the reference's per-frame
//    staging-buffer churn (SURVEY.md §2.3.8)
//  - a monotonic pacing clock with float-nanosecond budgets (the
//    reference's integer-ms SDL_Delay pacing truncates 60 fps to 62.5 Hz,
//    main.cpp:114; this one doesn't)
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <time.h>
#include <unistd.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- raw mmap
struct FgRaw {
  uint8_t* data = nullptr;
  size_t file_size = 0;
  size_t frame_bytes = 0;
  int64_t n_frames = 0;
  int fd = -1;
};

FgRaw* fg_raw_open(const char* path, int32_t width, int32_t height) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  size_t fb = (size_t)width * height * 4;
  if (fb == 0 || st.st_size % fb != 0) { close(fd); return nullptr; }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) { close(fd); return nullptr; }
  madvise(p, st.st_size, MADV_SEQUENTIAL);
  FgRaw* r = new FgRaw();
  r->data = (uint8_t*)p;
  r->file_size = st.st_size;
  r->frame_bytes = fb;
  r->n_frames = st.st_size / fb;
  r->fd = fd;
  return r;
}

int64_t fg_raw_frames(FgRaw* r) { return r ? r->n_frames : -1; }

const uint8_t* fg_raw_frame(FgRaw* r, int64_t i) {
  if (!r || i < 0 || i >= r->n_frames) return nullptr;
  return r->data + (size_t)i * r->frame_bytes;
}

void fg_raw_close(FgRaw* r) {
  if (!r) return;
  munmap(r->data, r->file_size);
  close(r->fd);
  delete r;
}

// ------------------------------------------------------------ conversions
void fg_bgra_to_rgba(const uint8_t* src, uint8_t* dst, int64_t n_px) {
  for (int64_t i = 0; i < n_px; i++) {
    dst[4 * i + 0] = src[4 * i + 2];
    dst[4 * i + 1] = src[4 * i + 1];
    dst[4 * i + 2] = src[4 * i + 0];
    dst[4 * i + 3] = src[4 * i + 3];
  }
}

// BT.601 limited-range -> RGB, 16.16 fixed point (matches the python
// reference conversion to within one 8-bit code)
static inline void yuv_px(int y, int u, int v, uint8_t* out) {
  int c = y - 16, d = u - 128, e = v - 128;
  int r = (76284 * c + 104595 * e) >> 16;
  int g = (76284 * c - 25690 * d - 53281 * e) >> 16;
  int b = (76284 * c + 132186 * d) >> 16;
  out[0] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
  out[1] = (uint8_t)(g < 0 ? 0 : (g > 255 ? 255 : g));
  out[2] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
  out[3] = 255;
}

void fg_yuv420_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       uint8_t* dst, int32_t w, int32_t h) {
  int cw = w / 2;
  for (int32_t r = 0; r < h; r++) {
    const uint8_t* yr = y + (size_t)r * w;
    const uint8_t* ur = u + (size_t)(r / 2) * cw;
    const uint8_t* vr = v + (size_t)(r / 2) * cw;
    uint8_t* dr = dst + (size_t)r * w * 4;
    for (int32_t c2 = 0; c2 < w; c2++)
      yuv_px(yr[c2], ur[c2 / 2], vr[c2 / 2], dr + 4 * c2);
  }
}

void fg_yuv444_to_rgba(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       uint8_t* dst, int32_t w, int32_t h) {
  int64_t n = (int64_t)w * h;
  for (int64_t i = 0; i < n; i++) yuv_px(y[i], u[i], v[i], dst + 4 * i);
}

// RGB -> BT.601 (egress for y4m writing)
void fg_rgba_to_yuv444(const uint8_t* src, uint8_t* y, uint8_t* u, uint8_t* v,
                       int64_t n_px) {
  for (int64_t i = 0; i < n_px; i++) {
    int r = src[4 * i], g = src[4 * i + 1], b = src[4 * i + 2];
    int yy = ((16829 * r + 33039 * g + 6416 * b) >> 16) + 16;
    int uu = ((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128;
    int vv = ((28784 * r - 24103 * g - 4681 * b) >> 16) + 128;
    y[i] = (uint8_t)(yy < 0 ? 0 : (yy > 255 ? 255 : yy));
    u[i] = (uint8_t)(uu < 0 ? 0 : (uu > 255 ? 255 : uu));
    v[i] = (uint8_t)(vv < 0 ? 0 : (vv > 255 ? 255 : vv));
  }
}

// 2x2 box average of a uint8 plane, (s + 2) >> 2 rounding — the "420jpeg"
// chroma downsample for y4m egress (w, h are the FULL-size plane dims,
// must be even; dst is (h/2) x (w/2))
void fg_down2x2(const uint8_t* src, uint8_t* dst, int32_t w, int32_t h) {
  int32_t cw = w / 2, ch = h / 2;
  for (int32_t r = 0; r < ch; r++) {
    const uint8_t* r0 = src + (size_t)(2 * r) * w;
    const uint8_t* r1 = r0 + w;
    uint8_t* d = dst + (size_t)r * cw;
    for (int32_t c = 0; c < cw; c++) {
      int s = r0[2 * c] + r0[2 * c + 1] + r1[2 * c] + r1[2 * c + 1];
      d[c] = (uint8_t)((s + 2) >> 2);
    }
  }
}

// --------------------------------------------------------- prefetch ring
// Reader thread decodes frames ahead into page-aligned slots.
struct FgRing {
  FgRaw* raw = nullptr;
  int channel_swap = 0;  // 1: source is BGRA
  int n_slots = 0;
  size_t slot_bytes = 0;
  std::vector<uint8_t*> slots;
  std::atomic<int64_t> head{0};   // next frame the reader fills
  std::atomic<int64_t> tail{0};   // next frame the consumer takes
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::thread reader;
};

static void ring_reader(FgRing* g) {
  while (!g->stop.load()) {
    int64_t h = g->head.load();
    if (h >= g->raw->n_frames) break;
    {
      std::unique_lock<std::mutex> lk(g->mu);
      g->cv_full.wait(lk, [&] {
        return g->stop.load() || h - g->tail.load() < g->n_slots;
      });
      if (g->stop.load()) break;
    }
    uint8_t* slot = g->slots[h % g->n_slots];
    const uint8_t* src = fg_raw_frame(g->raw, h);
    if (g->channel_swap)
      fg_bgra_to_rgba(src, slot, g->slot_bytes / 4);
    else
      memcpy(slot, src, g->slot_bytes);
    g->head.store(h + 1);
    g->cv_empty.notify_one();
  }
  g->head.store(g->raw->n_frames);
  g->cv_empty.notify_all();
}

FgRing* fg_ring_create(const char* path, int32_t w, int32_t h,
                       int32_t n_slots, int32_t src_is_bgra) {
  FgRaw* raw = fg_raw_open(path, w, h);
  if (!raw) return nullptr;
  FgRing* g = new FgRing();
  g->raw = raw;
  g->channel_swap = src_is_bgra;
  g->n_slots = n_slots;
  g->slot_bytes = raw->frame_bytes;
  long page = sysconf(_SC_PAGESIZE);
  for (int i = 0; i < n_slots; i++) {
    void* p = nullptr;
    if (posix_memalign(&p, (size_t)page, g->slot_bytes) != 0) {
      for (auto* s : g->slots) free(s);
      fg_raw_close(raw);
      delete g;
      return nullptr;
    }
    g->slots.push_back((uint8_t*)p);
  }
  g->reader = std::thread(ring_reader, g);
  return g;
}

// Blocks until the next frame is decoded; returns its slot pointer, or
// nullptr at end of stream.  The slot stays valid until fg_ring_release.
const uint8_t* fg_ring_acquire(FgRing* g) {
  int64_t t = g->tail.load();
  if (t >= g->raw->n_frames) return nullptr;
  std::unique_lock<std::mutex> lk(g->mu);
  g->cv_empty.wait(lk, [&] { return g->head.load() > t || g->stop.load(); });
  if (g->head.load() <= t) return nullptr;
  return g->slots[t % g->n_slots];
}

void fg_ring_release(FgRing* g) {
  g->tail.fetch_add(1);
  g->cv_full.notify_one();
}

int64_t fg_ring_frames(FgRing* g) { return g ? g->raw->n_frames : -1; }

void fg_ring_destroy(FgRing* g) {
  if (!g) return;
  g->stop.store(true);
  g->cv_full.notify_all();
  g->cv_empty.notify_all();
  if (g->reader.joinable()) g->reader.join();
  for (auto* s : g->slots) free(s);
  fg_raw_close(g->raw);
  delete g;
}

// ------------------------------------------------------------ pacing clock
struct FgClock {
  double period_s;
  struct timespec next;
};

FgClock* fg_clock_create(double fps) {
  FgClock* c = new FgClock();
  c->period_s = fps > 0 ? 1.0 / fps : 0.0;
  clock_gettime(CLOCK_MONOTONIC, &c->next);
  return c;
}

// Sleeps until the next frame deadline (absolute, drift-free).  Returns
// the lateness in seconds (0 when on time).
double fg_clock_pace(FgClock* c) {
  if (c->period_s <= 0) return 0.0;
  double ns = c->next.tv_nsec + c->period_s * 1e9;
  c->next.tv_sec += (time_t)(ns / 1e9);
  c->next.tv_nsec = (long)((long long)ns % 1000000000LL);
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  double late = (now.tv_sec - c->next.tv_sec) +
                (now.tv_nsec - c->next.tv_nsec) * 1e-9;
  if (late < 0) {
    clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &c->next, nullptr);
    return 0.0;
  }
  return late;
}

void fg_clock_destroy(FgClock* c) { delete c; }

}  // extern "C"
