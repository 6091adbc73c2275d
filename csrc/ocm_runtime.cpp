// Native host runtime for obs_color_monitor_tpu.
//
// The reference's host-side machinery is C: a staging queue with
// drop-on-full backpressure drained by a pthread (reference
// src/common.c:223-403).  This library provides this framework's
// equivalents on the ingest side of the host<->device boundary:
//
//   * a bounded lock-protected frame queue (drop-on-full, matching the
//     reference's CM_SURFACE_QUEUE_SIZE semantics, common.h:46);
//   * NV12 -> RGBA8888 conversion (BT.601/709, limited-range, integer
//     fixed point — the wire format decoders hand us);
//   * RGBA deinterleave to planar (the hot path's layout);
//   * synthetic pattern generators (color bars / gradient / zone plate)
//     used by tests and the benchmark as a frame source.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// Bounded frame queue
// ---------------------------------------------------------------------------

struct OcmQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable cv_drain;  // destroy waits for pop waiters
  std::deque<std::vector<uint8_t>> items;
  size_t depth;
  size_t frame_bytes;
  bool closed = false;
  int waiters = 0;  // threads inside ocm_queue_pop (under mu)
  std::atomic<uint64_t> pushed{0};
  std::atomic<uint64_t> dropped{0};
};

OcmQueue* ocm_queue_create(int depth, size_t frame_bytes) {
  auto* q = new OcmQueue();
  q->depth = static_cast<size_t>(depth);
  q->frame_bytes = frame_bytes;
  return q;
}

// Safe against consumers blocked in ocm_queue_pop: closes the queue, wakes
// them, and waits until every waiter has left before freeing.  Producers
// (ocm_queue_push callers, e.g. a reader thread) must be stopped FIRST —
// the Python wrapper enforces that ordering by keeping the queue object
// alive for the reader's lifetime and joining the reader before destroy.
void ocm_queue_destroy(OcmQueue* q) {
  {
    std::unique_lock<std::mutex> lk(q->mu);
    q->closed = true;
    q->cv.notify_all();
    q->cv_drain.wait(lk, [q] { return q->waiters == 0; });
  }
  delete q;
}

// 1 = queued, 0 = dropped (queue full; reference src/common.c:260-268).
int ocm_queue_push(OcmQueue* q, const uint8_t* data) {
  std::unique_lock<std::mutex> lk(q->mu);
  if (q->closed) return 0;
  if (q->items.size() >= q->depth) {
    q->dropped.fetch_add(1);
    return 0;
  }
  q->items.emplace_back(data, data + q->frame_bytes);
  q->pushed.fetch_add(1);
  lk.unlock();
  q->cv.notify_one();
  return 1;
}

// 1 = popped into out, 0 = timeout or closed-and-empty.
int ocm_queue_pop(OcmQueue* q, uint8_t* out, double timeout_s) {
  std::unique_lock<std::mutex> lk(q->mu);
  ++q->waiters;
  auto done = [q](int ret) {
    if (--q->waiters == 0 && q->closed) q->cv_drain.notify_all();
    return ret;
  };
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(timeout_s));
  while (q->items.empty() && !q->closed) {
    if (q->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
      // a push can land exactly at the deadline: timeout status does not
      // mean the predicate is still false — re-check before failing
      if (!q->items.empty()) break;
      return done(0);
    }
  }
  if (q->items.empty()) return done(0);
  std::memcpy(out, q->items.front().data(), q->frame_bytes);
  q->items.pop_front();
  return done(1);
}

void ocm_queue_close(OcmQueue* q) {
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv.notify_all();
}

int ocm_queue_size(OcmQueue* q) {
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int>(q->items.size());
}

uint64_t ocm_queue_pushed(OcmQueue* q) { return q->pushed.load(); }
uint64_t ocm_queue_dropped(OcmQueue* q) { return q->dropped.load(); }

// ---------------------------------------------------------------------------
// NV12 -> RGBA (limited-range BT.601/709, 12-bit fixed point)
//
// Spec (documented for the golden test): with Y' = Y - 16, C = Cx - 128,
//   R = clip((4769*Y' + a_r*Cr            + 2048) >> 12)
//   G = clip((4769*Y' + a_g*Cb + b_g*Cr   + 2048) >> 12)
//   B = clip((4769*Y' + a_b*Cb            + 2048) >> 12)
// where 4769 = round(255/219 * 4096) and the chroma coefficients are
// round(c * 4096) of the standard limited-range matrices:
//   601: Cr->R 1.596027, Cb,Cr->G -0.391762/-0.812968, Cb->B 2.017232
//   709: Cr->R 1.792741, Cb,Cr->G -0.213249/-0.532909, Cb->B 2.112402
// ---------------------------------------------------------------------------

static inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void ocm_nv12_to_rgba(const uint8_t* y_plane, const uint8_t* uv_plane, int w,
                      int h, int y_stride, int uv_stride, uint8_t* rgba,
                      int cs /*1=601, 2=709*/) {
  const int ky = 4769;  // round(255/219 * 4096)
  int kr_cr, kg_cb, kg_cr, kb_cb;
  if (cs == 1) {
    kr_cr = 6537;   // round(1.596027 * 4096)
    kg_cb = -1605;  // round(-0.391762 * 4096)
    kg_cr = -3330;  // round(-0.812968 * 4096)
    kb_cb = 8263;   // round(2.017232 * 4096)
  } else {
    kr_cr = 7343;   // round(1.792741 * 4096)
    kg_cb = -873;   // round(-0.213249 * 4096)
    kg_cr = -2183;  // round(-0.532909 * 4096)
    kb_cb = 8652;   // round(2.112402 * 4096)
  }
  for (int j = 0; j < h; ++j) {
    const uint8_t* yrow = y_plane + static_cast<size_t>(j) * y_stride;
    const uint8_t* uvrow = uv_plane + static_cast<size_t>(j / 2) * uv_stride;
    uint8_t* out = rgba + static_cast<size_t>(j) * w * 4;
    for (int i = 0; i < w; ++i) {
      int yp = (static_cast<int>(yrow[i]) - 16) * ky;
      int cb = static_cast<int>(uvrow[(i / 2) * 2]) - 128;
      int cr = static_cast<int>(uvrow[(i / 2) * 2 + 1]) - 128;
      out[i * 4 + 0] = clip8((yp + kr_cr * cr + 2048) >> 12);
      out[i * 4 + 1] = clip8((yp + kg_cb * cb + kg_cr * cr + 2048) >> 12);
      out[i * 4 + 2] = clip8((yp + kb_cb * cb + 2048) >> 12);
      out[i * 4 + 3] = 255;
    }
  }
}

// ---------------------------------------------------------------------------
// RGBA interleaved -> planar (R, G, B, A planes)
// ---------------------------------------------------------------------------

void ocm_deinterleave_rgba(const uint8_t* rgba, int64_t n_pixels, uint8_t* r,
                           uint8_t* g, uint8_t* b, uint8_t* a) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    r[i] = rgba[i * 4 + 0];
    g[i] = rgba[i * 4 + 1];
    b[i] = rgba[i * 4 + 2];
    a[i] = rgba[i * 4 + 3];
  }
}

void ocm_interleave_rgba(const uint8_t* r, const uint8_t* g, const uint8_t* b,
                         const uint8_t* a, int64_t n_pixels, uint8_t* rgba) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    rgba[i * 4 + 0] = r[i];
    rgba[i * 4 + 1] = g[i];
    rgba[i * 4 + 2] = b[i];
    rgba[i * 4 + 3] = a[i];
  }
}

// ---------------------------------------------------------------------------
// Native file reader: a producer thread reading raw RGBA or NV12 frames from
// disk, converting off the Python thread, and pushing into an OcmQueue with
// optional frame pacing and looping.  The native twin of the reference's
// capture producer (the graphics thread feeding the staging queue,
// reference src/common.c:223-333).
// ---------------------------------------------------------------------------

struct OcmReader {
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> frames_read{0};
  std::atomic<int> finished{0};  // 1 = EOF reached (non-looping)
};

static void reader_loop(OcmReader* r, std::string path, int w, int h,
                        int format, int cs, OcmQueue* q, int loop,
                        double fps) {
  const size_t rgba_bytes = static_cast<size_t>(w) * h * 4;
  const size_t in_bytes =
      format == 1 ? static_cast<size_t>(w) * h * 3 / 2 : rgba_bytes;
  std::vector<uint8_t> in_buf(in_bytes);
  std::vector<uint8_t> rgba(rgba_bytes);
  const auto frame_period =
      fps > 0 ? std::chrono::duration<double>(1.0 / fps)
              : std::chrono::duration<double>(0);
  auto next_t = std::chrono::steady_clock::now();

  while (!r->stop.load()) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) break;
    while (!r->stop.load() &&
           std::fread(in_buf.data(), 1, in_bytes, f) == in_bytes) {
      const uint8_t* frame = in_buf.data();
      if (format == 1) {
        ocm_nv12_to_rgba(in_buf.data(), in_buf.data() + static_cast<size_t>(w) * h,
                         w, h, w, w, rgba.data(), cs);
        frame = rgba.data();
      }
      if (fps > 0) {
        next_t += std::chrono::duration_cast<std::chrono::steady_clock::duration>(
            frame_period);
        std::this_thread::sleep_until(next_t);
      }
      ocm_queue_push(q, frame);  // drop-on-full, like the reference
      r->frames_read.fetch_add(1);
    }
    std::fclose(f);
    if (!loop) break;
  }
  r->finished.store(1);
}

OcmReader* ocm_reader_start(const char* path, int w, int h, int format,
                            int cs, OcmQueue* q, int loop, double fps) {
  auto* r = new OcmReader();
  r->thread = std::thread(reader_loop, r, std::string(path), w, h, format, cs,
                          q, loop, fps);
  return r;
}

void ocm_reader_stop(OcmReader* r) {
  r->stop.store(true);
  if (r->thread.joinable()) r->thread.join();
  delete r;
}

uint64_t ocm_reader_frames_read(OcmReader* r) { return r->frames_read.load(); }
int ocm_reader_finished(OcmReader* r) { return r->finished.load(); }

// ---------------------------------------------------------------------------
// Synthetic pattern sources (test/bench frame generators)
// ---------------------------------------------------------------------------

// 75% color bars (8 vertical bars) with a frame counter strip.
void ocm_pattern_bars(uint8_t* rgba, int w, int h, int frame_idx) {
  static const uint8_t bars[8][3] = {
      {191, 191, 191}, {191, 191, 0}, {0, 191, 191}, {0, 191, 0},
      {191, 0, 191},   {191, 0, 0},   {0, 0, 191},   {0, 0, 0},
  };
  for (int j = 0; j < h; ++j) {
    uint8_t* row = rgba + static_cast<size_t>(j) * w * 4;
    for (int i = 0; i < w; ++i) {
      const uint8_t* c = bars[(i * 8) / w];
      row[i * 4 + 0] = c[0];
      row[i * 4 + 1] = c[1];
      row[i * 4 + 2] = c[2];
      row[i * 4 + 3] = 255;
    }
  }
  // moving marker line (so successive frames differ)
  int y = frame_idx % h;
  uint8_t* row = rgba + static_cast<size_t>(y) * w * 4;
  for (int i = 0; i < w; ++i) {
    row[i * 4 + 0] = 255;
    row[i * 4 + 1] = 255;
    row[i * 4 + 2] = 255;
  }
}

// Horizontal luma ramp + vertical chroma sweep.
void ocm_pattern_ramp(uint8_t* rgba, int w, int h, int frame_idx) {
  for (int j = 0; j < h; ++j) {
    uint8_t* row = rgba + static_cast<size_t>(j) * w * 4;
    for (int i = 0; i < w; ++i) {
      int v = (i * 256) / w;
      int t = ((j + frame_idx) * 256) / h;
      row[i * 4 + 0] = clip8(v);
      row[i * 4 + 1] = clip8((v + t) / 2);
      row[i * 4 + 2] = clip8(t);
      row[i * 4 + 3] = 255;
    }
  }
}

// Zone plate (focus-peaking stress: concentric rings of rising frequency).
void ocm_pattern_zoneplate(uint8_t* rgba, int w, int h, int frame_idx) {
  const double cx = w / 2.0, cy = h / 2.0;
  const double k = 0.05 + 0.0005 * (frame_idx % 100);
  for (int j = 0; j < h; ++j) {
    uint8_t* row = rgba + static_cast<size_t>(j) * w * 4;
    for (int i = 0; i < w; ++i) {
      double dx = i - cx, dy = j - cy;
      double r2 = dx * dx + dy * dy;
      int v = static_cast<int>(127.5 + 127.5 * std::cos(k * r2 / 100.0));
      row[i * 4 + 0] = row[i * 4 + 1] = row[i * 4 + 2] = clip8(v);
      row[i * 4 + 3] = 255;
    }
  }
}

}  // extern "C"
