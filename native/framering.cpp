// Native host-IO runtime: stream-file reader + drop-to-latest frame ring.
//
// The reference's host data path is C++: a receive thread memcpys ZMQ frames
// into a persistently mapped double PBO under a mutex
// (reference: framework/NetKinectArray.cpp:484-544,
//  framework/double_pixel_buffer.cpp, framework/io/FileBuffer.cpp).
// This is the framework's equivalent: a GIL-free pump thread moves
// frames from a looping stream file (or any producer via ring_push) into a
// single latest-frame slot; Python consumes via ctypes into pinned numpy
// buffers and hands them to jax.device_put. Drop-to-latest == ZMQ RCVHWM=1.
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC -pthread).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Latest-frame ring (single slot, drop-to-latest semantics)
// ---------------------------------------------------------------------------

struct FrameRing {
  std::mutex mutex;
  std::vector<uint8_t> slot;
  uint64_t seq = 0;          // incremented per push
  uint64_t consumed = 0;     // last seq handed to a consumer
  uint64_t dropped = 0;      // pushes that overwrote an unconsumed frame
  size_t frame_bytes = 0;
  double timestamp = 0.0;
};

FrameRing* ring_create(size_t frame_bytes) {
  auto* r = new FrameRing();
  r->frame_bytes = frame_bytes;
  r->slot.resize(frame_bytes);
  return r;
}

void ring_destroy(FrameRing* r) { delete r; }

void ring_push(FrameRing* r, const uint8_t* data, double timestamp) {
  std::lock_guard<std::mutex> lock(r->mutex);
  if (r->seq > r->consumed) r->dropped++;
  std::memcpy(r->slot.data(), data, r->frame_bytes);
  r->timestamp = timestamp;
  r->seq++;
}

// Returns 1 and fills out/out_ts if a new frame was available, else 0.
int ring_pop_latest(FrameRing* r, uint8_t* out, double* out_ts) {
  std::lock_guard<std::mutex> lock(r->mutex);
  if (r->seq == r->consumed) return 0;
  std::memcpy(out, r->slot.data(), r->frame_bytes);
  *out_ts = r->timestamp;
  r->consumed = r->seq;
  return 1;
}

uint64_t ring_seq(FrameRing* r) {
  std::lock_guard<std::mutex> lock(r->mutex);
  return r->seq;
}

uint64_t ring_dropped(FrameRing* r) {
  std::lock_guard<std::mutex> lock(r->mutex);
  return r->dropped;
}

// ---------------------------------------------------------------------------
// Looping stream-file reader (FileBuffer role)
// ---------------------------------------------------------------------------

struct StreamFile {
  FILE* file = nullptr;
  size_t frame_bytes = 0;
  long file_bytes = 0;
  int loop = 1;
};

StreamFile* stream_open(const char* path, size_t frame_bytes, int loop) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < (long)frame_bytes) {
    std::fclose(f);
    return nullptr;
  }
  auto* s = new StreamFile();
  s->file = f;
  s->frame_bytes = frame_bytes;
  s->file_bytes = size - (size % (long)frame_bytes);
  s->loop = loop;
  return s;
}

// Returns 1 on success, 0 on EOF (non-looping).
int stream_read(StreamFile* s, uint8_t* out) {
  long pos = std::ftell(s->file);
  if (pos >= s->file_bytes) {
    if (!s->loop) return 0;
    std::fseek(s->file, 0, SEEK_SET);  // FileBuffer.cpp:108-128 loop
  }
  size_t got = std::fread(out, 1, s->frame_bytes, s->file);
  if (got < s->frame_bytes) {
    if (!s->loop) return 0;
    std::fseek(s->file, 0, SEEK_SET);
    got = std::fread(out, 1, s->frame_bytes, s->file);
    if (got < s->frame_bytes) return 0;
  }
  return 1;
}

long stream_num_frames(StreamFile* s) {
  return s->file_bytes / (long)s->frame_bytes;
}

void stream_close(StreamFile* s) {
  if (s->file) std::fclose(s->file);
  delete s;
}

// ---------------------------------------------------------------------------
// Pump: background thread moving stream frames into the ring at a target
// rate (the readLoop role, off the GIL)
// ---------------------------------------------------------------------------

struct Pump {
  std::thread thread;
  std::atomic<bool> running{true};
  uint64_t frames_pumped = 0;
};

Pump* pump_start(StreamFile* s, FrameRing* r, double fps) {
  auto* p = new Pump();
  p->thread = std::thread([p, s, r, fps]() {
    std::vector<uint8_t> buf(s->frame_bytes);
    const auto period = std::chrono::duration<double>(fps > 0 ? 1.0 / fps : 0.0);
    auto next = std::chrono::steady_clock::now();
    double t = 0.0;
    while (p->running.load()) {
      if (!stream_read(s, buf.data())) break;
      ring_push(r, buf.data(), t);
      p->frames_pumped++;
      t += fps > 0 ? 1.0 / fps : 0.0;
      if (fps > 0) {
        next += std::chrono::duration_cast<std::chrono::steady_clock::duration>(period);
        std::this_thread::sleep_until(next);
      }
    }
  });
  return p;
}

uint64_t pump_frames(Pump* p) { return p->frames_pumped; }

void pump_stop(Pump* p) {
  p->running.store(false);
  if (p->thread.joinable()) p->thread.join();
  delete p;
}

}  // extern "C"
