// SPSC lock-free ring buffer for sample-stream ingest.
//
// The reference leans on GNU Radio's circular buffers between blocks and on
// hand-rolled double-buffered worker threads for high-rate ingest
// (lib/clXEngine_impl.cc:304-382 of gr-clenabled, pinned host buffers +
// flag handshake).  Here the ring decouples a real-time capture thread from
// the thread that feeds the card: the producer writes raw samples, the
// consumer pops fixed frames for the host-to-device copy.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct RingBuffer {
  uint8_t* data;
  size_t capacity;                 // power of two
  std::atomic<uint64_t> head{0};   // write position (bytes, monotonic)
  std::atomic<uint64_t> tail{0};   // read position (bytes, monotonic)
};

size_t round_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* rb_create(size_t capacity) {
  auto* rb = new (std::nothrow) RingBuffer();
  if (!rb) return nullptr;
  rb->capacity = round_pow2(capacity);
  rb->data = new (std::nothrow) uint8_t[rb->capacity];
  if (!rb->data) {
    delete rb;
    return nullptr;
  }
  return rb;
}

void rb_destroy(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  if (!rb) return;
  delete[] rb->data;
  delete rb;
}

size_t rb_capacity(void* h) { return static_cast<RingBuffer*>(h)->capacity; }

size_t rb_available(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

size_t rb_space(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  return rb->capacity - (rb->head.load(std::memory_order_acquire) -
                         rb->tail.load(std::memory_order_acquire));
}

// Writes up to n bytes; returns bytes written (0..n).
size_t rb_write(void* h, const void* src, size_t n) {
  auto* rb = static_cast<RingBuffer*>(h);
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t tail = rb->tail.load(std::memory_order_acquire);
  size_t space = rb->capacity - (size_t)(head - tail);
  if (n > space) n = space;
  size_t pos = (size_t)(head & (rb->capacity - 1));
  size_t first = rb->capacity - pos;
  if (first > n) first = n;
  std::memcpy(rb->data + pos, src, first);
  std::memcpy(rb->data, static_cast<const uint8_t*>(src) + first, n - first);
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

// Reads up to n bytes; returns bytes read (0..n).
size_t rb_read(void* h, void* dst, size_t n) {
  auto* rb = static_cast<RingBuffer*>(h);
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  uint64_t head = rb->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  if (n > avail) n = avail;
  size_t pos = (size_t)(tail & (rb->capacity - 1));
  size_t first = rb->capacity - pos;
  if (first > n) first = n;
  std::memcpy(dst, rb->data + pos, first);
  std::memcpy(static_cast<uint8_t*>(dst) + first, rb->data, n - first);
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
