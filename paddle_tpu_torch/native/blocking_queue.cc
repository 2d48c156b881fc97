// Bounded blocking byte-buffer queue for the input pipeline.
//
// Native-parity component: the reference's feeding pipeline hands
// LoDTensors from Python into a C++ bounded queue the reader ops pop
// (reference: paddle/fluid/operators/reader/lod_tensor_blocking_queue.h,
// reader/blocking_queue.h). Here the queue carries serialized batches from
// the Python decode thread to the host feeder without holding the GIL,
// so prefetch overlaps XLA execution.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>

namespace {

struct Queue {
  std::mutex mu;
  std::condition_variable cv_push;
  std::condition_variable cv_pop;
  std::deque<std::string> items;
  size_t capacity = 0;
  bool closed = false;
};

}  // namespace

extern "C" {

void* btq_create(uint64_t capacity) {
  Queue* q = new Queue();
  q->capacity = capacity ? capacity : 64;
  return q;
}

// 0 ok; -1 queue closed.
int btq_push(void* h, const char* data, uint64_t len) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_push.wait(lk, [q] { return q->closed || q->items.size() < q->capacity; });
  if (q->closed) return -1;
  q->items.emplace_back(data, len);
  q->cv_pop.notify_one();
  return 0;
}

// Returns length and malloc'd buffer in *out (caller frees with
// btq_free_buf); -1 when closed and drained.
int64_t btq_pop(void* h, char** out) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_pop.wait(lk, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return -1;  // closed and drained
  std::string item = std::move(q->items.front());
  q->items.pop_front();
  q->cv_push.notify_one();
  lk.unlock();
  char* buf = static_cast<char*>(malloc(item.size() ? item.size() : 1));
  memcpy(buf, item.data(), item.size());
  *out = buf;
  return static_cast<int64_t>(item.size());
}

void btq_free_buf(char* buf) { free(buf); }

uint64_t btq_size(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

// Close: pushers fail immediately, poppers drain then get -1.
void btq_close(void* h) {
  Queue* q = static_cast<Queue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv_push.notify_all();
  q->cv_pop.notify_all();
}

// Reopen for reuse after reset (drops queued items).
void btq_reset(void* h) {
  Queue* q = static_cast<Queue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->items.clear();
    q->closed = false;
  }
  q->cv_push.notify_all();
}

void btq_destroy(void* h) {
  btq_close(h);
  delete static_cast<Queue*>(h);
}

}  // extern "C"
