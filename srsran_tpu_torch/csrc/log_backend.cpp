// Async log backend of srsran_tpu_torch — the srslog role (reference
// lib/src/srslog/log_backend_impl.h:43-61 + backend_worker.cpp): frontends
// enqueue formatted entries without blocking on I/O; ONE dedicated native
// thread drains the queue into the file sink.  Bounded queue, entries are
// dropped (and counted) under pressure like the reference's non-blocking
// mode.  Plain C ABI consumed via ctypes.
//
// The C ABI of native/log_backend.cpp, with one difference: `written` counts
// a batch only once it has been flushed to the file, and `slog_flush` waits
// until every line accepted before the call is counted so.  A flush that
// returned once the queue was empty could return while the worker still held
// its last batch, or before that batch left the stdio buffer.  Every counter
// is read and written under the queue's mutex.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {

struct LogBackend {
  FILE* sink = nullptr;
  size_t capacity = 8192;
  std::deque<std::string> q;
  std::mutex m;
  std::condition_variable cv;    // the worker waits here for lines
  std::condition_variable done;  // slog_flush waits here for `written`
  std::thread worker;
  bool stopping = false;
  uint64_t accepted = 0;
  uint64_t dropped = 0;
  uint64_t written = 0;

  void run() {
    std::deque<std::string> batch;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(m);
        cv.wait(lk, [&] { return stopping || !q.empty(); });
        if (q.empty() && stopping) break;
        batch.swap(q);
      }
      for (const std::string& line : batch) {
        fwrite(line.data(), 1, line.size(), sink);
      }
      fflush(sink);
      {
        std::lock_guard<std::mutex> lk(m);
        written += batch.size();
      }
      done.notify_all();
      batch.clear();
    }
  }
};

}  // namespace

extern "C" {

void* slog_create(const char* path, size_t queue_capacity) {
  FILE* f = fopen(path, "a");
  if (!f) return nullptr;
  auto* b = new LogBackend();
  b->sink = f;
  if (queue_capacity) b->capacity = queue_capacity;
  b->worker = std::thread([b] { b->run(); });
  return b;
}

// Returns 1 if enqueued, 0 if dropped (queue full).
int slog_write(void* handle, const char* line, size_t len) {
  auto* b = static_cast<LogBackend*>(handle);
  {
    std::lock_guard<std::mutex> lk(b->m);
    if (b->q.size() >= b->capacity) {
      b->dropped++;
      return 0;
    }
    b->q.emplace_back(line, len);
    b->accepted++;
  }
  b->cv.notify_one();
  return 1;
}

uint64_t slog_dropped(void* handle) {
  auto* b = static_cast<LogBackend*>(handle);
  std::lock_guard<std::mutex> lk(b->m);
  return b->dropped;
}

uint64_t slog_written(void* handle) {
  auto* b = static_cast<LogBackend*>(handle);
  std::lock_guard<std::mutex> lk(b->m);
  return b->written;
}

// Blocks until every line accepted before the call is in the file.
void slog_flush(void* handle) {
  auto* b = static_cast<LogBackend*>(handle);
  std::unique_lock<std::mutex> lk(b->m);
  const uint64_t target = b->accepted;
  b->done.wait(lk, [&] { return b->written >= target; });
}

void slog_destroy(void* handle) {
  auto* b = static_cast<LogBackend*>(handle);
  {
    std::lock_guard<std::mutex> lk(b->m);
    b->stopping = true;
  }
  b->cv.notify_one();
  b->worker.join();
  fclose(b->sink);
  delete b;
}

}  // extern "C"
