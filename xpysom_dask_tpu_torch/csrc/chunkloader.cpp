// Native streaming chunk loader for huge-N SOM training.
//
// Role: the host-side data engine feeding the streaming pipeline
// (xpysom_dask_tpu_torch/parallel/pipeline.py). A background reader thread
// streams fixed-size superbatches of float32 rows from a binary file into
// a ring of pre-allocated buffers, so disk I/O overlaps device compute.
// The same source as the JAX package's csrc/chunkloader.cpp, built by
// xpysom_dask_tpu_torch/utils/native.py with g++ at first use. Exposed to
// Python via a plain C ABI consumed with ctypes.
//
// Protocol per epoch:
//   h = xs_open(path, n_rows, n_cols, superbatch_rows, n_buffers)
//   loop: p = xs_acquire(h, &rows)   // blocks until a buffer is filled
//         ... consume rows*n_cols floats at p ...
//         xs_release(h)              // hand the buffer back to the reader
//   until rows == 0                  // end of file
//   xs_reset(h)                      // rewind for the next epoch
//   xs_close(h)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::vector<float> data;
  int64_t rows = 0;
  bool full = false;
};

struct Loader {
  std::string path;
  int64_t n_rows, n_cols, sb_rows;
  std::vector<Buffer> ring;
  size_t head = 0;  // next buffer the consumer takes
  size_t tail = 0;  // next buffer the reader fills
  bool stop = false;
  bool consumer_holds = false;
  std::string error;
  std::string error_snapshot;  // xs_error's stable copy (consumer-owned)
  std::mutex mu;
  std::condition_variable cv_reader, cv_consumer;
  std::thread reader;

  Loader(const char* p, int64_t nr, int64_t nc, int64_t sb, int nbuf)
      : path(p), n_rows(nr), n_cols(nc), sb_rows(sb), ring(nbuf) {
    for (auto& b : ring) b.data.resize(static_cast<size_t>(sb) * nc);
    start();
  }

  void start() {
    stop = false;
    head = tail = 0;
    consumer_holds = false;  // reset() must clear a held buffer
    error.clear();           // ...and a previous epoch's failure, or the
                             // documented rewind protocol returns -1 forever
    for (auto& b : ring) {
      b.full = false;
      b.rows = 0;
    }
    reader = std::thread([this] { this->run(); });
  }

  void run() {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      std::lock_guard<std::mutex> lk(mu);
      error = "cannot open " + path;
      cv_consumer.notify_all();
      return;
    }
    int64_t row = 0;
    while (true) {
      std::unique_lock<std::mutex> lk(mu);
      cv_reader.wait(lk, [this] { return stop || !ring[tail].full; });
      if (stop) break;
      Buffer& b = ring[tail];
      lk.unlock();

      int64_t want = std::min(sb_rows, n_rows - row);
      int64_t got = 0;
      if (want > 0) {
        got = static_cast<int64_t>(std::fread(
            b.data.data(), sizeof(float) * n_cols, want, f));
      }
      row += got;

      // Short read before the declared n_rows is an ERROR, not EOF:
      // a truncated/shrunk file or a mid-epoch read failure must raise
      // in the consumer (rows = -1), never silently train on partial
      // data. The np.memmap fallback raises for the same inputs.
      std::string err;
      if (got < want) {
        if (std::ferror(f)) {
          err = "read error in " + path;
        } else {
          err = "short file: " + path + " delivered " +
                std::to_string(row) + " of " + std::to_string(n_rows) +
                " declared rows";
        }
      }

      lk.lock();
      if (!err.empty()) {
        error = err;
        cv_consumer.notify_all();
        break;
      }
      b.rows = got;
      b.full = true;
      bool done = (got == 0);
      tail = (tail + 1) % ring.size();
      cv_consumer.notify_all();
      if (done) break;
    }
    std::fclose(f);
  }

  // Returns pointer to the next filled buffer; rows==0 signals end of epoch.
  const float* acquire(int64_t* rows) {
    std::unique_lock<std::mutex> lk(mu);
    cv_consumer.wait(lk, [this] { return ring[head].full || !error.empty(); });
    if (!error.empty()) {
      *rows = -1;
      return nullptr;
    }
    consumer_holds = true;
    *rows = ring[head].rows;
    return ring[head].data.data();
  }

  void release() {
    std::lock_guard<std::mutex> lk(mu);
    if (!consumer_holds) return;
    ring[head].full = false;
    ring[head].rows = 0;
    head = (head + 1) % ring.size();
    consumer_holds = false;
    cv_reader.notify_all();
  }

  void reset() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      cv_reader.notify_all();
    }
    if (reader.joinable()) reader.join();
    start();
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      cv_reader.notify_all();
    }
    if (reader.joinable()) reader.join();
  }
};

}  // namespace

extern "C" {

void* xs_open(const char* path, int64_t n_rows, int64_t n_cols,
              int64_t superbatch_rows, int n_buffers) {
  // superbatch_rows <= 0 would make the reader queue an immediate
  // rows==0 EOF with no error — the consumer would silently fold zero
  // superbatches of the declared n_rows (the exact "train on partial
  // data" failure the short-read check below guards against). Reject
  // invalid geometry here; a nullptr is the ABI's failure signal.
  if (!path || n_rows < 0 || n_cols <= 0 || superbatch_rows <= 0) {
    return nullptr;
  }
  // Magnitude guard: superbatch_rows * n_cols * sizeof(float) must not
  // wrap size_t — a wrapped product resizes the ring buffers to (almost)
  // nothing and the reader's fread then writes past the allocation
  // (heap corruption in native code, not a catchable bad_alloc).
  if (static_cast<uint64_t>(superbatch_rows) >
      SIZE_MAX / sizeof(float) / static_cast<uint64_t>(n_cols)) {
    return nullptr;
  }
  if (n_buffers < 2) n_buffers = 2;
  try {
    return new Loader(path, n_rows, n_cols, superbatch_rows, n_buffers);
  } catch (...) {
    return nullptr;
  }
}

const float* xs_acquire(void* h, int64_t* rows) {
  return static_cast<Loader*>(h)->acquire(rows);
}

// Message for the last failure (valid until the next xs_error/xs_reset/
// xs_close); empty string when no error. Lets Python raise the SPECIFIC
// cause (short file vs read error vs open failure) instead of a generic
// one. The live `error` string is owned by the reader thread's mutex —
// snapshot it under the lock into consumer-owned storage so the returned
// pointer stays valid after release (single consumer thread, like the
// rest of the acquire/release protocol).
const char* xs_error(void* h) {
  // No C++ exception may cross the C ABI into ctypes (std::terminate):
  // the snapshot assignment allocates and can throw bad_alloc under
  // memory pressure — degrade to a static message instead.
  Loader* L = static_cast<Loader*>(h);
  try {
    std::lock_guard<std::mutex> lk(L->mu);
    L->error_snapshot = L->error;
    return L->error_snapshot.c_str();
  } catch (...) {
    return "native loader error (message unavailable: out of memory)";
  }
}

void xs_release(void* h) { static_cast<Loader*>(h)->release(); }

void xs_reset(void* h) {
  // reset() -> start() constructs a std::thread, which throws
  // std::system_error on thread-resource exhaustion; surface that as a
  // consumer-visible error (acquire returns rows=-1) rather than letting
  // it cross the C ABI and abort the host process.
  Loader* L = static_cast<Loader*>(h);
  try {
    L->reset();
  } catch (...) {
    std::lock_guard<std::mutex> lk(L->mu);
    L->error = "cannot restart reader thread for " + L->path;
    L->cv_consumer.notify_all();
  }
}

void xs_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
