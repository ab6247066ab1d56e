// Background prefetch loader: the input pipeline for corpora that stream
// from host memory to the device every step.
//
// The device-resident path (training/data.py DeviceData) covers corpora
// that fit the card's memory. For the streaming path a producer thread
// gathers shuffled batch rows from the encoded in-RAM corpus into a ring
// of pre-allocated slot buffers ahead of consumption, so host batch
// assembly overlaps device compute. Python acquires and releases slots
// through ctypes (native/__init__.py NativeStreamLoader), copying each
// slot out before it hands it back.
//
// Columns are opaque byte rows: any dtype or width, gathered with one
// memcpy per (row, column). The shuffle is a per-epoch Fisher-Yates over
// row indices (xorshift64*, seeded); epochs cycle forever, and Python
// counts the steps.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Loader {
  int64_t n_rows, batch, n_cols, capacity;
  std::vector<const char*> cols;
  std::vector<int64_t> row_bytes;
  // slots[s][c] is a (batch * row_bytes[c]) buffer
  std::vector<std::vector<std::vector<char>>> slots;

  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::deque<int64_t> free_q, ready_q;
  std::atomic<bool> stop{false};

  std::vector<int64_t> perm;
  uint64_t rng_state;
  bool shuffle;
  int64_t cursor = 0;  // next row index within the epoch permutation

  std::thread worker;

  uint64_t next_rand() {
    // xorshift64*
    uint64_t x = rng_state;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    rng_state = x;
    return x * 0x2545F4914F6CDD1DULL;
  }

  void reshuffle() {
    if (!shuffle) return;
    for (int64_t i = n_rows - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(next_rand() % (uint64_t)(i + 1));
      std::swap(perm[i], perm[j]);
    }
  }

  void fill_slot(int64_t s) {
    for (int64_t c = 0; c < n_cols; ++c) {
      char* dst = slots[s][c].data();
      const char* src = cols[c];
      const int64_t rb = row_bytes[c];
      for (int64_t b = 0; b < batch; ++b) {
        std::memcpy(dst + b * rb, src + perm[cursor + b] * rb, rb);
      }
    }
    cursor += batch;
    if (cursor + batch > n_rows) {  // drop remainder, next epoch
      cursor = 0;
      reshuffle();
    }
  }

  void run() {
    while (!stop.load()) {
      int64_t s;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        s = free_q.front();
        free_q.pop_front();
      }
      fill_slot(s);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_q.push_back(s);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(int64_t n_cols, const char** col_ptrs,
                    const int64_t* row_bytes, int64_t n_rows, int64_t batch,
                    int64_t capacity, uint64_t seed, int shuffle) {
  if (n_rows < batch || batch <= 0 || capacity <= 0) return nullptr;
  Loader* L = new Loader();
  L->n_rows = n_rows;
  L->batch = batch;
  L->n_cols = n_cols;
  L->capacity = capacity;
  L->cols.assign(col_ptrs, col_ptrs + n_cols);
  L->row_bytes.assign(row_bytes, row_bytes + n_cols);
  L->slots.resize(capacity);
  for (int64_t s = 0; s < capacity; ++s) {
    L->slots[s].resize(n_cols);
    for (int64_t c = 0; c < n_cols; ++c) {
      L->slots[s][c].resize(batch * row_bytes[c]);
    }
    L->free_q.push_back(s);
  }
  L->perm.resize(n_rows);
  for (int64_t i = 0; i < n_rows; ++i) L->perm[i] = i;
  L->rng_state = seed ? seed : 0x9E3779B97F4A7C15ULL;
  L->shuffle = shuffle != 0;
  L->reshuffle();
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Pointers to slot s's per-column buffers (stable for the loader lifetime).
void loader_slot_ptrs(void* h, int64_t s, char** out_ptrs) {
  Loader* L = static_cast<Loader*>(h);
  for (int64_t c = 0; c < L->n_cols; ++c)
    out_ptrs[c] = L->slots[s][c].data();
}

// Block until a filled slot is available; returns its index (-1 if stopped).
int64_t loader_acquire(void* h) {
  Loader* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->stop.load() || !L->ready_q.empty(); });
  if (L->ready_q.empty()) return -1;
  int64_t s = L->ready_q.front();
  L->ready_q.pop_front();
  return s;
}

void loader_release(void* h, int64_t s) {
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_q.push_back(s);
  }
  L->cv_free.notify_one();
}

void loader_destroy(void* h) {
  Loader* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
