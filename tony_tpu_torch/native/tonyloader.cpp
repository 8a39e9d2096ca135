// tonyloader: native token-stream loader for tony-tpu.
//
// The reference framework's runtime is JVM-native and delegates input
// pipelines to the frameworks it launches; here the training-side input path
// is first-class, and the hot part — striding shuffled windows out of a
// memory-mapped token file while the trainer computes — is implemented in
// C++ so prefetch runs on a real thread, off the Python GIL.
//
// Design:
//   - mmap the int32 token file (zero-copy reads, page cache does the IO)
//   - windows of (seq_len + 1) tokens; each epoch visits every window of
//     this shard once, in a deterministic Fisher-Yates order seeded by
//     (seed, epoch) — restart-reproducible, matching train/data.py contracts
//   - a background thread keeps a small ring of batches filled; tl_next()
//     blocks only when the trainer outruns the disk
//
// C ABI (ctypes binding in tony_tpu_torch/train/native_loader.py):
//   void* tl_open(const char* path, long seq_len, long batch,
//                 long n_shards, long shard_id, unsigned long long seed)
//   long  tl_next(void* h, int* out)   // fills batch*(seq_len+1); 0 on ok
//   long  tl_windows_per_epoch(void* h)
//   void  tl_seek(void* h, long step)  // resume-exact positioning
//   void  tl_close(void* h)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread tonyloader.cpp -o libtonyloader.so
// (tony_tpu_torch/train/native_loader.py does this on demand, into
// tony_tpu_torch/csrc/build/)

#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int kRingSlots = 4;

struct Loader {
  const int32_t* data = nullptr;
  size_t n_tokens = 0;
  size_t file_bytes = 0;
  int fd = -1;

  long seq_len = 0;
  long batch = 0;
  long n_shards = 1;
  long shard_id = 0;
  uint64_t seed = 0;

  size_t window = 0;            // seq_len + 1
  size_t windows_total = 0;     // in the whole file
  size_t windows_shard = 0;     // owned by this shard
  std::vector<uint32_t> order;  // permutation of this shard's windows
  uint64_t order_epoch = ~0ull; // epoch the permutation was built for

  // ring buffer of prefetched batches
  std::vector<std::vector<int32_t>> ring;
  std::array<std::atomic<bool>, kRingSlots> ready{};
  std::atomic<long> head{0};    // next batch step to produce
  long tail = 0;                // next batch step to consume
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> generation{0};  // bumped by tl_seek; stale fills dropped
  std::thread worker;

  ~Loader() {
    {
      // stop must flip under mu: a waiter that has evaluated its predicate
      // but not yet blocked would otherwise miss the notify forever.
      std::lock_guard<std::mutex> lock(mu);
      stop.store(true);
      cv_produce.notify_all();
      cv_consume.notify_all();
    }
    if (worker.joinable()) worker.join();
    if (data != nullptr) munmap(const_cast<int32_t*>(data), file_bytes);
    if (fd >= 0) close(fd);
  }

  void build_order(uint64_t epoch) {
    if (order_epoch == epoch) return;
    order.resize(windows_shard);
    for (size_t i = 0; i < windows_shard; ++i) order[i] = static_cast<uint32_t>(i);
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ull + epoch);
    for (size_t i = windows_shard - 1; i > 0; --i) {
      size_t j = rng() % (i + 1);
      std::swap(order[i], order[j]);
    }
    order_epoch = epoch;
  }

  // copy the tokens of global batch-step `step` into dst
  void fill(long step, int32_t* dst) {
    const long per_epoch = static_cast<long>(windows_shard / batch);
    const uint64_t epoch = static_cast<uint64_t>(step / per_epoch);
    const long in_epoch = step % per_epoch;
    build_order(epoch);
    for (long b = 0; b < batch; ++b) {
      const uint32_t local = order[in_epoch * batch + b];
      // shard w owns windows (w, w + n_shards, w + 2*n_shards, ...)
      const size_t global_win = static_cast<size_t>(local) * n_shards + shard_id;
      const size_t off = global_win * window;
      std::memcpy(dst + b * window, data + off, window * sizeof(int32_t));
    }
  }

  void run() {
    while (!stop.load()) {
      uint64_t gen;
      long step;
      int slot;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_produce.wait(lock, [&] {
          return stop.load() || !ready[head.load() % kRingSlots].load();
        });
        if (stop.load()) return;
        gen = generation.load();
        step = head.load();
        slot = static_cast<int>(step % kRingSlots);
      }
      fill(step, ring[slot].data());
      std::unique_lock<std::mutex> lock(mu);
      if (generation.load() != gen) continue;  // superseded by a seek
      ready[slot].store(true);
      head.fetch_add(1);
      cv_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* tl_open(const char* path, long seq_len, long batch, long n_shards,
              long shard_id, unsigned long long seed) {
  auto* L = new Loader();
  L->seq_len = seq_len;
  L->batch = batch;
  L->n_shards = n_shards > 0 ? n_shards : 1;
  if (shard_id < 0 || shard_id >= L->n_shards) { delete L; return nullptr; }
  L->shard_id = shard_id;
  L->seed = seed;
  L->window = static_cast<size_t>(seq_len) + 1;

  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) { delete L; return nullptr; }
  struct stat st;
  if (fstat(L->fd, &st) != 0) { delete L; return nullptr; }
  L->file_bytes = static_cast<size_t>(st.st_size);
  L->n_tokens = L->file_bytes / sizeof(int32_t);
  L->windows_total = L->n_tokens / L->window;
  L->windows_shard = L->windows_total / L->n_shards;
  if (L->windows_shard < static_cast<size_t>(batch)) { delete L; return nullptr; }

  void* mem = mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (mem == MAP_FAILED) { delete L; return nullptr; }
  L->data = static_cast<const int32_t*>(mem);
  madvise(mem, L->file_bytes, MADV_RANDOM);  // shuffled window order

  L->ring.assign(kRingSlots, std::vector<int32_t>(batch * L->window));
  for (auto& r : L->ready) r.store(false);
  L->worker = std::thread([L] { L->run(); });
  return L;
}

long tl_windows_per_epoch(void* h) {
  auto* L = static_cast<Loader*>(h);
  return static_cast<long>(L->windows_shard / L->batch);
}

void tl_seek(void* h, long step) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lock(L->mu);
  // drop everything prefetched (and anything mid-fill, via the generation
  // bump) and restart production at `step`
  L->generation.fetch_add(1);
  for (auto& r : L->ready) r.store(false);
  L->head.store(step);
  L->tail = step;
  L->cv_produce.notify_all();
}

long tl_next(void* h, int32_t* out) {
  auto* L = static_cast<Loader*>(h);
  int slot = static_cast<int>(L->tail % kRingSlots);
  {
    std::unique_lock<std::mutex> lock(L->mu);
    L->cv_consume.wait(lock, [&] { return L->stop.load() || L->ready[slot].load(); });
    if (L->stop.load()) return -1;
  }
  // The producer never touches a slot while ready[slot] is true, so the copy
  // can run unlocked; the hand-back (ready=false) must happen under mu so the
  // producer's predicate check and our notify can't interleave into a lost
  // wakeup that parks the prefetch thread forever.
  std::memcpy(out, L->ring[slot].data(), L->batch * L->window * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->ready[slot].store(false);
    L->tail += 1;
    L->cv_produce.notify_one();
  }
  return 0;
}

void tl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
