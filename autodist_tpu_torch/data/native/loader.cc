// Native host data pipeline: a threaded prefetch ring over in-memory or
// memory-mapped datasets.
//
// Role in the framework: the reference delegated its input pipeline to TF's C++
// runtime (queues/iterators/staging, SURVEY.md §2.4 "host data plane"); here the
// equivalent native capability is owned in-tree. A background thread shuffles row
// indices (per-epoch reshuffle, seeded), gathers rows from the caller's arrays
// into pre-allocated batch slots, and hands full slots to the consumer — all
// outside the Python GIL (ctypes releases it for the duration of each call, and
// the gather/memcpy work happens on the worker thread regardless).
//
// Sources may be SEGMENTED: each key's rows live in one or more base pointers
// (file shards mapped with mmap via numpy's .npy memmap). The gather thread
// resolves a global row to (segment, local row) with a binary search over the
// shared segment-boundary table, so page faults on cold file pages happen on
// the worker thread, overlapped with the accelerator step — files larger than
// RAM stream through the page cache without ever materializing in full.
//
// C ABI only (no pybind11 in this environment): handles are opaque pointers,
// arrays are (ptr, row_bytes) pairs, batches are delivered by memcpy into
// caller-provided buffers.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct SourceArray {
  std::vector<const uint8_t*> segment_bases;  // one per dataset segment
  uint64_t row_bytes;
};

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // one per source array
  bool full = false;
};

struct Loader {
  std::vector<SourceArray> arrays;
  // Segment boundaries in global row space: seg_starts[s] = first row of
  // segment s; seg_starts[n_segments] = n_rows. All keys share the table
  // (shards are row-aligned across keys).
  std::vector<uint64_t> seg_starts;
  uint64_t n_rows = 0;
  uint64_t batch_size = 0;
  bool shuffle = false;
  bool drop_last = true;  // continuous stream: partial batches are never emitted

  std::vector<Slot> slots;
  uint64_t produce_idx = 0;  // next slot the worker fills
  uint64_t consume_idx = 0;  // next slot the consumer drains
  std::mutex mu;
  std::condition_variable cv_can_produce;
  std::condition_variable cv_can_consume;

  std::thread worker;
  std::atomic<bool> stop{false};

  std::vector<uint64_t> perm;
  uint64_t cursor = 0;  // position within perm
  std::mt19937_64 rng;
  // Written by the worker thread outside the slot mutex (fill_slot runs
  // unlocked); read from Python at any time — atomic, not mutex-guarded.
  std::atomic<uint64_t> epochs_completed{0};

  void refill_perm() {
    if (perm.empty()) {
      perm.resize(n_rows);
      for (uint64_t i = 0; i < n_rows; ++i) perm[i] = i;
    }
    if (shuffle) {
      for (uint64_t i = n_rows - 1; i > 0; --i) {
        std::uniform_int_distribution<uint64_t> d(0, i);
        std::swap(perm[i], perm[d(rng)]);
      }
    }
    cursor = 0;
  }

  // Global row -> (segment, local row). One segment (the in-memory case) is
  // branch-free; multi-segment uses a binary search over seg_starts (the
  // memcpy dominates, so the log(n_segments) lookup is noise).
  inline void locate(uint64_t row, size_t* seg, uint64_t* local) const {
    if (seg_starts.size() == 2) {
      *seg = 0;
      *local = row;
      return;
    }
    size_t lo = 0, hi = seg_starts.size() - 1;
    while (hi - lo > 1) {
      const size_t mid = (lo + hi) / 2;
      if (seg_starts[mid] <= row) lo = mid; else hi = mid;
    }
    *seg = lo;
    *local = row - seg_starts[lo];
  }

  void fill_slot(Slot& slot) {
    // drop_last semantics: a tail shorter than batch_size is skipped and the
    // next (reshuffled) epoch begins — no partial batches, static shapes only.
    if (n_rows - cursor < batch_size) {
      ++epochs_completed;
      refill_perm();
    }
    for (uint64_t j = 0; j < batch_size; ++j) {
      const uint64_t row = perm[cursor++];
      size_t seg;
      uint64_t local;
      locate(row, &seg, &local);
      for (size_t a = 0; a < arrays.size(); ++a) {
        const uint64_t rb = arrays[a].row_bytes;
        std::memcpy(slot.buffers[a].data() + j * rb,
                    arrays[a].segment_bases[seg] + local * rb, rb);
      }
    }
  }

  void run() {
    refill_perm();
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_can_produce.wait(lk, [&] {
        return stop.load() || !slots[produce_idx % slots.size()].full;
      });
      if (stop.load()) return;
      Slot& slot = slots[produce_idx % slots.size()];
      lk.unlock();

      fill_slot(slot);  // the heavy gather happens without the lock

      lk.lock();
      slot.full = true;
      ++produce_idx;
      cv_can_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Segmented creation: seg_ptrs is laid out [array][segment] (row-major,
// n_arrays * n_segments entries); seg_rows gives each segment's row count
// (shared by all arrays — shards are row-aligned across keys).
void* dl_create_sharded(uint64_t n_arrays, uint64_t n_segments,
                        const void** seg_ptrs, const uint64_t* row_bytes,
                        const uint64_t* seg_rows, uint64_t batch_size,
                        uint64_t queue_capacity, int shuffle, uint64_t seed) {
  if (n_arrays == 0 || n_segments == 0 || batch_size == 0 ||
      queue_capacity == 0) {
    return nullptr;
  }
  uint64_t n_rows = 0;
  for (uint64_t s = 0; s < n_segments; ++s) {
    if (seg_rows[s] == 0) return nullptr;
    n_rows += seg_rows[s];
  }
  if (batch_size > n_rows) return nullptr;
  auto* ld = new Loader();
  ld->n_rows = n_rows;
  ld->batch_size = batch_size;
  ld->shuffle = shuffle != 0;
  ld->rng.seed(seed);
  ld->seg_starts.resize(n_segments + 1);
  ld->seg_starts[0] = 0;
  for (uint64_t s = 0; s < n_segments; ++s) {
    ld->seg_starts[s + 1] = ld->seg_starts[s] + seg_rows[s];
  }
  for (uint64_t a = 0; a < n_arrays; ++a) {
    SourceArray src;
    src.row_bytes = row_bytes[a];
    for (uint64_t s = 0; s < n_segments; ++s) {
      src.segment_bases.push_back(
          static_cast<const uint8_t*>(seg_ptrs[a * n_segments + s]));
    }
    ld->arrays.push_back(std::move(src));
  }
  ld->slots.resize(queue_capacity);
  for (auto& slot : ld->slots) {
    slot.buffers.resize(n_arrays);
    for (uint64_t a = 0; a < n_arrays; ++a) {
      slot.buffers[a].resize(batch_size * row_bytes[a]);
    }
  }
  ld->worker = std::thread([ld] { ld->run(); });
  return ld;
}

// Single-segment convenience (the original in-memory ABI).
void* dl_create(uint64_t n_arrays, const void** array_ptrs,
                const uint64_t* row_bytes, uint64_t n_rows, uint64_t batch_size,
                uint64_t queue_capacity, int shuffle, uint64_t seed) {
  if (n_rows == 0) return nullptr;
  return dl_create_sharded(n_arrays, 1, array_ptrs, row_bytes, &n_rows,
                           batch_size, queue_capacity, shuffle, seed);
}

// Blocks until a batch is ready, then copies each array's rows into out_ptrs[a]
// (caller allocates batch_size * row_bytes[a] each). Returns 0 on success.
int dl_next(void* handle, void** out_ptrs) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_can_consume.wait(lk, [&] {
    return ld->stop.load() || ld->slots[ld->consume_idx % ld->slots.size()].full;
  });
  if (ld->stop.load()) return 1;
  Slot& slot = ld->slots[ld->consume_idx % ld->slots.size()];
  for (size_t a = 0; a < ld->arrays.size(); ++a) {
    std::memcpy(out_ptrs[a], slot.buffers[a].data(), slot.buffers[a].size());
  }
  slot.full = false;
  ++ld->consume_idx;
  ld->cv_can_produce.notify_one();
  return 0;
}

uint64_t dl_epochs_completed(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  return ld->epochs_completed.load();
}

void dl_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop.store(true);
  }
  ld->cv_can_produce.notify_all();
  ld->cv_can_consume.notify_all();
  if (ld->worker.joinable()) ld->worker.join();
  delete ld;
}

}  // extern "C"
