// Chrome-trace timeline writer: MPSC ring buffer + dedicated writer thread.
//
// Same role as the reference's Timeline (common/timeline.h:46-76:
// boost::lockfree::spsc_queue capacity 2^20 + writer thread) without the
// boost dependency.  Producers are *multiple* Python threads (user thread,
// window workers, transport drain — ctypes releases the GIL), so slots are
// claimed with a CAS on head and published through per-slot sequence
// numbers (Vyukov bounded-queue scheme, single consumer).  The training
// thread never blocks — on overflow events are dropped and counted
// (the reference blocks instead; dropping is the right call on a TPU host
// where the training thread also drives dispatch).

#include "bluefog_native.h"

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>

namespace {

constexpr int kRingBits = 16;          // 65536 slots
constexpr int kRingSize = 1 << kRingBits;
constexpr int kRingMask = kRingSize - 1;
constexpr int kNameCap = 96;
constexpr int kCatCap = 64;

struct Event {
  // seq == slot index: free for the producer claiming that index;
  // seq == index + 1: payload published, ready for the consumer;
  // consumer recycles with seq = index + kRingSize.
  std::atomic<uint64_t> seq;
  char name[kNameCap];
  char cat[kCatCap];
  char phase;
  int64_t ts_us;
  int64_t dur_us;
  int64_t tid;
};

}  // namespace

struct bf_timeline {
  FILE* f = nullptr;
  int32_t pid = 0;
  Event* ring = nullptr;
  std::atomic<uint64_t> head{0};   // producer
  std::atomic<uint64_t> tail{0};   // consumer
  std::atomic<int64_t> dropped{0};
  std::atomic<bool> stop{false};
  bool first = true;
  std::thread writer;
  std::mutex wake_m;
  std::condition_variable wake_cv;

  void Run() {
    for (;;) {
      uint64_t t = tail.load(std::memory_order_relaxed);
      Event& e = ring[t & kRingMask];
      if (e.seq.load(std::memory_order_acquire) != t + 1) {
        // Slot not yet published (empty, or a producer mid-write).
        if (stop.load(std::memory_order_acquire) &&
            t == head.load(std::memory_order_acquire))
          break;
        std::unique_lock<std::mutex> lk(wake_m);
        wake_cv.wait_for(lk, std::chrono::milliseconds(50));
        continue;
      }
      if (!first) std::fputs(",\n", f);
      first = false;
      if (e.phase == 'X') {
        std::fprintf(f,
                     "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"X\","
                     "\"ts\":%lld,\"dur\":%lld,\"pid\":%d,\"tid\":%lld}",
                     e.name, e.cat, (long long)e.ts_us, (long long)e.dur_us,
                     pid, (long long)e.tid);
      } else {
        std::fprintf(f,
                     "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"%c\","
                     "\"ts\":%lld,\"pid\":%d,\"tid\":%lld}",
                     e.name, e.cat, e.phase, (long long)e.ts_us, pid,
                     (long long)e.tid);
      }
      e.seq.store(t + kRingSize, std::memory_order_release);  // recycle slot
      tail.store(t + 1, std::memory_order_release);
    }
    std::fflush(f);
  }
};

extern "C" {

bf_timeline_t* bf_timeline_open(const char* path, int32_t pid) {
  FILE* f = std::fopen(path, "w");
  if (!f) return nullptr;
  auto* t = new bf_timeline;
  t->f = f;
  t->pid = pid;
  t->ring = new Event[kRingSize];
  for (uint64_t i = 0; i < kRingSize; ++i)
    t->ring[i].seq.store(i, std::memory_order_relaxed);
  std::fputs("[\n", f);
  t->writer = std::thread([t] { t->Run(); });
  return t;
}

void bf_timeline_event(bf_timeline_t* t, const char* name, const char* cat,
                       char phase, int64_t ts_us, int64_t dur_us,
                       int64_t tid) {
  if (!t) return;
  uint64_t h = t->head.load(std::memory_order_relaxed);
  Event* e;
  for (;;) {  // claim a slot (multi-producer CAS loop)
    e = &t->ring[h & kRingMask];
    uint64_t seq = e->seq.load(std::memory_order_acquire);
    intptr_t dif = (intptr_t)seq - (intptr_t)h;
    if (dif == 0) {
      if (t->head.compare_exchange_weak(h, h + 1,
                                        std::memory_order_relaxed))
        break;
    } else if (dif < 0) {  // ring full: drop, never stall the producer
      t->dropped.fetch_add(1, std::memory_order_relaxed);
      return;
    } else {
      h = t->head.load(std::memory_order_relaxed);
    }
  }
  std::snprintf(e->name, kNameCap, "%s", name ? name : "");
  std::snprintf(e->cat, kCatCap, "%s", cat ? cat : "");
  e->phase = phase;
  e->ts_us = ts_us;
  e->dur_us = dur_us;
  e->tid = tid;
  e->seq.store(h + 1, std::memory_order_release);  // publish
  t->wake_cv.notify_one();
}

int64_t bf_timeline_dropped(bf_timeline_t* t) {
  return t ? t->dropped.load(std::memory_order_relaxed) : 0;
}

void bf_timeline_close(bf_timeline_t* t) {
  if (!t) return;
  t->stop.store(true, std::memory_order_release);
  t->wake_cv.notify_one();
  t->writer.join();
  std::fputs("\n]\n", t->f);
  std::fclose(t->f);
  delete[] t->ring;
  delete t;
}

}  // extern "C"
