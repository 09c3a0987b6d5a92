// The window transport's native service, copied from the JAX package's
// bluefog_tpu/native/src/winsvc.cc so that the wire, the codecs and the
// drain fold stay the same bits: bluefog_tpu_torch/ops/transport.py
// drives it, and bluefog_tpu_torch/native builds it with g++ at first use.
//
// Async one-sided window transport over TCP (DCN path).
//
// The TPU-native answer to the reference's passive-recv service
// (nccl_controller.cc:1113-1238): there, a dedicated thread answers MPI
// control messages and issues ncclRecv into window buffers; here, a TCP
// listener accepts framed put/accumulate/get messages from peer hosts and
// queues them for the host framework (the Python window store) to apply.
// ICI-local window traffic never touches this — it lives in host memory; this
// service exists so win_put/win_accumulate/win_get work ACROSS hosts where
// the reference used MPI RMA over the network.
//
// Wire format (little-endian):
//   u32 magic 0xBF09F06D | u8 op | i32 src | i32 dst | f64 weight |
//   f64 p_weight | u16 name_len | name | u64 payload_len | payload
//
// OP_BATCH (10) frames carry a version-flagged stream of sub-messages —
// many one-sided ops in ONE frame, so the per-frame syscall/connect cost
// amortizes over a whole per-peer send queue.
//
// Two tiers of involvement with the op byte:
//   * the base service (bf_winsvc_send / bf_winsvc_recv) treats it as
//     opaque and only guarantees frames travel as units, in stream order —
//     the PR-4 contract, kept for the Python fallback path;
//   * the native hot path (BLUEFOG_TPU_WIN_NATIVE, default) moves the
//     whole transport hot loop down here: bf_wintx_* runs the per-peer
//     coalescing send queues and builds OP_BATCH frames in C++, and
//     bf_winsvc_drain decodes inbound batches, applies the bf16/sparse
//     payload codecs, groups runs of consecutive puts/accumulates per
//     window and folds same-slot contributions — handing Python one
//     already-folded commit set per win.lock hold.  The fold semantics
//     mirror ops/window._apply_data_run exactly (a PUT starts a fresh
//     entry, an ACCUMULATE folds into the immediately-previous entry of
//     the same (dst, src) slot, runs never span frames), so the result is
//     bit-identical to the Python batched apply — which stays intact as
//     the BLUEFOG_TPU_WIN_NATIVE=0 oracle.
//
// Sends are vectored: the fixed header is assembled into one stack buffer
// and shipped together with the payload via a single sendmsg() (2 iovecs)
// instead of ~9 small send() calls — with TCP_NODELAY each of those small
// writes could leave as its own packet.
//
// Threading: one accept thread; one reader thread per connection (peer count
// = in-degree of this host, small by construction — Exp2 gives log2 n).
// Inbound queue is bounded; when full the reader blocks, which backpressures
// the sender's TCP stream rather than dropping gossip messages.
// Connections that close (peer restart, stall-probe liveness pings that
// connect and immediately disconnect) are reaped: the acceptor joins
// finished readers on each new connection, so dead threads and closed fds
// never accumulate and shutdown never touches a recycled fd number.
//
// All sender-worker socket IO is non-blocking with short poll slices that
// watch the peer's closing flag, so drop_peer/stop never wait out a
// SYN timeout to a blackholed host.

#include "bluefog_native.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <cerrno>
#include <cmath>
#include <cstring>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <set>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xBF09F06Du;

// Wire op constants shared with ops/transport.py (the single source of
// truth for the codes; these mirrors exist only for the native hot path).
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpAccumulate = 2;
constexpr uint8_t kOpBatch = 10;
constexpr uint8_t kFlagBf16 = 0x40;
constexpr uint8_t kFlagSparse = 0x20;
constexpr uint8_t kFlagTrace = 0x10;  // OP_TRACE_FLAG: payload carries a
                                      // 24-byte (src, seq, origin) trailer
constexpr uint8_t kFlagMask = kFlagBf16 | kFlagSparse | kFlagTrace;
constexpr uint8_t kBatchVersion = 1;

// The telemetry module's shared log-spaced histogram boundary table
// (utils/telemetry._HIST_BUCKETS: 1e-6 .. 5e1, 1-2.5-5 ladder).  Native
// histograms use the same 24 boundaries + overflow so the Python side can
// merge bucket counts into the registry by elementwise addition.
constexpr double kHistBuckets[24] = {
    1e-06, 2.5e-06, 5e-06, 1e-05, 2.5e-05, 5e-05, 1e-04, 2.5e-04,
    5e-04, 1e-03,   2.5e-03, 5e-03, 1e-02, 2.5e-02, 5e-02, 1e-01,
    2.5e-01, 5e-01, 1e+00, 2.5e+00, 5e+00, 1e+01, 2.5e+01, 5e+01};

inline int HistIndex(double v) {
  int i = 0;
  while (i < 24 && kHistBuckets[i] < v) ++i;  // bisect_left semantics
  return i;
}

inline double NowSec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline int64_t MonoUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline int64_t UnixUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Flight recorder (bf_rec_*) + wire trace-tag sampling (bf_trace_*)
// ---------------------------------------------------------------------------
// The recorder is a process-wide fixed-size ring armed once; every record
// site is one relaxed atomic pointer load when the ring is off — the
// transport hot paths pay nothing until an operator arms the black box.
// Slot claims are a relaxed fetch_add, so concurrent writers never
// serialize; a snapshot taken while traffic is live may carry a few torn
// in-flight slots (documented flight-recorder semantics).

struct RecRing {
  std::vector<bf_rec_event_t> ev;
  std::atomic<uint64_t> idx{0};
  explicit RecRing(size_t cap) : ev(cap) {}
};

std::atomic<RecRing*> g_rec{nullptr};
std::mutex g_rec_m;  // serializes enable/reset only, never record

std::atomic<int32_t> g_trace_period{0};
std::atomic<uint32_t> g_trace_count{0};
std::atomic<uint32_t> g_trace_seq{0};
std::atomic<int64_t> g_trace_step{-1};
// 1 (default): the drain fold may merge an accumulate into a PUT-headed
// commit entry (the legacy-exact behavior).  0 (async bounded-staleness
// mode): accumulates never fold across a put, so every accumulate gets
// its own staleness decision at the Python commit.
std::atomic<int32_t> g_fold_across_put{1};

inline bool RecOn() {
  return g_rec.load(std::memory_order_acquire) != nullptr;
}

void RecNoteN(uint8_t etype, uint8_t op, uint8_t stripe, int32_t src,
              int32_t dst, uint32_t seq, uint64_t len, const char* name,
              size_t nlen) {
  RecRing* r = g_rec.load(std::memory_order_acquire);
  if (!r) return;
  uint64_t i = r->idx.fetch_add(1, std::memory_order_relaxed);
  bf_rec_event_t& e = r->ev[(size_t)(i % r->ev.size())];
  e.t_us = MonoUs();
  e.src = src;
  e.dst = dst;
  e.seq = seq;
  e.len = len > 0xffffffffull ? 0xffffffffu : (uint32_t)len;
  e.etype = etype;
  e.op = op;
  e.stripe = stripe;
  e.flags = 0;
  if (nlen >= sizeof(e.name)) nlen = sizeof(e.name) - 1;
  std::memset(e.name, 0, sizeof(e.name));
  if (name && nlen) std::memcpy(e.name, name, nlen);
}

inline void RecNote(uint8_t etype, uint8_t op, uint8_t stripe, int32_t src,
                    int32_t dst, uint32_t seq, uint64_t len,
                    const char* name) {
  if (!RecOn()) return;
  RecNoteN(etype, op, stripe, src, dst, seq, len, name,
           name ? std::strlen(name) : 0);
}

// bf16 -> f32 widening (exact: bf16 is f32's top 16 bits).
inline float WidenBf16(uint16_t h) {
  uint32_t u = ((uint32_t)h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct Inbound {
  bf_win_msg_t msg;
  std::vector<uint8_t> payload;
};

bool ReadFull(int fd, void* buf, size_t len) {
  auto* p = static_cast<uint8_t*>(buf);
  while (len > 0) {
    ssize_t r = ::recv(fd, p, len, 0);
    if (r <= 0) return false;
    p += r;
    len -= (size_t)r;
  }
  return true;
}

// Gather-write every iovec fully (sendmsg so MSG_NOSIGNAL applies — a
// peer closing mid-write must surface as an error, not SIGPIPE).  iov is
// consumed in place.
bool WritevFull(int fd, struct iovec* iov, int iovcnt) {
  while (iovcnt > 0) {
    msghdr mh{};
    mh.msg_iov = iov;
    mh.msg_iovlen = iovcnt;
    ssize_t r = ::sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    auto n = (size_t)r;
    while (iovcnt > 0 && n >= iov[0].iov_len) {
      n -= iov[0].iov_len;
      ++iov;
      --iovcnt;
    }
    if (iovcnt > 0) {
      iov[0].iov_base = static_cast<uint8_t*>(iov[0].iov_base) + n;
      iov[0].iov_len -= n;
    }
  }
  return true;
}

// Assemble the fixed frame header (magic through payload_len) into a
// caller-provided stack buffer; returns the header length.  name_len must
// already be < 128 (the receiver's field size).
constexpr size_t kMaxHdr = 4 + 1 + 4 + 4 + 8 + 8 + 2 + 128 + 8;

size_t BuildHeader(uint8_t* hdr, uint8_t op, int32_t src, int32_t dst,
                   double weight, double p_weight, const char* name,
                   uint16_t name_len, uint64_t payload_len) {
  size_t off = 0;
  auto put = [&](const void* p, size_t len) {
    std::memcpy(hdr + off, p, len);
    off += len;
  };
  put(&kMagic, 4);
  put(&op, 1);
  put(&src, 4);
  put(&dst, 4);
  put(&weight, 8);
  put(&p_weight, 8);
  put(&name_len, 2);
  put(name, name_len);
  put(&payload_len, 8);
  return off;
}

}  // namespace

extern "C" {

void bf_trace_configure(int32_t period) {
  g_trace_period.store(period < 0 ? 0 : period, std::memory_order_relaxed);
}

int32_t bf_trace_period(void) {
  return g_trace_period.load(std::memory_order_relaxed);
}

void bf_trace_set_step(int64_t step) {
  g_trace_step.store(step, std::memory_order_relaxed);
}

void bf_winsvc_set_fold_across_put(int32_t allow) {
  g_fold_across_put.store(allow ? 1 : 0, std::memory_order_relaxed);
}

int64_t bf_trace_step(void) {
  return g_trace_step.load(std::memory_order_relaxed);
}

int32_t bf_trace_next(int32_t src, uint8_t* trailer) {
  int32_t p = g_trace_period.load(std::memory_order_relaxed);
  if (p <= 0 || trailer == nullptr) return 0;
  uint32_t c = g_trace_count.fetch_add(1, std::memory_order_relaxed);
  if (c % (uint32_t)p) return 0;
  // Bit 31 marks the native sequence space: Python-side tags count up
  // from 1, so one process's (src_rank, seq) never collides across the
  // two encoders.
  uint32_t seq = 0x80000000u |
                 (g_trace_seq.fetch_add(1, std::memory_order_relaxed) + 1);
  int64_t mono = MonoUs(), unix_us = UnixUs();
  int64_t step = g_trace_step.load(std::memory_order_relaxed);
  std::memcpy(trailer, &src, 4);
  std::memcpy(trailer + 4, &seq, 4);
  std::memcpy(trailer + 8, &mono, 8);
  std::memcpy(trailer + 16, &unix_us, 8);
  std::memcpy(trailer + 24, &step, 8);
  return 1;
}

int64_t bf_rec_enable(int64_t capacity) {
  std::lock_guard<std::mutex> lk(g_rec_m);
  RecRing* r = g_rec.load(std::memory_order_acquire);
  if (r != nullptr) return (int64_t)r->ev.size();
  if (capacity <= 0) capacity = 65536;
  r = new RecRing((size_t)capacity);
  g_rec.store(r, std::memory_order_release);
  return capacity;
}

int32_t bf_rec_is_enabled(void) { return RecOn() ? 1 : 0; }

void bf_rec_note(int32_t etype, int32_t op, int32_t stripe, int32_t src,
                 int32_t dst, uint32_t seq, uint64_t len, const char* name) {
  RecNote((uint8_t)etype, (uint8_t)op, (uint8_t)stripe, src, dst, seq, len,
          name);
}

int64_t bf_rec_snapshot(bf_rec_event_t* out, int64_t cap) {
  RecRing* r = g_rec.load(std::memory_order_acquire);
  if (!r) return 0;
  uint64_t total = r->idx.load(std::memory_order_acquire);
  uint64_t size = (uint64_t)r->ev.size();
  uint64_t n = total < size ? total : size;
  if (out == nullptr) return (int64_t)n;
  if ((uint64_t)cap < n) n = (uint64_t)cap;
  // Oldest-first: when the ring has wrapped, the oldest live slot is at
  // total % size (the next one to be overwritten).
  uint64_t start = total < size ? 0 : total % size;
  for (uint64_t i = 0; i < n; ++i)
    out[i] = r->ev[(size_t)((start + i) % size)];
  return (int64_t)n;
}

void bf_rec_reset(void) {
  std::lock_guard<std::mutex> lk(g_rec_m);
  RecRing* r = g_rec.load(std::memory_order_acquire);
  if (!r) return;
  r->idx.store(0, std::memory_order_release);
  for (auto& e : r->ev) std::memset(&e, 0, sizeof(e));
}

}  // extern "C"

// One frame decoded by the drain-side pool into its OWN buffers (so
// decode of different connections/stripes runs in parallel); the drain
// call copies the result into the caller's arrays in arrival order.
struct DecodedFrame {
  std::vector<bf_win_item_t> items;
  std::vector<uint8_t> raw;
  std::vector<float> vals;
  uint64_t raw_len = 0;  // used bytes / elements of the vectors
  uint64_t val_len = 0;
  int32_t n_items = 0;
};

struct bf_winsvc {
  int listen_fd = -1;
  int32_t port = 0;
  int32_t max_pending = 1024;
  std::mutex m;
  std::condition_variable cv_space;
  std::condition_variable cv_data;  // signaled by readers on enqueue, so
                                    // bf_winsvc_drain can BLOCK in C (GIL
                                    // released) instead of Python polling
  std::deque<Inbound> q;
  bool stopping = false;
  std::thread acceptor;
  std::mutex conn_m;
  // Native drain path: registered f32 windows (name -> flat element
  // count) and the cumulative decode counters.  win_m orders
  // registration against frame decode — shared (read) side taken by the
  // decoders, so POOL WORKERS DECODE CONCURRENTLY and only the rare
  // win_set registration excludes them; rx is guarded by m.
  std::shared_mutex win_m;
  std::unordered_map<std::string, int64_t> wins;
  bf_winrx_stats_t rx{};
  // Drain-side decode pool (bf_winsvc_set_decode).  Workers pop frames
  // off q, stamping each with a sequence ticket under m (= arrival
  // order), decode into per-frame buffers in parallel, and park the
  // result in `decoded`; the drain call emits strictly in ticket order —
  // per-connection FIFO (the fence/mutex contract) is preserved exactly,
  // only the decode WORK overlaps.  All guarded by m except decode_busy.
  int32_t decode_threads = 0;
  std::vector<std::thread> dpool;
  std::condition_variable cv_decoded;
  std::map<uint64_t, DecodedFrame> decoded;
  uint64_t seq_assign = 0;  // next ticket to hand a worker
  uint64_t seq_emit = 0;    // next ticket the drain will emit
  std::atomic<int64_t> decode_busy{0};
  uint64_t decoded_frames = 0;

  void DecodeWorker();
  struct Slot {
    std::thread t;
    int fd = -1;
    bool closed = false;           // guarded by conn_m
    std::atomic<bool> done{false}; // set last; safe to join once true
  };
  std::list<Slot> slots;  // stable addresses; guarded by conn_m

  void Reader(Slot* slot) {
    const int fd = slot->fd;
    for (;;) {
      uint32_t magic;
      if (!ReadFull(fd, &magic, 4) || magic != kMagic) break;
      Inbound in{};
      uint16_t name_len;
      if (!ReadFull(fd, &in.msg.op, 1) || !ReadFull(fd, &in.msg.src, 4) ||
          !ReadFull(fd, &in.msg.dst, 4) || !ReadFull(fd, &in.msg.weight, 8) ||
          !ReadFull(fd, &in.msg.p_weight, 8) || !ReadFull(fd, &name_len, 2))
        break;
      if (name_len >= sizeof(in.msg.name)) break;
      if (!ReadFull(fd, in.msg.name, name_len)) break;
      in.msg.name[name_len] = '\0';
      if (!ReadFull(fd, &in.msg.payload_len, 8)) break;
      if (in.msg.payload_len > (1ull << 33)) break;  // 8 GiB sanity cap
      in.payload.resize(in.msg.payload_len);
      if (in.msg.payload_len &&
          !ReadFull(fd, in.payload.data(), in.msg.payload_len))
        break;
      std::unique_lock<std::mutex> lk(m);
      cv_space.wait(lk, [this] {
        return stopping || (int32_t)q.size() < max_pending;
      });
      if (stopping) break;
      q.push_back(std::move(in));
      cv_data.notify_one();
    }
    {
      // Close under conn_m so bf_winsvc_stop never calls shutdown() on an
      // fd number the kernel has already recycled for another socket.
      std::lock_guard<std::mutex> lk(conn_m);
      ::close(fd);
      slot->closed = true;
    }
    slot->done.store(true, std::memory_order_release);
  }

  void Reap() {  // acceptor thread only
    std::lock_guard<std::mutex> lk(conn_m);
    for (auto it = slots.begin(); it != slots.end();) {
      if (it->done.load(std::memory_order_acquire)) {
        it->t.join();  // already past its conn_m use: join cannot deadlock
        it = slots.erase(it);
      } else {
        ++it;
      }
    }
  }

  void Accept() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) break;  // listen_fd closed => shutdown
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      Reap();
      std::lock_guard<std::mutex> lk(conn_m);
      slots.emplace_back();
      Slot* slot = &slots.back();
      slot->fd = fd;
      slot->t = std::thread([this, slot] { Reader(slot); });
    }
  }
};

extern "C" {

bf_winsvc_t* bf_winsvc_start(int32_t port, int32_t max_pending) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, (sockaddr*)&addr, &alen);
  auto* s = new bf_winsvc;
  s->listen_fd = fd;
  s->port = (int32_t)ntohs(addr.sin_port);
  if (max_pending > 0) s->max_pending = max_pending;
  s->acceptor = std::thread([s] { s->Accept(); });
  return s;
}

int32_t bf_winsvc_port(bf_winsvc_t* s) { return s ? s->port : -1; }

int32_t bf_winsvc_recv(bf_winsvc_t* s, bf_win_msg_t* msg, uint8_t* payload,
                       uint64_t cap) {
  if (!s) return 0;
  std::lock_guard<std::mutex> lk(s->m);
  if (s->q.empty()) return 0;
  Inbound& in = s->q.front();
  if (in.payload.size() > cap) return -1;
  *msg = in.msg;
  if (!in.payload.empty())
    std::memcpy(payload, in.payload.data(), in.payload.size());
  s->q.pop_front();
  s->cv_space.notify_one();
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native drain: OP_BATCH decode + codec + same-slot fold
// ---------------------------------------------------------------------------

namespace {

struct RxTally {
  uint64_t batch_frames = 0, msgs = 0, folded = 0, commits = 0, bytes = 0;
  uint64_t by_op[16] = {0};
  uint64_t bs_hist[25] = {0};
  double bs_sum = 0.0;
};

struct DrainCursor {
  bf_win_item_t* items;
  int32_t max_items;
  int32_t n_items;
  uint8_t* raw_buf;
  uint64_t raw_cap, raw_off;
  float* val_buf;
  uint64_t val_cap, val_off;  // val offsets/caps in ELEMENTS
};

// Emit one raw item (payload copied into raw_buf, 8-byte aligned so the
// Python side can frombuffer it without an alignment copy).  Returns 0,
// -1 raw_buf full, -3 items full.
int EmitRaw(DrainCursor* c, uint8_t op, int32_t src, int32_t dst,
            double weight, double p_weight, const char* name,
            size_t name_len, const uint8_t* payload, uint64_t plen) {
  if (c->n_items >= c->max_items) return -3;
  uint64_t off = (c->raw_off + 7) & ~7ull;
  if (off + plen > c->raw_cap) return -1;
  bf_win_item_t& it = c->items[c->n_items++];
  std::memset(&it, 0, sizeof(it));
  it.kind = 0;
  it.op = op;
  it.src = src;
  it.dst = dst;
  it.weight = weight;
  it.p_weight = p_weight;
  if (name_len >= sizeof(it.name)) name_len = sizeof(it.name) - 1;
  std::memcpy(it.name, name, name_len);
  it.name[name_len] = '\0';
  it.off = off;
  it.len = plen;
  if (plen) std::memcpy(c->raw_buf + off, payload, plen);
  c->raw_off = off + plen;
  return 0;
}

// Decode one data payload into dst[0..elems) scaled by wf, replicating
// ops/window._payload_row + the `row * weight` scale bit-for-bit (no FP
// contraction: the Makefile passes -ffp-contract=off).  Returns false on
// any validation failure (wrong byte count, sparse index out of range) —
// the caller emits the sub-message raw so the Python path raises/logs
// exactly as it does today.
bool DecodePayload(const uint8_t* pp, uint64_t plen, uint8_t op, float wf,
                   int64_t elems, float* dst, bool fold,
                   std::vector<float>& scratch) {
  if (op & kFlagSparse) {
    // u32 k | k x i32 idx | k x f32 val, scattered into a zero row; the
    // FULL row is then scaled and (when folding) added — including the
    // zeros, so -0.0 accumulator entries normalize to +0.0 exactly as
    // numpy's whole-row add does.
    if (plen < 4) return false;
    uint32_t k;
    std::memcpy(&k, pp, 4);
    if (plen != 4ull + 8ull * k) return false;
    scratch.assign((size_t)elems, 0.0f);
    const uint8_t* ip = pp + 4;
    const uint8_t* vp = pp + 4 + 4ull * k;
    for (uint32_t j = 0; j < k; ++j) {
      int32_t idx;
      std::memcpy(&idx, ip + 4ull * j, 4);
      if (idx < 0 || idx >= elems) return false;
      float v;
      std::memcpy(&v, vp + 4ull * j, 4);
      scratch[(size_t)idx] = v;
    }
    if (fold) {
      for (int64_t i = 0; i < elems; ++i) {
        float t = scratch[(size_t)i] * wf;
        dst[i] += t;
      }
    } else {
      for (int64_t i = 0; i < elems; ++i) dst[i] = scratch[(size_t)i] * wf;
    }
    return true;
  }
  if (op & kFlagBf16) {
    if (plen != (uint64_t)elems * 2) return false;
    for (int64_t i = 0; i < elems; ++i) {
      uint16_t h;
      std::memcpy(&h, pp + 2 * i, 2);
      float t = WidenBf16(h) * wf;
      if (fold)
        dst[i] += t;
      else
        dst[i] = t;
    }
    return true;
  }
  if (plen != (uint64_t)elems * 4) return false;
  for (int64_t i = 0; i < elems; ++i) {
    float v;
    std::memcpy(&v, pp + 4 * i, 4);
    float t = v * wf;
    if (fold)
      dst[i] += t;
    else
      dst[i] = t;
  }
  return true;
}

// Decode one inbound frame into the cursor.  Returns 0 on success (items
// emitted, tally updated for natively decoded batches), or -1/-2/-3 when a
// buffer is too small (cursor rolled back, frame untouched).
int DecodeFrame(bf_winsvc* s, const Inbound& in, DrainCursor* c,
                RxTally* tally, uint8_t frame_tag) {
  const int32_t save_items = c->n_items;
  const uint64_t save_raw = c->raw_off, save_val = c->val_off;
  const uint8_t* buf = in.payload.data();
  const uint64_t len = in.payload.size();
  // Whole-frame fallback: hand the frame to Python untouched (its decoder
  // owns error reporting for malformed/foreign frames, and its telemetry
  // owns the counting — nothing is tallied here for fallback frames).
  auto whole_raw = [&]() -> int {
    c->n_items = save_items;
    c->raw_off = save_raw;
    c->val_off = save_val;
    return EmitRaw(c, in.msg.op, in.msg.src, in.msg.dst, in.msg.weight,
                   in.msg.p_weight, in.msg.name, std::strlen(in.msg.name),
                   buf, len);
  };
  if (in.msg.op != kOpBatch) {
    // Singleton frame: raw pass-through, counted here (the Python item
    // loop counts only fallback OP_BATCH frames, whose decode it owns).
    int rc = whole_raw();
    if (rc == 0) {
      tally->msgs++;
      tally->by_op[(in.msg.op & (uint8_t)~kFlagMask) & 15]++;
      tally->bytes += len;
    }
    return rc;
  }
  if (len < 5) return whole_raw();
  uint8_t ver = buf[0];
  uint32_t count;
  std::memcpy(&count, buf + 1, 4);
  if (ver != kBatchVersion) return whole_raw();
  RxTally local{};
  uint64_t off = 5;
  int last_commit = -1;  // item index an ACCUMULATE may fold into
  // One registry lookup per name change (consecutive sub-messages are
  // overwhelmingly same-window), under a SHARED win_m hold for the whole
  // frame: concurrent decode workers read the registry in parallel and
  // only bf_winsvc_win_set takes the exclusive side.
  std::shared_lock<std::shared_mutex> wlk(s->win_m);
  const char* cached_name = nullptr;
  size_t cached_len = 0;
  int64_t cached_elems = -1;
  thread_local std::vector<float> scratch;
  for (uint32_t i = 0; i < count; ++i) {
    if (off + 27 > len) return whole_raw();
    uint8_t op = buf[off];
    int32_t msrc, mdst;
    double w, pw;
    uint16_t nlen;
    std::memcpy(&msrc, buf + off + 1, 4);
    std::memcpy(&mdst, buf + off + 5, 4);
    std::memcpy(&w, buf + off + 9, 8);
    std::memcpy(&pw, buf + off + 17, 8);
    std::memcpy(&nlen, buf + off + 25, 2);
    off += 27;
    if (off + nlen + 8 > len) return whole_raw();
    if (nlen >= 128) return whole_raw();  // item name field cannot carry it
    const char* nm = (const char*)(buf + off);
    off += nlen;
    uint64_t plen;
    std::memcpy(&plen, buf + off, 8);
    off += 8;
    if (off + plen > len || plen > len) return whole_raw();
    const uint8_t* pp = buf + off;
    off += plen;
    uint8_t base = op & (uint8_t)~kFlagMask;
    local.msgs++;
    local.by_op[base & 15]++;
    bool is_data = (base == kOpPut || base == kOpAccumulate);
    int64_t elems = -1;
    if (is_data) {
      if (cached_name != nullptr && cached_len == nlen &&
          std::memcmp(cached_name, nm, nlen) == 0) {
        elems = cached_elems;
      } else {
        auto wit = s->wins.find(std::string(nm, nlen));
        elems = (wit == s->wins.end()) ? -1 : wit->second;
        cached_name = nm;
        cached_len = nlen;
        cached_elems = elems;
      }
    }
    if (!is_data || elems < 0) {
      // Control op, or a window Python did not register (not created yet,
      // non-f32 dtype): raw pass-through, ends the fold run.
      int rc = EmitRaw(c, op, msrc, mdst, w, pw, nm, nlen, pp, plen);
      if (rc != 0) {
        c->n_items = save_items;
        c->raw_off = save_raw;
        c->val_off = save_val;
        return rc;
      }
      c->items[c->n_items - 1].frame = frame_tag;
      last_commit = -1;
      continue;
    }
    float wf = (float)w;
    // Wire trace tag (kFlagTrace): strip the 32-byte trailer BEFORE the
    // codec validation (the payload-length checks are exact); the full
    // plen still counts as wire bytes.  A tagged payload too short to
    // carry its trailer is malformed — raw emit, losing only itself,
    // exactly like any other bad payload.
    uint64_t dlen = plen;
    uint32_t tr_seq = 0;
    int32_t tr_src = 0;
    int64_t tr_mono = 0, tr_unix = 0, tr_step = -1;
    if (op & kFlagTrace) {
      if (plen < BF_TRACE_TRAILER_LEN) {
        int rc = EmitRaw(c, op, msrc, mdst, w, pw, nm, nlen, pp, plen);
        if (rc != 0) {
          c->n_items = save_items;
          c->raw_off = save_raw;
          c->val_off = save_val;
          return rc;
        }
        c->items[c->n_items - 1].frame = frame_tag;
        continue;
      }
      const uint8_t* tp = pp + plen - BF_TRACE_TRAILER_LEN;
      std::memcpy(&tr_src, tp, 4);
      std::memcpy(&tr_seq, tp + 4, 4);
      std::memcpy(&tr_mono, tp + 8, 8);
      std::memcpy(&tr_unix, tp + 16, 8);
      std::memcpy(&tr_step, tp + 24, 8);
      dlen -= BF_TRACE_TRAILER_LEN;
      if (RecOn())
        RecNoteN(BF_REC_DECODE, op, 0, msrc, mdst, tr_seq, plen, nm, nlen);
    }
    bool can_fold = false;
    if (base == kOpAccumulate && last_commit >= 0) {
      bf_win_item_t& prev = c->items[last_commit];
      can_fold = prev.src == msrc && prev.dst == mdst &&
                 prev.name[nlen] == '\0' &&
                 std::memcmp(prev.name, nm, nlen) == 0;
      // Async bounded-staleness mode: never fold an accumulate into a
      // PUT-headed entry — puts bypass the staleness policy (overwrite
      // semantics), so the fold would smuggle the accumulate's mass
      // past it.  Accumulate-into-accumulate folds stay.
      if (can_fold && prev.replace &&
          !g_fold_across_put.load(std::memory_order_relaxed))
        can_fold = false;
    }
    if (can_fold) {
      bf_win_item_t& prev = c->items[last_commit];
      if (!DecodePayload(pp, dlen, op, wf, elems, c->val_buf + prev.off,
                         /*fold=*/true, scratch)) {
        // Malformed payload: this sub-message alone goes raw (Python
        // raises + logs it, losing only itself); the fold run survives —
        // exactly what _apply_data_run's `continue` does.
        int rc = EmitRaw(c, op, msrc, mdst, w, pw, nm, nlen, pp, plen);
        if (rc != 0) {
          c->n_items = save_items;
          c->raw_off = save_raw;
          c->val_off = save_val;
          return rc;
        }
        c->items[c->n_items - 1].frame = frame_tag;
        continue;
      }
      prev.p_weight += pw;
      prev.accs += 1;
      prev.wire_bytes += plen;
      if (tr_seq) {
        // The commit entry carries the LAST tag folded into it — at
        // 1/N sampling a multi-tag fold is rare, and the freshest tag
        // is the one the staleness bound cares about.
        prev.trace_seq = tr_seq;
        prev.trace_src = tr_src;
        prev.trace_mono_us = tr_mono;
        prev.trace_unix_us = tr_unix;
        prev.trace_step = tr_step;
        if (RecOn())
          RecNoteN(BF_REC_FOLD, op, 0, msrc, mdst, tr_seq, plen, nm, nlen);
      }
      local.folded++;
      continue;
    }
    // Fresh commit entry.
    if (c->n_items >= c->max_items) {
      c->n_items = save_items;
      c->raw_off = save_raw;
      c->val_off = save_val;
      return -3;
    }
    if (c->val_off + (uint64_t)elems > c->val_cap) {
      c->n_items = save_items;
      c->raw_off = save_raw;
      c->val_off = save_val;
      return -2;
    }
    if (!DecodePayload(pp, dlen, op, wf, elems, c->val_buf + c->val_off,
                       /*fold=*/false, scratch)) {
      int rc = EmitRaw(c, op, msrc, mdst, w, pw, nm, nlen, pp, plen);
      if (rc != 0) {
        c->n_items = save_items;
        c->raw_off = save_raw;
        c->val_off = save_val;
        return rc;
      }
      c->items[c->n_items - 1].frame = frame_tag;
      continue;
    }
    bf_win_item_t& it = c->items[c->n_items];
    std::memset(&it, 0, sizeof(it));
    it.kind = 1;
    it.frame = frame_tag;
    it.replace = (base == kOpPut) ? 1 : 0;
    it.src = msrc;
    it.dst = mdst;
    it.puts = (base == kOpPut) ? 1 : 0;
    it.accs = (base == kOpAccumulate) ? 1 : 0;
    it.p_weight = pw;
    it.off = c->val_off;
    it.len = (uint64_t)elems;
    it.wire_bytes = plen;
    it.trace_seq = tr_seq;
    it.trace_src = tr_src;
    it.trace_mono_us = tr_mono;
    it.trace_unix_us = tr_unix;
    it.trace_step = tr_step;
    std::memcpy(it.name, nm, nlen);
    it.name[nlen] = '\0';
    last_commit = c->n_items;
    c->n_items++;
    c->val_off += (uint64_t)elems;
    local.commits++;
    local.folded++;
  }
  if (off != len) return whole_raw();  // trailing bytes: Python raises
  tally->batch_frames++;
  tally->msgs += local.msgs;
  tally->folded += local.folded;
  tally->commits += local.commits;
  tally->bytes += len;
  for (int i = 0; i < 16; ++i) tally->by_op[i] += local.by_op[i];
  tally->bs_hist[HistIndex((double)count)]++;
  tally->bs_sum += (double)count;
  return 0;
}

// Decode one frame into a DecodedFrame's OWN buffers, growing them on
// demand (the caller-buffer grow codes -1/-2/-3 become retries here).
// The fold arithmetic is the SAME DecodeFrame the inline path runs —
// the pool changes scheduling, never bytes.
void DecodeOwned(bf_winsvc* s, const Inbound& in, DecodedFrame* df,
                 RxTally* tally) {
  df->items.resize(64);
  df->raw.resize(in.payload.size() + 64);
  df->vals.resize(4096);
  for (;;) {
    DrainCursor c{df->items.data(), (int32_t)df->items.size(), 0,
                  df->raw.data(), (uint64_t)df->raw.size(), 0,
                  df->vals.data(), (uint64_t)df->vals.size(), 0};
    RxTally local{};
    // frame_tag 1: a placeholder the drain remaps to its cycling
    // per-frame ordinal at emit time (one frame per DecodedFrame, so a
    // constant is unambiguous).
    int rc = DecodeFrame(s, in, &c, &local, /*frame_tag=*/1);
    if (rc == 0) {
      df->n_items = c.n_items;
      df->raw_len = c.raw_off;
      df->val_len = c.val_off;
      *tally = local;
      return;
    }
    if (rc == -1)
      df->raw.resize(df->raw.size() * 2);
    else if (rc == -2)
      df->vals.resize(df->vals.size() * 2);
    else
      df->items.resize(df->items.size() * 2);
  }
}

// Copy one decoded frame into the caller's drain buffers (arrival-order
// emit).  Returns 0, or the -1/-2/-3 grow code when the caller's buffers
// cannot take it (nothing partially written).
int EmitDecoded(const DecodedFrame& df, DrainCursor* c, uint8_t frame_tag) {
  if (c->n_items + df.n_items > c->max_items) return -3;
  const uint64_t raw_base = (c->raw_off + 7) & ~7ull;  // keep items 8-aligned
  if (raw_base + df.raw_len > c->raw_cap) return -1;
  if (c->val_off + df.val_len > c->val_cap) return -2;
  if (df.raw_len) std::memcpy(c->raw_buf + raw_base, df.raw.data(), df.raw_len);
  if (df.val_len)
    std::memcpy(c->val_buf + c->val_off, df.vals.data(), df.val_len * 4);
  for (int32_t i = 0; i < df.n_items; ++i) {
    bf_win_item_t& it = c->items[c->n_items + i];
    it = df.items[(size_t)i];
    it.off += it.kind ? c->val_off : raw_base;
    if (it.frame) it.frame = frame_tag;
  }
  c->n_items += df.n_items;
  c->raw_off = raw_base + df.raw_len;
  c->val_off += df.val_len;
  return 0;
}

}  // namespace

void bf_winsvc::DecodeWorker() {
  for (;;) {
    Inbound in;
    uint64_t seq;
    {
      std::unique_lock<std::mutex> lk(m);
      cv_data.wait(lk, [this] {
        return stopping ||
               (!q.empty() && seq_assign - seq_emit < (uint64_t)max_pending);
      });
      if (stopping) return;
      in = std::move(q.front());
      q.pop_front();
      seq = seq_assign++;
      cv_space.notify_one();  // q space freed: unblock a reader
    }
    if (RecOn())
      RecNote(BF_REC_DRAIN, in.msg.op, 0, in.msg.src, in.msg.dst, 0,
              in.payload.size(), in.msg.name);
    decode_busy.fetch_add(1, std::memory_order_acq_rel);
    DecodedFrame df;
    RxTally tally{};
    DecodeOwned(this, in, &df, &tally);
    decode_busy.fetch_sub(1, std::memory_order_acq_rel);
    {
      std::lock_guard<std::mutex> lk(m);
      rx.batch_frames += tally.batch_frames;
      rx.msgs += tally.msgs;
      rx.folded_msgs += tally.folded;
      rx.commits += tally.commits;
      rx.bytes += tally.bytes;
      for (int i = 0; i < 16; ++i) rx.by_op[i] += tally.by_op[i];
      for (int i = 0; i < 25; ++i) rx.batch_size_hist[i] += tally.bs_hist[i];
      rx.batch_size_sum += tally.bs_sum;
      decoded_frames++;
      decoded[seq] = std::move(df);
      cv_decoded.notify_all();
    }
  }
}

extern "C" {

int32_t bf_winsvc_win_set(bf_winsvc_t* s, const char* name, int64_t elems) {
  if (!s || !name) return -1;
  if (std::strlen(name) >= 128) return -4;
  std::lock_guard<std::shared_mutex> lk(s->win_m);
  if (elems > 0)
    s->wins[name] = elems;
  else
    s->wins.erase(name);
  return 0;
}

namespace {

// Pooled drain: emit already-decoded frames strictly in arrival order.
// The decode work happened on the pool; what remains here is bounded
// memcpys into the caller's buffers.
int32_t DrainPooled(bf_winsvc* s, DrainCursor* c, int32_t max_frames,
                    int32_t wait_ms) {
  int frames = 0;
  int grow_rc = 0;
  uint8_t frame_tag = 0;
  while (frames < max_frames) {
    DecodedFrame df;
    uint64_t seq;
    {
      std::unique_lock<std::mutex> lk(s->m);
      seq = s->seq_emit;
      if (!s->decoded.count(seq)) {
        // Only the FIRST frame is worth waiting for (same rule as the
        // inline path): once something was emitted, return it.
        if (frames > 0 || c->n_items > 0 || wait_ms <= 0) break;
        s->cv_decoded.wait_for(lk, std::chrono::milliseconds(wait_ms),
                               [&] {
                                 return s->decoded.count(seq) || s->stopping;
                               });
        if (!s->decoded.count(seq)) break;
      }
      df = std::move(s->decoded[seq]);
      s->decoded.erase(seq);
    }
    frame_tag = (uint8_t)(frame_tag == 255 ? 1 : frame_tag + 1);
    int rc = EmitDecoded(df, c, frame_tag);
    std::lock_guard<std::mutex> lk(s->m);
    if (rc != 0) {
      // Caller buffers too small: park the frame back at its ticket
      // (order preserved) and report what was emitted so far — or, with
      // nothing emitted, the grow request itself.
      s->decoded[seq] = std::move(df);
      grow_rc = rc;
      break;
    }
    s->seq_emit = seq + 1;
    s->cv_data.notify_all();  // in-flight shrank: wake bounded workers
    frames++;
  }
  if (c->n_items == 0 && grow_rc != 0) return grow_rc;
  return c->n_items;
}

}  // namespace

int32_t bf_winsvc_drain(bf_winsvc_t* s, bf_win_item_t* items,
                        int32_t max_items, uint8_t* raw_buf, uint64_t raw_cap,
                        float* val_buf, uint64_t val_cap, int32_t max_frames,
                        int32_t wait_ms) {
  if (!s || max_items <= 0) return 0;
  DrainCursor c{items, max_items, 0, raw_buf, raw_cap, 0, val_buf, val_cap, 0};
  if (s->decode_threads > 0)
    return DrainPooled(s, &c, max_frames, wait_ms);
  RxTally tally;
  int frames = 0;
  int grow_rc = 0;
  uint8_t frame_tag = 0;  // per-frame ordinal, 1..255 cycling (0 reserved)
  while (frames < max_frames) {
    Inbound in;
    {
      std::unique_lock<std::mutex> lk(s->m);
      if (s->q.empty()) {
        // Block here (caller's GIL is released across the ctypes call)
        // instead of making the host poll: the drain thread sleeps in C
        // and wakes the instant a reader queues a frame.  Only the FIRST
        // frame is worth waiting for — once something was decoded,
        // return it rather than sitting on it.
        if (frames > 0 || c.n_items > 0 || wait_ms <= 0) break;
        s->cv_data.wait_for(lk, std::chrono::milliseconds(wait_ms),
                            [&] { return !s->q.empty() || s->stopping; });
        if (s->q.empty()) break;
      }
      in = std::move(s->q.front());
      s->q.pop_front();
      s->cv_space.notify_one();
    }
    if (RecOn())
      RecNote(BF_REC_DRAIN, in.msg.op, 0, in.msg.src, in.msg.dst, 0,
              in.payload.size(), in.msg.name);
    frame_tag = (uint8_t)(frame_tag == 255 ? 1 : frame_tag + 1);
    int rc = DecodeFrame(s, in, &c, &tally, frame_tag);
    if (rc != 0) {
      // Frame does not fit the caller's buffers: put it back at the head
      // (order preserved) and report what was decoded so far — or, with
      // nothing decoded, the grow request itself.
      std::lock_guard<std::mutex> lk(s->m);
      s->q.push_front(std::move(in));
      grow_rc = rc;
      break;
    }
    frames++;
  }
  {
    std::lock_guard<std::mutex> lk(s->m);
    s->rx.batch_frames += tally.batch_frames;
    s->rx.msgs += tally.msgs;
    s->rx.folded_msgs += tally.folded;
    s->rx.commits += tally.commits;
    s->rx.bytes += tally.bytes;
    for (int i = 0; i < 16; ++i) s->rx.by_op[i] += tally.by_op[i];
    for (int i = 0; i < 25; ++i) s->rx.batch_size_hist[i] += tally.bs_hist[i];
    s->rx.batch_size_sum += tally.bs_sum;
  }
  if (c.n_items == 0 && grow_rc != 0) return grow_rc;
  return c.n_items;
}

void bf_winsvc_rx_stats(bf_winsvc_t* s, bf_winrx_stats_t* out) {
  if (!s || !out) return;
  std::lock_guard<std::mutex> lk(s->m);
  *out = s->rx;
  out->decode_busy =
      (uint64_t)std::max<int64_t>(0, s->decode_busy.load(
                                         std::memory_order_acquire));
  out->decode_threads = (uint64_t)s->decode_threads;
  out->decoded_frames = s->decoded_frames;
}

int32_t bf_winsvc_set_decode(bf_winsvc_t* s, int32_t threads) {
  if (!s) return 0;
  std::lock_guard<std::mutex> lk(s->m);
  if (s->decode_threads > 0 || threads <= 0 || s->stopping)
    return s->decode_threads;  // once-only; <= 0 keeps the inline decode
  s->decode_threads = threads;
  for (int32_t i = 0; i < threads; ++i)
    s->dpool.emplace_back([s] { s->DecodeWorker(); });
  return s->decode_threads;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Legacy single-message client send (pooled connections)
// ---------------------------------------------------------------------------

namespace {

// One pooled persistent connection per peer, each with its own mutex so a
// slow or backpressured peer only stalls traffic headed to that peer — the
// pool lock is held just long enough to find/create the entry, never across
// getaddrinfo/connect/send.
struct Conn {
  std::mutex m;
  int fd = -1;
};

}  // namespace

extern "C" {

int32_t bf_winsvc_send(const char* host, int32_t port, uint8_t op,
                       const char* name, int32_t src, int32_t dst,
                       double weight, double p_weight, const uint8_t* payload,
                       uint64_t payload_len) {
  static std::mutex pool_m;
  static std::map<std::string, Conn*>* pool =
      new std::map<std::string, Conn*>();
  const std::string key = std::string(host) + ":" + std::to_string(port);

  Conn* conn;
  {
    std::lock_guard<std::mutex> lk(pool_m);
    auto it = pool->find(key);
    if (it == pool->end()) it = pool->emplace(key, new Conn).first;
    conn = it->second;
  }

  std::lock_guard<std::mutex> lk(conn->m);  // serializes per peer only
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (conn->fd < 0) {
      addrinfo hints{}, *res = nullptr;
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      const std::string port_s = std::to_string(port);
      if (::getaddrinfo(host, port_s.c_str(), &hints, &res) != 0 || !res)
        return -1;
      int fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) < 0) {
        if (fd >= 0) ::close(fd);
        ::freeaddrinfo(res);
        return -2;
      }
      ::freeaddrinfo(res);
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      conn->fd = fd;
    }
    int fd = conn->fd;
    uint16_t name_len = (uint16_t)std::strlen(name);
    if (name_len >= 128) return -4;  // receiver's name[128] would reject it
    // One stack header + one payload iovec -> one sendmsg(): the whole
    // frame leaves in a single syscall (and, small frames, one packet).
    uint8_t hdr[kMaxHdr];
    size_t hlen = BuildHeader(hdr, op, src, dst, weight, p_weight, name,
                              name_len, payload_len);
    struct iovec iov[2] = {{hdr, hlen},
                           {const_cast<uint8_t*>(payload), payload_len}};
    bool ok = WritevFull(fd, iov, payload_len ? 2 : 1);
    if (ok) return 0;
    // Stale pooled connection (peer restarted): drop and retry once fresh.
    ::close(fd);
    conn->fd = -1;
  }
  return -3;
}

void bf_winsvc_stop(bf_winsvc_t* s) {
  if (!s) return;
  {
    std::lock_guard<std::mutex> lk(s->m);
    s->stopping = true;
  }
  s->cv_space.notify_all();
  s->cv_data.notify_all();  // wake a drain call blocked on an empty queue
  s->cv_decoded.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  s->acceptor.join();  // after this, no new slots can appear
  {
    std::lock_guard<std::mutex> lk(s->conn_m);
    for (auto& sl : s->slots)
      if (!sl.closed) ::shutdown(sl.fd, SHUT_RDWR);  // unblock recv()
  }
  // Join without conn_m: exiting readers need it to close their fds.
  for (auto& sl : s->slots) sl.t.join();
  for (auto& t : s->dpool) t.join();
  delete s;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native transmit path: per-peer coalescing send queues (bf_wintx)
// ---------------------------------------------------------------------------

namespace {

// One queued message's framing metadata.  The message CONTENT lives in the
// peer's append-only arena, already encoded as a wire sub-message — the
// enqueue pays exactly one copy (payload -> arena) and zero per-message
// heap allocations, and the worker ships arena ranges without re-encoding.
struct TxSeg {
  uint64_t len;   // encoded sub-message bytes in the arena
  uint64_t plen;  // payload bytes (threshold accounting, Python parity)
};

struct TxPeer {
  std::string host;
  int32_t port = 0;
  int32_t stripe = 0;
  std::string addr;  // "host:port" (partition match, per-peer aggregation)
  std::string key;   // "host:port#stripe" (peer-map key)
  std::mutex m;
  std::condition_variable cv;
  std::vector<uint8_t> arena;     // encoded sub-message stream (guarded by m)
  std::deque<TxSeg> segs;         // per-message lengths (guarded by m)
  uint64_t bytes_pending = 0;
  bool flush_now = false;
  // Highest seq_enq any flusher is waiting on: the worker skips the
  // linger (and drains back-to-back frames) until seq_done reaches it,
  // so a capped multi-frame flush never pays a linger between frames.
  uint64_t flush_target = 0;
  std::atomic<bool> closing{false};  // written under m; read lock-free by
                                     // the worker's socket poll slices
  int32_t err_code = 0;           // stored send error (consume-once)
  uint64_t seq_enq = 0, seq_done = 0;
  // Cumulative counters, guarded by m.
  uint64_t frames = 0, batches = 0, batched_msgs = 0, bytes_enq = 0;
  uint64_t errors = 0, err_events = 0, retries = 0, dropped = 0;
  uint64_t by_op[16] = {0};
  uint64_t bs_hist[25] = {0};
  uint64_t ss_hist[25] = {0};
  double bs_sum = 0.0, ss_sum = 0.0;
  int fd = -1;  // worker-owned
  std::thread worker;
  std::mt19937 rng{std::random_device{}()};  // worker-only (retry jitter)
};

}  // namespace

struct bf_wintx {
  uint64_t flush_bytes = 1 << 20;
  uint64_t linger_us = 1000;
  int32_t queue_max = 1024;
  int32_t retries = 1;
  double backoff_sec = 0.05;
  int32_t stripes = 1;  // sockets/workers/arenas per peer endpoint
  std::mutex m;  // guards peers/all/partition
  std::map<std::string, TxPeer*> peers;      // active senders
  std::vector<std::unique_ptr<TxPeer>> all;  // every peer ever (joined at stop)
  std::set<std::string> partition;
  std::atomic<bool> stopping{false};
  // Callers currently inside an API function (a producer blocked in the
  // backpressure wait, a flusher in FlushPeer): bf_wintx_stop wakes them
  // (closing) and waits for this to drain before freeing the peers —
  // destroying a mutex/condvar someone still waits on is UB.
  std::atomic<int64_t> inflight{0};
};

namespace {

struct InflightGuard {
  std::atomic<int64_t>& c;
  explicit InflightGuard(std::atomic<int64_t>& counter) : c(counter) {
    c.fetch_add(1, std::memory_order_acq_rel);
  }
  ~InflightGuard() { c.fetch_sub(1, std::memory_order_acq_rel); }
};

}  // namespace

namespace {

// Nonblocking connect with short poll slices watching closing — a dropped
// peer's worker must exit promptly, never wait out a SYN timeout.
int ConnectPeer(TxPeer* p) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  const std::string port_s = std::to_string(p->port);
  if (::getaddrinfo(p->host.c_str(), port_s.c_str(), &hints, &res) != 0 ||
      !res)
    return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return -2;
  }
  ::fcntl(fd, F_SETFL, O_NONBLOCK);
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  ::freeaddrinfo(res);
  if (rc < 0 && errno != EINPROGRESS) {
    ::close(fd);
    return -2;
  }
  if (rc < 0) {
    for (;;) {
      if (p->closing.load(std::memory_order_acquire)) {
        ::close(fd);
        return -2;
      }
      pollfd pf{fd, POLLOUT, 0};
      int pr = ::poll(&pf, 1, 100);
      if (pr < 0 && errno != EINTR) {
        ::close(fd);
        return -2;
      }
      if (pr > 0) break;
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    if (::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 ||
        err != 0) {
      ::close(fd);
      return -2;
    }
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  p->fd = fd;
  return 0;
}

// Gather-write every iovec fully on the worker's nonblocking socket;
// EAGAIN backs off in poll slices.  While the peer is closing, a frame
// that cannot make progress is abandoned after ~5 s — the connection is
// doomed anyway, and stop() must not hang on a peer that stopped reading.
bool SendVec(TxPeer* p, struct iovec* iov, int iovcnt) {
  int stalled = 0;
  while (iovcnt > 0) {
    msghdr mh{};
    mh.msg_iov = iov;
    mh.msg_iovlen = iovcnt;
    ssize_t r = ::sendmsg(p->fd, &mh, MSG_NOSIGNAL);
    if (r < 0 && errno == EINTR) continue;
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      pollfd pf{p->fd, POLLOUT, 0};
      int pr = ::poll(&pf, 1, 100);
      if (pr < 0 && errno != EINTR) return false;
      if (pr == 0 && p->closing.load(std::memory_order_acquire) &&
          ++stalled >= 50)
        return false;
      continue;
    }
    if (r <= 0) return false;
    auto n = (size_t)r;
    while (iovcnt > 0 && n >= iov[0].iov_len) {
      n -= iov[0].iov_len;
      ++iov;
      --iovcnt;
    }
    if (iovcnt > 0) {
      iov[0].iov_base = static_cast<uint8_t*>(iov[0].iov_base) + n;
      iov[0].iov_len -= n;
    }
  }
  return true;
}

// Ship one frame (header + body range) on the peer's connection in a
// single sendmsg, reconnecting once on a stale pooled connection (same
// two-attempt rule as bf_winsvc_send).
int SendFrameOnce(TxPeer* p, const uint8_t* hdr, size_t hlen,
                  const uint8_t* body, size_t blen) {
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (p->fd < 0) {
      int rc = ConnectPeer(p);
      if (rc != 0) return rc;
    }
    struct iovec iov[2] = {{const_cast<uint8_t*>(hdr), hlen},
                           {const_cast<uint8_t*>(body), blen}};
    if (SendVec(p, iov, blen ? 2 : 1)) return 0;
    ::close(p->fd);
    p->fd = -1;
  }
  return -3;
}

void BackoffSleep(TxPeer* p, double sec) {
  std::unique_lock<std::mutex> lk(p->m);
  p->cv.wait_for(lk, std::chrono::duration<double>(sec), [&] {
    return p->closing.load(std::memory_order_relaxed);
  });
}

// One frame send with the jittered exponential transient-retry ladder
// (mirrors ops/transport.WindowTransport._native_send: -1 resolve and the
// chaos partition are deterministic, everything else retries).
int SendFrameWithRetries(bf_wintx* t, TxPeer* p, const uint8_t* hdr,
                         size_t hlen, const uint8_t* body, size_t blen) {
  {
    std::lock_guard<std::mutex> lk(t->m);
    if (t->partition.count(p->addr)) return -7;  // chaos partition: no wire
  }
  int attempt = 0;
  for (;;) {
    int rc = SendFrameOnce(p, hdr, hlen, body, blen);
    if (rc == 0 || rc == -1) return rc;
    if (attempt >= t->retries ||
        p->closing.load(std::memory_order_acquire))
      return rc;
    {
      std::lock_guard<std::mutex> lk(p->m);
      p->retries++;
    }
    if (t->backoff_sec > 0.0) {
      // Full jitter on an exponential ladder, as in the Python sender: a
      // gang-wide blip must not hammer a restarting host in lockstep.
      std::uniform_real_distribution<double> jitter(0.5, 1.5);
      BackoffSleep(p,
                   t->backoff_sec * std::pow(2.0, attempt) * jitter(p->rng));
    }
    attempt++;
  }
}

// Encoded sub-message field offsets (little-endian, see the file header):
//   u8 op | i32 src | i32 dst | f64 weight | f64 p_weight | u16 nlen |
//   name | u64 plen | payload
constexpr size_t kSubFixed = 1 + 4 + 4 + 8 + 8 + 2;  // 27

void TxWorker(bf_wintx* t, TxPeer* p) {
  std::vector<uint8_t> buf;   // taken arena (capacities ping-pong via swap)
  std::deque<TxSeg> segs;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(p->m);
      p->cv.wait(lk, [&] {
        return !p->segs.empty() ||
               p->closing.load(std::memory_order_relaxed);
      });
      if (p->segs.empty()) break;  // closing with a drained queue
      auto rush = [&] {
        return p->flush_now || p->seq_done < p->flush_target ||
               p->closing.load(std::memory_order_relaxed);
      };
      if (!rush() && t->linger_us > 0) {
        // Linger briefly so back-to-back edge sends coalesce; only an
        // urgent op, a threshold crossing, an explicit flush or close may
        // cut it short.  The linger is the coalescing engine: a producer
        // mid-burst keeps enqueueing (without waking us) and the whole
        // burst ships in big frames when the linger fires.
        p->cv.wait_for(lk, std::chrono::microseconds(t->linger_us), rush);
      }
      // Take the WHOLE arena in O(1) (swap — the enqueue path never pays
      // a per-message allocation) and emit it below as however many
      // byte-threshold-bounded frames it needs.
      buf.clear();
      buf.swap(p->arena);
      segs.clear();
      segs.swap(p->segs);
      p->bytes_pending = 0;
      p->flush_now = false;
      p->cv.notify_all();  // wake backpressured producers
    }
    // -- emit frames: consecutive segs grouped up to the byte threshold --
    size_t pos = 0, idx = 0;
    const size_t nsegs = segs.size();
    while (idx < nsegs) {
      size_t fmsgs = 0;
      uint64_t fpayload = 0, flen = 0;
      const size_t fstart = pos;
      while (idx < nsegs && (fmsgs == 0 || fpayload < t->flush_bytes)) {
        flen += segs[idx].len;
        fpayload += segs[idx].plen;
        fmsgs++;
        idx++;
      }
      pos = fstart + flen;
      const uint8_t* body = buf.data() + fstart;
      uint8_t hdr[kMaxHdr + 5];
      size_t hlen;
      const uint8_t* send_body;
      size_t send_blen;
      if (fmsgs == 1) {
        // Singleton: re-wrap as a plain legacy frame (bit-identical to
        // the per-message wire) — fields sit at fixed offsets in the
        // encoded sub-message.
        uint8_t op = body[0];
        int32_t msrc, mdst;
        double w, pw;
        uint16_t nlen;
        std::memcpy(&msrc, body + 1, 4);
        std::memcpy(&mdst, body + 5, 4);
        std::memcpy(&w, body + 9, 8);
        std::memcpy(&pw, body + 17, 8);
        std::memcpy(&nlen, body + 25, 2);
        char name[128];
        std::memcpy(name, body + kSubFixed, nlen);
        name[nlen] = '\0';
        uint64_t plen;
        std::memcpy(&plen, body + kSubFixed + nlen, 8);
        hlen = BuildHeader(hdr, op, msrc, mdst, w, pw, name, nlen, plen);
        send_body = body + kSubFixed + nlen + 8;
        send_blen = plen;
      } else {
        // OP_BATCH container: header + version/count, body = the arena
        // range verbatim (zero re-encode, zero copy).
        hlen = BuildHeader(hdr, kOpBatch, -1, -1, 0.0, 0.0, "", 0,
                           (uint64_t)(5 + flen));
        uint8_t ver = kBatchVersion;
        uint32_t count = (uint32_t)fmsgs;
        std::memcpy(hdr + hlen, &ver, 1);
        std::memcpy(hdr + hlen + 1, &count, 4);
        hlen += 5;
        send_body = body;
        send_blen = flen;
      }
      const uint8_t frame_op = fmsgs == 1 ? body[0] : kOpBatch;
      if (RecOn())
        RecNote(BF_REC_FLUSH, frame_op, (uint8_t)p->stripe, -1, p->port,
                (uint32_t)fmsgs, send_blen, p->addr.c_str());
      double t0 = NowSec();
      int rc = SendFrameWithRetries(t, p, hdr, hlen, send_body, send_blen);
      double dt = NowSec() - t0;
      if (RecOn())
        // src carries the send rc (0 = handed to TCP) — the black box
        // must show WHICH frame a drop was.
        RecNote(BF_REC_SENDMSG, frame_op, (uint8_t)p->stripe, rc, p->port,
                (uint32_t)fmsgs, send_blen, p->addr.c_str());
      std::lock_guard<std::mutex> lk(p->m);
      p->seq_done += fmsgs;
      if (rc == 0) {
        p->frames++;
        p->bs_hist[HistIndex((double)fmsgs)]++;
        p->bs_sum += (double)fmsgs;
        p->ss_hist[HistIndex(dt)]++;
        p->ss_sum += dt;
        if (fmsgs > 1) {
          p->batches++;
          p->batched_msgs += fmsgs;
        }
      } else {
        // Advance past dropped frames too: flushers are woken by the
        // stored error first, so a drop never reads as silent success.
        p->err_code = rc;
        p->errors++;
        p->err_events++;
      }
      p->cv.notify_all();
    }
  }
  if (p->fd >= 0) {
    ::close(p->fd);
    p->fd = -1;
  }
}

std::string PeerAddr(const char* host, int32_t port) {
  return std::string(host) + ":" + std::to_string(port);
}

TxPeer* GetOrCreatePeer(bf_wintx* t, const char* host, int32_t port,
                        int32_t stripe) {
  std::string addr = PeerAddr(host, port);
  std::string key = addr + "#" + std::to_string(stripe);
  std::lock_guard<std::mutex> lk(t->m);
  // Checked under t->m: stop() sets the flag before taking this lock, so
  // once its join loop runs no new peer/worker can ever be appended.
  if (t->stopping.load(std::memory_order_relaxed)) return nullptr;
  auto it = t->peers.find(key);
  if (it != t->peers.end()) return it->second;
  auto owned = std::make_unique<TxPeer>();
  TxPeer* p = owned.get();
  p->host = host;
  p->port = port;
  p->stripe = stripe;
  p->addr = std::move(addr);
  p->key = std::move(key);
  t->all.push_back(std::move(owned));
  t->peers[p->key] = p;
  p->worker = std::thread([t, p] { TxWorker(t, p); });
  return p;
}

// Every ACTIVE stripe sender of (host, port) — flush/err/stats/drop
// operate on the whole peer, never one stripe.
std::vector<TxPeer*> AddrPeers(bf_wintx* t, const char* host, int32_t port) {
  const std::string addr = PeerAddr(host, port);
  std::vector<TxPeer*> out;
  std::lock_guard<std::mutex> lk(t->m);
  for (auto& kv : t->peers)
    if (kv.second->addr == addr) out.push_back(kv.second);
  return out;
}

int FlushPeer(TxPeer* p, double timeout_sec) {
  std::unique_lock<std::mutex> lk(p->m);
  const uint64_t target = p->seq_enq;
  if (target > p->flush_target) p->flush_target = target;
  p->cv.notify_all();
  auto done = [&] {
    return p->err_code != 0 || p->seq_done >= target ||
           p->closing.load(std::memory_order_relaxed);
  };
  bool ok = p->cv.wait_for(lk, std::chrono::duration<double>(timeout_sec),
                           done);
  if (p->err_code != 0) {
    int rc = p->err_code;
    p->err_code = 0;
    return rc;
  }
  if (p->seq_done >= target) return 0;
  if (p->closing.load(std::memory_order_relaxed)) {
    // stop() raced this flush: the worker drains its queue before
    // exiting — give it the same bounded grace the Python sender allows.
    p->cv.wait_for(lk,
                   std::chrono::duration<double>(std::min(5.0, timeout_sec)),
                   [&] { return p->err_code != 0 || p->seq_done >= target; });
    if (p->err_code != 0) {
      int rc = p->err_code;
      p->err_code = 0;
      return rc;
    }
    return p->seq_done >= target ? 0 : -5;
  }
  return ok ? 0 : -6;
}

void AddPeerStats(TxPeer* p, bf_wintx_stats_t* out) {
  std::lock_guard<std::mutex> lk(p->m);
  out->msgs_enq += p->seq_enq;
  out->msgs_done += p->seq_done;
  out->frames += p->frames;
  out->batches += p->batches;
  out->batched_msgs += p->batched_msgs;
  out->bytes += p->bytes_enq;
  out->errors += p->errors;
  out->retries += p->retries;
  out->dropped_msgs += p->dropped;
  out->queue_len += p->segs.size();
  for (int i = 0; i < 16; ++i) out->by_op[i] += p->by_op[i];
  for (int i = 0; i < 25; ++i) {
    out->batch_size_hist[i] += p->bs_hist[i];
    out->send_sec_hist[i] += p->ss_hist[i];
  }
  out->batch_size_sum += p->bs_sum;
  out->send_sec_sum += p->ss_sum;
}

}  // namespace

extern "C" {

bf_wintx_t* bf_wintx_start(uint64_t flush_bytes, uint64_t linger_us,
                           int32_t queue_max, int32_t retries,
                           double backoff_sec, int32_t stripes) {
  auto* t = new bf_wintx;
  if (flush_bytes > 0) t->flush_bytes = flush_bytes;
  t->linger_us = linger_us;
  if (queue_max > 0) t->queue_max = queue_max;
  t->retries = retries < 0 ? 0 : retries;
  t->backoff_sec = backoff_sec < 0.0 ? 0.0 : backoff_sec;
  t->stripes = stripes < 1 ? 1 : stripes;
  return t;
}

int32_t bf_wintx_stripes(bf_wintx_t* t) { return t ? t->stripes : 1; }

int32_t bf_wintx_send(bf_wintx_t* t, const char* host, int32_t port,
                      uint8_t op, const char* name, int32_t src, int32_t dst,
                      double weight, double p_weight, const uint8_t* payload,
                      uint64_t payload_len, int32_t urgent, int32_t stripe) {
  if (!t) return -5;
  InflightGuard guard(t->inflight);
  if (t->stopping.load(std::memory_order_acquire)) return -5;
  const size_t nlen = name ? std::strlen(name) : 0;
  if (nlen >= 128) return -4;  // deterministic, path-independent rejection
  if (stripe < 0 || stripe >= t->stripes) stripe = 0;
  TxPeer* p = GetOrCreatePeer(t, host, port, stripe);
  if (p == nullptr) return -5;  // raced a stop(): transport is closing
  std::unique_lock<std::mutex> lk(p->m);
  if (p->err_code != 0) {  // surface a stored async error at the producer
    int rc = p->err_code;
    p->err_code = 0;
    return rc;
  }
  // Backpressure: a full queue blocks the CALLER, exactly like the
  // blocking native send did — gossip is never dropped, only paced.  A
  // queue at capacity IS a shippable backlog: cut the worker's linger so
  // the throughput cap is the send pipeline, not queue_max per linger.
  while ((int32_t)p->segs.size() >= t->queue_max &&
         !p->closing.load(std::memory_order_relaxed) && p->err_code == 0) {
    if (!p->flush_now) {
      p->flush_now = true;
      p->cv.notify_all();
    }
    p->cv.wait_for(lk, std::chrono::milliseconds(50));
  }
  if (p->err_code != 0) {
    int rc = p->err_code;
    p->err_code = 0;
    return rc;
  }
  if (p->closing.load(std::memory_order_relaxed)) return -5;
  const bool was_empty = p->segs.empty();
  // Encode the wire sub-message straight into the peer's arena: ONE copy,
  // no per-message heap allocation (amortized growth only), and the
  // worker ships the bytes verbatim inside an OP_BATCH frame.
  const uint64_t need = kSubFixed + nlen + 8 + payload_len;
  const size_t off = p->arena.size();
  p->arena.resize(off + need);
  uint8_t* w = p->arena.data() + off;
  uint16_t nlen16 = (uint16_t)nlen;
  w[0] = op;
  std::memcpy(w + 1, &src, 4);
  std::memcpy(w + 5, &dst, 4);
  std::memcpy(w + 9, &weight, 8);
  std::memcpy(w + 17, &p_weight, 8);
  std::memcpy(w + 25, &nlen16, 2);
  std::memcpy(w + kSubFixed, name, nlen);
  std::memcpy(w + kSubFixed + nlen, &payload_len, 8);
  if (payload_len)
    std::memcpy(w + kSubFixed + nlen + 8, payload, payload_len);
  p->segs.push_back(TxSeg{need, payload_len});
  p->seq_enq++;
  p->bytes_pending += payload_len;
  p->bytes_enq += payload_len;
  p->by_op[(op & (uint8_t)~kFlagMask) & 15]++;
  if (RecOn()) {
    // A Python-tagged message already carries its trailer in the
    // payload: lift the seq so the enqueue event joins the tag's chain.
    uint32_t seq = 0;
    if ((op & kFlagTrace) && payload_len >= BF_TRACE_TRAILER_LEN)
      std::memcpy(&seq, payload + payload_len - BF_TRACE_TRAILER_LEN + 4,
                  4);
    RecNote(BF_REC_ENQUEUE, op, (uint8_t)stripe, src, dst, seq,
            payload_len, name);
  }
  // Wake the worker only on transitions it cares about: queue went
  // nonempty (it may sit in the outer wait) or the linger must be cut
  // (urgent op / byte threshold).  A steady burst otherwise enqueues with
  // ZERO futex traffic — the worker's linger timeout collects it into
  // one frame.
  const bool cut = (urgent || p->bytes_pending >= t->flush_bytes) &&
                   !p->flush_now;
  if (cut) p->flush_now = true;
  if (was_empty || cut) p->cv.notify_all();
  return 0;
}

int32_t bf_wintx_flush(bf_wintx_t* t, const char* host, int32_t port,
                       double timeout_sec) {
  if (!t) return 0;
  InflightGuard guard(t->inflight);
  std::vector<TxPeer*> targets;
  if (host != nullptr) {
    targets = AddrPeers(t, host, port);  // every stripe of the peer
    if (targets.empty()) return 0;  // unknown/retired peer: nothing queued
  } else {
    std::lock_guard<std::mutex> lk(t->m);
    for (auto& kv : t->peers) targets.push_back(kv.second);
  }
  int first_err = 0;
  for (TxPeer* p : targets) {
    int rc = FlushPeer(p, timeout_sec);
    if (rc != 0 && first_err == 0) first_err = rc;  // drain ALL stripes
  }
  return first_err;
}

int64_t bf_wintx_err_count(bf_wintx_t* t, const char* host, int32_t port) {
  if (!t) return 0;
  InflightGuard guard(t->inflight);
  int64_t total = 0;
  if (host != nullptr) {
    for (TxPeer* p : AddrPeers(t, host, port)) {
      std::lock_guard<std::mutex> lk(p->m);
      total += (int64_t)p->err_events;
    }
    return total;
  }
  std::lock_guard<std::mutex> lk(t->m);
  for (auto& kv : t->peers) {
    std::lock_guard<std::mutex> pk(kv.second->m);
    total += (int64_t)kv.second->err_events;
  }
  return total;
}

void bf_wintx_kick(bf_wintx_t* t) {
  if (!t) return;
  InflightGuard guard(t->inflight);
  std::vector<TxPeer*> targets;
  {
    std::lock_guard<std::mutex> lk(t->m);
    for (auto& kv : t->peers) targets.push_back(kv.second);
  }
  for (TxPeer* p : targets) {
    std::lock_guard<std::mutex> lk(p->m);
    if (!p->segs.empty()) {
      p->flush_now = true;
      p->cv.notify_all();
    }
  }
}

int64_t bf_wintx_drop_peer(bf_wintx_t* t, const char* host, int32_t port) {
  if (!t) return 0;
  InflightGuard guard(t->inflight);
  std::vector<TxPeer*> peers;
  {
    // Retire EVERY stripe of the peer under one map lock: a dead peer
    // must never leave N-1 orphan stripe workers retrying into closed
    // sockets while stripe 0 alone was torn down.
    const std::string addr = PeerAddr(host, port);
    std::lock_guard<std::mutex> lk(t->m);
    for (auto it = t->peers.begin(); it != t->peers.end();) {
      if (it->second->addr == addr) {
        peers.push_back(it->second);
        it = t->peers.erase(it);  // later sends lazily re-create stripes
      } else {
        ++it;
      }
    }
  }
  int64_t total = 0;
  for (TxPeer* p : peers) {
    std::lock_guard<std::mutex> lk(p->m);
    int64_t dropped = (int64_t)p->segs.size();
    p->segs.clear();
    p->arena.clear();
    p->bytes_pending = 0;
    // Account discarded messages as done-with-error so a blocked flusher
    // fails immediately instead of waiting out the closing grace.
    p->seq_done = p->seq_enq;
    if (dropped > 0) {
      p->err_code = -8;  // retired by the churn controller
      p->err_events++;
      p->dropped += (uint64_t)dropped;
    }
    p->closing.store(true, std::memory_order_release);
    p->cv.notify_all();
    total += dropped;
  }
  return total;
}

void bf_wintx_set_partition(bf_wintx_t* t, const char* csv) {
  if (!t) return;
  InflightGuard guard(t->inflight);
  std::set<std::string> next;
  if (csv != nullptr) {
    const char* s = csv;
    while (*s) {
      const char* e = std::strchr(s, ',');
      size_t n = e ? (size_t)(e - s) : std::strlen(s);
      if (n) next.emplace(s, n);
      s += n + (e ? 1 : 0);
    }
  }
  std::lock_guard<std::mutex> lk(t->m);
  t->partition.swap(next);
}

void bf_wintx_stats(bf_wintx_t* t, const char* host, int32_t port,
                    bf_wintx_stats_t* out) {
  if (!out) return;
  std::memset(out, 0, sizeof(*out));
  if (!t) return;
  InflightGuard guard(t->inflight);
  if (host != nullptr) {
    for (TxPeer* p : AddrPeers(t, host, port)) AddPeerStats(p, out);
    return;
  }
  // Aggregate over every peer ever created (retired ones included) so
  // totals stay monotonic across drop_peer/recreate cycles.
  std::lock_guard<std::mutex> lk(t->m);
  for (auto& p : t->all) AddPeerStats(p.get(), out);
}

void bf_wintx_stripe_stats(bf_wintx_t* t, const char* host, int32_t port,
                           int32_t stripe, bf_wintx_stats_t* out) {
  if (!out) return;
  std::memset(out, 0, sizeof(*out));
  if (!t || host == nullptr) return;
  InflightGuard guard(t->inflight);
  const std::string key =
      PeerAddr(host, port) + "#" + std::to_string(stripe);
  std::lock_guard<std::mutex> lk(t->m);
  auto it = t->peers.find(key);
  if (it != t->peers.end()) AddPeerStats(it->second, out);
}

void bf_wintx_stop(bf_wintx_t* t) {
  if (!t) return;
  t->stopping.store(true, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk(t->m);
    t->peers.clear();
  }
  // Wake EVERY waiter first (producers blocked in the backpressure wait,
  // flushers in FlushPeer, workers in their linger), then wait for the
  // in-flight API calls to drain before touching peer storage — a
  // mutex/condvar must never be destroyed under a live waiter.
  for (auto& p : t->all) {
    std::lock_guard<std::mutex> lk(p->m);
    p->closing.store(true, std::memory_order_release);
    p->cv.notify_all();
  }
  while (t->inflight.load(std::memory_order_acquire) > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  for (auto& p : t->all)
    if (p->worker.joinable()) p->worker.join();
  delete t;
}

}  // extern "C"
