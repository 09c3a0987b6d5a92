// Put plans, their sparse residual store, and the probe ring.
//
// The host part of the JAX package's bluefog_tpu/native/src/xlacall.cc
// (its lines 1-440), copied unchanged below this note; the XLA FFI
// handlers that follow it there are left out.  On a card their role is
// played by stream host functions (bluefog_tpu_torch/csrc/hostfn.cpp):
// cudaLaunchHostFunc nodes that call bf_xla_plan_run on the pinned copy of
// a put's owned rows, and bf_probe_note at the fused step's seams.
//
// A plan compiles one put dispatch (per remote edge: peer endpoint, wire
// op, weight, row, stripe); running it encodes each row of the caller's
// f32 buffer into the bf_wintx_* per-peer arenas (dense raw, bf16
// round-to-nearest-even, or sparse top-|magnitude| with sender residuals
// keyed (window, src, dst)), so the frames are those of the host-staged
// path in ops/window.py.  bluefog_tpu_torch/native/__init__.py links this
// file into the service's library.

#include "bluefog_native.h"

#include <cmath>
#include <cstring>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t kXFlagBf16 = 0x40;    // OP_BF16_FLAG (ops/transport.py)
constexpr uint8_t kXFlagSparse = 0x20;  // OP_SPARSE_FLAG
constexpr uint8_t kXFlagTrace = 0x10;   // OP_TRACE_FLAG

struct XEdge {
  std::string host;
  int32_t port = 0;
  uint8_t op = 0;
  int32_t src = 0;
  int32_t dst = 0;
  double weight = 0.0;
  double p_weight = 0.0;
  int64_t row = 0;
  int32_t stripe = 0;  // transport stripe, pinned at plan-compile time
};

struct XPlan {
  std::string name;
  int64_t elems = 0;
  int32_t codec = 0;  // 0 dense, 1 bf16, 2 sparse
  double frac = 1.0;
  std::vector<XEdge> edges;
};

std::mutex g_plan_m;
std::unordered_map<int64_t, std::shared_ptr<XPlan>>* g_plans =
    new std::unordered_map<int64_t, std::shared_ptr<XPlan>>();
int64_t g_next_plan = 1;

// Sparse error-feedback residuals, keyed (window, src, dst) — the native
// twin of ops/window._ef_residuals (same key, same purge points), so the
// time-summed wire traffic on this path carries the full input mass.
std::mutex g_res_m;
std::map<std::tuple<std::string, int32_t, int32_t>, std::vector<float>>*
    g_res = new std::map<std::tuple<std::string, int32_t, int32_t>,
                         std::vector<float>>();

// f32 -> bf16 with round-to-nearest-even: the rule numpy/ml_dtypes'
// astype(bfloat16) applies, so bf16 frames are bit-identical to the
// Python encoder's for every finite value (NaNs quieten canonically).
inline uint16_t Bf16RNE(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)           // NaN: keep it a NaN
    return (uint16_t)((u >> 16) | 0x0040u);
  uint32_t bias = 0x7fffu + ((u >> 16) & 1u);    // ties to even
  return (uint16_t)((u + bias) >> 16);
}

std::shared_ptr<XPlan> FindPlan(int64_t id) {
  std::lock_guard<std::mutex> lk(g_plan_m);
  auto it = g_plans->find(id);
  return it == g_plans->end() ? nullptr : it->second;
}

// Encode + enqueue one sparse edge: v = row + residual, ship the top
// ceil(frac*elems) entries by |v| (ascending index order, bit-exact f32
// values), keep the complement as the new residual.  Mirrors
// ops/window._sparse_payload.
int32_t SendSparse(bf_wintx_t* tx, const XPlan& p, const XEdge& e,
                   const float* row) {
  thread_local std::vector<float> v;
  thread_local std::vector<int32_t> order;
  thread_local std::vector<uint8_t> payload;
  const int64_t n = p.elems;
  v.resize((size_t)n);
  {
    std::lock_guard<std::mutex> lk(g_res_m);
    auto it = g_res->find(std::make_tuple(p.name, e.src, e.dst));
    if (it != g_res->end() && (int64_t)it->second.size() == n) {
      for (int64_t i = 0; i < n; ++i) v[(size_t)i] = row[i] + it->second[(size_t)i];
    } else {
      std::memcpy(v.data(), row, (size_t)n * 4);
    }
  }
  int64_t k = (int64_t)std::ceil(p.frac * (double)n);
  if (k < 1) k = 1;
  if (k > n) k = n;
  order.resize((size_t)n);
  for (int64_t i = 0; i < n; ++i) order[(size_t)i] = (int32_t)i;
  if (k < n) {
    // Top-k by |v|, deterministic (|v| desc, index asc on ties), then
    // ascending index — the order the Python encoder ships.
    std::nth_element(order.begin(), order.begin() + k, order.end(),
                     [&](int32_t a, int32_t b) {
                       float fa = std::fabs(v[(size_t)a]);
                       float fb = std::fabs(v[(size_t)b]);
                       if (fa != fb) return fa > fb;
                       return a < b;
                     });
    std::sort(order.begin(), order.begin() + k);
  }
  payload.resize(4 + (size_t)k * 8);
  uint32_t k32 = (uint32_t)k;
  std::memcpy(payload.data(), &k32, 4);
  uint8_t* ip = payload.data() + 4;
  uint8_t* vp = payload.data() + 4 + (size_t)k * 4;
  for (int64_t j = 0; j < k; ++j) {
    int32_t idx = order[(size_t)j];
    std::memcpy(ip + 4 * j, &idx, 4);
    std::memcpy(vp + 4 * j, &v[(size_t)idx], 4);
  }
  {
    // New residual: v with the shipped entries zeroed.
    std::lock_guard<std::mutex> lk(g_res_m);
    auto& res = (*g_res)[std::make_tuple(p.name, e.src, e.dst)];
    res.assign(v.begin(), v.end());
    for (int64_t j = 0; j < k; ++j) res[(size_t)order[(size_t)j]] = 0.0f;
  }
  uint8_t op = (uint8_t)(e.op | kXFlagSparse);
  uint8_t trailer[BF_TRACE_TRAILER_LEN];
  if (bf_trace_next(e.src, trailer)) {
    // Wire trace tag: the trailer rides INSIDE the payload (after the
    // sparse stream), exactly as the Python encoder appends it, so the
    // receiver strips it identically whichever path sent the row.
    payload.insert(payload.end(), trailer, trailer + BF_TRACE_TRAILER_LEN);
    op |= kXFlagTrace;
  }
  return bf_wintx_send(tx, e.host.c_str(), e.port, op, p.name.c_str(),
                       e.src, e.dst, e.weight, e.p_weight, payload.data(),
                       payload.size(), 0, e.stripe);
}

int32_t PlanRun(int64_t plan, const void* txp, const float* data,
                uint64_t total_elems) {
  auto p = FindPlan(plan);
  if (!p || txp == nullptr || data == nullptr) return -9;
  auto* tx = (bf_wintx_t*)(uintptr_t)txp;
  thread_local std::vector<uint16_t> half;
  thread_local std::vector<uint8_t> tagged;
  uint8_t trailer[BF_TRACE_TRAILER_LEN];
  for (const XEdge& e : p->edges) {
    if (e.row < 0 ||
        (uint64_t)(e.row + 1) * (uint64_t)p->elems > total_elems)
      return -10;
    const float* row = data + (size_t)e.row * (size_t)p->elems;
    int32_t rc;
    if (p->codec == 2) {
      rc = SendSparse(tx, *p, e, row);
    } else if (p->codec == 1) {
      half.resize((size_t)p->elems);
      for (int64_t i = 0; i < p->elems; ++i) half[(size_t)i] = Bf16RNE(row[i]);
      const uint8_t* body = (const uint8_t*)half.data();
      uint64_t blen = (uint64_t)p->elems * 2;
      uint8_t op = (uint8_t)(e.op | kXFlagBf16);
      if (bf_trace_next(e.src, trailer)) {
        tagged.assign(body, body + blen);
        tagged.insert(tagged.end(), trailer,
                      trailer + BF_TRACE_TRAILER_LEN);
        body = tagged.data();
        blen = tagged.size();
        op |= kXFlagTrace;
      }
      rc = bf_wintx_send(tx, e.host.c_str(), e.port, op, p->name.c_str(),
                         e.src, e.dst, e.weight, e.p_weight, body, blen, 0,
                         e.stripe);
    } else {
      // Dense: the row pointer goes straight into the arena copy — the
      // zero-staging-copy fast path (the weight rides the wire header;
      // the receiver scales, exactly like the Python remote-edge path).
      // A sampled trace tag is the one exception: the trailer must ride
      // the payload, so that 1-in-N message pays one staging copy.
      const uint8_t* body = (const uint8_t*)row;
      uint64_t blen = (uint64_t)p->elems * 4;
      uint8_t op = e.op;
      if (bf_trace_next(e.src, trailer)) {
        tagged.assign(body, body + blen);
        tagged.insert(tagged.end(), trailer,
                      trailer + BF_TRACE_TRAILER_LEN);
        body = tagged.data();
        blen = tagged.size();
        op |= kXFlagTrace;
      }
      rc = bf_wintx_send(tx, e.host.c_str(), e.port, op, p->name.c_str(),
                         e.src, e.dst, e.weight, e.p_weight, body, blen, 0,
                         e.stripe);
    }
    if (rc != 0) return rc;  // first failing edge stops the dispatch
  }
  return 0;
}

}  // namespace

extern "C" {

int64_t bf_xla_plan_new(const char* name, int64_t elems, int32_t n_edges,
                        int32_t codec, double sparse_frac) {
  if (!name || elems <= 0 || n_edges < 0) return -9;
  if (std::strlen(name) >= 128) return -4;
  auto p = std::make_shared<XPlan>();
  p->name = name;
  p->elems = elems;
  p->codec = codec;
  p->frac = sparse_frac;
  p->edges.resize((size_t)n_edges);
  std::lock_guard<std::mutex> lk(g_plan_m);
  int64_t id = g_next_plan++;
  (*g_plans)[id] = std::move(p);
  return id;
}

int32_t bf_xla_plan_edge(int64_t plan, int32_t i, const char* host,
                         int32_t port, uint8_t op, int32_t src, int32_t dst,
                         double weight, int64_t row, int32_t stripe) {
  auto p = FindPlan(plan);
  if (!p || !host || i < 0 || (size_t)i >= p->edges.size()) return -9;
  XEdge& e = p->edges[(size_t)i];
  e.host = host;
  e.port = port;
  e.op = op;
  e.src = src;
  e.dst = dst;
  e.weight = weight;
  e.row = row;
  e.stripe = stripe < 0 ? 0 : stripe;
  return 0;
}

int32_t bf_xla_plan_set_p(int64_t plan, const double* p_vals, int32_t n) {
  auto p = FindPlan(plan);
  if (!p || !p_vals || (size_t)n != p->edges.size()) return -9;
  for (int32_t i = 0; i < n; ++i) p->edges[(size_t)i].p_weight = p_vals[i];
  return 0;
}

int32_t bf_xla_plan_run(int64_t plan, const void* tx, const float* data,
                        uint64_t total_elems) {
  return PlanRun(plan, tx, data, total_elems);
}

int32_t bf_xla_plan_free(int64_t plan) {
  std::lock_guard<std::mutex> lk(g_plan_m);
  return g_plans->erase(plan) ? 0 : -9;
}

int64_t bf_xla_take_residual(const char* name, int32_t src, int32_t dst,
                             float* out, int64_t cap) {
  if (!name || !out) return 0;
  std::lock_guard<std::mutex> lk(g_res_m);
  auto it = g_res->find(std::make_tuple(std::string(name), src, dst));
  if (it == g_res->end()) return 0;
  int64_t n = (int64_t)it->second.size();
  if (n > cap) return -1;
  std::memcpy(out, it->second.data(), (size_t)n * 4);
  g_res->erase(it);
  return n;
}

int32_t bf_xla_add_residual(const char* name, int32_t src, int32_t dst,
                            const float* data, int64_t n) {
  if (!name || !data || n <= 0) return -9;
  std::lock_guard<std::mutex> lk(g_res_m);
  auto& res = (*g_res)[std::make_tuple(std::string(name), src, dst)];
  if ((int64_t)res.size() != n) res.assign((size_t)n, 0.0f);
  for (int64_t i = 0; i < n; ++i) res[(size_t)i] += data[i];
  return 0;
}

void bf_xla_drop_residuals(const char* name) {
  std::lock_guard<std::mutex> lk(g_res_m);
  if (name == nullptr) {
    g_res->clear();
    return;
  }
  std::string want(name);
  for (auto it = g_res->begin(); it != g_res->end();) {
    if (std::get<0>(it->first) == want)
      it = g_res->erase(it);
    else
      ++it;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// In-program probe ring (BLUEFOG_TPU_PROBE) — the flight-recorder design
// (winsvc.cc RecRing) with a 16-byte event and a drain cursor.  The ring
// is process-wide and lock-free on the record path: arming swaps an atomic
// pointer under a mutex, recording is an acquire pointer load + a relaxed
// fetch_add slot claim + a 16-byte store.  Off state = one pointer load,
// zero mutation (the BLUEFOG_TPU_PROBE=0 inertness contract).  Only the
// drain takes the mutex (once per training step, from Python).
// ---------------------------------------------------------------------------

namespace {

struct ProbeRing {
  std::vector<bf_probe_event_t> ev;
  std::atomic<uint64_t> idx{0};
};

std::atomic<ProbeRing*> g_probe{nullptr};
std::mutex g_probe_m;  // serializes enable/reset/drain, never the record
uint64_t g_probe_read = 0;  // drain cursor (total events already drained)

inline int64_t SteadyNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

int64_t bf_probe_enable(int64_t capacity) {
  std::lock_guard<std::mutex> lk(g_probe_m);
  ProbeRing* r = g_probe.load(std::memory_order_acquire);
  if (r != nullptr) return (int64_t)r->ev.size();
  if (capacity <= 0) capacity = 8192;
  auto* ring = new ProbeRing();
  ring->ev.assign((size_t)capacity, bf_probe_event_t{0, 0, 0});
  g_probe_read = 0;
  g_probe.store(ring, std::memory_order_release);
  return capacity;
}

int32_t bf_probe_is_enabled(void) {
  return g_probe.load(std::memory_order_acquire) != nullptr;
}

void bf_probe_note(int32_t probe_id) {
  ProbeRing* r = g_probe.load(std::memory_order_acquire);
  if (r == nullptr) return;
  uint64_t i = r->idx.fetch_add(1, std::memory_order_relaxed);
  bf_probe_event_t& e = r->ev[(size_t)(i % r->ev.size())];
  e.t_ns = SteadyNs();
  e.probe_id = probe_id;
  e.seq = (uint32_t)i;
}

int64_t bf_probe_total(void) {
  ProbeRing* r = g_probe.load(std::memory_order_acquire);
  return r == nullptr ? 0 : (int64_t)r->idx.load(std::memory_order_relaxed);
}

int64_t bf_probe_drain(bf_probe_event_t* out, int64_t cap) {
  std::lock_guard<std::mutex> lk(g_probe_m);
  ProbeRing* r = g_probe.load(std::memory_order_acquire);
  if (r == nullptr) return -1;
  uint64_t total = r->idx.load(std::memory_order_acquire);
  uint64_t size = (uint64_t)r->ev.size();
  uint64_t first = g_probe_read;
  if (total - first > size) first = total - size;  // overwritten: lost
  uint64_t n = total - first;
  if (out != nullptr && (int64_t)n > cap) {
    first = total - (uint64_t)cap;  // keep the newest cap events
    n = (uint64_t)cap;
  }
  if (out != nullptr) {
    for (uint64_t k = 0; k < n; ++k)
      out[k] = r->ev[(size_t)((first + k) % size)];
  }
  g_probe_read = total;
  return (int64_t)n;
}

void bf_probe_reset(void) {
  std::lock_guard<std::mutex> lk(g_probe_m);
  ProbeRing* r = g_probe.load(std::memory_order_acquire);
  if (r == nullptr) return;
  // Disarm first so no recorder claims a slot mid-clear, then re-arm the
  // same storage (the ring stays allocated for the process lifetime —
  // same leak-by-design as the flight recorder's reset).
  g_probe.store(nullptr, std::memory_order_release);
  r->idx.store(0, std::memory_order_release);
  std::fill(r->ev.begin(), r->ev.end(), bf_probe_event_t{0, 0, 0});
  g_probe_read = 0;
  g_probe.store(r, std::memory_order_release);
}

}  // extern "C"
