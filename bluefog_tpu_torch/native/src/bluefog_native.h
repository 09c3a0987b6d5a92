/* C ABI of the window transport's native service (winsvc.cc), the
 * timeline writer (timeline.cc) and the put plans and probe ring
 * (xlacall.cc).
 *
 * The declarations of the JAX package's bluefog_tpu/native/src/
 * bluefog_native.h that these sources define: the chrome-trace writer,
 * the TCP service, its native drain and decode pool, the per-peer
 * coalescing send queues, the wire trace tags, the transport flight
 * recorder, the put plans with their residual store, and the probe ring.
 * Plain C for ctypes (bluefog_tpu_torch/native/__init__.py binds it).
 */

#ifndef BLUEFOG_NATIVE_H_
#define BLUEFOG_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------- timeline.cc ---------------- */

typedef struct bf_timeline bf_timeline_t;

bf_timeline_t* bf_timeline_open(const char* path, int32_t pid);
/* phase: 'B' begin | 'E' end | 'X' complete (dur_us used). Non-blocking:
 * events are dropped (counted) if the ring is full. */
void bf_timeline_event(bf_timeline_t* t, const char* name, const char* cat,
                       char phase, int64_t ts_us, int64_t dur_us,
                       int64_t tid);
int64_t bf_timeline_dropped(bf_timeline_t* t);
void bf_timeline_close(bf_timeline_t* t);

/* ---------------- winsvc.cc ---------------- */

typedef struct bf_winsvc bf_winsvc_t;

/* Inbound message, drained by the host framework (Python window store). */
typedef struct {
  uint8_t op;          /* opaque; ops/transport.py defines the codes
                        * (1=put 2=accumulate ... 10=batch container) */
  int32_t src;
  int32_t dst;
  double weight;
  double p_weight;     /* associated-P mass carried with the payload */
  char name[128];      /* window name (NUL-terminated) */
  uint64_t payload_len;
  int64_t rx_mono_us;  /* CLOCK_MONOTONIC (us) when the reader had read the
                        * frame's last byte off its connection */
} bf_win_msg_t;

/* Start a server listening on port (0 = ephemeral; bf_winsvc_port tells).
 * max_pending bounds the inbound queue. */
bf_winsvc_t* bf_winsvc_start(int32_t port, int32_t max_pending);
int32_t bf_winsvc_port(bf_winsvc_t* s);

/* Drain one inbound message; payload copied into caller buffer (cap bytes).
 * Returns 1 if a message was produced, 0 if queue empty, -1 if payload
 * exceeded cap (message stays queued; call again with a bigger buffer). */
int32_t bf_winsvc_recv(bf_winsvc_t* s, bf_win_msg_t* msg, uint8_t* payload,
                       uint64_t cap);

/* Send a one-sided message to host:port (blocking; pooled connections;
 * the whole frame leaves in one sendmsg).  Returns 0 on success, negative
 * code on failure (-1 resolve, -2 connect, -3 write, -4 name too long
 * for the receiver's 128-byte field — deterministic, don't retry). */
int32_t bf_winsvc_send(const char* host, int32_t port, uint8_t op,
                       const char* name, int32_t src, int32_t dst,
                       double weight, double p_weight, const uint8_t* payload,
                       uint64_t payload_len);

void bf_winsvc_stop(bf_winsvc_t* s);

/* The control lane: the readers hand OP_MEMBER frames to a queue of their
 * own instead of the drain's, and bf_winsvc_ctrl_recv pops them in arrival
 * order, waiting up to wait_ms for one; it returns as bf_winsvc_recv does
 * (bf_winsvc_recv and bf_winsvc_drain never see an OP_MEMBER frame). */
int32_t bf_winsvc_ctrl_recv(bf_winsvc_t* s, bf_win_msg_t* msg,
                            uint8_t* payload, uint64_t cap, int32_t wait_ms);

/* -------- native receive/drain fast path (BLUEFOG_TPU_WIN_NATIVE) -------
 *
 * The host framework registers each f32 window's flat element count; the
 * drain call then decodes queued OP_BATCH frames in C++ (dense f32, bf16
 * and sparse payload codecs), groups runs of consecutive put/accumulate
 * sub-messages per window, folds consecutive same-slot contributions
 * (matching ops/window._apply_data_run: a put starts a fresh entry, an
 * accumulate folds into the immediately-previous entry of the same
 * (dst, src) slot) and hands back an ORDERED item list: folded commit
 * entries interleaved with raw messages (control ops, unregistered or
 * non-f32 windows, undecodable payloads) in exact stream order — the
 * FIFO property win_fence and the distributed mutex rely on. */

typedef struct {
  uint8_t kind;        /* 0 = raw message, 1 = folded commit entry */
  uint8_t op;          /* raw: wire op byte, compression flags intact */
  uint8_t replace;     /* commit: 1 iff the run's first contribution was
                        * a PUT (slot overwrite, then accumulates fold) */
  uint8_t frame;       /* nonzero: ordinal (1..255, cycling) of the decoded
                        * OP_BATCH frame this item came from — consecutive
                        * items sharing it belong to one frame, so a host
                        * consumer can reconstruct per-frame delivery.
                        * 0: singleton or fallback whole-frame item. */
  int32_t src;
  int32_t dst;
  int32_t puts;        /* commit: PUT messages folded in (0 or 1) */
  int32_t accs;        /* commit: ACCUMULATE messages folded in */
  double weight;       /* raw only (commit values are pre-scaled) */
  double p_weight;     /* raw: p_weight; commit: folded associated-P mass */
  uint64_t off;        /* raw: byte offset into raw_buf; commit: ELEMENT
                        * offset into val_buf */
  uint64_t len;        /* raw: payload bytes; commit: element count */
  uint64_t wire_bytes; /* commit: summed wire payload bytes (telemetry) */
  /* Wire trace tag (OP_TRACE_FLAG trailer) of the LAST tagged message
   * folded into this commit entry; trace_seq == 0 means untagged.  Raw
   * items keep their trailer in the payload instead (the Python decoder
   * strips it). */
  uint32_t trace_seq;
  int32_t trace_src;
  int64_t trace_mono_us;  /* sender's CLOCK_MONOTONIC at origin (us) */
  int64_t trace_unix_us;  /* sender's unix wall clock at origin (us) */
  int64_t trace_step;     /* sender's training step at origin (-1 = the
                           * sender had no step clock) */
  char name[128];
} bf_win_item_t;

/* Cumulative counters of the native drain path (monotonic; snapshot and
 * diff on the host side).  Histogram buckets use the telemetry module's
 * shared log-spaced boundary table (1e-6 .. 5e1, 24 boundaries + overflow),
 * so bucket counts merge into the registry by elementwise addition. */
typedef struct {
  uint64_t batch_frames;   /* OP_BATCH frames fully decoded natively */
  uint64_t msgs;           /* sub-messages in those frames */
  uint64_t folded_msgs;    /* data sub-messages folded into commits */
  uint64_t commits;        /* commit entries emitted */
  uint64_t bytes;          /* frame payload bytes of decoded batches */
  uint64_t by_op[16];      /* sub-message counts by base op code */
  uint64_t batch_size_hist[25];
  double batch_size_sum;
  uint64_t decode_busy;    /* decode-pool workers busy RIGHT NOW (gauge) */
  uint64_t decode_threads; /* decode-pool size (0 = inline decode) */
  uint64_t decoded_frames; /* frames decoded BY THE POOL (0 inline) */
} bf_winrx_stats_t;

/* Register (elems > 0) or unregister (elems <= 0) a window for the native
 * fold path: a flat f32 row of `elems` elements.  Unregistered windows'
 * messages pass through as raw items.  Returns 0, -4 if the name exceeds
 * the 128-byte field. */
int32_t bf_winsvc_win_set(bf_winsvc_t* s, const char* name, int64_t elems);

/* Pop up to max_frames queued inbound frames, decode + fold, and fill the
 * caller's buffers.  Returns the number of items written (>0), 0 when the
 * queue is empty, or a grow request with nothing consumed: -1 raw_buf too
 * small, -2 val_buf too small, -3 items array too small (the offending
 * frame stays queued).  With wait_ms > 0 and an empty queue, blocks up to
 * that long for the first frame (the caller's GIL is released across the
 * call, so the drain thread sleeps in C instead of polling).  Fold runs
 * never span frames, so the result is bit-identical to the Python batched
 * apply on the same frames. */
int32_t bf_winsvc_drain(bf_winsvc_t* s, bf_win_item_t* items,
                        int32_t max_items, uint8_t* raw_buf, uint64_t raw_cap,
                        float* val_buf, uint64_t val_cap, int32_t max_frames,
                        int32_t wait_ms);

void bf_winsvc_rx_stats(bf_winsvc_t* s, bf_winrx_stats_t* out);

/* Start a drain-side decode thread pool of `threads` workers: inbound
 * frames are decoded/scaled/folded IN PARALLEL (per-frame buffers) and
 * bf_winsvc_drain emits the results in exact arrival order, so per-
 * connection FIFO — the fence/mutex ordering contract — is preserved
 * while decode of different connections (and different stripes of one
 * peer) overlaps.  Call once, BEFORE the first drain, and only on a
 * service consumed via bf_winsvc_drain (bf_winsvc_recv bypasses the
 * pool and must not be mixed with it).  threads <= 0 keeps the inline
 * single-thread decode (bit-identical; the pool changes scheduling,
 * never bytes).  Returns the pool size actually started. */
int32_t bf_winsvc_set_decode(bf_winsvc_t* s, int32_t threads);

/* -------- native transmit path: per-peer coalescing send queues --------
 *
 * The C++ twin of ops/transport._PeerSender: one bounded queue + one
 * worker thread per peer, flushing as a single OP_BATCH frame (or a plain
 * legacy frame for a singleton) on a byte threshold, a linger timeout, an
 * urgent op, or an explicit flush — one sendmsg per frame, no Python
 * thread and no GIL anywhere on the per-message path. */

typedef struct bf_wintx bf_wintx_t;

/* Cumulative per-peer counters (aggregate with host=NULL includes retired
 * peers so totals stay monotonic across drop_peer/recreate cycles). */
typedef struct {
  uint64_t msgs_enq;       /* messages accepted by bf_wintx_send */
  uint64_t msgs_done;      /* handed to TCP, failed, or dropped */
  uint64_t frames;         /* frames successfully handed to TCP */
  uint64_t batches;        /* frames carrying > 1 message */
  uint64_t batched_msgs;   /* messages in such frames */
  uint64_t bytes;          /* payload bytes enqueued */
  uint64_t errors;         /* failed frame sends (batches dropped) */
  uint64_t retries;        /* transient-retry attempts */
  uint64_t dropped_msgs;   /* queued messages discarded by drop_peer */
  uint64_t queue_len;      /* current queue length (gauge) */
  uint64_t by_op[16];      /* enqueued messages by base op code */
  uint64_t batch_size_hist[25];  /* telemetry bucket table, see above */
  uint64_t send_sec_hist[25];    /* frame send duration (seconds table) */
  double batch_size_sum;
  double send_sec_sum;
} bf_wintx_stats_t;

/* Start the native sender.  flush_bytes/linger_us/queue_max mirror the
 * BLUEFOG_TPU_WIN_COALESCE_* knobs; retries/backoff_sec the transient-
 * retry policy (jittered exponential, as in the Python path).  stripes
 * (>= 1) is the multi-stream width: every (host, port) peer is driven by
 * `stripes` independent sockets + sender workers + send arenas, each an
 * independent FIFO — the caller shards frames deterministically by
 * (window, row) onto a stripe, so same-slot ordering is preserved per
 * stripe while a fat DCN link is saturated by N parallel streams. */
bf_wintx_t* bf_wintx_start(uint64_t flush_bytes, uint64_t linger_us,
                           int32_t queue_max, int32_t retries,
                           double backoff_sec, int32_t stripes);

/* Enqueue one message onto (host, port)'s stripe queue; blocking
 * backpressure when full.  stripe is clamped into [0, stripes); each
 * stripe owns its socket, worker and send arena, so producers writing
 * different stripes never contend on one queue mutex.  urgent != 0 cuts
 * the linger (and drags THAT STRIPE's queued data onto the wire ahead of
 * it).  Returns 0, -4 name >= 128 bytes (deterministic), -5
 * transport/peer stopping, or a stored negative send-error code from a
 * previously failed batch on this stripe (consumed, as the Python
 * sender's stored error is). */
int32_t bf_wintx_send(bf_wintx_t* t, const char* host, int32_t port,
                      uint8_t op, const char* name, int32_t src, int32_t dst,
                      double weight, double p_weight, const uint8_t* payload,
                      uint64_t payload_len, int32_t urgent, int32_t stripe);

/* Block until everything enqueued to (host, port) BEFORE this call has
 * been handed to TCP — across ALL of the peer's stripes.  host == NULL
 * drains every peer.  Returns 0, a stored send-error code (consumed),
 * -6 on timeout, -5 stopped with messages unsent. */
int32_t bf_wintx_flush(bf_wintx_t* t, const char* host, int32_t port,
                       double timeout_sec);

/* Monotonic failed-batch count for (host, port), summed over its stripes
 * (0 if unknown/retired); host == NULL sums the active peers — the
 * error-epoch token.  The token scopes per (peer, stripe): a failure on
 * any stripe of an addressed peer trips every op that overlapped it. */
int64_t bf_wintx_err_count(bf_wintx_t* t, const char* host, int32_t port);

/* Non-blocking: wake every sender with a pending queue (pacing). */
void bf_wintx_kick(bf_wintx_t* t);

/* Retire a peer: discard the queues of EVERY stripe (returns the summed
 * count, recorded in dropped_msgs), fail any blocked flusher, let all
 * stripe workers exit — a dead peer must never leave N-1 orphan workers
 * retrying into closed sockets.  A later send to the same address lazily
 * creates fresh stripe senders. */
int64_t bf_wintx_drop_peer(bf_wintx_t* t, const char* host, int32_t port);

/* Declare "host:port,host:port" peers unreachable (chaos fault
 * injection): their batch sends fail with no wire traffic and no retries.
 * NULL or "" heals. */
void bf_wintx_set_partition(bf_wintx_t* t, const char* csv);

/* The chaos link-delay fault: sleep us microseconds before each DATA
 * enqueue (put, accumulate, get reply; control ops never), on every path
 * that enqueues (a Python send and a put plan's run alike), after the
 * message's trace tag was stamped.  0 heals. */
void bf_wintx_set_send_delay(bf_wintx_t* t, int64_t us);

/* Counter snapshot: host == NULL aggregates every peer ever created;
 * otherwise the named active peer, summed over ALL its stripes (zeroed
 * if unknown). */
void bf_wintx_stats(bf_wintx_t* t, const char* host, int32_t port,
                    bf_wintx_stats_t* out);

/* Counter snapshot of ONE stripe of (host, port) — the per-stripe
 * telemetry series (bytes, queue depth, errors per stripe).  Zeroed when
 * the peer/stripe is unknown or retired. */
void bf_wintx_stripe_stats(bf_wintx_t* t, const char* host, int32_t port,
                           int32_t stripe, bf_wintx_stats_t* out);

/* The configured stripe width (>= 1). */
int32_t bf_wintx_stripes(bf_wintx_t* t);

/* Drain queues (workers finish in-flight batches; unreachable peers fail
 * fast), join every worker, free the transport. */
void bf_wintx_stop(bf_wintx_t* t);

/* -------- winsvc.cc: wire trace tags + transport flight recorder --------
 *
 * Trace tags (BLUEFOG_TPU_TRACE_SAMPLE): a sampled subset of
 * put/accumulate messages carries OP_TRACE_FLAG (0x10) in the op byte
 * and a 32-byte trailer appended to the payload:
 *   i32 src_rank | u32 seq | i64 origin_monotonic_us | i64 origin_unix_us
 *   | i64 origin_step
 * The Python sender builds the trailer itself (the payload is opaque to
 * bf_wintx_send, so the native tx path ships it unchanged); the XLA put
 * plans call bf_trace_next from C.  Sequence spaces are disjoint: Python
 * tags count up from 1, native tags carry bit 31 set — one process's
 * (src_rank, seq) is globally unique either way.  origin_step is the
 * sender's training step at encode time (-1 when no step clock was
 * published) — the exact age-in-steps sensor the bounded-staleness
 * async fold reads. */

#define BF_TRACE_TRAILER_LEN 32

/* Set the sampling period (tag every Nth data message; <= 0 = off). */
void bf_trace_configure(int32_t period);
int32_t bf_trace_period(void);
/* Publish the sender-side origin-step clock carried by native-encoded
 * trailers (the window optimizer family calls this each step). */
void bf_trace_set_step(int64_t step);
int64_t bf_trace_step(void);
/* Drain-fold policy: allow=0 stops the decoder folding accumulates into
 * PUT-headed commit entries, so the async bounded-staleness policy sees
 * every accumulate individually (default 1 = the legacy-exact fold). */
void bf_winsvc_set_fold_across_put(int32_t allow);
/* Sampling decision + trailer for one outgoing message on the native
 * encode paths.  Returns 1 and fills trailer[BF_TRACE_TRAILER_LEN] when
 * this message is tagged, else 0 (trailer untouched). */
int32_t bf_trace_next(int32_t src, uint8_t* trailer);

/* Flight recorder: a process-wide lock-free fixed-size ring of transport
 * events (enqueue/flush/sendmsg/drain/decode/fold/commit), keyed by
 * (window/peer name, stripe, src, dst, trace seq).  Recording costs tens
 * of ns per event (one relaxed fetch_add + a struct write); when not
 * enabled every record site is a single atomic pointer load — zero
 * mutation, zero allocation.  Snapshots taken while traffic is live may
 * contain a few torn in-flight slots (flight-recorder semantics: the
 * black box favors availability over consistency). */

#define BF_REC_ENQUEUE 1 /* message accepted by a send queue            */
#define BF_REC_FLUSH   2 /* frame assembled from a queue (pre-send)     */
#define BF_REC_SENDMSG 3 /* frame handed to TCP (src field carries rc)  */
#define BF_REC_DRAIN   4 /* inbound frame popped by the drain           */
#define BF_REC_DECODE  5 /* tagged sub-message decoded                  */
#define BF_REC_FOLD    6 /* tagged sub-message folded into a commit     */
#define BF_REC_COMMIT  7 /* entry committed to window staging (Python)  */

typedef struct {
  int64_t t_us;   /* CLOCK_MONOTONIC microseconds at record time */
  int32_t src;
  int32_t dst;
  uint32_t seq;   /* trace-tag seq (0 untagged); FLUSH/SENDMSG: msgs in
                   * the frame */
  uint32_t len;   /* payload/frame bytes (saturating u32) */
  uint8_t etype;  /* BF_REC_* */
  uint8_t op;     /* wire op byte, flags intact */
  uint8_t stripe;
  uint8_t flags;  /* reserved */
  char name[20];  /* window name or peer "host:port", NUL-padded */
} bf_rec_event_t;

/* Allocate + arm the ring (idempotent; capacity <= 0 = 65536).  Returns
 * the live capacity. */
int64_t bf_rec_enable(int64_t capacity);
int32_t bf_rec_is_enabled(void);
/* Record one event from the host side (the native hot paths record
 * directly; this entry serves the Python fallback path + commit sites). */
void bf_rec_note(int32_t etype, int32_t op, int32_t stripe, int32_t src,
                 int32_t dst, uint32_t seq, uint64_t len, const char* name);
/* Copy up to cap events oldest-first into out; returns the count copied.
 * out == NULL returns the count a full snapshot would produce. */
int64_t bf_rec_snapshot(bf_rec_event_t* out, int64_t cap);
void bf_rec_reset(void);

/* -------- xlacall.cc: put plans --------
 *
 * A put plan is the routing of one window put/accumulate dispatch: per
 * remote edge, the peer endpoint, wire op, (src, dst), weight, stripe and
 * the row of the caller's (rows, elems) f32 buffer.  Running a plan
 * encodes each row straight from the buffer into the bf_wintx_* per-peer
 * arenas (one arena copy, no per-edge staging): ops/xlaffi.py runs it
 * with a pointer to the tensor's memory on the CPU, or to the pinned copy
 * of the put's owned rows on a card, from Python or from a stream host
 * function (csrc/hostfn.cpp).  Codecs (bf16 round-to-nearest-even, sparse
 * top-|magnitude| with sender error-feedback residuals keyed by (window,
 * src, dst), as ops/window.py's) are applied during the encode. */

/* codec: 0 dense f32, 1 bf16, 2 sparse(frac).  Returns a plan id > 0,
 * or -4 if the window name exceeds the receiver's 128-byte field. */
int64_t bf_xla_plan_new(const char* name, int64_t elems, int32_t n_edges,
                        int32_t codec, double sparse_frac);

/* Fill edge slot i (0-based).  op carries the BASE wire code (codec flag
 * bits are applied by the encoder).  row is the row index into the
 * (rows, elems) input buffer.  stripe pins the edge's transport stripe
 * AT COMPILE TIME (the same deterministic (window, row) shard the eager
 * sender computes, so plan-dispatched and host-dispatched frames for one
 * edge always ride the same FIFO).  Returns 0, -9 unknown plan / bad
 * index. */
int32_t bf_xla_plan_edge(int64_t plan, int32_t i, const char* host,
                         int32_t port, uint8_t op, int32_t src, int32_t dst,
                         double weight, int64_t row, int32_t stripe);

/* Refresh every edge's associated-P mass before a dispatch (push-sum
 * runs; n must equal n_edges).  Returns 0, -9 unknown plan / size. */
int32_t bf_xla_plan_set_p(int64_t plan, const double* p, int32_t n);

/* Execute a plan against a raw f32 buffer of total_elems elements,
 * enqueueing every edge's encoded row onto tx's per-peer queues.  Returns 0, -9 unknown plan, -10 a row offset
 * falls outside the buffer, -5/-7/... any bf_wintx_send error (stops at
 * the first failing edge, like the Python per-edge loop). */
int32_t bf_xla_plan_run(int64_t plan, const void* tx, const float* data,
                        uint64_t total_elems);

int32_t bf_xla_plan_free(int64_t plan);

/* Purge sparse error-feedback residuals (one window's, or all when name
 * is NULL) — the native twin of ops/window._drop_ef_residuals. */
void bf_xla_drop_residuals(const char* name);

/* Cross-store residual hand-off, so a put stream that mixes the plan and
 * host-staged paths on one (window, src, dst) edge never strands mass in
 * whichever store the other path cannot see (residuals are additive:
 * merging is exact).  take: copy-and-erase the native residual into out
 * (returns the element count, 0 if none, -1 if cap is too small — the
 * residual stays).  add: fold data into (or create) the native
 * residual. */
int64_t bf_xla_take_residual(const char* name, int32_t src, int32_t dst,
                             float* out, int64_t cap);
int32_t bf_xla_add_residual(const char* name, int32_t src, int32_t dst,
                            const float* data, int64_t n);

/* -------- xlacall.cc: the probe ring --------
 *
 * Timestamps of the fused step's seams (utils/probes.py): each note
 * records one (probe_id, steady-clock ns, claim counter) event into a
 * process-wide lock-free ring, the flight recorder's design with a 16-byte
 * event and a drain cursor.  A note is one relaxed fetch_add and a 16-byte
 * store; with the ring off, one atomic pointer load.  The clock is
 * CLOCK_MONOTONIC, the epoch of Python's time.monotonic_ns() and of the
 * timeline's event clock.  On a card the fused step's program notes its
 * seams from stream host functions (csrc/hostfn.cpp), the host notes its
 * own over ctypes, into the same ring. */

typedef struct {
  int64_t t_ns;     /* std::chrono::steady_clock (CLOCK_MONOTONIC) ns */
  int32_t probe_id; /* caller-defined seam id (utils/probes.py names them) */
  uint32_t seq;     /* low 32 bits of the global claim counter (wraps) */
} bf_probe_event_t;

/* Allocate + arm the ring (idempotent; capacity <= 0 = 8192).  Returns
 * the live capacity. */
int64_t bf_probe_enable(int64_t capacity);
int32_t bf_probe_is_enabled(void);
/* Record one probe event (a stream host function of the fused program,
 * or Python over ctypes for the host-side seams). */
void bf_probe_note(int32_t probe_id);
/* Total events ever recorded (monotonic; drain loss = total - drained). */
int64_t bf_probe_total(void);
/* Copy the events recorded since the last drain into out (oldest-first,
 * at most cap; events overwritten before the drain are lost — ring
 * semantics) and advance the cursor.  Returns the count copied, 0 when
 * nothing new, -1 when the ring is off. */
int64_t bf_probe_drain(bf_probe_event_t* out, int64_t cap);
void bf_probe_reset(void);

#ifdef __cplusplus
}
#endif

#endif /* BLUEFOG_NATIVE_H_ */
