"""Communication microbenchmarks: the gossip schedules, the window
transport and the put and fused-step paths, as loopback rigs.

The port of the repository's root ``bench_comm.py`` (the JAX package's):
the same flags, the same modes and, for each, one JSON last line with the
same ``metric`` and ``detail`` keys.  Each JAX function keeps its name
here, so a reader finds its counterpart.

    python -m bluefog_tpu_torch.bench_comm                  # schedule bench
    python -m bluefog_tpu_torch.bench_comm --smoke --device cpu
    python -m bluefog_tpu_torch.bench_comm --transport      # or --ffi,
        # --fused, --placement, --hier, --synth, --sharded and each mode's
        # --<mode>-smoke; --stripe-smoke, --tracerec-smoke, --async-smoke,
        # --probe-smoke

The modes:

* the schedule bench (no mode flag): rounds, edges and ms an op of
  ``neighbor_allreduce`` under the naive shift-distance schedule against
  the min-round repack, on ring, Exp2, star and random-regular over
  ``--n`` ranks.  The JAX bench times a ``shard_map``'d ppermute chain on
  a virtual CPU mesh; here the ranks are the rows of one ``(n, payload)``
  tensor on one device, so ``ms_per_op_*`` times the port's gather and
  tree-sum combine (CUDA events on the card).  The asserts are the JAX
  ones: the same edge set, no more rounds, König's bound, and the outputs
  within 1e-6.
* ``--placement``, ``--synth``, ``--hier``, ``--sharded``: the cost models
  of ``ops/placement.py``, ``ops/synthesis.py``, the two-level gossip and
  ``ops/sharded.py`` (host arithmetic, the JAX package's numbers), then
  each one's end-to-end leg through the port's ops on ``--device``.
* ``--transport``, ``--stripe-smoke``, ``--tracerec-smoke``,
  ``--async-smoke``: the window transport (``ops/transport.py``,
  ``native/src/winsvc.cc``) between loopback endpoints of this process.
* ``--ffi``: window puts through a loopback store in three modes,
  ``legacy`` (the Python sender), ``native`` (the host-staged put feeding
  the C++ sender) and ``ffi`` (the put plans, ``BLUEFOG_TPU_WIN_XLA``).
* ``--fused``, ``--probe-smoke``: the fused window step
  (``ops/fused_step.py``: a CUDA graph on the card, the same ops uncaptured
  on the CPU) against the eager step on that loopback store, and its
  in-program probes.

Every gate and assert of the JAX rigs is kept with its threshold (native
>= 5x for rows <= 256 B, plan dispatch >= 2x for rows >= 4 KiB, fused step
>= 1.5x, placement >= 2x, hierarchical >= 4x).  Unlike the JAX rigs, none
prints a skip when its native core is missing: the port's core builds from
its sources at first use, and a failed build, plan or launch raises, so the
rig exits nonzero.  ``BLUEFOG_TPU_WIN_NATIVE=0`` in the launch
environment still pins the transport rigs to the Python path, as asked
(the JAX rigs' native-off leg).

``--device`` (default ``cuda``) places the rigs' tensors; asked for CUDA
without a GPU the script raises.  The JAX rigs set ``JAX_PLATFORMS`` and
``XLA_FLAGS`` before importing jax; the port's set only its own
``BLUEFOG_TPU_*`` knobs (``utils/config.py``).

The put-side staging bytes (``bf_win_host_copy_bytes_total{path}``): on
the CPU a plan reads the tensor's own memory, so ``--ffi`` asserts zero
bytes on every path, as the JAX rig does.  On the card a plan makes one
pinned copy of its source rows a put (``path="plan_stage"``), so the card
leg asserts that those bytes equal the source rows' bytes put, and that
``stage`` and ``enqueue`` stay at zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

__all__ = ["main", "transport_main", "stripe_main", "async_main",
           "tracerec_main", "ffi_main", "fused_main", "probe_main",
           "placement_main", "hier_main", "synth_main", "sharded_main"]

N = 8             # the loopback rigs' ranks: even ones here, odd remote


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the rigs' tensors live (default cuda; "
                        "raises without a GPU)")
    p.add_argument("--n", type=int, default=None,
                   help="ranks of the schedule bench (default 32, 8 with "
                        "--smoke)")
    p.add_argument("--degree", type=int, default=4,
                   help="random-regular degree (default 4)")
    p.add_argument("--payload", type=int, default=2048,
                   help="per-rank f32 payload elements (default 2048)")
    p.add_argument("--iters", type=int, default=10,
                   help="timed iterations per schedule (default 10)")
    p.add_argument("--reps", type=int, default=2,
                   help="op applications per timed call (default 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny fast configuration for CI (n=8, few iters)")
    p.add_argument("--transport", action="store_true",
                   help="the window-transport loopback microbench; asserts "
                        "the >= 5x native messages/s win for <= 256 B rows")
    p.add_argument("--transport-smoke", action="store_true",
                   help="tiny variant of --transport: asserts batched "
                        "delivery + metric presence, no timing assertion")
    p.add_argument("--ffi", action="store_true",
                   help="the put-plan microbench (BLUEFOG_TPU_WIN_XLA): "
                        "put-side dispatch us/row and msgs/s of the legacy "
                        "/ native / plan put paths through a loopback "
                        "store; asserts the >= 2x dispatch win for rows >= "
                        "4 KiB and the staging-byte invariant")
    p.add_argument("--ffi-smoke", action="store_true",
                   help="tiny variant of --ffi: asserts the plan path "
                        "engaged and the staging-byte invariant, no timing "
                        "assertion")
    p.add_argument("--fused", action="store_true",
                   help="the fused-step bench (BLUEFOG_TPU_FUSED_STEP): "
                        "eager vs fused step time on the loopback rig plus "
                        "the structural gates; asserts the >= 1.5x win and "
                        "<= 1e-6 trajectory equivalence over 50 steps")
    p.add_argument("--fused-smoke", action="store_true",
                   help="variant of --fused: fused engagement, trajectory "
                        "equivalence vs eager, FUSED_STEP=0 bitwise "
                        "inertness and the one-warning fallback; no timing "
                        "assertion")
    p.add_argument("--probe-smoke", action="store_true",
                   help="the in-program probes' gate: a fused loopback run "
                        "lands bf_fused_overlap_ratio in (0, 1], per-bucket "
                        "issue histograms, bf_probe_events_total, a finite "
                        "divergence and a trace-merge with fused-probe "
                        "lanes")
    p.add_argument("--async-smoke", action="store_true",
                   help="the async gossip mode's gate: stale accumulates "
                        "rejected into the stale-residual store, the "
                        "counters on /metrics and /healthz, the exact fold "
                        "and the BLUEFOG_TPU_TELEMETRY=0 guard")
    p.add_argument("--tracerec-smoke", action="store_true",
                   help="the message-level tracing gate: contribution-age "
                        "histograms on /metrics and /healthz, a recorder "
                        "dump that merges with flow arrows, and the "
                        "BLUEFOG_TPU_TELEMETRY=0 guard")
    p.add_argument("--stripe-smoke", action="store_true",
                   help="the striped transport's gate: >= 2 stripes engage "
                        "with per-stripe telemetry; BLUEFOG_TPU_WIN_STRIPES"
                        "=1 keeps the pre-stripe wire exactly")
    p.add_argument("--rows", type=int, default=5000,
                   help="transport bench: messages per mode (default 5000)")
    p.add_argument("--row-bytes", type=int, default=4096,
                   help="transport bench: payload bytes per message "
                        "(default 4096)")
    p.add_argument("--placement", action="store_true",
                   help="the placement cost-model report on simulated 4x8 "
                        "and 8x8 tori plus an end-to-end equivalence check")
    p.add_argument("--placement-smoke", action="store_true",
                   help="variant of --placement (same assertions)")
    p.add_argument("--placement-iters", type=int, default=1000,
                   help="simulated-annealing iterations of the placement "
                        "search (default 1000)")
    p.add_argument("--hier", action="store_true",
                   help="the hierarchical-gossip report on simulated "
                        "2x(4x8) and 4x(4x4) tori; asserts >= 4x DCN "
                        "reduction at equal-or-better consensus")
    p.add_argument("--hier-smoke", action="store_true",
                   help="variant of --hier (same assertions)")
    p.add_argument("--synth", action="store_true",
                   help="the schedule-synthesis report plus an end-to-end "
                        "check of a synthesized schedule")
    p.add_argument("--synth-smoke", action="store_true",
                   help="variant of --synth (same assertions)")
    p.add_argument("--sharded", action="store_true",
                   help="the sharded-gossip report: DCN bytes scale with "
                        "the replicated fraction only, plus an executor "
                        "leg on 8 ranks")
    p.add_argument("--sharded-smoke", action="store_true",
                   help="variant of --sharded (same assertions)")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _check(ok, what: str) -> None:
    """The JAX rigs' ``assert``, kept under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def _resolve_device(name: str) -> str:
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_comm: --device cuda (the default) but "
                           "no GPU is available; pass --device cpu for the "
                           "CPU rigs")
    return name


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


@contextlib.contextmanager
def _env(**kv):
    """Set ``BLUEFOG_TPU_*`` knobs (None unsets one) and reload the config;
    restore both after."""
    from bluefog_tpu_torch.utils import config
    prev = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    config.reload()
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config.reload()


class _Loopback:
    """The loopback store of the window legs: windows made in this process
    (every rank's slots), then a directory whose odd ranks belong to a
    local server transport feeding the same store, so every put from an
    even rank to an odd one crosses TCP.  ``store=False`` only counts what
    arrives."""

    def __init__(self, device: str, store: bool = True):
        import torch

        import bluefog_tpu_torch as bf
        from bluefog_tpu_torch import topology as topo
        from bluefog_tpu_torch.ops import transport as T
        from bluefog_tpu_torch.ops import window as W
        self.W = W
        bf.init(N, device=device, topology_fn=lambda: topo.RingGraph(N))
        self.applied = 0
        self.cv = threading.Condition()
        self.store = store
        self.server = T.WindowTransport(
            self._apply, apply_batch=self._apply_batch,
            apply_items=self._apply_items,
            alloc=W._pinned_alloc(torch.device(device)))
        self.client = T.WindowTransport(lambda *a: None)
        self.saved = W._store.distrib

    def _bump(self, k):
        with self.cv:
            self.applied += k
            self.cv.notify_all()

    def _apply(self, *msg):
        if self.store:
            self.W._apply_inbound(*msg)
        self._bump(1)

    def _apply_batch(self, msgs):
        if self.store:
            self.W._apply_inbound_batch(msgs)
        self._bump(len(msgs))

    def _apply_items(self, items):
        if self.store:
            self.W._apply_inbound_items(items)
        self._bump(sum((p[5] + p[6]) if k else 1 for k, p in items))

    def install(self, names_elems):
        for name, elems in names_elems:
            self.server.register_window(name, int(elems))
        self.W._store.distrib = self.W._Distrib(
            self.client, rank_owner={r: r % 2 for r in range(N)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", self.server.port)}, my_proc=0)

    def wait(self, total, timeout=60):
        with self.cv:
            _check(self.cv.wait_for(lambda: self.applied >= total,
                                    timeout=timeout),
                   f"only {self.applied}/{total} messages arrived")

    def close(self):
        import bluefog_tpu_torch as bf
        self.W._store.distrib = self.saved
        self.client.stop()
        self.server.stop()
        bf.shutdown()


def _to_np(t) -> np.ndarray:
    """A host copy (a CPU tensor's ``numpy()`` would share its memory)."""
    return t.detach().to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
# The window transport: --transport, --stripe-smoke
# ---------------------------------------------------------------------------

def _transport_one_mode(mode: str, rows: int, row_bytes: int,
                        peers: int = 1, stripes: int = 1,
                        windows: int = 8, trace_every: int = 0,
                        recorder: bool = False) -> dict:
    """Loopback exchange of ``peers x rows`` messages in one mode:
    ``legacy`` (one frame a message, coalescing off), ``python`` (the
    coalesced Python senders and drain, ``BLUEFOG_TPU_WIN_NATIVE=0``) or
    ``native`` (the C++ queues, encode, decode and fold of ``winsvc.cc``).
    ``peers`` client transports feed ONE server round-robin from one
    producer thread.  The clock stops when the last message was applied at
    the receiver.  Returns the rates and the server's drain-burst p50/p99
    (the JAX rig's ``_transport_one_mode``)."""
    from bluefog_tpu_torch.ops.transport import (OP_ACCUMULATE,
                                                 OP_TRACE_FLAG,
                                                 WindowTransport,
                                                 make_trace_tag)
    from bluefog_tpu_torch.utils import config, flightrec, telemetry

    prev = {v: os.environ.get(v) for v in (
        "BLUEFOG_TPU_WIN_NATIVE", "BLUEFOG_TPU_WIN_COALESCE",
        "BLUEFOG_TPU_WIN_STRIPES", "BLUEFOG_TPU_TRACE_SAMPLE")}
    os.environ["BLUEFOG_TPU_WIN_COALESCE"] = \
        "0" if mode == "legacy" else "1"
    os.environ["BLUEFOG_TPU_WIN_NATIVE"] = "1" if mode == "native" else "0"
    os.environ["BLUEFOG_TPU_WIN_STRIPES"] = str(max(1, stripes))
    if trace_every > 0:
        os.environ["BLUEFOG_TPU_TRACE_SAMPLE"] = str(trace_every)
    else:
        os.environ.pop("BLUEFOG_TPU_TRACE_SAMPLE", None)
    # Long linger: the bench flushes explicitly (as window ops do at op
    # boundaries), so batch sizes reflect the queue, not the clock.
    os.environ.setdefault("BLUEFOG_TPU_WIN_COALESCE_LINGER_MS", "5")
    config.reload()
    telemetry.reset()  # per-mode isolation for the drain histograms

    state = {"n": 0, "batches": 0}
    done = threading.Event()
    target = [0]
    lock = threading.Lock()

    def count(k):
        with lock:
            state["n"] += k
            if state["n"] >= target[0]:
                done.set()

    def apply(op, name, src, dst, weight, p_weight, payload):
        count(1)

    def apply_batch(msgs):
        state["batches"] += 1
        count(len(msgs))

    def apply_items(items):
        count(sum((p[5] + p[6]) if kind else 1 for kind, p in items))

    server = WindowTransport(apply, apply_batch=apply_batch,
                             apply_items=apply_items)
    # Several windows + rotating src ranks, so the (window, row) shard
    # spreads across stripes.
    names = [f"bench{w}" for w in range(max(1, windows))]
    for nm in names:
        server.register_window(nm, row_bytes // 4)
    clients = [WindowTransport(lambda *a: None) for _ in range(peers)]
    if recorder:
        flightrec.enable()
        flightrec.reset()  # this cell's events only
    try:
        row = np.arange(row_bytes // 4, dtype=np.float32)
        row_blob = row.tobytes()
        host, port = "127.0.0.1", server.port
        nw = len(names)

        def payload_for(i):
            # The sampled wire trace tag, appended as the window layer
            # appends it (the tagging cost is part of the cell).
            tag = make_trace_tag(i % 8)
            if tag is None:
                return OP_ACCUMULATE, row
            return (OP_ACCUMULATE | OP_TRACE_FLAG,
                    np.frombuffer(row_blob + tag, np.uint8))

        def exchange(count_per_client):
            done.clear()
            total = count_per_client * peers
            target[0] = state["n"] + total
            if state["n"] >= target[0]:
                done.set()
            t0 = time.perf_counter()
            if trace_every > 0:
                sends = [c.send for c in clients]
                for i in range(total):
                    op, payload = payload_for(i)
                    sends[i % peers](host, port, op, names[i % nw],
                                     i % 8, 1, 1.0, payload)
            elif peers == 1:
                send = clients[0].send
                for i in range(count_per_client):
                    send(host, port, OP_ACCUMULATE, names[i % nw],
                         i % 8, 1, 1.0, row)
            else:
                sends = [c.send for c in clients]
                for i in range(total):
                    sends[i % peers](host, port, OP_ACCUMULATE,
                                     names[i % nw], i % 8, 1, 1.0, row)
            for c in clients:
                c.flush()
            _check(done.wait(timeout=300),
                   f"only {state['n']}/{target[0]} messages arrived")
            return time.perf_counter() - t0

        exchange(min(rows // 10 + 1, 200))  # warm the connections
        dt = exchange(rows)
        total = rows * peers
        for c in clients:
            c.stop()
        server.stop()  # final telemetry pump before the histogram read
        clients.clear()
        burst = telemetry.histogram_percentiles(
            "bf_win_drain_burst_seconds", qs=(50.0, 99.0)) or {}
        snap = telemetry.snapshot() if telemetry.enabled() else {}
        engaged = {k.split('stripe="', 1)[1].split('"', 1)[0]
                   for k in snap
                   if k.startswith("bf_win_tx_stripe_bytes_total")}
        res = {
            "mode": mode,
            "peers": peers,
            "stripes": stripes,
            "stripes_engaged": len(engaged),
            "row_bytes": row_bytes,
            "native_engaged": bool(server.native_path),
            "decode_threads": int(getattr(server, "decode_threads", 0)),
            "msgs_per_s": round(total / dt, 1),
            "mb_per_s": round(total * row_bytes / dt / 1e6, 2),
            "batches_seen": state["batches"],
            "drain_burst_p50_ms": round(burst.get(50.0, 0.0) * 1e3, 3),
            "drain_burst_p99_ms": round(burst.get(99.0, 0.0) * 1e3, 3),
        }
        if recorder:
            # Per-edge one-way delay (enqueue -> drain decode) from the
            # recorder: both ends share this process, so one pseudo-dump
            # at offset 0 joins them.
            from bluefog_tpu_torch.tools import tracegossip
            ev = flightrec.snapshot()
            delays = tracegossip.edge_delays(
                [{"rank": 0, "offset_us": 0, "events": ev}])
            res["tracing"] = {
                "rec_events": int(len(ev)),
                "sample_every": trace_every,
                "edges": {f"{s}->{d}": {
                    "tags": int(len(v)),
                    "p50_ms": round(float(np.percentile(v, 50)) / 1e3, 3),
                    "p99_ms": round(float(np.percentile(v, 99)) / 1e3, 3)}
                    for (s, d), v in delays.items()},
            }
        return res
    finally:
        for c in clients:
            c.stop()
        with contextlib.suppress(Exception):  # stopped on the happy path
            server.stop()
        for var, val in prev.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val
        config.reload()


def transport_main(args) -> int:
    """The loopback transport microbench: the 64 B / 256 B / 4 KB sweep
    over the legacy, Python-coalesced and native paths, the concurrent-
    peers axis, and (full runs) the stripe axis, the put-plan and fused
    legs.  Then the tracing and link-observatory legs.  The full variant
    asserts the native path's >= 5x messages/s over the Python coalesced
    path for <= 256 B rows; the smoke asserts structure only."""
    from bluefog_tpu_torch.utils import telemetry

    smoke = args.transport_smoke
    rows = min(args.rows, 300) if smoke else args.rows
    # An explicit BLUEFOG_TPU_WIN_NATIVE=0 pins the run to the Python
    # path (the native modes are not run, nothing native is asserted).
    native_ok = os.environ.get("BLUEFOG_TPU_WIN_NATIVE") != "0"

    sizes = [64, 256, 4096]
    modes = ["python"] + (["native"] if native_ok else [])
    sweep = []
    failures = []

    # Legacy reference at the CLI row size (fewer rows: one frame a
    # message is ~15x slower).
    legacy = _transport_one_mode("legacy", max(rows // 4, 50),
                                 args.row_bytes)
    if legacy["batches_seen"] != 0:
        failures.append("legacy path delivered batch frames")

    for row_bytes in sizes:
        for mode in modes:
            res = _transport_one_mode(mode, rows, row_bytes)
            sweep.append(res)
            if mode == "python" and res["batches_seen"] == 0:
                failures.append(
                    f"python coalescing on but no batch frame arrived "
                    f"({row_bytes} B)")
            if mode == "native" and not res["native_engaged"]:
                failures.append(
                    f"native path did not engage ({row_bytes} B)")

    # Telemetry presence, from the last run's registry.
    snap = telemetry.snapshot() if telemetry.enabled() else {}
    for series in ("bf_win_tx_batches_total", "bf_win_tx_batched_msgs_total",
                   "bf_win_tx_batch_size", "bf_win_rx_batches_total"):
        if not any(k.startswith(series) for k in snap):
            failures.append(f"expected telemetry series {series!r}")
    if native_ok:
        for series in ("bf_win_native_tx_frames_total",
                       "bf_win_native_rx_frames_total"):
            if not any(k.startswith(series) for k in snap):
                failures.append(
                    f"native path engaged but series {series!r} missing")

    # Concurrent-peers axis: the drain's p99 as senders multiply.
    peer_axis = [1, 2] if smoke else [1, 4, 8]
    peers_tbl = []
    if native_ok:
        for p in peer_axis:
            peers_tbl.append(_transport_one_mode(
                "native", max(rows // p, 50), 256, peers=p))

    # Stripe axis: 1/2/4 stripes x 4 KiB/64 KiB/256 KiB rows x 1/8 peers
    # on the native path; the headline is the best striped cell against
    # one stream at >= 64 KiB rows under 8 peers.
    stripe_tbl = []
    stripe_speedup = None
    if native_ok and not smoke:
        for row_bytes in (4096, 65536, 262144):
            per = max(80, int(rows * 4096 / max(row_bytes, 4096)))
            for p in (1, 8):
                for st in (1, 2, 4):
                    stripe_tbl.append(_transport_one_mode(
                        "native", max(per // p, 40), row_bytes, peers=p,
                        stripes=st))

        def _cell(row_bytes, p, st):
            for r in stripe_tbl:
                if (r["row_bytes"], r["peers"], r["stripes"]) == \
                        (row_bytes, p, st):
                    return r
            return None

        ratios_sp = []
        for row_bytes in (65536, 262144):
            base = _cell(row_bytes, 8, 1)
            cands = [c for c in (_cell(row_bytes, 8, s) for s in (2, 4))
                     if c]
            if base and cands:
                best = max(cands, key=lambda c: c["msgs_per_s"])
                ratios_sp.append(best["msgs_per_s"] / base["msgs_per_s"])
        if ratios_sp:
            stripe_speedup = round(max(ratios_sp), 2)

    def _rate(mode, row_bytes):
        for r in sweep:
            if r["mode"] == mode and r["row_bytes"] == row_bytes:
                return r["msgs_per_s"]
        return None

    ratios = {}
    for row_bytes in sizes:
        py, nat = _rate("python", row_bytes), _rate("native", row_bytes)
        if py and nat:
            ratios[row_bytes] = round(nat / py, 2)
    small_ratio = max((v for k, v in ratios.items() if k <= 256),
                      default=None)

    # The put-plan leg (full runs): plans vs the host-staged native and the
    # Python put paths, folded into this report's detail.
    ffi_detail = None
    ffi_value = None
    if not smoke and native_ok:
        ffi_value, ffi_detail, ffi_failures = _ffi_report(False, args.device)
        failures.extend(f"ffi leg: {f}" for f in ffi_failures)

    # Tracing leg, last: arming the flight recorder is process-sticky.
    # The 4 KiB / 8-peer overhead pair (recorder + 1/64 sampled tags vs
    # plain) and the per-edge one-way-delay p50/p99 from every-message
    # tags.
    tracing_detail = None
    if native_ok:
        t_rows = max(rows // 8, 50)
        base = _transport_one_mode("native", t_rows, 4096, peers=8)
        traced = _transport_one_mode("native", t_rows, 4096, peers=8,
                                     trace_every=64, recorder=True)
        delay_leg = _transport_one_mode("native", max(t_rows // 2, 50),
                                        4096, peers=2, trace_every=1,
                                        recorder=True)
        tracing_detail = {
            "overhead_cell": {
                "row_bytes": 4096, "peers": 8, "sample_every": 64,
                "base_msgs_per_s": base["msgs_per_s"],
                "traced_msgs_per_s": traced["msgs_per_s"],
                "ratio": round(traced["msgs_per_s"]
                               / max(base["msgs_per_s"], 1e-9), 3),
            },
        }
        tracing_detail.update(delay_leg.get("tracing", {}))
        if not delay_leg.get("tracing", {}).get("edges"):
            failures.append(
                "tracing leg produced no per-edge delay readout")

    # Link-observatory leg on the same rig: the traced 4 KiB / 8-peer cell
    # with BLUEFOG_TPU_LINK_OBS=0 (bitwise inert: not one bf_link_* series)
    # and =1 (tx goodput published), then the recorder's delay samples fed
    # through linkobs.note_delay into the link table.
    links_detail = None
    if native_ok and tracing_detail is not None:
        from bluefog_tpu_torch.tools import tracegossip
        from bluefog_tpu_torch.utils import flightrec, linkobs
        prev_win = linkobs._GOODPUT_WINDOW_S
        try:
            with _env(BLUEFOG_TPU_LINK_OBS="0"):
                off = _transport_one_mode("native", t_rows, 4096, peers=8,
                                          trace_every=64)
                snap = telemetry.snapshot() if telemetry.enabled() else {}
            inert = not any(k.startswith("bf_link_") for k in snap)
            if not inert:
                failures.append(
                    "BLUEFOG_TPU_LINK_OBS=0 leg still published bf_link_* "
                    "series (the off-switch is not bitwise inert)")
            with _env(BLUEFOG_TPU_LINK_OBS="1"):
                # The goodput gauge publishes once a >= 0.5 s window,
                # longer than a smoke cell: shrink it (read at call time).
                linkobs._GOODPUT_WINDOW_S = 0.02
                on = _transport_one_mode("native", t_rows, 4096, peers=8,
                                         trace_every=64)
                snap = telemetry.snapshot() if telemetry.enabled() else {}
                if not any(k.startswith("bf_link_goodput_bytes")
                           for k in snap):
                    failures.append(
                        "link observatory armed but the tx path published "
                        "no bf_link_goodput_bytes series")
                linkobs.reset()
                delays = tracegossip.edge_delays(
                    [{"rank": 0, "offset_us": 0,
                      "events": flightrec.snapshot()}])
                for (s, d), samples in sorted(delays.items()):
                    for us in samples:
                        linkobs.note_delay(int(s), int(d), float(us))
                rep = linkobs.local_report()
            if not rep.get("edges"):
                failures.append(
                    "link observatory produced no edge table from the "
                    "recorder's delay samples")
            links_detail = {
                "overhead_cell": {
                    "row_bytes": 4096, "peers": 8, "sample_every": 64,
                    "off_msgs_per_s": off["msgs_per_s"],
                    "on_msgs_per_s": on["msgs_per_s"],
                    "ratio": round(on["msgs_per_s"]
                                   / max(off["msgs_per_s"], 1e-9), 3),
                    "off_inert": inert,
                },
                "report": rep,
            }
        finally:
            linkobs._GOODPUT_WINDOW_S = prev_win
            linkobs.reset()

    # The fused-step leg (full runs): the eager-vs-fused step-time cell.
    fused_detail = None
    if not smoke and native_ok:
        prev_fused = _fused_env_setup()
        try:
            fused_detail = _fused_timing_cell(device=args.device)
        finally:
            _fused_env_restore(prev_fused)

    rc = 0
    for f in failures:
        print(f"bench_comm --transport: {f}", file=sys.stderr)
        rc = 1
    if not smoke and native_ok and (small_ratio is None
                                    or small_ratio < 5.0):
        print(f"bench_comm: native transport speedup {small_ratio}x < 5x "
              "for <=256 B rows", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "win_transport_native_speedup",
        "value": small_ratio,
        "unit": "x",
        "detail": {
            "rows": rows,
            "smoke": smoke,
            "native_available": native_ok,
            "ratios_by_row_bytes": ratios,
            "legacy": legacy,
            "sweep": sweep,
            "peers": peers_tbl,
            "stripes": stripe_tbl,
            "stripe_speedup_64k_plus_8p": stripe_speedup,
            "ffi_dispatch_speedup": ffi_value,
            "ffi": ffi_detail,
            "tracing": tracing_detail,
            "links": links_detail,
            "fused_step": fused_detail,
        },
    }))
    return rc


def stripe_main(args) -> int:
    """The striped transport's gate, three structural checks: a 2-stripe
    loopback run engages >= 2 stripes (and, native, a live decode pool
    with its busy gauge); the per-stripe series exist; a pinned
    ``BLUEFOG_TPU_WIN_STRIPES=1`` leg reproduces the pre-stripe wire
    exactly (one sender, send-order delivery, identical fields and bytes,
    fence weight 0.0)."""
    from bluefog_tpu_torch.ops import transport as T
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import telemetry

    native_ok = os.environ.get("BLUEFOG_TPU_WIN_NATIVE") != "0"
    failures = []

    # -- leg 1: striped run, >= 2 stripes engaged + telemetry ---------------
    mode = "native" if native_ok else "python"
    res = _transport_one_mode(mode, 300, 4096, peers=2, stripes=2)
    if res["stripes_engaged"] < 2:
        failures.append(
            f"only {res['stripes_engaged']} stripe(s) engaged with "
            "BLUEFOG_TPU_WIN_STRIPES=2")
    if native_ok and not res["native_engaged"]:
        failures.append("native path did not engage")
    snap = telemetry.snapshot() if telemetry.enabled() else {}
    stripes_seen = {k.split('stripe="', 1)[1].split('"', 1)[0]
                    for k in snap
                    if k.startswith("bf_win_tx_stripe_bytes_total")}
    if len(stripes_seen) < 2:
        failures.append(
            "expected >= 2 stripe labels on 'bf_win_tx_stripe_bytes_total',"
            f" got {sorted(stripes_seen)}")
    if not any(k.startswith("bf_win_tx_queue_depth") and 'stripe="' in k
               for k in snap):
        failures.append("per-stripe bf_win_tx_queue_depth gauges missing")
    if native_ok and res["decode_threads"] > 0 and not any(
            k.startswith("bf_win_rx_decode_pool_busy") for k in snap):
        failures.append("bf_win_rx_decode_pool_busy gauge missing with a "
                        "live decode pool")

    # -- leg 2: STRIPES=1 pinned: the pre-stripe wire, exactly -------------
    got = []
    cv = threading.Condition()

    def apply(op, name, src, dst, weight, p_weight, payload):
        with cv:
            got.append((op, name, src, dst, weight, bytes(payload)))
            cv.notify_all()

    def apply_batch(msgs):
        for m in msgs:
            apply(*m)

    with _env(BLUEFOG_TPU_WIN_STRIPES="1", BLUEFOG_TPU_WIN_NATIVE="0",
              BLUEFOG_TPU_WIN_COALESCE_LINGER_MS="2"):
        server = T.WindowTransport(apply, apply_batch=apply_batch)
        client = T.WindowTransport(lambda *a: None)
        try:
            if client.n_stripes != 1:
                failures.append(
                    f"STRIPES=1 leg resolved {client.n_stripes} stripes")
            host, port = "127.0.0.1", server.port
            expect = []
            for i in range(8):
                row = np.arange(16, dtype=np.float32) * (i + 1)
                client.send(host, port, T.OP_PUT, "w", i, 1, 0.5, row)
                expect.append((T.OP_PUT, "w", i, 1, 0.5, row.tobytes()))
            client.send(host, port, T.OP_FENCE_REQ, "", 0, -1,
                        W._fanout_weight(1), np.zeros(0, np.float32))
            expect.append((T.OP_FENCE_REQ, "", 0, -1, 0.0, b""))
            client.flush()
            with cv:
                ok = cv.wait_for(lambda: len(got) >= len(expect),
                                 timeout=30)
            if not ok or got != expect:
                failures.append(
                    "STRIPES=1 wire differs from the pre-stripe transport "
                    f"(got {len(got)} messages)")
            if sorted(k[2] for k in client._senders) not in ([], [0]):
                failures.append("STRIPES=1 leg created stripe senders > 0")
        finally:
            client.stop()
            server.stop()

    rc = 0
    for f in failures:
        print(f"bench_comm --stripe-smoke: {f}", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "win_transport_stripes_engaged",
        "value": res["stripes_engaged"],
        "unit": "stripes",
        "detail": {
            "native_available": native_ok,
            "striped_cell": res,
            "single_stripe_wire_ok": all(
                "STRIPES=1" not in f for f in failures),
        },
    }))
    return rc


# ---------------------------------------------------------------------------
# The window store over the wire: --async-smoke, --tracerec-smoke
# ---------------------------------------------------------------------------

def _healthz_and_metrics(telemetry):
    import urllib.error
    import urllib.request
    port = telemetry.start_http_server(0)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            hz = json.loads(r.read().decode())
    except urllib.error.HTTPError as e:   # a degraded status is still JSON
        hz = json.loads(e.read().decode())
    return text, hz


def async_main(args) -> int:
    """The barrier-free async mode's gate, structural: through the
    loopback store, with the async mode armed,
      1. a FRESH round (origin step one behind the receiver's clock)
         commits into staging on the lockstep arithmetic;
      2. a STALE round (the sender's origin-step clock pinned 50 behind)
         is rejected into the stale-residual store, with
         ``bf_win_stale_rejected_total{src}`` on /metrics and the async
         block in /healthz;
      3. ``win_fold_stale_residuals`` folds the held mass back EXACTLY;
      4. under ``BLUEFOG_TPU_TELEMETRY=0`` the same traffic leaves the
         registry untouched (the policy still applies: it is state)."""
    import torch

    knobs = dict(BLUEFOG_TPU_ASYNC="1",
                 BLUEFOG_TPU_ASYNC_STALENESS_STEPS="4",
                 BLUEFOG_TPU_ASYNC_STALENESS_POLICY="reject",
                 BLUEFOG_TPU_TRACE_SAMPLE="1", BLUEFOG_TPU_TELEMETRY="1",
                 BLUEFOG_TPU_WIN_COALESCE_LINGER_MS="100")
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import transport as T
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config as _config
    from bluefog_tpu_torch.utils import telemetry
    dev = args.device
    failures = []

    def drive(rounds):
        """Accumulate streams through the loopback store, each round
        ``(origin_step, rows 8xD)``; returns the window's staging, its
        stale residuals, the fold's count and staging after the fold."""
        rig = _Loopback(dev)
        try:
            _check(bf.win_create(torch.zeros(N, 6, device=dev), "asmoke",
                                 zero_init=True), "win_create")
            rig.install([("asmoke", 6)])
            W.configure_async()
            # The receiver's step clock: contributions age against it.
            W.set_async_step(100)
            total = 0
            for origin_step, t in rounds:
                # The injected delay: pin the sender's origin-step clock
                # behind the receiver's.
                T.set_trace_origin_step(origin_step)
                bf.win_accumulate(torch.from_numpy(t).to(dev), "asmoke")
                total += 8  # the ring's 8 remote (even->odd) edges
                rig.wait(total, timeout=30)
            win = W._store.get("asmoke")
            with win.lock:
                staging = {k: _to_np(v) for k, v in win.staging.items()}
                residual = {k: _to_np(v)
                            for k, v in win.stale_residual.items()}
            folded = W.win_fold_stale_residuals("asmoke")
            with win.lock:
                after = {k: _to_np(v) for k, v in win.staging.items()}
            return staging, residual, folded, after
        finally:
            W._store.distrib = rig.saved
            bf.win_free("asmoke")
            rig.close()

    with _env(**knobs):
        telemetry.reset()
        fresh = np.random.RandomState(5).randn(8, 6).astype(np.float32)
        stale = np.random.RandomState(6).randn(8, 6).astype(np.float32)
        staging, residual, folded, after = drive(
            [(99, fresh), (50, stale)])    # ages 1 (fresh) and 50 (stale)
        # The ring's 8 remote (even-src -> odd-dst) edges.
        remote = sorted({((s + step) % 8, s)
                         for s in range(0, 8, 2) for step in (1, -1)})
        n_stale_edges = 0
        for key in remote:
            d, s = key
            if not np.array_equal(staging.get(key), fresh[s]):
                failures.append(f"edge {key}: fresh round not committed "
                                "on the lockstep path")
            if key in residual:
                n_stale_edges += 1
                if not np.array_equal(residual[key], stale[s]):
                    failures.append(f"edge {key}: stale residual mismatch")
            if not np.array_equal(after.get(key), fresh[s] + stale[s]):
                failures.append(f"edge {key}: fold did not restore mass "
                                "exactly")
        if n_stale_edges == 0:
            failures.append("no edge ever hit the staleness policy")

        # -- /metrics + /healthz surfaces -----------------------------------
        text, hz = _healthz_and_metrics(telemetry)
        if "bf_win_stale_rejected_total" not in text:
            failures.append("bf_win_stale_rejected_total missing on "
                            "/metrics")
        ablock = hz.get("async")
        if not ablock:
            failures.append("no async block in /healthz")
        elif ablock.get("staleness_steps") != 4 or "stale_rejected" not in \
                ablock:
            failures.append(f"async /healthz block incomplete: {ablock}")

        # -- BLUEFOG_TPU_TELEMETRY=0 zero-mutation guard --------------------
        with _env(BLUEFOG_TPU_TELEMETRY="0"):
            telemetry.reset()
            W.clear_async_staleness()
            _, residual0, _, _ = drive([(40, stale)])
            leaked = telemetry.snapshot()
        if not residual0:
            failures.append("TELEMETRY=0 leg: policy did not apply (it is "
                            "state, not telemetry)")
        if leaked:
            failures.append("BLUEFOG_TPU_TELEMETRY=0 leg mutated the "
                            f"registry: {sorted(leaked)[:5]}")
    _config.reload()
    W.configure_async()
    W.clear_async_staleness()
    T.set_trace_origin_step(-1)
    telemetry.stop_http_server()

    rc = 0
    for f in failures:
        print(f"bench_comm --async-smoke: {f}", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "win_async_stale_edges",
        "value": n_stale_edges,
        "unit": "edges",
        "detail": {
            "healthz_async": ablock,
            "fold_restored_exactly": rc == 0,
            "zero_mutation_ok": not leaked,
        },
    }))
    return rc


def tracerec_main(args) -> int:
    """Message-level tracing's gate, structural:
      1. with the flight recorder armed and trace tags sampled at 1/2, a
         put/accumulate stream through the loopback store lands
         ``bf_win_contribution_age_seconds{src}`` and the freshest/stalest
         gauges on /metrics and the contribution_age block in /healthz;
      2. the recorder carries the event chain (enqueue ... commit) and its
         dump merges into a chrome trace with at least one flow arrow;
      3. under ``BLUEFOG_TPU_TELEMETRY=0`` the same traffic leaves the
         registry untouched."""
    import tempfile

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.tools import tracegossip
    from bluefog_tpu_torch.utils import flightrec, telemetry
    dev = args.device
    failures = []

    def drive(n_steps=4):
        rig = _Loopback(dev)
        rng = np.random.RandomState(7)
        try:
            _check(bf.win_create(torch.from_numpy(
                rng.randn(8, 6).astype(np.float32)).to(dev), "trc",
                zero_init=True), "win_create")
            rig.install([("trc", 6)])
            total = 0
            for step in range(n_steps):
                t = torch.from_numpy(np.random.RandomState(100 + step)
                                     .randn(8, 6).astype(np.float32)).to(dev)
                if step % 2:
                    bf.win_accumulate(t, "trc")
                else:
                    bf.win_put(t, "trc")
                total += 8  # the ring's 8 remote (even->odd) edges an op
                rig.wait(total, timeout=30)
        finally:
            W._store.distrib = rig.saved
            bf.win_free("trc")
            rig.close()

    with _env(BLUEFOG_TPU_TRACE_SAMPLE="2", BLUEFOG_TPU_FLIGHT_RECORDER="1",
              BLUEFOG_TPU_TELEMETRY="1",
              BLUEFOG_TPU_WIN_COALESCE_LINGER_MS="200"):
        telemetry.reset()
        flightrec.reset()
        W.clear_contribution_age()
        drive()

        # -- leg 1: age telemetry on /metrics + /healthz --------------------
        text, hz = _healthz_and_metrics(telemetry)
        for series in ("bf_win_contribution_age_seconds_bucket",
                       "bf_win_contribution_freshest_age_seconds",
                       "bf_win_contribution_stalest_age_seconds"):
            if series not in text:
                failures.append(f"missing {series} on /metrics")
        ages = hz.get("contribution_age")
        if not ages:
            failures.append("no contribution_age block in /healthz")
        n_edges = len(ages or {})

        # -- leg 2: recorder chain + merged-trace decode --------------------
        ev = flightrec.snapshot()
        etypes = set(int(e) for e in ev["etype"])
        want = {flightrec.ENQUEUE, flightrec.COMMIT}
        if not want <= etypes:
            failures.append(
                f"recorder event chain incomplete: have {sorted(etypes)}, "
                f"need at least {sorted(want)}")
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "flightrec")
            path = flightrec.dump(path=f"{prefix}.0.bin", reason="smoke")
            if path is None:
                failures.append("flight recorder dump failed")
            else:
                out, stats = tracegossip.merge_gossip(prefix)
                with open(out) as f:
                    json.load(f)  # valid chrome-trace JSON
                if stats["flows_matched"] < 1:
                    failures.append(
                        f"no flow arrows matched in the merged trace "
                        f"({stats})")

        # -- leg 3: BLUEFOG_TPU_TELEMETRY=0 zero-mutation guard -------------
        with _env(BLUEFOG_TPU_TELEMETRY="0"):
            telemetry.reset()
            W.clear_contribution_age()
            drive(n_steps=2)
            leaked = telemetry.snapshot()
        if leaked:
            failures.append(
                "BLUEFOG_TPU_TELEMETRY=0 leg mutated the registry: "
                f"{sorted(leaked)[:5]}")
    telemetry.stop_http_server()

    rc = 0
    for f in failures:
        print(f"bench_comm --tracerec-smoke: {f}", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "win_tracing_age_edges",
        "value": n_edges,
        "unit": "edges",
        "detail": {
            "contribution_age": ages,
            "rec_events": int(len(ev)),
            "etypes": sorted(etypes),
            "zero_mutation_ok": not leaked,
        },
    }))
    return rc


# ---------------------------------------------------------------------------
# The fused window step: --fused, --probe-smoke
# ---------------------------------------------------------------------------

_FUSED_KNOBS = ("BLUEFOG_TPU_WIN_NATIVE", "BLUEFOG_TPU_WIN_XLA",
                "BLUEFOG_TPU_WIN_COALESCE",
                "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS",
                "BLUEFOG_TPU_WIN_COMPRESSION", "BLUEFOG_TPU_FUSED_STEP",
                "BLUEFOG_TPU_TELEMETRY")


def _fused_env_setup():
    """Arm the fused-step rig's knobs: native window transport, put
    plans, coalescing with a long linger, no compression, telemetry on,
    ``BLUEFOG_TPU_FUSED_STEP`` unset (each leg says ``fused=``).  Only the
    port's ``BLUEFOG_TPU_*`` knobs; returns the saved values."""
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.utils import config
    prev = {v: os.environ.get(v) for v in _FUSED_KNOBS}
    os.environ.update({
        "BLUEFOG_TPU_WIN_NATIVE": "1",
        "BLUEFOG_TPU_WIN_XLA": "1",
        "BLUEFOG_TPU_WIN_COALESCE": "1",
        "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS": "500",
        "BLUEFOG_TPU_WIN_COMPRESSION": "none",
        "BLUEFOG_TPU_TELEMETRY": "1",
    })
    os.environ.pop("BLUEFOG_TPU_FUSED_STEP", None)
    config.reload()
    xlaffi._reset_for_tests()
    return prev


def _fused_env_restore(prev):
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.utils import config
    for var, val in prev.items():
        if val is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = val
    config.reload()
    xlaffi._reset_for_tests()


def _fused_rig(fused, leaves, cols, buckets, steps, warm=0, synced=False,
               lr=0.5, armed=True, device="cpu"):
    """One loopback leg of the fused-step rig: ``leaves`` parameters of
    ``(8, cols)`` float32 from ``RandomState(7)``, plain SGD at ``lr``
    under ``DistributedWinPutOptimizer(fused=fused,
    fusion_buckets=buckets)``, against the loopback store (every remote
    put crosses TCP).  Each step's gradient is ``p * 0.01 + N(0, 1) *
    1e-3`` from ``RandomState(42)``, as the JAX rig's.

    ``synced=True`` gates each combine on every remote frame of the step
    having been applied (the determinism mode of the trajectory legs);
    timing legs run ungated.  A step's time ends after
    ``torch.cuda.synchronize()`` on the card.  Returns (times_ms, final
    parameters by leaf name, fused steps)."""
    import torch

    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.optim import window_optimizers as WO

    W.win_free()
    rig = _Loopback(device)
    rs = np.random.RandomState(7)
    params = [torch.nn.Parameter(torch.from_numpy(
        rs.randn(N, cols).astype(np.float32)).to(device))
        for _ in range(leaves)]
    opt = WO.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=lr),
                                        fused=fused, fusion_buckets=buckets)
    orig_update = W._update_rows
    expect = [0]

    def synced_update(name, **kw):
        rig.wait(expect[0])
        return orig_update(name, **kw)

    try:
        rig.install([(name, sum(b - a for a, b in rngs)) for name, rngs in
                     zip(opt._names, opt._bucket_ranges)])
        if armed:
            _check(xlaffi.armed(), f"put plans disarmed: "
                                   f"{xlaffi.disarm_reason()}")
        if synced:
            W._update_rows = synced_update
        rng = np.random.RandomState(42)
        times = []
        n_windows = len(opt._names)
        for i in range(steps + warm):
            for p in params:
                noise = torch.from_numpy(
                    rng.randn(N, cols).astype(np.float32)).to(device)
                p.grad = p.detach() * 0.01 + noise * 1e-3
            # The ring's out-edges from the owned (even) ranks all target
            # odd ranks: 8 remote edges an op a window.
            expect[0] += 8 * n_windows
            _sync(device)
            t0 = time.perf_counter()
            opt.step(require_mutex=False)
            _sync(device)
            if i >= warm:
                times.append((time.perf_counter() - t0) * 1e3)
        fused_steps = (opt._fused_impl.fused_steps
                       if opt._fused_impl is not None else 0)
        return (times, {f"l{i:02d}": _to_np(p) for i, p in
                        enumerate(params)}, fused_steps)
    finally:
        W._update_rows = orig_update
        W._store.distrib = rig.saved
        opt.free()
        rig.close()


def _probe_overlap_cell(buckets: int, steps: int) -> Optional[dict]:
    """The measured-overlap summary over the fused leg's last ``steps``
    probe reconciles: the median ``bf_fused_overlap_ratio``, per-bucket
    p50/p99 put-issue latencies, and the modeled mean for the divergence
    ratio."""
    from bluefog_tpu_torch.utils import probes
    rows = probes.recent_summaries(steps)
    if not rows:
        return None
    measured = float(np.median([r["measured_overlap"] for r in rows]))
    modeled = rows[-1].get("modeled_overlap")
    cell = {
        "measured_overlap": round(measured, 4),
        "modeled_overlap": modeled,
        "overlap_divergence": (round(measured / modeled, 3)
                               if modeled else None),
        "reconciled_steps": len(rows),
        "bucket_issue_us": {},
    }
    for bi in range(buckets):
        vals = [r["bucket_issue_seconds"][bi] * 1e6 for r in rows
                if bi in r["bucket_issue_seconds"]]
        if vals:
            cell["bucket_issue_us"][str(bi)] = {
                "p50": round(float(np.percentile(vals, 50)), 1),
                "p99": round(float(np.percentile(vals, 99)), 1),
            }
    return cell


def _fused_timing_cell(steps=40, warm=6, device="cpu"):
    """The acceptance cell: eager vs fused step time on the ungated
    loopback rig at the window-heavy configuration (32 leaves x (8, 128)
    over 8 fusion buckets: 8 puts a step), with the probes' measured
    overlap.  ``compile_seconds`` is the fused programs' build and capture
    time."""
    from bluefog_tpu_torch.utils import probes, telemetry
    leaves, cols, buckets = 32, 128, 8
    te, _, _ = _fused_rig(False, leaves, cols, buckets, steps, warm,
                          device=device)
    telemetry.reset()
    probes._reset_for_tests()
    tf, _, fsteps = _fused_rig(True, leaves, cols, buckets, steps, warm,
                               device=device)
    snap = telemetry.snapshot()
    compile_s = snap.get("bf_fused_step_compile_seconds_sum", 0.0)
    e50, e99 = np.percentile(te, 50), np.percentile(te, 99)
    f50, f99 = np.percentile(tf, 50), np.percentile(tf, 99)
    cell = {
        "leaves": leaves, "cols": cols, "fusion_buckets": buckets,
        "steps": steps,
        "eager_ms_p50": round(float(e50), 3),
        "eager_ms_p99": round(float(e99), 3),
        "fused_ms_p50": round(float(f50), 3),
        "fused_ms_p99": round(float(f99), 3),
        "speedup": round(float(e50 / max(f50, 1e-9)), 3),
        "compile_seconds": round(float(compile_s), 3),
        "fused_steps": fsteps,
    }
    overlap = _probe_overlap_cell(buckets, steps)
    if overlap is not None:
        cell["overlap"] = overlap
    return cell


def _fused_report(smoke: bool, device: str = "cpu"):
    """The fused step's gate: returns (speedup|None, detail, failures).
    Callers arm the knobs first (``_fused_env_setup``).

      1. engagement: a gated loopback run where every step takes the
         fused path (``bf_fused_step_active`` 1, the program's puts
         counted), within 1e-6 of the eager run on the same gradients
         (bitwise expected: lr 2^-1 keeps the update exact);
      2. ``BLUEFOG_TPU_FUSED_STEP=0``: bitwise the eager run and inert (no
         program, no bf_fused_step_* series);
      3. fallback: with the put plans disarmed (``BLUEFOG_TPU_WIN_XLA=0``,
         which the port's fused step cannot lower across processes) a
         ``fused=True`` optimizer warns ONCE, steps eagerly, reports
         inactive and lands the same parameters bit for bit.
    Full runs add the timing cell and assert the >= 1.5x step-time win."""
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.utils import logging as bflog
    from bluefog_tpu_torch.utils import telemetry

    failures = []
    detail = {"smoke": smoke}
    steps = 10 if smoke else 50

    # -- leg 1: engagement + trajectory equivalence (gated loopback) --------
    telemetry.reset()
    _, pe, _ = _fused_rig(False, 2, 48, 2, steps, synced=True,
                          device=device)
    _, pf, fsteps = _fused_rig(True, 2, 48, 2, steps, synced=True,
                               device=device)
    snap = telemetry.snapshot()
    max_diff = max(float(np.abs(pe[k] - pf[k]).max()) for k in pe)
    bitwise = all(np.array_equal(pe[k], pf[k]) for k in pe)
    if fsteps != steps:
        failures.append(f"only {fsteps}/{steps} steps took the fused "
                        "path on the engagement leg")
    if snap.get("bf_fused_step_active") != 1.0:
        failures.append("bf_fused_step_active != 1 after a fused run")
    if not snap.get("bf_fused_step_puts_total"):
        failures.append("no in-program puts counted "
                        "(bf_fused_step_puts_total)")
    if max_diff > 1e-6:
        failures.append(f"fused-vs-eager trajectory diverged: max |d| = "
                        f"{max_diff} > 1e-6 over {steps} steps")
    detail["trajectory"] = {
        "steps": steps, "max_abs_diff": max_diff, "bitwise": bitwise,
        "puts_total": snap.get("bf_fused_step_puts_total", 0.0),
    }

    # -- leg 2: BLUEFOG_TPU_FUSED_STEP=0 is inert and bitwise eager ---------
    with _env(BLUEFOG_TPU_FUSED_STEP="0"):
        telemetry.reset()
        _, p0, _ = _fused_rig(None, 2, 48, 2, steps, synced=True,
                              device=device)
    snap0 = telemetry.snapshot()
    off_bitwise = all(np.array_equal(pe[k], p0[k]) for k in pe)
    if not off_bitwise:
        failures.append("FUSED_STEP=0 leg is not bitwise identical to "
                        "the eager oracle")
    leaked = [k for k in snap0 if k.startswith("bf_fused_step")]
    if leaked:
        failures.append(f"FUSED_STEP=0 leg registered {leaked[:3]}")
    detail["env_off"] = {"bitwise": off_bitwise, "inert": not leaked}

    # -- leg 3: one-warning fallback with the put plans disarmed ------------
    warns = []
    logger = bflog.get_logger()
    orig_warning = logger.warning
    logger.warning = lambda msg, *a, **kw: (
        warns.append(msg % a if a else msg), orig_warning(msg, *a, **kw))
    try:
        with _env(BLUEFOG_TPU_WIN_XLA="0"):
            xlaffi._reset_for_tests()
            telemetry.reset()
            _, pfb, fb_steps = _fused_rig(True, 2, 48, 2, steps,
                                          synced=True, armed=False,
                                          device=device)
            fb_active = telemetry.snapshot().get("bf_fused_step_active")
    finally:
        logger.warning = orig_warning
        xlaffi._reset_for_tests()
    fb_warns = [m for m in warns if "falling back to the eager path" in m]
    if len(fb_warns) != 1:
        failures.append(f"fallback leg warned {len(fb_warns)} times "
                        "(want exactly 1)")
    if fb_steps != 0:
        failures.append(f"fallback leg still took {fb_steps} fused steps "
                        "with the put plans disarmed")
    if fb_active != 0.0:
        failures.append("fallback leg did not report "
                        "bf_fused_step_active = 0")
    fb_bitwise = all(np.array_equal(pe[k], pfb[k]) for k in pe)
    if not fb_bitwise:
        failures.append("fallback leg's eager trajectory is not bitwise "
                        "identical to the eager oracle")
    detail["fallback"] = {"warnings": len(fb_warns),
                          "bitwise_eager": fb_bitwise}

    # -- timing cell (full runs only) ---------------------------------------
    speedup = None
    if not smoke:
        cell = _fused_timing_cell(device=device)
        detail["timing"] = cell
        speedup = cell["speedup"]
        if speedup < 1.5:
            failures.append(f"fused end-to-end step speedup {speedup}x "
                            "< 1.5x on the transport rig")
    return speedup, detail, failures


def fused_main(args) -> int:
    """``--fused-smoke`` / ``--fused``: the fused step's gate (engagement,
    trajectory, ``FUSED_STEP=0`` inertness, the one-warning fallback); the
    full run adds the timing cell and its >= 1.5x gate."""
    smoke = bool(args.fused_smoke and not args.fused)
    prev = _fused_env_setup()
    try:
        value, detail, failures = _fused_report(smoke, args.device)
    finally:
        _fused_env_restore(prev)
    rc = 0
    for f in failures:
        print(f"bench_comm --fused: {f}", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "fused_step_speedup",
        "value": value,
        "unit": "x",
        "detail": detail,
    }))
    return rc


def probe_main(args) -> int:
    """``--probe-smoke``: one fused loopback run (probes on by default)
    must land every probe surface: ``bf_fused_overlap_ratio`` in (0, 1],
    per-bucket ``bf_fused_bucket_issue_seconds`` histograms,
    ``bf_probe_events_total``, a positive divergence ratio, and, with a
    timeline armed, a trace-merge that is valid JSON carrying the
    ``fused-probe`` lanes.  Structural only."""
    import tempfile

    from bluefog_tpu_torch import tools
    from bluefog_tpu_torch.utils import probes, telemetry, timeline

    prev = _fused_env_setup()
    # Probe lanes need the Python timeline writer (lane names).
    prev["BLUEFOG_TPU_PYTHON_TIMELINE"] = os.environ.get(
        "BLUEFOG_TPU_PYTHON_TIMELINE")
    os.environ["BLUEFOG_TPU_PYTHON_TIMELINE"] = "1"
    try:
        from bluefog_tpu_torch.utils import config as _config
        _config.reload()
        failures = []
        buckets, steps = 2, 8
        tmpdir = tempfile.mkdtemp(prefix="bf-probe-smoke-")
        prefix = os.path.join(tmpdir, "tl_")
        telemetry.reset()
        probes._reset_for_tests()
        timeline.start_timeline(f"{prefix}0.json")
        try:
            _, _, fsteps = _fused_rig(True, 4, 64, buckets, steps,
                                      device=args.device)
        finally:
            timeline.stop_timeline()

        if fsteps != steps:
            failures.append(f"only {fsteps}/{steps} steps took the "
                            "fused path")
        snap = telemetry.snapshot()
        ratio = snap.get("bf_fused_overlap_ratio")
        if ratio is None or not (0.0 < ratio <= 1.0):
            failures.append(f"bf_fused_overlap_ratio {ratio!r} not in "
                            "(0, 1]")
        if not snap.get("bf_probe_events_total"):
            failures.append("bf_probe_events_total missing or zero")
        issue_counts = [k for k in snap
                        if k.startswith("bf_fused_bucket_issue_seconds"
                                        "_count")]
        if len(issue_counts) < buckets:
            failures.append("per-bucket issue histograms missing: "
                            f"{issue_counts}")
        div = snap.get("bf_fused_overlap_divergence_ratio")
        if div is None or not (div > 0):
            failures.append(f"divergence ratio {div!r} not finite/positive")
        if probes.last_summary() is None:
            failures.append("probes.last_summary() is None after a "
                            "fused run")

        merged = tools.trace_merge(prefix)
        try:
            with open(merged) as f:
                events = json.load(f)  # must be VALID json
        except ValueError as e:
            events = []
            failures.append(f"trace-merge output is not valid JSON: {e}")
        lanes = {e.get("tid") for e in events
                 if e.get("cat") == "fused-probe"}
        if not lanes:
            failures.append("no fused-probe lanes in the merged trace")

        rc = 0
        for f in failures:
            print(f"bench_comm --probe-smoke: {f}", file=sys.stderr)
            rc = 1
        print(json.dumps({
            "metric": "probe_overlap_measured",
            "value": ratio,
            "unit": "ratio",
            "detail": {
                "fused_steps": fsteps,
                "overlap": _probe_overlap_cell(buckets, steps),
                "probe_events": snap.get("bf_probe_events_total"),
                "divergence": div,
                "probe_lanes": sorted(int(t) for t in lanes
                                      if t is not None),
                "merged_events": len(events),
            },
        }))
        return rc
    finally:
        _fused_env_restore(prev)


# ---------------------------------------------------------------------------
# The put plans: --ffi
# ---------------------------------------------------------------------------

_COPY_PATHS = ("stage", "plan_stage", "enqueue")


def _ffi_one_mode(mode: str, elems: int, bursts: int, per_burst: int,
                  device: str = "cpu"):
    """Put-side microbench of one window put path through a loopback
    store: ``legacy`` (the Python coalesced sender, WIN_NATIVE=0),
    ``native`` (the host-staged put feeding the C++ sender, WIN_XLA=0) and
    ``ffi`` (the put plans, WIN_XLA=1).

    ``dispatch_us_per_row`` is the put-side host overhead: the minimum
    over bursts of a put's dispatch time with the op-boundary flush taken
    out of the clock (the queued frames ship once a burst, outside it);
    ``msgs_per_s`` is blocking puts end to end (to the last receiver
    apply).  ``host_copy_bytes`` is ``bf_win_host_copy_bytes_total`` by
    the port's paths (``stage``: the host-staged put's copy of a row,
    ``plan_stage``: a plan's pinned copy of its source rows, ``enqueue``:
    the Python sender's queue copy); ``plan_source_bytes`` is what the
    plans' source rows of every put made add up to."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.utils import telemetry

    knobs = dict(
        BLUEFOG_TPU_WIN_COALESCE="1",
        # Long linger: nothing ships inside the timed dispatch region; the
        # per-burst flush (outside the clock) puts it on the wire.
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS="2000",
        BLUEFOG_TPU_WIN_NATIVE="0" if mode == "legacy" else "1",
        BLUEFOG_TPU_WIN_XLA="1" if mode == "ffi" else "0",
        BLUEFOG_TPU_WIN_COMPRESSION="none")
    with _env(**knobs):
        xlaffi._reset_for_tests()
        telemetry.reset()
        rig = _Loopback(device, store=False)
        real_flush = W._flush_transport
        try:
            _check(bf.win_create(torch.zeros(N, elems, device=device),
                                 "ffibench", zero_init=True), "win_create")
            # Even ranks owned here; odd ranks' owner is the loopback
            # server: the ring's 8 even->odd out-edges travel the wire.
            rig.install([("ffibench", elems)])
            t = torch.from_numpy(np.random.RandomState(0).randn(
                N, elems).astype(np.float32)).to(device)
            _sync(device)
            win = W._store.get("ffibench")
            edges = W._resolve_edge_weights(None, win.out_nbrs, 1.0,
                                            ranks=win.owned)
            srcs = {s for (s, d) in edges if s % 2 == 0 and d % 2 == 1}
            W._do_put("ffibench", t, edges, False, False)  # warm the plan
            total_puts = 1
            times = []
            for _ in range(bursts):
                W._flush_transport = lambda *a, **k: None
                t0 = time.perf_counter()
                for _ in range(per_burst):
                    W._do_put("ffibench", t, edges, False, False)
                times.append((time.perf_counter() - t0) / per_burst)
                W._flush_transport = real_flush
                W.win_flush()
                total_puts += per_burst
                rig.wait(total_puts * 8, timeout=120)
            # End-to-end throughput: blocking puts, clock to the last apply.
            e2e_puts = max(per_burst // 2, 20)
            before = rig.applied
            t0 = time.perf_counter()
            for _ in range(e2e_puts):
                bf.win_put(t, "ffibench", require_mutex=False)
            rig.wait(before + e2e_puts * 8, timeout=120)
            e2e_dt = time.perf_counter() - t0
            total_puts += e2e_puts
            snap = telemetry.snapshot()
            copies = {p: snap.get(
                f'bf_win_host_copy_bytes_total{{path="{p}"}}', 0)
                for p in _COPY_PATHS}
            return {
                "mode": mode,
                "row_bytes": elems * 4,
                "dispatch_us_per_put": round(min(times) * 1e6, 2),
                "dispatch_us_per_row": round(min(times) * 1e6 / 8, 3),
                "msgs_per_s": round(e2e_puts * 8 / e2e_dt, 1),
                "ffi_engaged": snap.get("bf_win_xla_puts_total", 0) > 0,
                "host_copy_bytes": copies,
                "puts": total_puts,
                "plan_source_bytes": total_puts * len(srcs) * elems * 4,
            }
        finally:
            W._flush_transport = real_flush
            W._store.distrib = rig.saved
            bf.win_free("ffibench")
            rig.close()
            xlaffi._reset_for_tests()


def _ffi_staging_failures(res: dict, elems: int, device: str) -> list:
    """The staging-byte invariant of a plan leg.  On the CPU a plan reads
    the tensor's memory: no path counts a byte (the JAX rig's zero-copy
    check).  On the card a plan stages its source rows once a put into
    pinned memory: ``plan_stage`` equals those rows' bytes, ``stage`` and
    ``enqueue`` stay at zero."""
    copies = res["host_copy_bytes"]
    if device == "cuda":
        bad = {p: b for p, b in copies.items() if p != "plan_stage" and b}
        if copies["plan_stage"] != res["plan_source_bytes"]:
            bad["plan_stage"] = (copies["plan_stage"],
                                 res["plan_source_bytes"])
    else:
        bad = {p: b for p, b in copies.items() if b > 0}
    if bad:
        return [f"plan leg's staging copies broke the invariant on "
                f"{device}: {bad} ({elems} elems)"]
    return []


def ffi_main(args) -> int:
    """The put-plan report (``--ffi``) and its smoke."""
    smoke = args.ffi_smoke
    value, detail, failures = _ffi_report(smoke, args.device)
    rc = 0
    for f in failures:
        print(f"bench_comm --ffi: {f}", file=sys.stderr)
        rc = 1
    print(json.dumps({
        "metric": "win_put_ffi_dispatch_speedup",
        "value": value,
        "unit": "x",
        "detail": detail,
    }))
    return rc


def _ffi_report(smoke: bool, device: str = "cpu"):
    """Run the put-plan sweep; returns ``(speedup, detail, failures)``.
    Shared by ``--ffi[-smoke]`` and the full ``--transport`` run's leg."""
    bursts, per_burst = (3, 30) if smoke else (10, 100)
    sizes = [1024] if smoke else [256, 1024, 16384]  # f32 elems a row
    sweep, failures = [], []
    for elems in sizes:
        for mode in (["native", "ffi"] if smoke
                     else ["legacy", "native", "ffi"]):
            res = _ffi_one_mode(mode, elems, bursts, per_burst, device)
            sweep.append(res)
            if mode == "ffi":
                if not res["ffi_engaged"]:
                    failures.append(
                        f"put plans armed but did not engage ({elems} "
                        "elems)")
                failures.extend(_ffi_staging_failures(res, elems, device))

    def _us(mode, elems):
        for r in sweep:
            if r["mode"] == mode and r["row_bytes"] == elems * 4:
                return r["dispatch_us_per_row"]
        return None

    ratios = {}
    for elems in sizes:
        nat, ffi = _us("native", elems), _us("ffi", elems)
        if nat and ffi:
            ratios[elems * 4] = round(nat / ffi, 2)
    big_ratio = min((v for k, v in ratios.items() if k >= 4096),
                    default=None)
    if not smoke and (big_ratio is None or big_ratio < 2.0):
        failures.append(
            f"put-plan dispatch speedup {big_ratio}x < 2x vs the "
            "host-staged native path for rows >= 4 KiB")
    detail = {"smoke": smoke, "ratios_by_row_bytes": ratios,
              "sweep": sweep}
    return big_ratio, detail, failures


# ---------------------------------------------------------------------------
# The schedule pipeline: --placement, --hier, --synth, --sharded
# ---------------------------------------------------------------------------

def _build_schedule(w, optimize: bool):
    """The uncached matrix -> schedule of the JAX package's
    ``schedule._build_schedule``: the naive shift-distance rounds, then
    (``optimize``) the min-round repack."""
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    naive = S._naive_schedule(np.asarray(w, dtype=float))
    return SO.optimize_schedule(naive) if optimize else naive


def _effective_w(sched, n):
    """The effective weight matrix a compiled schedule applies (the
    repack-equivalence oracle: regrouping rounds must never change it)."""
    w = np.zeros((n, n))
    w[np.arange(n), np.arange(n)] = sched.self_scale
    for rnd in sched.rounds:
        for s, d in rnd.pairs:
            w[s, d] = rnd.send_scale[s]
    return w


def _topo_families(topo, n, seed, degree=4):
    """The four topology families every report sweeps."""
    return (
        ("ring", lambda: topo.RingGraph(n)),
        ("exp2", lambda: topo.ExponentialTwoGraph(n)),
        ("star", lambda: topo.StarGraph(n)),
        ("random_regular",
         lambda: topo.RandomRegularGraph(n, degree, seed=seed)),
    )


def placement_main(args) -> int:
    """The placement report.  Part 1 is host arithmetic: on simulated 4x8
    and 8x8 tori, for each topology family, modeled max link load under
    identity placement, the optimized permutation and the permutation with
    congestion-aware packing; random-regular must improve >= 2x on the 8x8
    torus, no family is made worse, the effective weight matrix survives
    the repack exactly.  Part 2 runs ``neighbor_allreduce`` on 8 ranks on
    ``--device`` under a fake 2x4 torus: placement alone bit for bit the
    ``BLUEFOG_TPU_PLACEMENT=0`` output, the congestion repack within
    1e-6."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule_opt as SO

    smoke = args.placement_smoke
    seed = args.seed
    tori = {}
    for dims in ((4, 8), (8, 8)):
        n = dims[0] * dims[1]
        model = PL.synthetic_torus(dims)
        per_topo = {}
        for name, make in _topo_families(topo, n, seed):
            w = topo.weight_matrix(make())
            sched = _build_schedule(w, optimize=True)
            res = PL.optimize_placement(model, sched, n,
                                        iters=args.placement_iters,
                                        seed=seed)
            packed = SO.congestion_aware_repack(
                sched, model, res.perm, budget_factor=2.0)
            pc = PL.schedule_cost(model, packed, res.perm)
            _check(np.array_equal(_effective_w(sched, n),
                                  _effective_w(packed, n)),
                   f"{name}@{dims}: repack changed the effective weight "
                   "matrix")
            _check(res.optimized_cost.max_link_load
                   <= res.identity_cost.max_link_load,
                   f"{name}@{dims}: placement made max-link-load WORSE")
            _check(pc.max_link_load <= res.optimized_cost.max_link_load,
                   f"{name}@{dims}: congestion repack made max-link-load "
                   "WORSE")
            per_topo[name] = {
                "max_link_load_naive": res.identity_cost.max_link_load,
                "max_link_load_placed": res.optimized_cost.max_link_load,
                "max_link_load_packed": pc.max_link_load,
                "hop_bytes_naive": res.identity_cost.hop_bytes,
                "hop_bytes_opt": res.optimized_cost.hop_bytes,
                "rounds": len(sched.rounds),
                "rounds_packed": len(packed.rounds),
                "identity_placement": res.is_identity,
                "improvement_ratio": round(
                    res.identity_cost.max_link_load
                    / max(pc.max_link_load, 1e-12), 3),
            }
        tori["x".join(map(str, dims))] = per_topo

    rr = tori["8x8"]["random_regular"]
    _check(rr["improvement_ratio"] >= 2.0,
           "placement+packing must cut modeled max-link-load >= 2x for "
           f"random-regular(4, 64) on the 8x8 torus, got "
           f"{rr['improvement_ratio']}x")

    # ---- Part 2: end-to-end output equivalence on 8 ranks.
    topo_fn = lambda: topo.RandomRegularGraph(8, 4, seed=1)  # noqa: E731
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 64)).astype(np.float32)).to(args.device)

    def run(**env):
        knobs = {k: None for k in ("BLUEFOG_TPU_PLACEMENT",
                                   "BLUEFOG_TPU_FAKE_TORUS",
                                   "BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET")}
        knobs.update(env)
        with _env(**knobs):
            bf.init(8, device=args.device, topology_fn=topo_fn)
            try:
                return (_to_np(bf.neighbor_allreduce(x)),
                        bf.placement_info())
            finally:
                bf.shutdown()

    out_off, info_off = run(BLUEFOG_TPU_PLACEMENT="0",
                            BLUEFOG_TPU_FAKE_TORUS="2x4")
    out_place, info_on = run(BLUEFOG_TPU_PLACEMENT="1",
                             BLUEFOG_TPU_FAKE_TORUS="2x4",
                             BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET="0")
    out_pack, _ = run(BLUEFOG_TPU_PLACEMENT="1",
                      BLUEFOG_TPU_FAKE_TORUS="2x4")
    _check(info_off is None, "PLACEMENT=0 must disable the physical model")
    _check(info_on is not None and (info_on["max_link_load_opt"]
                                    <= info_on["max_link_load_naive"]),
           f"placement info {info_on}")
    _check(np.array_equal(out_off, out_place),
           "placement permutation must be BIT-identical to enumeration "
           "order (it only moves ranks)")
    pack_diff = float(np.abs(out_off - out_pack).max())
    _check(pack_diff <= 1e-6,
           f"congestion repack drifted outputs by {pack_diff} (> 1e-6)")

    print(json.dumps({
        "metric": "gossip_placement_max_link_load_reduction_random_regular",
        "value": rr["improvement_ratio"],
        "unit": "x",
        "detail": {
            "smoke": smoke,
            "tori": tori,
            "e2e": {
                "mesh": f"8 ranks on {args.device}, fake torus 2x4",
                "bit_identical_placement_only": True,
                "packed_max_output_diff": pack_diff,
                "placement_info": info_on,
            },
        },
    }))
    return 0


def _dcn_serial_time(model, sched) -> float:
    """Modeled inter-slice serial link time of one application of
    ``sched``: over rounds, the busiest DCN link's weighted load (the ICI
    portion left out)."""
    node = np.asarray(model.device_node, np.int64)
    first_dcn = model.first_dcn_link
    total = 0.0
    for rnd in sched.rounds:
        loads = np.zeros(model.n_links)
        for s, d in rnd.pairs:
            r = model.route(int(node[s]), int(node[d]))
            np.add.at(loads, r, 1.0)
        dcn = loads[first_dcn:] * model.dcn_link_cost
        if dcn.size:
            total += float(dcn.max())
    return total


def _dcn_rows(w, n_slices) -> int:
    """Directed inter-slice edges of one application of a flat weight
    matrix over slice-contiguous rank blocks."""
    n = w.shape[0]
    slice_of = np.arange(n) // (n // n_slices)
    srcs, dsts = np.nonzero(w)
    return int(sum(1 for s, d in zip(srcs, dsts)
                   if s != d and slice_of[s] != slice_of[d]))


def _simulate_hier_consensus(ht, w_flat, steps, frac, seed, dim=8):
    """Consensus distance (mean per-rank L2 to the global mean) of flat
    gossip vs the two-level mode after ``steps`` applications, simulated on
    the per-step effective operators (the sparse outer level exchanges a
    rotating block of coordinates, as the executor)."""
    import math
    n = ht.n
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, dim))
    kk = max(1, int(math.ceil(frac * dim)))
    nblocks = max(1, -(-dim // kk))
    w_in_full = ht.inner_full_matrix()

    def dist(x):
        return float(np.linalg.norm(x - x.mean(axis=0, keepdims=True),
                                    axis=1).mean())

    xf = x0.copy()
    xh = x0.copy()
    for step in range(steps):
        xf = w_flat.T @ xf
        xh = w_in_full.T @ xh
        if ht.is_outer_step(step):
            outer_step = step // ht.outer_every
            rot = (np.arange(kk) + (outer_step % nblocks) * kk) % dim
            p = ht.outer_phase_index(step, sweep_len=nblocks)
            wo = ht.outer_full_matrix(p)
            xh[:, rot] = wo.T @ xh[:, rot]
    return dist(xf), dist(xh)


def hier_main(args) -> int:
    """The hierarchical-gossip report.  Part 1 is host arithmetic: on
    simulated multi-slice tori (2 slices of 4x8, 4 of 4x4, 64 ranks each)
    flat static Exp2 against the two-level mode (dense Exp2 inside a
    slice, one-peer Exp2 across slices at cadence 2 with sparse:0.5 and
    the cadence-corrected self weight sqrt(1/2)); per torus, per-step DCN
    wire rows AND modeled inter-slice serial time drop >= 4x at equal or
    better simulated consensus.  Part 2: the sparse codec round-trips bit
    for bit through the OP_BATCH framing, and on 8 ranks of ``--device``
    (2 machines of 4) dense cadence-1 ``hierarchical_gossip`` equals flat
    ``neighbor_allreduce`` over the product topology within 1e-6, and the
    flat op is bit for bit the same with ``BLUEFOG_TPU_HIER`` on and
    unset."""
    import math

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import transport as T

    smoke = args.hier_smoke
    outer_every = 2
    frac = 0.5
    # theta**outer_every == 0.5 an exchange: exact pairwise averaging.
    theta = math.sqrt(0.5)
    budget_steps = 24
    tori = {
        "2x(4x8)": ((4, 8), 2),
        "4x(4x4)": ((4, 4), 4),
    }
    detail = {}
    worst_bytes_ratio = None
    for tname, (dims, n_slices) in tori.items():
        model = PL.synthetic_torus(dims, n_slices=n_slices)
        n = len(model.device_node)
        ht = topo.hierarchical_two_level(
            n, n_slices, outer_every=outer_every, outer_self_weight=theta)
        w_flat = topo.weight_matrix(topo.ExponentialTwoGraph(n))
        flat_sched = _build_schedule(w_flat, optimize=True)

        flat_rows = _dcn_rows(w_flat, n_slices)
        hier_rows = ht.dcn_edges_per_outer_step() * frac / outer_every
        bytes_ratio = flat_rows / max(hier_rows, 1e-12)

        flat_dcn_serial = _dcn_serial_time(model, flat_sched)
        outer_scheds = [
            _build_schedule(ht.outer_full_matrix(p), optimize=True)
            for p in range(len(ht.outer_phases))]
        hier_dcn_serial = (sum(_dcn_serial_time(model, s)
                               for s in outer_scheds)
                           / max(len(outer_scheds), 1)
                           * frac / outer_every)
        serial_ratio = flat_dcn_serial / max(hier_dcn_serial, 1e-12)

        flat_dist, hier_dist = _simulate_hier_consensus(
            ht, w_flat, budget_steps, frac, args.seed)

        _check(bytes_ratio >= 4.0,
               f"{tname}: hierarchical DCN wire rows must drop >= 4x vs "
               f"flat exp2, got {bytes_ratio:.2f}x")
        _check(serial_ratio >= 4.0,
               f"{tname}: modeled inter-slice serial time must drop >= 4x, "
               f"got {serial_ratio:.2f}x")
        _check(hier_dist <= flat_dist + 1e-12,
               f"{tname}: hierarchical consensus distance {hier_dist:.3e} "
               f"worse than flat {flat_dist:.3e} after {budget_steps} "
               "steps")
        worst_bytes_ratio = (bytes_ratio if worst_bytes_ratio is None
                             else min(worst_bytes_ratio, bytes_ratio))
        detail[tname] = {
            "n": n, "n_slices": n_slices,
            "dcn_rows_flat_per_step": flat_rows,
            "dcn_rows_hier_per_step": hier_rows,
            "dcn_rows_reduction": round(bytes_ratio, 3),
            "dcn_serial_flat": flat_dcn_serial,
            "dcn_serial_hier": round(hier_dcn_serial, 4),
            "dcn_serial_reduction": round(serial_ratio, 3),
            "consensus_flat": flat_dist,
            "consensus_hier": hier_dist,
            "steps": budget_steps,
            "policy": {"inner": "exp2", "outer": "exp2 one-peer",
                       "outer_every": outer_every,
                       "outer_compression": f"sparse:{frac}",
                       "outer_self_weight_per_exchange": 0.5},
        }

    # ---- Part 2a: sparse wire codec through the OP_BATCH framing --------
    rng = np.random.default_rng(args.seed)
    row = rng.standard_normal(64).astype(np.float32)
    idx = np.argsort(-np.abs(row))[:16].astype(np.int32)
    idx.sort()
    payload = T.sparse_encode(row[idx], idx)
    msgs = [(T.OP_ACCUMULATE | T.OP_SPARSE_FLAG, "w", 0, 1, 1.0, 0.0,
             payload.tobytes())]
    decoded = T._decode_batch(T._encode_batch(msgs))
    d_idx, d_val = T.sparse_decode(decoded[0][6])
    _check(np.array_equal(d_idx, idx) and np.array_equal(
        d_val.view(np.int32), row[idx].view(np.int32)),
        "sparse payload must round-trip BIT-exact through OP_BATCH framing")

    # ---- Part 2b: end-to-end executor equivalence on 8 ranks -----------
    x8 = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (8, 16)).astype(np.float32)).to(args.device)
    knobs = ("BLUEFOG_TPU_HIER", "BLUEFOG_TPU_HIER_OUTER_EVERY",
             "BLUEFOG_TPU_HIER_OUTER_COMPRESSION")

    def init():
        bf.init(8, device=args.device,
                topology_fn=lambda: topo.ExponentialGraph(8), local_size=4)

    with _env(**{k: None for k in knobs}):
        init()
        out_unset = _to_np(bf.neighbor_allreduce(x8))
        bf.shutdown()
    with _env(**{**{k: None for k in knobs}, "BLUEFOG_TPU_HIER": "1"}):
        init()
        try:
            out_flat = _to_np(bf.neighbor_allreduce(x8))
            _check(np.array_equal(out_unset, out_flat),
                   "flat neighbor_allreduce must be BIT-identical with "
                   "BLUEFOG_TPU_HIER on vs unset (the knob gates only the "
                   "hierarchical path)")
            ht8 = topo.hierarchical_two_level(8, 2)
            max_diff = 0.0
            for step in range(4):
                out_h = _to_np(bf.hierarchical_gossip(x8, step))
                expect = _to_np(bf.neighbor_allreduce(
                    x8, src_weights=ht8.effective_weight_matrix(step)))
                max_diff = max(max_diff,
                               float(np.abs(out_h - expect).max()))
            _check(max_diff <= 1e-6,
                   f"dense cadence-1 hierarchical gossip drifted {max_diff}"
                   " (> 1e-6) from the flat product topology")
            e2e = {"mesh": f"8 ranks on {args.device}, 2 slices of 4",
                   "product_equivalence_max_diff": max_diff,
                   "hier_info": bf.hierarchical_gossip_info()}
        finally:
            bf.shutdown()

    print(json.dumps({
        "metric": "hier_gossip_dcn_wire_reduction_worst_torus",
        "value": round(worst_bytes_ratio, 3),
        "unit": "x",
        "detail": {"smoke": smoke, "tori": detail, "e2e": e2e},
    }))
    return 0


def synth_main(args) -> int:
    """The schedule-synthesis report.  Part 1 is host arithmetic: on
    simulated 4x8, 8x8, 2x(4x8) and 4x(4x4) tori, for each family, the
    modeled serial_link_time of the König schedule, the congestion-aware
    repack and the sketch-synthesis selection (identity placement).  The
    selection never loses to the packed schedule, beats it strictly on
    exp2@8x8, random_regular@8x8 and random_regular@4x(4x4), and where it
    ties on exp2 or random-regular the packed schedule sits on the
    busiest-link lower bound; weight matrices survive exactly and round
    budgets hold.  Part 2 runs a synthesized Exp2(32) schedule through the
    port's combine on ``--device`` (within 1e-6 of the naive schedule),
    then checks that ``BLUEFOG_TPU_SCHEDULE_SYNTH=0`` disables the
    pipeline with equivalent outputs."""
    import math as _math

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.ops import synthesis as SY
    from bluefog_tpu_torch.utils import telemetry

    smoke = args.synth_smoke
    budget = 2.0
    tori = {
        "4x8": PL.synthetic_torus((4, 8)),
        "8x8": PL.synthetic_torus((8, 8)),
        "2x(4x8)": PL.synthetic_torus((4, 8), n_slices=2),
        "4x(4x4)": PL.synthetic_torus((4, 4), n_slices=4),
    }
    detail = {}
    strict_wins = []
    for tname, model in tori.items():
        n = len(model.device_node)
        per_topo = {}
        for name, make in _topo_families(topo, n, args.seed):
            w = topo.weight_matrix(make())
            naive = _build_schedule(w, optimize=False)
            konig = SO.optimize_schedule(naive)
            packed = SO.congestion_aware_repack(
                konig, model, None, budget_factor=budget, record=False)
            chosen, ratio = SY.select_schedule(konig, packed, model, None,
                                               budget_factor=budget)
            ks = PL.schedule_cost(model, konig).serial_link_time
            ps = PL.schedule_cost(model, packed).serial_link_time
            cs = PL.schedule_cost(model, chosen).serial_link_time
            lb = SY.serial_lower_bound(model, konig)
            _check(cs <= ps + 1e-9,
                   f"{name}@{tname}: synthesis selection made serial WORSE")
            _check(np.array_equal(_effective_w(naive, n),
                                  _effective_w(chosen, n)),
                   f"{name}@{tname}: synthesis changed the weight matrix")
            _check(len(chosen.rounds) <= max(
                len(konig.rounds),
                _math.ceil(budget * SO.min_rounds(konig))),
                f"{name}@{tname}: synthesis exceeded the round budget")
            if name in ("exp2", "random_regular"):
                if cs < ps - 1e-9:
                    strict_wins.append(f"{name}@{tname}")
                else:
                    # No win allowed ONLY at provable optimality.
                    _check(ps <= lb + 1e-9,
                           f"{name}@{tname}: synthesis tied the packed "
                           f"schedule at {ps} > lower bound {lb}")
            per_topo[name] = {
                "serial_konig": ks, "serial_packed": ps,
                "serial_synth": cs, "lower_bound": lb,
                "rounds_synth": len(chosen.rounds),
                "provenance": S.schedule_provenance(chosen),
                "improvement_ratio": round(ps / max(cs, 1e-12), 3),
            }
        detail[tname] = per_topo
    for required in ("exp2@8x8", "random_regular@8x8",
                     "random_regular@4x(4x4)"):
        _check(required in strict_wins,
               f"synthesis must beat congestion_aware_repack strictly on "
               f"{required}; wins: {strict_wins}")

    # ---- Part 2a: a synthesized schedule through the port's combine.
    n = 32
    model = PL.synthetic_torus((4, 8))
    w = topo.weight_matrix(topo.ExponentialTwoGraph(n))
    naive = _build_schedule(w, optimize=False)
    konig = SO.optimize_schedule(naive)
    packed = SO.congestion_aware_repack(konig, model, None,
                                        budget_factor=budget, record=False)
    chosen, ratio = SY.select_schedule(konig, packed, model, None,
                                       budget_factor=budget)
    _check(S.schedule_provenance(chosen).startswith("synthesized"),
           "e2e leg expected a synthesized win for exp2(32) on 4x8")
    x = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (n, 256)).astype(np.float32)).to(args.device)
    diff = float(np.abs(_to_np(C.neighbor_allreduce(x, naive))
                        - _to_np(C.neighbor_allreduce(x, chosen))).max())
    _check(diff <= 1e-6,
           f"synthesized schedule drifted outputs by {diff} (> 1e-6)")
    e2e = {"synth_vs_naive_max_diff": diff,
           "synth_provenance": S.schedule_provenance(chosen),
           "synth_serial": PL.schedule_cost(model, chosen).serial_link_time,
           "packed_serial": PL.schedule_cost(model, packed).serial_link_time}

    # ---- Part 2b: the env hatch disables the synthesis pipeline.
    topo_fn = lambda: topo.RandomRegularGraph(8, 4, seed=1)  # noqa: E731
    x8 = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (8, 64)).astype(np.float32)).to(args.device)

    def run_ctx(**env):
        knobs = {k: None for k in ("BLUEFOG_TPU_SCHEDULE_SYNTH",
                                   "BLUEFOG_TPU_FAKE_TORUS",
                                   "BLUEFOG_TPU_PLACEMENT")}
        knobs.update(env)
        with _env(**knobs):
            bf.init(8, device=args.device, topology_fn=topo_fn)
            try:
                out = _to_np(bf.neighbor_allreduce(x8))
                info = bf.synthesis_info()
                snap = telemetry.snapshot() if telemetry.enabled() else {}
            finally:
                bf.shutdown()
        return out, info, snap

    out_off, info_off, snap_off = run_ctx(
        BLUEFOG_TPU_SCHEDULE_SYNTH="0", BLUEFOG_TPU_FAKE_TORUS="2x4")
    out_on, info_on, snap_on = run_ctx(
        BLUEFOG_TPU_SCHEDULE_SYNTH="1", BLUEFOG_TPU_FAKE_TORUS="2x4")
    _check(info_off is None,
           "SCHEDULE_SYNTH=0 must disable the synthesis pipeline entirely")
    _check("bf_schedule_synth_improvement_ratio" not in snap_off,
           "SCHEDULE_SYNTH=0 published the synthesis gauge")
    _check(info_on is not None and info_on["improvement_ratio"] >= 1.0,
           f"synthesis info {info_on}")
    _check(snap_on.get("bf_schedule_synth_improvement_ratio", 0) >= 1.0,
           "bf_schedule_synth_improvement_ratio < 1")
    hatch_diff = float(np.abs(out_off - out_on).max())
    _check(hatch_diff <= 1e-6,
           f"env hatch outputs drifted by {hatch_diff} (> 1e-6)")
    e2e["hatch_max_diff"] = hatch_diff

    rr = detail["8x8"]["random_regular"]
    print(json.dumps({
        "metric": "gossip_schedule_synth_serial_time_reduction_rr_8x8",
        "value": rr["improvement_ratio"],
        "unit": "x",
        "detail": {
            "smoke": smoke,
            "strict_wins": strict_wins,
            "tori": detail,
            "e2e": e2e,
        },
    }))
    return 0


def sharded_main(args) -> int:
    """The sharded-gossip report.  Part 1 is host arithmetic: on a
    simulated 16-rank MoE mesh (4 replica groups of 4) trees whose
    replicated byte fraction is 25/50/75%; through the ``ShardPlan``
    planner and the per-group schedules, per-step DCN bytes scale with the
    replicated fraction only.  Part 2 runs the collective optimizer on 8
    ranks of ``--device`` (2 replica groups of 4): the replicated leaf
    equals the dense ``W^T x`` oracle within 1e-6, each rank's own shard
    slice the per-group oracle with its ghost region untouched, the
    ``bf_comm_level_bytes_total{shard=...}`` split bills exactly the
    replicated rows to the DCN, and ``BLUEFOG_TPU_SHARDED_GOSSIP=0`` or a
    fully replicated tree is bit for bit the no-spec path."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import sharded as SH
    from bluefog_tpu_torch.utils import telemetry

    smoke = args.sharded_smoke

    # ---- Part 1: planner byte model on a simulated 16-rank MoE mesh -----
    n, n_shards = 16, 4
    groups = SH.default_groups(n, n_shards)
    sched = S.compile_static(topo.ExponentialTwoGraph(n))
    total_cols = 4096  # floats a rank across the whole tree
    detail = {}
    baseline_dcn = None  # all-replicated DCN bytes a step
    for frac in (1.0, 0.75, 0.5, 0.25):
        rep_cols = int(total_cols * frac)
        sh_cols = (total_cols - rep_cols) // n_shards
        tree = {"router": np.zeros((n, rep_cols), np.float32)}
        specs = {"router": None}
        if sh_cols:
            tree["experts"] = np.zeros((n, n_shards, sh_cols), np.float32)
            specs["experts"] = ("ep", None)
        plan = SH.build_plan(tree, specs, n=n, n_shards=n_shards,
                             groups=groups)
        _check(abs(plan.replicated_fraction - frac) < 1e-9,
               f"{frac} {plan.replicated_fraction}")
        rep_ici, rep_dcn = SH.edge_level_counts(plan.coords, sched)
        rep_row = plan.rep_bytes / n
        sh_row = plan.sh_bytes / n / n_shards if plan.any_sharded else 0.0
        dcn_bytes = rep_row * rep_dcn  # sharded slices: in-group only
        gsched, per_group = SH.compile_group_schedules(n, groups)
        g_ici, g_dcn = SH.edge_level_counts(plan.coords, gsched)
        _check(g_dcn == 0.0,
               "per-group schedules must never emit a cross-group (DCN) "
               f"edge, got {g_dcn}")
        if frac == 1.0:
            baseline_dcn = dcn_bytes
        else:
            ratio = dcn_bytes / baseline_dcn
            _check(abs(ratio - frac) < 1e-9,
                   f"DCN bytes must scale with the replicated fraction: "
                   f"frac={frac} ratio={ratio}")
        detail[f"{int(frac * 100)}%"] = {
            "replicated_fraction": frac,
            "rep_row_bytes": rep_row,
            "sharded_row_bytes": sh_row,
            "dcn_bytes_per_step": dcn_bytes,
            "dcn_vs_all_replicated": round(dcn_bytes / baseline_dcn, 4),
            "ici_bytes_per_step": rep_row * rep_ici + sh_row * g_ici,
            "group_rounds": [len(sub.rounds) for _g, sub in per_group],
            "merged_rounds": len(gsched.rounds),
        }

    # ---- Part 2: executor leg on 8 ranks --------------------------------
    rng = np.random.default_rng(args.seed)
    steps = 2 if smoke else 4
    dev = args.device
    init = {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "b": rng.standard_normal((8, 4, 8)).astype(np.float32)}
    keys = sorted(init)
    specs = {"a": (), "b": (None, "tp")}

    def drive(shard_specs, num_shards):
        ps = [torch.from_numpy(init[k].copy()).to(dev) for k in keys]
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt = bf.optim.DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD(ps, lr=0.0),
            shard_specs=(None if shard_specs is None
                         else [shard_specs[k] for k in keys]),
            num_shards=num_shards)
        for _ in range(steps):
            opt.step()
        return {k: _to_np(p) for k, p in zip(keys, ps)}

    with _env(BLUEFOG_TPU_TELEMETRY="1", BLUEFOG_TPU_SHARDED_GOSSIP=None):
        bf.init(8, device=dev)
        try:
            n8 = bf.size()
            telemetry.reset()
            out = drive(specs, 2)
            snap = telemetry.snapshot()

            # Dense oracle for the replicated leaf: one step is W^T x.
            W = topo.weight_matrix(bf.load_topology())
            exp_a = init["a"].astype(np.float64)
            for _ in range(steps):
                exp_a = W.T @ exp_a
            rep_err = float(np.abs(out["a"] - exp_a).max())
            _check(rep_err <= 1e-6, f"replicated leaf: {rep_err}")

            # Per-group oracle for each rank's own slice; ghost untouched.
            plan = SH.build_plan(init, specs, n=n8, n_shards=2)
            _g, per = SH.compile_group_schedules(n8, plan.groups)
            Wg = np.zeros((n8, n8))
            for g, _sub in per:
                sw = topo.weight_matrix(topo.ExponentialTwoGraph(len(g)))
                for i, gi in enumerate(g):
                    for j, gj in enumerate(g):
                        Wg[gi, gj] = sw[i, j]
            b0, b1 = init["b"], out["b"]
            chunk = b0.shape[-1] // 2
            sh_err = 0.0
            for r in range(n8):
                c = plan.coords[r]
                exp = b0[:, :, c * chunk:(c + 1) * chunk].astype(np.float64)
                for _ in range(steps):
                    exp = np.einsum("sr,s...->r...", Wg, exp)
                got = b1[r, :, c * chunk:(c + 1) * chunk]
                sh_err = max(sh_err, float(np.abs(got - exp[r]).max()))
                ghost = b1[r, :, (1 - c) * chunk:(2 - c) * chunk]
                _check(np.array_equal(
                    ghost, b0[r, :, (1 - c) * chunk:(2 - c) * chunk]),
                    f"rank {r}: ghost region must be bit-untouched")
            _check(sh_err <= 1e-6, f"sharded slices: {sh_err}")

            # Telemetry: the DCN carries exactly the replicated rows.
            sched8 = S.compile_static(bf.load_topology())
            ici8, dcn8 = SH.edge_level_counts(plan.coords, sched8)
            rep_row8 = plan.rep_bytes / n8
            key_dcn = ('bf_comm_level_bytes_total'
                       '{level="dcn",shard="replicated"}')
            got_dcn = snap.get(key_dcn, 0.0)
            want_dcn = rep_row8 * dcn8 * steps
            _check(abs(got_dcn - want_dcn) < 1e-6, f"{got_dcn} {want_dcn}")
            _check(not any('shard="sharded"' in k and '"dcn"' in k
                           for k in snap),
                   "sharded bytes must never be billed to the DCN")

            # Bitwise hatches: knob off, and a fully replicated tree.
            base = drive(None, None)
            with _env(BLUEFOG_TPU_SHARDED_GOSSIP="0"):
                off = drive(specs, 2)
            allrep = drive({"a": (), "b": ()}, 2)
            for k in base:
                _check(np.array_equal(off[k], base[k]),
                       f"{k}: BLUEFOG_TPU_SHARDED_GOSSIP=0 must be "
                       "BIT-identical to the no-spec path")
                _check(np.array_equal(allrep[k], base[k]),
                       f"{k}: a fully replicated tree must be "
                       "BIT-identical to the no-spec path")
            e2e = {
                "mesh": f"{n8} ranks on {dev}, 2 replica groups of 4",
                "steps": steps,
                "replicated_oracle_max_err": rep_err,
                "sharded_oracle_max_err": sh_err,
                "dcn_bytes": got_dcn,
                "dcn_bytes_expected": want_dcn,
                "replicated_fraction": plan.replicated_fraction,
            }
        finally:
            bf.shutdown()

    half = detail["50%"]
    print(json.dumps({
        "metric": "sharded_gossip_dcn_bytes_fraction_at_50pct",
        "value": half["dcn_vs_all_replicated"],
        "unit": "x",
        "detail": {"smoke": smoke, "fractions": detail, "e2e": e2e},
    }))
    return 0


# ---------------------------------------------------------------------------
# The schedule bench (no mode flag)
# ---------------------------------------------------------------------------

def _time_ms(fn, iters: int, device: str) -> float:
    """Milliseconds of ``iters`` calls of ``fn`` after one warm call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return float(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


def schedule_main(args) -> int:
    """The schedule bench: for each topology family over ``--n`` ranks,
    the naive and the min-round schedules' rounds and edges (the same
    edge set, no more rounds, König's bound), the outputs within 1e-6,
    and ms an op of ``--reps`` chained applications (the JAX bench's
    ``main``)."""
    import torch

    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.utils import telemetry

    if args.smoke:
        args.n = args.n or 8
        args.payload = min(args.payload, 1024)
        args.iters = min(args.iters, 5)
        args.reps = min(args.reps, 4)
    n = args.n or 32
    if n < 4:
        print(f"bench_comm: needs >= 4 ranks to build its topologies, got "
              f"--n {n}", file=sys.stderr)
        return 2
    # Random-regular needs n * degree even: drop the clamped degree by one
    # for parity, and fail with a usable message if that empties it.
    rr_degree = min(args.degree, n - 1)
    if (n * rr_degree) % 2:
        rr_degree -= 1
    if rr_degree < 1:
        raise SystemExit(
            f"bench_comm: no valid random-regular degree at n={n} with "
            f"--degree {args.degree} (n * degree must be even and "
            "0 < degree < n); use an even --n or a larger --degree")
    topologies = dict(_topo_families(topo, n, args.seed, degree=rr_degree))

    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.standard_normal((n, args.payload)).astype(
        np.float32)).to(args.device)

    def run_op(sched):
        def body():
            out = x
            for _ in range(args.reps):
                out = C.neighbor_allreduce(out, sched)
            return out
        return body

    detail = {}
    for name, make in topologies.items():
        w = topo.weight_matrix(make())
        naive = _build_schedule(w, optimize=False)
        opt = _build_schedule(w, optimize=True)
        r0, e0 = C.schedule_wire_stats(naive)[:2]
        r1, e1 = C.schedule_wire_stats(opt)[:2]
        _check(e0 == e1, f"{name}: repack changed the edge set ({e0} -> "
                         f"{e1})")
        _check(r1 <= r0, f"{name}: repack emitted MORE rounds ({r0} -> "
                         f"{r1})")
        _check(r1 == SO.min_rounds(opt),
               f"{name}: {r1} rounds, König bound {SO.min_rounds(opt)}")
        f_naive, f_opt = run_op(naive), run_op(opt)
        max_diff = float(np.abs(_to_np(f_naive())
                                - _to_np(f_opt())).max())
        _check(max_diff <= 1e-6,
               f"{name}: outputs differ by {max_diff} (> 1e-6)")
        per_op = args.iters * args.reps
        detail[name] = {
            "rounds_naive": r0, "rounds_optimized": r1,
            "edges": e0,
            "round_reduction": round(r0 / max(r1, 1), 3),
            "ms_per_op_naive": round(
                _time_ms(f_naive, args.iters, args.device) / per_op, 4),
            "ms_per_op_optimized": round(
                _time_ms(f_opt, args.iters, args.device) / per_op, 4),
            "max_output_diff": max_diff,
        }

    rr = detail["random_regular"]
    snap = telemetry.snapshot() if telemetry.enabled() else {}
    print(json.dumps({
        "metric": "gossip_schedule_opt_round_reduction_random_regular",
        "value": rr["round_reduction"],
        "unit": "x",
        "detail": {
            "n": n,
            "payload_f32": args.payload,
            "backend": args.device,
            "per_topology": detail,
            "schedule_opt_rounds_saved_total": snap.get(
                "bf_schedule_opt_rounds_saved_total", 0),
        },
    }))
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    args.device = _resolve_device(args.device)
    if args.ffi or args.ffi_smoke:
        return ffi_main(args)
    if args.fused or args.fused_smoke:
        return fused_main(args)
    if args.probe_smoke:
        return probe_main(args)
    if args.async_smoke:
        return async_main(args)
    if args.tracerec_smoke:
        return tracerec_main(args)
    if args.stripe_smoke:
        return stripe_main(args)
    if args.transport or args.transport_smoke:
        return transport_main(args)
    if args.placement or args.placement_smoke:
        return placement_main(args)
    if args.synth or args.synth_smoke:
        return synth_main(args)
    if args.hier or args.hier_smoke:
        return hier_main(args)
    if args.sharded or args.sharded_smoke:
        return sharded_main(args)
    return schedule_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
