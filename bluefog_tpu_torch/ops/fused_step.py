"""The fused window step: the optimizer update, each bucket's flat and its
put plan as one captured program.

The port of ``bluefog_tpu/ops/fused_step.py``.  The eager window step
(``optim/window_optimizers.py``) crosses the host at every stage: the
base update, a put a window on the pool (staging each remote row, a send
an edge), the drain, the rebuild.  Under ``BLUEFOG_TPU_FUSED_STEP=1`` (or
``fused=True``) the win_put and push-sum families run instead:

* **the program**, built once a cache key and replayed every step: the
  base optimizer's ``step()`` over the rank-major parameters, each fusion
  bucket's flat (a view of the parameters' rows, or their concatenation),
  and, for a bucket with remote edges, the device-to-host copy of its
  owned rows into the plan's pinned buffer (``ops/xlaffi.py``) followed by
  a host function that runs the bucket's put plan
  (``ops/hostfn.py``: ``bf_xla_plan_run`` into the native sender's arenas,
  the counterpart of the JAX package's ``bf_xla_win_put_pass``), its
  return code written to a pinned status slot.  The copies run on a side
  stream, so the copy of a bucket overlaps the plan run of the one before.
  On a card the program is a CUDA graph (``torch.cuda.CUDAGraph``); on the
  CPU the same ops run in the same order, uncaptured, the plans reading
  the tensor's own memory;
* **the host finish**, as the JAX package's: once the program's event has
  fired the statuses are read (a failed put raises, as ``_check_statuses``
  does), then the local edges' staging writes, one scoped flush, the
  self-publish (``window._fused_host_finish``), the push-sum fence, the
  drain (``win_update`` or the collect) and the rebuild of the parameters.

The parameters and the window state come out bit for bit those of the
eager step: the same update kernels, the same frames (the plan path is
held to the host-staged one), the same host arithmetic.

**Hazards of the capture, and what settles them.**

* The first step of a key runs the program uncaptured: SGD's momentum
  buffer (any base's lazily made state) and the library handles come into
  being then, and every step, the first too, gives the eager bits.  The
  capture happens at the key's second step; it records and does not run,
  and the replay that follows runs the step.
* Hyperparameters (``lr``, momentum, ...) are baked into the captured
  kernels: they are part of the key.  A base whose update keeps host
  state the graph cannot replay (``torch.optim.Adam`` without
  ``capturable=True``: its step count is a CPU tensor) is not fused.
* The graph reads fixed addresses: the parameters (keyed by their
  pointers), the optimizer state (its pointers checked at every replay; a
  change re-captures), the bucket flats and pinned buffers (made before the
  capture and kept by the program) and the gradients, which
  ``zero_grad(set_to_none=True)`` moves: a step whose ``.grad`` lies
  elsewhere is copied into the captured one first.  A new shape, topology
  generation (``set_topology``), window set or codec is a new key.
* With ``require_mutex`` every remote edge's mutex is held across the
  program in sorted ``dst`` order (the JAX package's superset hold).
* A host function blocks its stream while it encodes: the local-edge
  staging, the flush, the self-publish and the fence stay on the host
  between programs, as in the JAX package.
* Under churn (``BLUEFOG_TPU_CHURN``) the key carries the membership
  epoch: after a committed change the optimizer drops its programs, the
  next step builds at the new epoch and the one after captures.  A send
  to a peer that died before the gang voted it out fails its status or
  its flush; the step then combines what arrived (``window.
  churn_tolerates``), and a remote mutex that does not answer leaves this
  step to the eager path before anything is dispatched.
* Probes (``utils/probes.py``) are host functions too (grad-ready, each
  bucket's put chain before and after, step end), so the program's seams
  and the host's drain seams land in one ring on one steady clock.

Telemetry: ``bf_fused_step_active`` (gauge), ``bf_fused_step_compile_seconds``
(the capture, or the CPU build), ``bf_fused_step_puts_total`` (plan runs)
and ``bf_fused_step_overlap_seconds{bucket}`` (from the probes).  Nothing
here runs with the knob off.

Not lowered, each warning once and running the eager step: per-parameter
windows (``fuse=False``), sharded gossip, the async mode, non-float32
parameters and a base optimizer the graph cannot replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.ops import xlaffi
from bluefog_tpu_torch.utils import probes as _probes

__all__ = ["FusedStep", "FusedFallback", "compile_fused_schedule",
           "modeled_overlap"]

# Programs cached an optimizer: a topology flip A -> B -> A hits, a sweep
# does not grow without bound.
_MAX_PROGRAMS = 4

# A status slot's value before its plan ran.
_NOT_RUN = -99


class FusedFallback(Exception):
    """This step cannot take the fused path: run the eager step.  Raised
    for configuration reasons only, before anything is dispatched."""


class _Program:
    """One fused step program and what its dispatch needs."""

    __slots__ = ("key", "names", "plans", "tx", "edges", "remote_procs",
                 "accumulate", "probes", "statuses", "status_ptr",
                 "graph", "payloads", "grads", "state_sig", "runs",
                 "host_args")

    def __init__(self):
        self.graph = None
        self.payloads = None
        self.grads = None
        self.state_sig = None
        self.runs = 0
        self.host_args: List[int] = []

    def release(self) -> None:
        """Drop the graph, then the host functions' records it held."""
        self.graph = None
        from bluefog_tpu_torch.ops import hostfn
        for a in self.host_args:
            hostfn.free(a)
        self.host_args = []


def _edge_token(dst_weights):
    """Hashable identity of a ``dst_weights`` argument."""
    if dst_weights is None:
        return None
    if isinstance(dst_weights, dict):
        return tuple(sorted((k, float(v)) for k, v in dst_weights.items()))
    arr = np.asarray(dst_weights, dtype=float)
    return ("matrix", arr.shape, arr.tobytes())


def _self_weight_token(self_weight):
    if self_weight is None:
        return None
    arr = np.asarray(self_weight, dtype=float)
    return (arr.shape, arr.tobytes())


def compile_fused_schedule(edges: Dict[tuple, float], n: int):
    """A resolved ``{(src, dst): w}`` edge set as a ``CompiledSchedule``
    stamped ``lowering="fused"``: the schedule layer's form of the program's
    pushes, read back through ``window_plan()``."""
    from bluefog_tpu_torch.ops import schedule as S
    m = np.zeros((n, n), dtype=float)
    for (src, dst), w in edges.items():
        if src != dst:
            m[src, dst] = float(w)
    sched = S.compile_static(basics.load_topology(), src_weights=m)
    return S.as_compiled(sched, lowering="fused")


def modeled_overlap(bucket_bytes: List[int]) -> List[dict]:
    """The static overlap preview of ``k`` buckets (no execution): the
    update costs one unit spread evenly over the buckets; bucket ``i``'s
    put issues once its flat is ready (``ready_at = (i+1)/k`` of the
    compute) and its wire time can hide behind the remaining
    ``(k-i-1)/k`` (``overlap``)."""
    k = len(bucket_bytes)
    return [{"bucket": i, "bytes": int(nb),
             "ready_at": (i + 1) / k if k else 1.0,
             "overlap": (k - i - 1) / k if k else 0.0}
            for i, nb in enumerate(bucket_bytes)]


def _group_signature(opt) -> tuple:
    """The base optimizer's hyperparameters, which a capture bakes in."""
    out = []
    for g in opt.base.param_groups:
        out.append(tuple(sorted(
            (k, v if isinstance(v, (bool, int, float, str, type(None)))
             else repr(v))
            for k, v in g.items() if k != "params")))
    return tuple(out)


def _state_signature(opt) -> tuple:
    """Where the base optimizer's state tensors live (a replay reads them
    there)."""
    sig = []
    for p in opt.params:
        st = opt.base.state.get(p, {})
        sig.append(tuple(sorted((k, v.data_ptr()) for k, v in st.items()
                                if torch.is_tensor(v))))
    return tuple(sig)


class FusedStep:
    """The fused-step compiler and dispatcher of one window optimizer: up
    to ``_MAX_PROGRAMS`` programs, keyed, replayed across steps."""

    def __init__(self, opt):
        self.opt = opt
        self._programs: Dict[tuple, _Program] = {}
        self.builds = 0          # programs (re)built
        self.captures = 0        # CUDA graph captures
        self.replays = 0         # CUDA graph replays
        self.fused_steps = 0     # steps the fused path served
        self.capture_seconds = 0.0
        self._warned: set = set()
        self._copy_stream = None     # the bucket copies' side stream
        self.last_statuses: List[int] = []   # the last step's plan runs
        self.last_program_ms = None  # its program's time on the card

    # -- eligibility -------------------------------------------------------

    def _fallback(self, reason: str):
        from bluefog_tpu_torch.utils import telemetry
        telemetry.set_gauge("bf_fused_step_active", 0.0)
        if reason not in self._warned:
            self._warned.add(reason)
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning(
                "fused step: falling back to the eager path (%s); set "
                "BLUEFOG_TPU_FUSED_STEP=0 to silence", reason)
        raise FusedFallback(reason)

    def _check_eligible(self):
        opt = self.opt
        if not opt.fuse:
            self._fallback("fuse=False (per-parameter windows) is not "
                           "lowered")
        if opt._shard_plan is not None:
            self._fallback("sharded gossip is not lowered by the port's "
                           "fused step")
        if opt._async_on:
            self._fallback("async mode (BLUEFOG_TPU_ASYNC) keeps the eager "
                           "barrier-free step")
        ps = opt.params
        if not all(p.dtype == torch.float32 for p in ps):
            self._fallback("non-float32 parameters")
        if ps[0].device.type == "cuda" and any(
                g.get("capturable") is False for g in opt.base.param_groups):
            self._fallback(f"{type(opt.base).__name__} without "
                           "capturable=True keeps host state a CUDA graph "
                           "cannot replay")
        d = W._store.distrib
        if d is not None:
            if not xlaffi.armed():
                self._fallback("put-plan path disarmed: %s"
                               % (xlaffi.disarm_reason() or "unknown"))
            if getattr(d.transport, "_tx", None) is None:
                self._fallback("window transport is not native "
                               "(BLUEFOG_TPU_WIN_NATIVE=0?)")
        return d

    # -- program build -----------------------------------------------------

    def _key(self, family, dst_weights, self_weight, require_mutex, d):
        from bluefog_tpu_torch.utils import config, telemetry
        opt = self.opt
        view = getattr(opt, "membership_change", None)
        cfg = config.get()
        return (
            family,
            tuple((tuple(p.shape), str(p.dtype), str(p.device),
                   p.data_ptr()) for p in opt.params),
            tuple(opt._names), basics._ctx.topology_version,
            (view.epoch if view is not None else -1),
            _edge_token(dst_weights), _self_weight_token(self_weight),
            bool(require_mutex), cfg.win_compression,
            W._store.associated_p_enabled,
            (getattr(d.transport, "_tx", None) if d is not None else None),
            telemetry.enabled(), bool(cfg.probe),
            _group_signature(opt),
        )

    def _resolve_edges(self, dst_weights):
        """The schedule-layer pass: the caller's weights resolved as the
        eager put resolves them, compiled into the ``lowering="fused"``
        artifact, and the program's pushes read off ``window_plan()``."""
        win = W._store.get(self.opt._names[0])
        resolved = W._resolve_edge_weights(dst_weights, win.out_nbrs, 1.0,
                                           ranks=win.owned)
        sched = compile_fused_schedule(resolved, win.n)
        plan = sched.window_plan()
        return {(src, dst): w for src in win.owned if W._owns(src)
                for dst, w in plan[src]}

    def _build(self, family, *, dst_weights, require_mutex, d, key):
        from bluefog_tpu_torch.utils import config
        opt = self.opt
        prog = _Program()
        prog.key = key
        prog.accumulate = family == "pushsum"
        prog.names = list(opt._names)
        prog.edges = self._resolve_edges(dst_weights)
        prog.remote_procs = ({d.rank_owner[t] for (s, t) in prog.edges
                              if not W._owns(t)} if d is not None else set())
        prog.tx = getattr(d.transport, "_tx", None) if d is not None \
            else None
        op = W.OP_ACCUMULATE if prog.accumulate else W.OP_PUT
        remote_edges = tuple(((s, t), w) for (s, t), w in prog.edges.items()
                             if not W._owns(t))
        on_card = opt.params[0].device.type == "cuda"
        prog.plans = []
        for name in prog.names:
            if d is None or not remote_edges:
                prog.plans.append(None)
                continue
            plan = xlaffi.prepare_put(d, W._store.get(name), name, op,
                                      remote_edges, per_edge=False,
                                      compact=on_card)
            if plan is None:
                self._fallback(f"native plan build failed for {name!r}")
            if on_card:
                xlaffi.pinned_rows(plan)
            prog.plans.append(plan)
        n_groups = sum(len(p.groups) for p in prog.plans if p is not None)
        if on_card and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(opt.params[0].device)
        prog.statuses = torch.full((n_groups,), _NOT_RUN, dtype=torch.int32,
                                   pin_memory=on_card)
        prog.status_ptr = prog.statuses.data_ptr()
        prog.probes = bool(config.get().probe) and _probes.arm()
        self.builds += 1
        return prog

    # -- the program -------------------------------------------------------

    def _body(self, prog: _Program, on_card: bool,
              keep: List[int]) -> List[torch.Tensor]:
        """The program's ops, in order: run directly (the CPU, or a card's
        first step of a key) or under capture.  The host functions'
        records go to ``keep``.  Returns the bucket flats."""
        opt = self.opt
        if on_card:
            from bluefog_tpu_torch.ops import hostfn

            def note(pid):
                if prog.probes:
                    keep.append(hostfn.enqueue_probe(pid))
        else:
            def note(pid):
                if prog.probes:
                    _probes.note(pid)
        note(_probes.GRAD_READY)
        opt.base.step()
        payloads = opt._payloads()
        main = torch.cuda.current_stream() if on_card else None
        side = self._copy_stream if on_card and any(prog.plans) else None
        if side is not None:
            side.wait_stream(main)
        slot = 0
        for bi, (plan, payload) in enumerate(zip(prog.plans, payloads)):
            note(_probes.BUCKET_PRE + bi)
            if plan is not None:
                win = W._store.get(prog.names[bi])
                if on_card:
                    with torch.cuda.stream(side):
                        xlaffi.copy_rows_async(plan, payload, win)
                    main.wait_stream(side)
                    buf = plan.pinned
                    for pid, _grp in plan.groups:
                        keep.append(hostfn.enqueue_plan_run(
                            pid, prog.tx, buf.data_ptr(), buf.numel(),
                            prog.status_ptr + 4 * slot))
                        slot += 1
                else:
                    t = payload.contiguous()
                    for pid, _grp in plan.groups:
                        prog.statuses[slot] = int(
                            xlaffi._lib().bf_xla_plan_run(
                                pid, prog.tx, t.data_ptr(), t.numel()))
                        slot += 1
            note(_probes.BUCKET_POST + bi)
        note(_probes.STEP_END)
        if side is not None:
            main.wait_stream(side)
        return payloads

    def _run(self, prog: _Program,
             transient: List[int]) -> List[torch.Tensor]:
        """One run of the program: replayed, captured then replayed, or
        direct (module docstring); a direct run on a card leaves its host
        functions' records in ``transient``.  Returns the bucket flats."""
        from bluefog_tpu_torch.utils import telemetry
        opt = self.opt
        on_card = opt.params[0].device.type == "cuda"
        if not on_card:
            if prog.runs == 0:
                t0 = time.monotonic()
            out = self._body(prog, False, transient)
            if prog.runs == 0:
                telemetry.observe("bf_fused_step_compile_seconds",
                                  time.monotonic() - t0)
            prog.runs += 1
            return out
        if prog.graph is not None and prog.state_sig != _state_signature(opt):
            prog.release()           # the state moved: capture anew
        if prog.graph is None and prog.runs > 0:
            self._capture(prog)
        if prog.graph is None:
            out = self._body(prog, True, transient)
        else:
            for p, g in zip(opt.params, prog.grads):
                if p.grad is not None and p.grad.data_ptr() != g.data_ptr():
                    g.copy_(p.grad)
            prog.graph.replay()
            self.replays += 1
            out = prog.payloads
        prog.runs += 1
        return out

    def _capture(self, prog: _Program) -> None:
        from bluefog_tpu_torch.utils import telemetry
        opt = self.opt
        t0 = time.monotonic()
        prog.grads = [p.grad for p in opt.params]
        if any(g is None for g in prog.grads):
            raise FusedFallback("a parameter has no gradient")
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            payloads = self._body(prog, True, prog.host_args)
        prog.graph = g
        prog.payloads = payloads
        prog.state_sig = _state_signature(opt)
        dt = time.monotonic() - t0
        self.capture_seconds += dt
        self.captures += 1
        telemetry.observe("bf_fused_step_compile_seconds", dt)

    # -- dispatch ----------------------------------------------------------

    def step(self, *, family: str, dst_weights=None, self_weight=None,
             require_mutex: bool = True, pre_drain=None) -> None:
        """One fused step (the parameters updated in place, the step
        counter advanced); raises :class:`FusedFallback` when this
        configuration cannot take it (nothing was done then)."""
        from bluefog_tpu_torch.utils import profiler as _profiler
        from bluefog_tpu_torch.utils import telemetry
        opt = self.opt
        d = self._check_eligible()
        key = self._key(family, dst_weights, self_weight, require_mutex, d)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._build(family, dst_weights=dst_weights,
                               require_mutex=require_mutex, d=d, key=key)
            # A new key made the older programs stale: a stale program
            # must never dispatch against a new generation.
            if len(self._programs) >= _MAX_PROGRAMS:
                for old in self._programs.values():
                    old.release()
                self._programs.clear()
            self._programs[key] = prog
        if hasattr(opt, "_drain_pending"):
            opt._drain_pending()     # overlapped eager puts land first
        on_card = opt.params[0].device.type == "cuda"

        # Before the program: the error token, the sparse residuals the
        # host-staged path left, the P refresh (what _plan_put does before
        # its run, once here because the run is inside the program).
        tok = None
        if prog.remote_procs:
            tok = d.transport.error_token(
                {d.proc_addr[p] for p in prog.remote_procs})
        prog.statuses.fill_(_NOT_RUN)
        xlaffi.sync_trace_period()
        with contextlib.ExitStack() as stack:
            for name, plan in zip(prog.names, prog.plans):
                if plan is None:
                    continue
                stack.enter_context(plan.stage_lock)
                stack.enter_context(plan.dispatch_lock)
                xlaffi.migrate_residuals(plan, W._ef_residuals, W._ef_lock)
                xlaffi.refresh_p(plan, W._store.get(name),
                                 W._store.associated_p_enabled)
            if require_mutex:
                # A host function cannot hold a distributed mutex around
                # its own send: every remote destination's mutex is held
                # across the program, in sorted dst order, once (by its
                # first source) since a process holds one at a time.
                holders: Dict[int, int] = {}
                for (src, dst) in sorted(prog.edges):
                    if not W._owns(dst):
                        holders.setdefault(dst, src)
                for dst in sorted(holders):
                    try:
                        stack.enter_context(W._remote_mutex(
                            prog.names[0], dst, holders[dst]))
                    except ConnectionError as e:
                        # A peer that died before the gang voted it out:
                        # nothing has run, and the eager step combines
                        # what arrived (churn only; else it raises).
                        if not W.churn_tolerates(e):
                            raise
                        raise FusedFallback(
                            f"rank {dst}'s mutex did not answer") from e
            transient: List[int] = []
            if on_card:
                began = torch.cuda.Event(enable_timing=True)
                began.record()
            payloads = self._run(prog, transient)
            if on_card:
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                done.synchronize()   # the plans have run
                self.last_program_ms = began.elapsed_time(done)
                from bluefog_tpu_torch.ops import hostfn
                for a in transient:  # an uncaptured run's callbacks
                    hostfn.free(a)
        t_statuses_ns = time.monotonic_ns() if prog.probes else None
        try:
            self._check_statuses(prog)
        except ConnectionError as e:
            if not W.churn_tolerates(e):
                raise
            opt.churn_send_errors += 1

        for name, payload in zip(prog.names, payloads):
            W._count_win_op("accumulate" if prog.accumulate else "put",
                            payload.numel() * payload.element_size(),
                            prog.edges)
        n_runs = 0
        for plan in prog.plans:
            if plan is not None:
                d.transport.count_tx(plan.total_bytes)
                xlaffi.record_dispatch(plan)
                n_runs += len(plan.groups)
        if n_runs:
            telemetry.inc("bf_fused_step_puts_total", float(n_runs))

        # The host half: local edges and self-publish a bucket, then one
        # scoped flush for every bucket's sends.
        for name, payload in zip(prog.names, payloads):
            W._fused_host_finish(
                name, payload, prog.edges, accumulate=prog.accumulate,
                self_weight=self_weight, require_mutex=require_mutex,
                remote_procs=prog.remote_procs, since=tok, flush=False)
        if prog.remote_procs:
            try:
                W._flush_transport(prog.remote_procs, since=tok)
            except ConnectionError as e:
                # Under churn: a dead peer's sends failed; the others
                # were flushed, and the step combines what arrived.
                if not W.churn_tolerates(e):
                    raise
                opt.churn_send_errors += 1
        if pre_drain is not None:    # push-sum's fence and backstop
            pre_drain()
        if prog.probes:
            _probes.note(_probes.DRAIN_START)
        combined = [
            W._collect_rows(name, require_mutex=require_mutex)
            if prog.accumulate else
            W._update_rows(name, require_mutex=require_mutex)
            for name in prog.names]
        if prog.probes:
            _probes.note(_probes.DRAIN_COMMIT)
        opt._maybe_sample_consensus(payloads, combined)
        opt._rebuild(combined)
        if prog.probes:
            _probes.note(_probes.FINISH_DONE)

        attributed = False
        if prog.probes:
            k = len(prog.names)
            summary = _probes.reconcile(
                k, modeled_mean=(k - 1) / (2 * k) if k else 0.0,
                t_statuses_ns=t_statuses_ns)
            attributed = bool(summary and summary.get("attributed"))
        prof = _profiler.active()
        if prof is not None:
            prof.note_fused(attributed)
        telemetry.set_gauge("bf_fused_step_active", 1.0)
        self.fused_steps += 1
        opt.step_count += 1

    def _check_statuses(self, prog: _Program) -> None:
        """A nonzero status raises as ``xlaffi.run_group`` would; the
        program is dropped, since its plans may be stale.  (A vanished
        plan sent nothing, but the JAX package's re-dispatch of it would
        reorder this step's frames after its local writes; here it raises
        too.)"""
        rcs = prog.statuses.numpy()
        self.last_statuses = rcs.tolist()
        bad = rcs[rcs != 0]
        if not bad.size:
            return
        self._programs.pop(prog.key, None)
        prog.release()
        rc = int(bad[0])
        if rc == _NOT_RUN:
            raise RuntimeError("fused step: a bucket's put plan did not run")
        xlaffi.check_rc(rc)

    def close(self) -> None:
        """Drop every program (their plans die with the windows)."""
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()

