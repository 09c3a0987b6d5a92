"""Distributed step profiler: phase attribution and cross-rank stragglers.

The port of ``bluefog_tpu/utils/profiler.py``.  ``bf.step_profile()``
wraps one training step and splits its wall time into the phases
``grad-compute`` / ``gossip-communicate`` / ``optimizer-update`` /
``host-sync`` through ``timeline.op_span``: while a profiler is active
every framework op span reports its duration here, ``prof.phase(name)``
marks explicit sub-phases, and the unattributed remainder is the step's own
compute.  Phases land in the ``bf_step_phase_seconds`` histogram, the step
in ``bf_step_seconds``.

The phases are host wall time, as in the JAX package.  On CUDA a torch op
returns once it is queued, so a span times the launch, and the device work
queued in a step shows where the host next waits for it: with no sync in
the step, ``grad-compute`` holds the host's launch time and the device runs
behind.  The optimizers' synced sample (``profile_every=``,
``BLUEFOG_TPU_PROFILE_EVERY``) calls ``torch.cuda.synchronize()`` on the
sampled step only, so that step's total is its true wall time.

Every N profiled steps the profiler gathers every rank's step time over
the port's ``allgather`` and emits a straggler report (per-rank z-scores,
the slowest rank, the ``bf_straggler_score`` gauge), which ``/healthz``
shows.  The gather is collective across processes: every process profiles
the same steps.  Nothing here runs with ``BLUEFOG_TPU_TELEMETRY=0``.

A fused window step (``ops/fused_step.py``) is one captured program,
opaque to host spans: its probes (``utils/probes.py``) attribute its
phases through :meth:`StepProfiler.attribute`.  A fused step that ran
without that attribution labels the step's remainder ``fused-step``
(:data:`FUSED_PHASE`) instead of ``grad-compute``, and trips the flag
:func:`attribution_degraded` that ``/healthz`` reports.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np

from bluefog_tpu_torch.utils import config, telemetry

__all__ = [
    "PHASES",
    "StepProfiler",
    "step_profile",
    "active",
    "attribution_degraded",
    "profile_period",
    "record_synced_step",
    "straggler_report",
    "last_straggler_report",
]

# The canonical phase set.  Every op span maps into one of the last three;
# the unattributed remainder of a profiled step is grad-compute (the
# step's own forward/backward math — the only part the framework cannot
# see from inside its comm entry points).
PHASES = ("grad-compute", "gossip-communicate", "optimizer-update",
          "host-sync")

# The remainder of a profiled step that a fused program served without
# probe attribution: one captured program, composition unknown.
FUSED_PHASE = "fused-step"

def _classify_span(op_name: str, span_phase: str) -> str:
    """Map a ``timeline.op_span`` (op, phase) pair to a profiler phase.

    UPDATE spans are optimizer math; the ``synchronize`` COMMUNICATE span
    is a host-side block on device completion (host-sync); every other
    ENQUEUE/COMMUNICATE span is communication work (dispatching a
    collective, a window edge transfer, a transport apply)."""
    if span_phase == "UPDATE":
        return "optimizer-update"
    if op_name == "synchronize":
        return "host-sync"
    return "gossip-communicate"


# ---------------------------------------------------------------------------
# Module state (the active profiler + last straggler report)
# ---------------------------------------------------------------------------

_active: Optional["StepProfiler"] = None
_state_lock = threading.Lock()
_step_count = 0          # profiled steps seen (straggler-gather period base)
_last_report: Optional[dict] = None
_degraded = False        # a fused step ran without probe attribution


def active() -> Optional["StepProfiler"]:
    """The StepProfiler currently wrapping a step, or None."""
    return _active


def attribution_degraded() -> bool:
    """True once a profiled fused step ran without probe attribution
    (``BLUEFOG_TPU_PROBE=0``): its phase histograms carry an opaque
    ``fused-step`` bucket, and ``/healthz`` says so."""
    return _degraded


def last_straggler_report() -> Optional[dict]:
    """The most recent cross-rank straggler report (``/healthz`` and
    ``%bfstat`` read this), or None before the first gather."""
    rep = _last_report
    return None if rep is None else dict(rep)


def _reset_for_tests() -> None:
    global _active, _step_count, _last_report, _degraded
    _active = None
    _step_count = 0
    _last_report = None
    _degraded = False
    _uninstall_hook()


def profile_period(explicit: Optional[int] = None) -> int:
    """Straggler-gather / profile-sampling period in steps (0 = off).

    An explicit argument (``DistributedOptimizer(profile_every=N)``) wins;
    otherwise ``BLUEFOG_TPU_PROFILE=1`` enables the env-configured
    ``BLUEFOG_TPU_PROFILE_EVERY``.  Always 0 when telemetry is disabled —
    profiling must never mutate a disabled registry or add collectives."""
    cfg = config.get()
    if not cfg.telemetry:
        return 0
    if explicit is not None:
        return max(int(explicit), 0)
    return cfg.profile_every if cfg.profile else 0


# ---------------------------------------------------------------------------
# op_span hook plumbing (installed only while a profiler is active)
# ---------------------------------------------------------------------------

def _on_op_span(op_name: str, span_phase: str, seconds: float) -> None:
    p = _active
    if p is None:
        return
    if op_name.startswith("win_apply."):
        # Drain-thread spans are PEER-driven (inbound gossip landing while
        # we happen to be profiling) — not this step's own work; billing
        # them to the active step would misattribute a neighbor's traffic.
        return
    p.attribute(_classify_span(op_name, span_phase), seconds)


def _install_hook() -> None:
    from bluefog_tpu_torch.utils import timeline
    timeline.set_op_span_hook(_on_op_span)


def _uninstall_hook() -> None:
    from bluefog_tpu_torch.utils import timeline
    timeline.set_op_span_hook(None)


# ---------------------------------------------------------------------------
# StepProfiler
# ---------------------------------------------------------------------------

class StepProfiler:
    """Context wrapping ONE training step; see :func:`step_profile`.

    ``straggler``: None (default) gathers cross-rank step times every
    :func:`profile_period` profiled steps; True forces a gather on this
    step; False never gathers.  ``clock`` is injectable for tests.

    Attribution scope: only TOP-LEVEL op spans report (nested per-edge
    window spans are folded into their op-level parent), and peer-driven
    drain-thread work (``win_apply``) is excluded.  Spans from the window
    worker pool DO attribute — they are this step's own puts/gets — so in
    overlap modes a previous step's still-draining put can bill the
    current step; that spillover is the async design's real behavior, and
    the ``grad-compute`` remainder is floored at 0 when concurrent comm
    threads make attributed time exceed the step's wall time."""

    def __init__(self, *, straggler: Optional[bool] = None,
                 clock=time.perf_counter):
        self._clock = clock
        self._straggler = straggler
        self._phases: Dict[str, float] = {}
        self._lock = threading.Lock()  # window workers attribute concurrently
        self._t0: Optional[float] = None
        self._enabled = False
        self._prev: Optional[StepProfiler] = None
        self._fused = False
        self._fused_attributed = False

    def note_fused(self, attributed: bool) -> None:
        """A fused program served this step; ``attributed`` says whether
        its probes reconciled real phases into it.  Without them the
        remainder is labeled ``fused-step`` and the module's degraded flag
        trips."""
        global _degraded
        self._fused = True
        if attributed:
            self._fused_attributed = True
        else:
            _degraded = True

    def attribute(self, phase: str, seconds: float) -> None:
        """Add ``seconds`` of this step's wall time to ``phase``."""
        with self._lock:
            self._phases[phase] = self._phases.get(phase, 0.0) + seconds

    @contextmanager
    def phase(self, name: str):
        """Explicitly mark a sub-phase (``with prof.phase("grad-compute")``)
        — time inside is attributed to ``name`` instead of the remainder."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.attribute(name, self._clock() - t0)

    def phases(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._phases)

    def request_straggler(self) -> None:
        """Ask for the cross-rank gather at this step's exit (the
        optimizer families call this when their own ``profile_every``
        sample lands inside an enclosing ``bf.step_profile()`` — ONE
        gather, owned by the outer context, instead of two).  An explicit
        ``straggler=False`` on the context wins: the caller opted out of
        collectives (e.g. a non-lockstep async-family loop where an
        unmatched allgather would hang), and a sampler must not override
        that."""
        if self._straggler is None:
            self._straggler = True

    def __enter__(self) -> "StepProfiler":
        global _active
        self._enabled = telemetry.enabled()
        if not self._enabled:
            return self
        with _state_lock:
            self._prev = _active
            _active = self
            _install_hook()
        self._t0 = self._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active, _step_count
        if not self._enabled:
            return False
        total = self._clock() - self._t0
        with _state_lock:
            _active = self._prev
            if _active is None:
                _uninstall_hook()
        attributed = sum(self.phases().values())
        if total > attributed:
            # The step's own compute: everything no framework span claimed;
            # a fused program without probe attribution is the opaque
            # ``fused-step`` instead.
            remainder = (FUSED_PHASE
                         if self._fused and not self._fused_attributed
                         else "grad-compute")
            self.attribute(remainder, total - attributed)
        for ph, dt in sorted(self.phases().items()):
            telemetry.observe("bf_step_phase_seconds", dt, phase=ph)
        telemetry.observe("bf_step_seconds", total)
        if exc_type is None:
            with _state_lock:
                _step_count += 1
                count = _step_count
            want = self._straggler
            if want is None:
                p = profile_period()
                want = bool(p) and count % p == 0
            if want:
                times = _gather_step_seconds(total)
                if times is not None:
                    _record_straggler(times)
        return False


def step_profile(*, straggler: Optional[bool] = None,
                 clock=time.perf_counter) -> StepProfiler:
    """``with bf.step_profile(): ...`` — profile one training step.

    While active, every framework op span feeds the phase accumulators
    (see module docstring); on exit the per-phase durations land in the
    ``bf_step_phase_seconds`` histogram and — on straggler steps — all
    ranks' step durations are gathered into a straggler report.  Inert
    when telemetry is disabled."""
    return StepProfiler(straggler=straggler, clock=clock)


# ---------------------------------------------------------------------------
# Straggler attribution (rides the collective path)
# ---------------------------------------------------------------------------

def straggler_report(step_seconds) -> dict:
    """Pure straggler math over per-rank step durations: z-scores, the
    slowest rank, and the straggler score (max z-score — how many standard
    deviations the worst rank sits above the fleet).  A uniform fleet
    scores 0.

    The max z-score is capped at ``sqrt(n-1)`` by construction (one slow
    rank among n), so on small gangs it identifies the straggler but not
    its SEVERITY — ``slowest_over_mean`` (slowest rank's time over the
    fleet mean, also the ``bf_straggler_ratio`` gauge) carries the
    magnitude: 1.0 = uniform, 2.0 = the slowest rank takes twice the mean
    step time."""
    t = np.asarray(step_seconds, dtype=np.float64).reshape(-1)
    mean = float(t.mean())
    std = float(t.std())
    z = (t - mean) / std if std > 0 else np.zeros_like(t)
    slowest = int(np.argmax(t))
    return {
        "step_seconds": [round(float(v), 6) for v in t],
        "mean_sec": round(mean, 6),
        "std_sec": round(std, 6),
        "z_scores": [round(float(v), 3) for v in z],
        "slowest_rank": slowest,
        "straggler_score": round(float(z.max()) if t.size > 1 else 0.0, 3),
        "slowest_over_mean": round(float(t[slowest]) / mean
                                   if mean > 0 else 1.0, 3),
    }


def _gather_step_seconds(my_seconds: float) -> Optional[np.ndarray]:
    """Every rank's step time over the port's ``allgather`` (one ``(m, 1)``
    float32 gather).  Collective across processes; None before init."""
    from bluefog_tpu_torch import basics
    if not basics.initialized():
        return None
    import torch
    n = basics.size()
    rows = torch.full((len(basics.owned_ranks()), 1), float(my_seconds),
                      dtype=torch.float32, device=basics.device())
    return basics.allgather(rows)[0].cpu().numpy().reshape(n)


def _record_straggler(times: np.ndarray) -> None:
    global _last_report
    rep = straggler_report(times)
    telemetry.set_gauge("bf_straggler_score", rep["straggler_score"])
    telemetry.set_gauge("bf_straggler_ratio", rep["slowest_over_mean"])
    telemetry.set_gauge("bf_straggler_rank", rep["slowest_rank"])
    telemetry.inc("bf_straggler_reports_total")
    _last_report = rep


def record_synced_step(total_seconds: float,
                       phases: Optional[Dict[str, float]] = None,
                       *, straggler: bool = True) -> None:
    """Record one fully-synced step measured by a caller (the optimizer
    families' ``profile_every`` hook): step + phase histograms and — by
    default — a straggler gather.  The caller must have synchronized
    the step so ``total_seconds`` is true wall time, and in multi-process
    runs must call this on every process together (collective gather)."""
    if not telemetry.enabled():
        return
    telemetry.observe("bf_step_seconds", total_seconds)
    for ph, dt in (phases or {}).items():
        telemetry.observe("bf_step_phase_seconds", dt, phase=ph)
    if straggler:
        times = _gather_step_seconds(total_seconds)
        if times is not None:
            _record_straggler(times)
