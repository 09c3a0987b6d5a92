"""The tuner: a self-tuning control plane for the window transport
(``BLUEFOG_TPU_TUNE``).

The port of ``bluefog_tpu/utils/tuner.py``, the same state machine.  Every
transport knob (stripes, coalesce linger, hierarchical outer cadence,
sparse fraction, async staleness bound) and every modeled cost
(``TorusModel.dcn_link_cost``) is static, while the link observatory
(``utils/linkobs.py``) measures each edge's delay, jitter and goodput.
This module closes the loop:

* **Sense**: the cluster-consistent gauge-MAX merge of the ``bf_link_*``
  matrix (``linkobs.merge_link_snapshots``) is fed in; every rank fed the
  same snapshots (in any order) derives the same state, so decisions are
  rank-local and applied alike.
* **Re-price**: when the measured matrix diverges past
  ``BLUEFOG_TPU_TUNE_DIVERGENCE`` from the applied prices, the tuner builds
  a :class:`~bluefog_tpu_torch.ops.placement.MeasuredModel` (name
  ``measured:<sketch>``), which ``basics._placement_model`` returns through
  :func:`maybe_measured`, and re-enters ``set_topology`` at a step boundary
  so that placement, repack and synthesis run against measurement; a gang
  with no model re-routes instead, to the cheapest candidate topology
  under the measured edge costs (windows snapshotted, freed and recreated).
* **Adapt knobs**: bounded moves toward targets derived from measurement,
  with hysteresis: a dwell (``BLUEFOG_TPU_TUNE_DWELL_STEPS``) between
  epochs, a bounded step, and revert-on-regression (each epoch opens a
  probation window and rolls back, pinning the knobs, if the median of
  ``bf_optimizer_step_seconds`` over it regresses).

Every change is one numbered epoch: logged, counted in ``bf_tune_*`` and
shown in the ``tuner`` block of ``/healthz``.  With ``BLUEFOG_TPU_TUNE=0``
(the default) nothing here is constructed, the override table the
consumers read stays empty, and every knob and modeled cost is bitwise as
configured.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import config, linkobs, telemetry
from bluefog_tpu_torch.utils.logging import get_logger

__all__ = [
    "Tuner",
    "maybe_tuner",
    "tick",
    "feed_snapshots",
    "maybe_measured",
    "override_int",
    "override_float",
    "health_summary",
    "reset",
]


# Name table of the labeled tuner series (the metrics-lint inventory
# convention, like linkobs._RATE_GAUGES); unlabeled series use literal
# names at their call sites.
_TUNE_GAUGES = {
    "epoch": "bf_tune_epoch",
    "probation": "bf_tune_probation",
    "divergence": "bf_tune_max_divergence_ratio",
    "knob": "bf_tune_knob_value",
}
_TUNE_COUNTERS = {
    "adaptations": "bf_tune_adaptations_total",
    "reverts": "bf_tune_reverts_total",
}

# Topology switch hysteresis: a candidate must beat the current edge set's
# measured cost by this factor before a re-route epoch opens (a marginal
# win is never worth a live window swap).
_TOPO_IMPROVEMENT = 1.5

# Regression line for revert-on-regression: the probation-window median of
# bf_optimizer_step_seconds must not exceed the pre-epoch median by more
# than this factor, or the epoch rolls back.
_REGRESSION = 1.25

# After a revert, the reverted knobs are pinned for this many dwell
# windows (an adaptation that regressed once must not be retried on the
# next trigger).
_PIN_DWELLS = 4


# ---------------------------------------------------------------------------
# The override table — how adapted knob values reach their consumers
# ---------------------------------------------------------------------------
# Consumers (resolve_stripes, the hier builder, the sparse encoder) call
# override_int/override_float at their existing read sites.  The table is
# only ever populated by an armed tuner, so with BLUEFOG_TPU_TUNE=0 the
# lookup misses and the configured default passes through bitwise.

_overrides_lock = threading.Lock()
_overrides: Dict[str, float] = {}


def override_float(name: str, default: float) -> float:
    v = _overrides.get(name)
    return default if v is None else float(v)


def override_int(name: str, default: int) -> int:
    v = _overrides.get(name)
    return default if v is None else int(v)


def _set_override(name: str, value: Optional[float]) -> None:
    with _overrides_lock:
        if value is None:
            _overrides.pop(name, None)
        else:
            _overrides[name] = float(value)


# The measured model the placement layer swaps in (basics._placement_model
# consults maybe_measured); None until a re-price epoch installs one.
_measured_model = None


def maybe_measured(base):
    """The measured re-pricing of ``base``, iff the tuner is armed and has
    derived one for the same geometry; ``base`` itself otherwise (the
    BLUEFOG_TPU_TUNE=0 path returns its argument untouched)."""
    m = _measured_model
    if m is None or not config.get().tune:
        return base
    if (m.dims != base.dims or m.device_node != base.device_node
            or m.n_slices != base.n_slices):
        return base
    return m


# ---------------------------------------------------------------------------
# Knob state
# ---------------------------------------------------------------------------

@dataclass
class Knob:
    """One adapted knob: its current value, bounds, and the largest move
    one epoch may make (bounded step size)."""
    name: str
    value: float
    lo: float
    hi: float
    max_step: float
    integer: bool = True
    pinned_until: int = -1      # step before which this knob may not move

    def bounded_move(self, target: float) -> float:
        """The value one epoch is allowed to reach: ``target`` clamped to
        the bounds and to at most ``max_step`` away from the current."""
        t = min(max(float(target), self.lo), self.hi)
        lo, hi = self.value - self.max_step, self.value + self.max_step
        t = min(max(t, lo), hi)
        return float(round(t)) if self.integer else t


@dataclass
class _Probation:
    """An open revert-on-regression window: the state needed to roll the
    epoch back if the step-seconds median regresses past its end."""
    until_step: int
    pre_median: Optional[float]
    pre_counts: Optional[List[float]]
    prev_values: Dict[str, Optional[float]]
    prev_topology: object = None          # nx.DiGraph to restore, or None
    prev_weighted: bool = False
    changed: List[str] = field(default_factory=list)


def _bucket_median(pre: Optional[List[float]],
                   post: Optional[List[float]]) -> Optional[float]:
    """Median step seconds of the observations recorded BETWEEN two bucket
    -count snapshots of ``bf_optimizer_step_seconds`` (the cumulative
    histogram cannot answer "recent median" directly), interpolated within
    the containing bucket like ``telemetry.histogram_percentiles``."""
    if post is None:
        return None
    delta = [c - (pre[i] if pre and i < len(pre) else 0.0)
             for i, c in enumerate(post)]
    total = sum(delta)
    if total <= 0:
        return None
    bounds = telemetry._HIST_BUCKETS
    target, cum = total / 2.0, 0.0
    for i, c in enumerate(delta):
        cum += c
        if cum >= target:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i else 0.0
            return lo + (bounds[i] - lo) * ((target - (cum - c)) / c)
    return None


def _step_seconds_counts() -> Optional[List[float]]:
    return telemetry.histogram_bucket_counts("bf_optimizer_step_seconds")


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

class Tuner:
    """The per-process control loop.  Step-driven (``on_step``), so the
    hysteresis state machine is exactly testable with synthetic step
    numbers and an injected ``counts_fn`` (the fake clock); nothing in the
    decision path reads wall time."""

    def __init__(self, counts_fn: Callable[[], Optional[List[float]]]
                 = _step_seconds_counts):
        cfg = config.get()
        self._lock = threading.RLock()
        self._counts_fn = counts_fn
        self.dwell = max(1, int(cfg.tune_dwell_steps))
        self.trigger = max(1.0, float(cfg.tune_divergence))
        self.epoch = 0
        self.reverts = 0
        self.last_knob: Optional[str] = None
        self._matrix: Dict[str, float] = {}
        self._last_adapt_step: Optional[int] = None
        self._probation: Optional[_Probation] = None
        # The prices currently applied, per directed edge: measured
        # relative costs once an epoch installs them, 1.0 before — the
        # denominator of the divergence trigger, so a matrix the tuner
        # has already adapted to stops triggering (one epoch per change).
        self._applied_cost: Dict[Tuple[int, int], float] = {}
        self._applied_topology_tag: Optional[str] = None
        self.knobs = self._default_knobs(cfg)

    @staticmethod
    def _default_knobs(cfg) -> Dict[str, Knob]:
        sparse = None
        for spec in (cfg.win_compression, cfg.hier_outer_compression):
            if spec.startswith("sparse"):
                sparse = config.parse_sparse_frac(spec)
                break
        knobs = {
            "stripes": Knob("stripes", 0.0, 1.0, 8.0, 8.0),
            "coalesce_linger_ms": Knob(
                "coalesce_linger_ms",
                max(0.0, cfg.win_coalesce_linger_ms), 0.0, 16.0, 16.0,
                integer=False),
            "hier_outer_every": Knob(
                "hier_outer_every", max(1, cfg.hier_outer_every),
                1.0, 64.0, 64.0),
            "staleness_steps": Knob(
                "staleness_steps", max(0, cfg.async_staleness_steps),
                0.0, 512.0, 512.0),
        }
        if sparse is not None:
            knobs["sparse_frac"] = Knob(
                "sparse_frac", sparse, 0.01, 1.0, 1.0, integer=False)
        # "stripes" value 0 means "not yet derived" — the static resolver
        # stays authoritative until the first measured decision.
        return knobs

    # -- sensing ----------------------------------------------------------

    def feed(self, snapshots) -> None:
        """Install the cluster-consistent measured matrix: a list of
        per-rank ``bf_link_*`` snapshots (any order — the merge is
        gauge-MAX, so permutations are irrelevant) or one pre-merged
        dict."""
        if isinstance(snapshots, dict):
            merged = dict(snapshots)
        else:
            merged = linkobs.merge_link_snapshots(list(snapshots))
        with self._lock:
            self._matrix = merged

    def _relative_costs(self, rep: dict) -> Dict[Tuple[int, int], float]:
        """Measured relative cost per directed edge: one-way delay EWMA
        over the fastest measured edge, floored at 1.0 — the same
        min-normalization as ``bf_link_divergence_ratio``."""
        edges = rep.get("edges") or []
        delays = [e.get("delay_us", 0.0) for e in edges]
        floor = min((d for d in delays if d > 0.0), default=0.0)
        if floor <= 0.0:
            return {}
        return {(e["src"], e["dst"]): max(e["delay_us"] / floor, 1.0)
                for e in edges if e.get("delay_us", 0.0) > 0.0}

    def max_divergence(self) -> float:
        """Measured matrix vs the APPLIED prices (1.0 until an epoch
        installs measured costs) — the adaptation trigger statistic."""
        with self._lock:
            if not self._matrix:
                return 0.0
            rel = self._relative_costs(
                linkobs.report_from_snapshot(self._matrix))
            if not rel:
                return 0.0
            return max(c / max(self._applied_cost.get(e, 1.0), 1.0)
                       for e, c in rel.items())

    # -- the step-boundary state machine ----------------------------------

    def on_step(self, step: int) -> None:
        with self._lock:
            self._settle_probation(step)
            div = self.max_divergence()
            telemetry.set_gauge("bf_tune_max_divergence_ratio", div)
            telemetry.set_gauge("bf_tune_epoch", float(self.epoch))
            telemetry.set_gauge("bf_tune_probation",
                                1.0 if self._probation is not None else 0.0)
            if div < self.trigger or self._probation is not None:
                return
            if (self._last_adapt_step is not None
                    and step - self._last_adapt_step < self.dwell):
                return
            self._adapt(step)

    def _settle_probation(self, step: int) -> None:
        pro = self._probation
        if pro is None or step < pro.until_step:
            return
        self._probation = None
        post = _bucket_median(pro.pre_counts, self._counts_fn())
        if (pro.pre_median is not None and post is not None
                and post > pro.pre_median * _REGRESSION):
            self._revert(step, pro, pre=pro.pre_median, post=post)
        else:
            get_logger().info(
                "tune: epoch %d committed (median %.1fms -> %s)",
                self.epoch,
                1e3 * (pro.pre_median or 0.0),
                f"{1e3 * post:.1f}ms" if post is not None else "n/a")

    # -- adaptation -------------------------------------------------------

    def _adapt(self, step: int) -> None:
        rep = linkobs.report_from_snapshot(self._matrix)
        rel = self._relative_costs(rep)
        if not rel:
            return
        cfg = config.get()
        prev_values: Dict[str, Optional[float]] = {}
        changed: List[str] = []

        # (a)+(b) — re-price the cost model and re-feed the placement /
        # synthesis pipeline (or re-route, on modelless gangs).
        prev_topo, prev_weighted, tag = self._replan(rel)
        if tag is not None:
            changed.append(tag)

        # (c) — bounded knob moves toward measurement-derived ABSOLUTE
        # targets (never relative to the current value: an unchanged
        # matrix must map to an unchanged decision, or every dwell window
        # would open a fresh epoch against the same fault).
        for name, target in self._targets(rel, cfg).items():
            knob = self.knobs[name]
            if knob.pinned_until > step:
                continue
            new = knob.bounded_move(target)
            if new == knob.value:
                continue
            prev_values[name] = knob.value
            knob.value = new
            self._apply_knob(name, new)
            changed.append(name)

        if not changed:
            return
        self._applied_cost = dict(rel)
        self.epoch += 1
        self._last_adapt_step = step
        self.last_knob = changed[0]
        for name in changed:
            telemetry.inc("bf_tune_adaptations_total", 1.0, knob=name)
            if name in self.knobs:
                telemetry.set_gauge("bf_tune_knob_value",
                                    self.knobs[name].value, knob=name)
        self._probation = _Probation(
            until_step=step + self.dwell,
            pre_median=_bucket_median(None, self._counts_fn()),
            pre_counts=self._counts_fn(),
            prev_values=prev_values,
            prev_topology=prev_topo,
            prev_weighted=prev_weighted,
            changed=changed)
        get_logger().warning(
            "tune: epoch %d at step %d — adapted %s (max divergence "
            "x%.1f); probation until step %d",
            self.epoch, step, ", ".join(changed),
            max(rel.values()), step + self.dwell)

    def _targets(self, rel: Dict[Tuple[int, int], float],
                 cfg) -> Dict[str, float]:
        """Measurement-derived absolute knob targets.  Hot = some edge
        diverges past the trigger against the *static* floor (the
        decision must not depend on what was already applied)."""
        hot = max(rel.values()) >= self.trigger
        targets: Dict[str, float] = {}
        base_model = self._base_model()
        if base_model is not None:
            # Stripes parallelize a high-cost DCN link.  The static
            # oracle prices them off the modeled constant; measurement
            # prices them off the DCN edges actually observed — and a
            # measured-idle DCN (no slow inter-slice edge in the matrix)
            # collapses to one stream.
            dcn = [c for (s, d), c in rel.items()
                   if self._is_dcn_edge(base_model, s, d)]
            targets["stripes"] = float(
                min(8, max(1, int(round(max(dcn))))) if dcn else 1)
        if hot:
            base = max(0.0, cfg.win_coalesce_linger_ms)
            targets["coalesce_linger_ms"] = max(base * 4.0, base + 4.0)
            if cfg.hier:
                targets["hier_outer_every"] = max(
                    1, cfg.hier_outer_every) * 2.0
            if cfg.async_mode and cfg.async_staleness_steps > 0:
                targets["staleness_steps"] = \
                    cfg.async_staleness_steps * 2.0
            if "sparse_frac" in self.knobs:
                targets["sparse_frac"] = max(
                    self.knobs["sparse_frac"].lo,
                    config.parse_sparse_frac(
                        cfg.win_compression
                        if cfg.win_compression.startswith("sparse")
                        else cfg.hier_outer_compression) / 2.0)
        return targets

    @staticmethod
    def _base_model():
        try:
            from bluefog_tpu_torch import basics
            if not basics._ctx.initialized:
                return None
            return basics._ctx._placement_state[0]
        except Exception:  # noqa: BLE001 — pre-init processes
            return None

    @staticmethod
    def _is_dcn_edge(model, src: int, dst: int) -> bool:
        from bluefog_tpu_torch.ops import placement as PL
        act = PL.active()
        perm = act[1] if act is not None else None
        n = len(model.device_node)
        if not (0 <= src < n and 0 <= dst < n):
            return False
        s, d = ((int(perm[src]), int(perm[dst])) if perm is not None
                else (int(src), int(dst)))
        a, b = int(model.device_node[s]), int(model.device_node[d])
        return (a // model.nodes_per_slice) != (b // model.nodes_per_slice)

    def _apply_knob(self, name: str, value: float) -> None:
        """Publish one adapted value: into the override table (what the
        consumers' read sites consult) and — where a live setter exists —
        pushed into the running subsystem."""
        if name == "stripes":
            # value 0 is the "not yet derived" sentinel — no override, the
            # static resolver stays authoritative.
            _set_override(name, value if value >= 1.0 else None)
            return
        _set_override(name, value)
        if name == "coalesce_linger_ms":
            for t in self._live_transports():
                t.set_linger_ms(value)
        elif name == "staleness_steps":
            try:
                from bluefog_tpu_torch.ops import window as W
                with W._async.lock:
                    if W._async.armed:
                        W._async.staleness_steps = int(value)
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _live_transports():
        try:
            from bluefog_tpu_torch.ops import window as W
            d = W._store.distrib
            return [d.transport] if d is not None else []
        except Exception:  # noqa: BLE001
            return []

    # -- re-price / re-route ----------------------------------------------

    def _replan(self, rel: Dict[Tuple[int, int], float]):
        """Re-feed the placement/synthesis pipeline against measurement.
        Returns ``(prev_topology, prev_weighted, tag)`` — the state a
        revert restores, and the epoch tag (None = no re-plan)."""
        try:
            from bluefog_tpu_torch import basics
        except Exception:  # noqa: BLE001
            return None, False, None
        if not basics._ctx.initialized:
            return None, False, None
        ctx = basics._ctx
        base = self._base_model()
        global _measured_model
        if base is not None:
            # Modeled gang: install the measured model and re-enter
            # set_topology so optimize_placement + congestion repack +
            # synthesize_schedule re-run against it (provenance
            # measured:<sketch> via the model name in every cache key).
            from bluefog_tpu_torch.ops import placement as PL
            dcn = [c for (s, d), c in rel.items()
                   if self._is_dcn_edge(base, s, d)]
            measured = PL.MeasuredModel.from_measurements(
                base, sorted((s, d, c) for (s, d), c in rel.items()),
                dcn_link_cost=max(dcn) if dcn else base.dcn_link_cost)
            if getattr(base, "sketch", None) == measured.sketch:
                return None, False, None
            _measured_model = measured
            self._reenter_topology(ctx.topology, ctx.is_topo_weighted)
            return None, False, f"model={measured.name}"
        # Modelless gang (flat CPU hosts): re-route — swap in the
        # candidate topology that minimizes total measured edge cost,
        # with a margin (hysteresis in decision space).
        choice = self._choose_topology(basics.size(), rel, ctx.topology)
        if choice is None:
            return None, False, None
        tag, topo = choice
        prev_topo, prev_weighted = ctx.topology, ctx.is_topo_weighted
        self._reenter_topology(topo, True)
        self._applied_topology_tag = tag
        return prev_topo, prev_weighted, f"topology={tag}"

    @staticmethod
    def _topology_cost(topo, rel) -> float:
        return sum(rel.get((int(u), int(v)), 1.0)
                   for u, v in topo.edges() if u != v)

    def _choose_topology(self, n: int, rel, current):
        from bluefog_tpu_torch import topology as topology_util
        if current is None or n < 2:
            return None
        candidates = [
            ("ring+1", topology_util.RingGraph(n, connect_style=2)),
            ("ring-1", topology_util.RingGraph(n, connect_style=1)),
            ("exp2", topology_util.ExponentialTwoGraph(n)),
        ]
        cur_cost = self._topology_cost(current, rel)
        best_tag, best_topo, best_cost = None, None, cur_cost
        for tag, topo in candidates:
            if topology_util.IsTopologyEquivalent(topo, current):
                continue
            c = self._topology_cost(topo, rel)
            if c < best_cost:
                best_tag, best_topo, best_cost = tag, topo, c
        if best_topo is None or best_cost * _TOPO_IMPROVEMENT > cur_cost:
            return None
        return best_tag, best_topo

    @staticmethod
    def _reenter_topology(topo, weighted: bool) -> None:
        """Swap topology under live windows at a step boundary: snapshot
        every window's owned rows and push-sum mass, free, set_topology
        (placement search and synthesis re-run for the new prices),
        recreate zero-init and restore the scalars so push-sum keeps its
        conservation invariant."""
        import torch
        from bluefog_tpu_torch import basics
        from bluefog_tpu_torch.ops import window as W
        snaps: Dict[str, dict] = {}
        for name in W.get_current_created_window_names():
            win = W._store.get(name)
            with win.update_lock, win.lock:
                snaps[name] = {
                    "rows": torch.stack([win.main[r] for r in win.owned])
                    if win.owned else
                    torch.zeros((0,) + win.shape, dtype=win.dtype,
                                device=win.device),
                    "p_main": dict(win.p_main),
                }
        if snaps:
            W.win_free()
        basics.set_topology(topo, is_weighted=weighted)
        for name, snap in snaps.items():
            W.win_create(snap["rows"], name, zero_init=True)
            win = W._store.get(name)
            with win.lock:
                for r, p in snap["p_main"].items():
                    if r in win.p_main:
                        win.p_main[r] = p

    # -- revert-on-regression ---------------------------------------------

    def _revert(self, step: int, pro: _Probation, *, pre: float,
                post: float) -> None:
        global _measured_model
        for name, value in pro.prev_values.items():
            knob = self.knobs[name]
            knob.value = value
            knob.pinned_until = step + _PIN_DWELLS * self.dwell
            self._apply_knob(name, value)
            telemetry.inc("bf_tune_reverts_total", 1.0, knob=name)
            telemetry.set_gauge("bf_tune_knob_value", value, knob=name)
        if pro.prev_topology is not None:
            self._reenter_topology(pro.prev_topology, pro.prev_weighted)
            self._applied_topology_tag = None
            telemetry.inc("bf_tune_reverts_total", 1.0, knob="topology")
        if any(c.startswith("model=") for c in pro.changed):
            _measured_model = None
            telemetry.inc("bf_tune_reverts_total", 1.0, knob="model")
        self._applied_cost = {}
        self.epoch += 1
        self.reverts += 1
        self._last_adapt_step = step
        self.last_knob = "revert"
        get_logger().warning(
            "tune: epoch %d at step %d — REVERTED %s (median regressed "
            "%.1fms -> %.1fms); pinned for %d steps",
            self.epoch, step, ", ".join(pro.changed), 1e3 * pre,
            1e3 * post, _PIN_DWELLS * self.dwell)

    # -- introspection -----------------------------------------------------

    def health(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "reverts": self.reverts,
                "last_knob": self.last_knob,
                "probation": self._probation is not None,
                "max_divergence_ratio": round(self.max_divergence(), 3),
                "knobs": {k.name: k.value for k in self.knobs.values()},
                "model": getattr(_measured_model, "name", None),
                "topology": self._applied_topology_tag,
            }


# ---------------------------------------------------------------------------
# Process-wide singleton + the step-boundary entry points
# ---------------------------------------------------------------------------

_singleton: Optional[Tuner] = None
_singleton_lock = threading.Lock()


def maybe_tuner() -> Optional[Tuner]:
    """The process-wide tuner iff BLUEFOG_TPU_TUNE=1; None otherwise
    (never raises, lazily constructed once)."""
    if not config.get().tune:
        return None
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = Tuner()
        return _singleton


def tick(step: int) -> None:
    """Step-boundary hook (``window.set_async_step`` calls it next to
    ``linkobs.on_step``); a no-op unless armed."""
    t = maybe_tuner()
    if t is not None:
        t.on_step(step)


def feed_snapshots(snapshots) -> None:
    """Feed the merged (or to-be-merged) ``bf_link_*`` matrix; a no-op
    unless armed."""
    t = maybe_tuner()
    if t is not None:
        t.feed(snapshots)


def health_summary() -> Optional[dict]:
    """The ``/healthz`` ``tuner`` block, or None when the tuner is off or
    never constructed (no block, no key, nothing — the =0 contract)."""
    if not config.get().tune:
        return None
    t = _singleton
    return None if t is None else t.health()


def reset() -> None:
    """Drop every piece of tuner state (tests + config reloads)."""
    global _singleton, _measured_model
    with _singleton_lock:
        _singleton = None
    _measured_model = None
    with _overrides_lock:
        _overrides.clear()
