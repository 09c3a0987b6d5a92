"""The environment knobs the port reads so far.

A subset of ``bluefog_tpu/utils/config.py``: the same variable names,
defaults and validation, for the knobs of the ported paths.  Values are
read on first access and cached; call :func:`reload` after changing
``os.environ``, or scope a change with :func:`override` (which leaves
``os.environ`` alone).  The observability knobs (timeline, log level, stall
watchdog, telemetry, flight recorder, step profiler, fusion-bucket cap) are
the JAX package's, with its names and defaults, and so are the link
observatory's, the SLO engine's, the tuner's, the device-side put plans'
and the fused step's with its probes, and so are the churn, gang and
chaos knobs of the elasticity layer (ROADMAP item 20).

| Variable | Default | Meaning |
|---|---|---|
| BLUEFOG_TIMELINE              | unset | timeline file prefix (one file a process: <prefix><process>.json) |
| BLUEFOG_TPU_LOG_LEVEL         | warn  | trace/debug/info/warn/error/fatal |
| BLUEFOG_TPU_LOG_HIDE_TIME     | 0     | drop timestamps from log lines |
| BLUEFOG_TPU_PYTHON_TIMELINE   | 0     | 1: the Python timeline writer instead of the native one |
| BLUEFOG_TPU_STALL_WARNING_SEC | 60    | stall-watchdog threshold in seconds (0 = off) |
| BLUEFOG_TPU_TELEMETRY         | 1     | 0: disable the metric registry entirely |
| BLUEFOG_TPU_TELEMETRY_PORT    | unset | serve /metrics + /healthz on this port (0 = ephemeral) |
| BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY | 10 | consensus-distance sample period in steps (0 = off) |
| BLUEFOG_TPU_FLIGHT_RECORDER   | 0     | 1: record transport events into the native ring, dumped to <path>.<rank>.bin |
| BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS | 65536 | flight-recorder ring capacity (events; oldest overwritten) |
| BLUEFOG_TPU_FLIGHT_RECORDER_PATH | flightrec | dump path prefix |
| BLUEFOG_TPU_PROFILE           | 0     | 1: the step profiler's periodic synced samples and straggler gathers |
| BLUEFOG_TPU_PROFILE_EVERY     | 50    | their period in steps |
| BLUEFOG_TPU_FUSION_BUCKET_MB  | 0     | fusion-buffer bucket cap in MiB (0 = one bucket) |
| BLUEFOG_TPU_WIN_PORT          | 0     | window-service port (0=ephemeral) |
| BLUEFOG_TPU_WIN_MAX_PENDING   | 4096  | inbound window-message queue bound |
| BLUEFOG_TPU_WIN_COMPRESSION   | none  | cross-process window payloads: none / bf16 / sparse:<frac> (top-|magnitude| with sender error feedback, accumulates only) |
| BLUEFOG_TPU_WIN_COALESCE      | 1     | 0: one native send a message, no per-peer queues |
| BLUEFOG_TPU_WIN_COALESCE_LINGER_MS | 1.0 | sender-worker linger before flushing a partial batch |
| BLUEFOG_TPU_WIN_COALESCE_BYTES | 1 MiB | queued bytes that force an immediate batch flush |
| BLUEFOG_TPU_WIN_TX_QUEUE      | 1024  | per-peer outbound queue bound (messages); full blocks the producer |
| BLUEFOG_TPU_WIN_NATIVE        | 1     | 0: the transport's hot loop (queues, batch encode, drain decode and fold) in Python |
| BLUEFOG_TPU_WIN_STRIPES       | auto  | sockets and sender workers a peer, frames sharded by (window, row); auto = the placement model's dcn_link_cost (no model: 1) |
| BLUEFOG_TPU_WIN_DECODE_THREADS | auto | native drain's decode pool (0 = inline); auto = min(4, cores - 1), at least 1 |
| BLUEFOG_TPU_WIN_RETRIES       | 1     | transient-send retries before ConnectionError |
| BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS | 50 | base of the jittered exponential retry backoff |
| BLUEFOG_TPU_WIN_TIMEOUT       | 300   | seconds a window op waits for a peer (fence acks, get replies, mutex grants, flushes) |
| BLUEFOG_TPU_TRACE_SAMPLE      | 0     | wire trace-tag sampling: "1/N" (or plain "N") tags every Nth put/accumulate with a (src, seq, origin-time, origin-step) trailer; 0/unset = off, wire bitwise identical |
| BLUEFOG_TPU_WIN_XLA           | 1     | the put-plan path (ops/xlaffi.py + native/src/xlacall.cc): a put whose remote edges all ride the native transport copies its owned rows once into a pinned buffer and encodes them in C; 0 pins the host-staged put path (the bitwise oracle) |
| BLUEFOG_TPU_FUSED_STEP        | 0     | the fused window step (ops/fused_step.py): update, bucket flats and per-bucket put plans as one captured program (a CUDA graph on the card); 0 pins the eager step (the bitwise oracle); 1 falls back to eager (one warning) where the configuration cannot be lowered |
| BLUEFOG_TPU_PROBE             | 1     | probes of the fused step (utils/probes.py): host nodes noting the program's seams into the native ring on one steady clock; 0 records none |
| BLUEFOG_TPU_LINK_OBS          | 1     | 0: disable the link observatory (utils/linkobs.py): no per-edge delay/jitter/goodput/divergence estimation, no SLO evaluation, bitwise inert |
| BLUEFOG_TPU_SLO               | unset | SLO rules, `<metric><op><value>` joined by `;` (e.g. `link_delay_us>50000;step_lag>128`), evaluated at step boundaries; a breach degrades /healthz, bumps bf_slo_breaches_total and dumps the flight recorder |
| BLUEFOG_TPU_TUNE              | 0     | 1: arm the tuner (utils/tuner.py): measured link costs re-price placement (MeasuredModel) and adapt transport knobs; 0 leaves every knob and modeled cost as configured, bitwise |
| BLUEFOG_TPU_TUNE_DIVERGENCE   | 3.0   | measured-vs-applied divergence ratio that opens a tuner epoch |
| BLUEFOG_TPU_TUNE_DWELL_STEPS  | 20    | minimum steps between tuner epochs, and the revert-on-regression probation window |
| BLUEFOG_TPU_ASYNC             | 0     | 1: barrier-free async window-optimizer mode (no per-step fence, bounded-staleness policy); 0 = bitwise lockstep |
| BLUEFOG_TPU_ASYNC_STALENESS_STEPS | 0 | staleness bound k (origin steps); 0 = unbounded (accept everything) |
| BLUEFOG_TPU_ASYNC_STALENESS_POLICY | reject | reject (full mass to the stale-residual store) or downweight:<alpha> (alpha enters staging, 1-alpha to the store) |
| BLUEFOG_TPU_ASYNC_COLLECT_EVERY | 64  | every N async steps: fence, fold the stale residuals back, exact collect; 0 = never |
| BLUEFOG_TPU_CHURN             | 0     | 1: enable the elastic-gossip churn controller (ops/membership.py, run/supervisor.py) |
| BLUEFOG_TPU_CHURN_HEARTBEAT_MS | 250  | membership heartbeat period |
| BLUEFOG_TPU_CHURN_SUSPECT_MS  | 1500  | heartbeat silence before a peer is suspected |
| BLUEFOG_TPU_CHURN_STRAGGLER_STEPS | 0 | step lag that marks a live peer a straggler suspect (0=off) |
| BLUEFOG_TPU_ELASTIC_JOIN      | 0     | 1: enable the join/bootstrap subsystem (ops/gang.py): wired joins, the replicated endpoint directory, coordinator-free bootstrap |
| BLUEFOG_TPU_GANG_DIR_PATH     | unset | endpoint-directory persistence prefix (files <prefix>.<proc>.json); unset = in memory only |
| BLUEFOG_TPU_JOIN_TIMEOUT_MS   | 30000 | how long a joining process waits for a join grant per contacted endpoint |
| BLUEFOG_TPU_CHAOS             | unset | fault-injection spec (utils/chaos.py grammar) |
| BLUEFOG_TPU_HIER              | 0     | 1: enable two-level hierarchical gossip |
| BLUEFOG_TPU_HIER_OUTER_EVERY  | 1     | outer (inter-machine) cadence: every k steps |
| BLUEFOG_TPU_HIER_INNER        | exp2  | intra-machine dense topology: exp2 / ring |
| BLUEFOG_TPU_HIER_OUTER        | exp2  | inter-machine one-peer walk: exp2 / ring |
| BLUEFOG_TPU_HIER_OUTER_COMPRESSION | none | outer-level codec: none / bf16 / sparse:<frac> |
| BLUEFOG_TPU_HIER_OUTER_SELF_WEIGHT | 0.5 | cadence-1 outer self weight (cadence-corrected to theta**k) |
| BLUEFOG_TPU_SHARDED_GOSSIP    | 1     | with shard specs: replicated leaves gossip over the whole topology, sharded ones per replica group (ops/sharded.py); 0 = the replicated path, bit for bit |
| BLUEFOG_TPU_SCHEDULE_SYNTH    | 1     | 0: skip sketch-guided schedule synthesis (the congestion-repack path exactly) |
| BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH | auto | synthesis sketch: auto / ring-within-slice / hierarchical / chunked-pipelined |
| BLUEFOG_TPU_PLACEMENT         | 1     | 0: keep the enumeration-order placement |
| BLUEFOG_TPU_PLACEMENT_ITERS   | 1000  | simulated-annealing refinement iterations |
| BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET | 2.0 | congestion-repack round budget (x König; 0=off) |
| BLUEFOG_TPU_FAKE_TORUS        | unset | synthetic torus spec (e.g. 4x8): the interconnect model where devices carry no geometry |
| BLUEFOG_TPU_TORUS_WRAP        | auto  | real-coords wrap policy: auto / 1 (torus) / 0 (mesh) |
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Config", "get", "reload", "override", "parse_sparse_frac",
           "parse_staleness_policy", "compression_byte_factor",
           "COMPRESSION_VOCAB"]

COMPRESSION_VOCAB = ("none", "bf16", "sparse:<frac>")


def parse_sparse_frac(value: str) -> float:
    """Fraction of a ``sparse:<frac>`` codec spec, validated in (0, 1]."""
    if ":" not in value:
        raise ValueError(
            f"malformed {value!r}: use 'sparse:<frac>' (e.g. 'sparse:0.25')")
    try:
        frac = float(value.split(":", 1)[1])
    except ValueError:
        raise ValueError(
            f"malformed {value!r}: the fraction must be a float in (0, 1], "
            "e.g. 'sparse:0.25'") from None
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"sparse fraction must be in (0, 1], got {frac}")
    return frac


def compression_byte_factor(value: str) -> float:
    """The wire bytes of a compression spec against the raw row's:
    ``none`` 1.0, ``bf16`` 0.5, ``sparse:<frac>`` the fraction."""
    if value in (None, "none"):
        return 1.0
    if value == "bf16":
        return 0.5
    if isinstance(value, str) and value.startswith("sparse"):
        return parse_sparse_frac(value)
    raise ValueError(
        f"unknown compression {value!r}; expected one of "
        f"{', '.join(COMPRESSION_VOCAB)}")


def _validated_compression(value: str, var: str) -> str:
    if value in ("none", "bf16"):
        return value
    if value.startswith("sparse"):
        parse_sparse_frac(value)  # raises on a malformed fraction
        return value
    raise ValueError(
        f"{var}={value!r} is not supported; expected one of "
        f"{', '.join(COMPRESSION_VOCAB)} (a typo here would otherwise "
        "silently disable compression)")


def parse_staleness_policy(value: str):
    """Parse ``BLUEFOG_TPU_ASYNC_STALENESS_POLICY`` into ``(kind, alpha)``:
    ``("reject", 0.0)`` or ``("downweight", alpha)`` with alpha in (0, 1).
    A typo fails loudly: a misread policy would either drop fresh gossip or
    admit arbitrarily stale mass."""
    if value == "reject":
        return ("reject", 0.0)
    if value.startswith("downweight"):
        if ":" not in value:
            raise ValueError(
                f"malformed {value!r}: use 'downweight:<alpha>' "
                "(e.g. 'downweight:0.25')")
        try:
            alpha = float(value.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"malformed {value!r}: the alpha must be a float in "
                "(0, 1), e.g. 'downweight:0.25'") from None
        if not 0.0 < alpha < 1.0:
            raise ValueError(
                f"downweight alpha must be in (0, 1), got {alpha} "
                "(1.0 would be a no-op — raise "
                "BLUEFOG_TPU_ASYNC_STALENESS_STEPS instead; 0.0 is "
                "'reject')")
        return ("downweight", alpha)
    raise ValueError(
        f"BLUEFOG_TPU_ASYNC_STALENESS_POLICY={value!r} is not supported; "
        "expected 'reject' or 'downweight:<alpha>'")


def _validated_staleness_policy(value: str) -> str:
    parse_staleness_policy(value)  # raises on malformed input
    return value


def _validated_slo(value: Optional[str]) -> Optional[str]:
    """``BLUEFOG_TPU_SLO``, parsed once at load so that a malformed rule
    stops the run here (``utils/linkobs.py`` owns the grammar)."""
    if value is None or not value.strip():
        return None
    from bluefog_tpu_torch.utils.linkobs import parse_slo_rules
    parse_slo_rules(value)
    return value


def _parse_trace_sample(raw: Optional[str]) -> int:
    """``BLUEFOG_TPU_TRACE_SAMPLE``: ``"1/N"`` or a plain period ``N``
    tags every Nth data message; ``0``, ``off``, empty or unset disable
    tagging (the wire stays bitwise identical).  A typo fails loudly."""
    if raw is None:
        return 0
    raw = raw.strip()
    if raw in ("", "0", "off"):
        return 0
    if raw.startswith("1/"):
        raw = raw[2:]
    try:
        period = int(raw)
    except ValueError:
        raise ValueError(
            f"BLUEFOG_TPU_TRACE_SAMPLE={raw!r} is not '1/N', an integer "
            "period N, or 0/off") from None
    if period < 0:
        raise ValueError(
            f"BLUEFOG_TPU_TRACE_SAMPLE period must be >= 0, got {period}")
    return period


def _validated_sketch(value: str) -> str:
    # Lazy import: ops/synthesis owns the sketch vocabulary.
    from bluefog_tpu_torch.ops.synthesis import SKETCHES
    allowed = ("auto",) + SKETCHES
    if value not in allowed:
        raise ValueError(
            f"BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH={value!r} is not a known "
            f"sketch; expected one of {', '.join(allowed)} (a typo here "
            "would otherwise silently fall back to some default sketch)")
    return value


def _flag(name: str, default: bool = False) -> bool:
    return os.environ.get(name, "1" if default else "0") in ("1", "true",
                                                             "True", "yes")


def _int_or_auto(name: str, floor: int = 0) -> int:
    """An integer knob with an ``auto`` sentinel: unset or ``auto`` is -1
    (the consumer derives the value); anything else is an integer >=
    ``floor``."""
    raw = os.environ.get(name, "auto").strip().lower()
    if raw in ("", "auto"):
        return -1
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer or 'auto'") \
            from None
    if v < floor:
        raise ValueError(f"{name}={v} must be >= {floor} (or 'auto')")
    return v


@dataclass(frozen=True)
class Config:
    timeline_prefix: Optional[str]
    log_level: str
    log_hide_time: bool
    python_timeline: bool
    stall_warning_sec: float
    telemetry: bool
    telemetry_port: Optional[int]
    telemetry_consensus_every: int
    # Whether the consensus period was set explicitly: samplers that cost
    # communication (the collective optimizer family) run only then.
    telemetry_consensus_set: bool
    flight_recorder: bool
    flight_recorder_events: int
    flight_recorder_path: str
    # bf.step_profile() works regardless; these arm the periodic synced
    # samples (an explicit profile_every= on an optimizer wins).
    profile: bool
    profile_every: int
    fusion_bucket_mb: float
    win_port: int
    win_max_pending: int
    win_compression: str
    win_coalesce: bool
    win_coalesce_linger_ms: float
    win_coalesce_bytes: int
    win_tx_queue: int
    win_native: bool
    win_stripes: int
    win_decode_threads: int
    win_retries: int
    win_retry_backoff_ms: float
    win_timeout: float
    trace_sample: int
    win_xla: bool
    fused_step: bool
    probe: bool
    link_obs: bool
    slo: Optional[str]
    tune: bool
    tune_divergence: float
    tune_dwell_steps: int
    async_mode: bool
    async_staleness_steps: int
    async_staleness_policy: str
    async_collect_every: int
    churn: bool
    churn_heartbeat_ms: float
    churn_suspect_ms: float
    churn_straggler_steps: int
    elastic_join: bool
    gang_dir_path: Optional[str]
    join_timeout_ms: float
    chaos: Optional[str]
    hier: bool
    hier_outer_every: int
    hier_inner: str
    hier_outer: str
    hier_outer_compression: str
    hier_outer_self_weight: float
    sharded_gossip: bool
    schedule_synth: bool
    schedule_synth_sketch: str
    placement: bool
    placement_iters: int
    placement_round_budget: float
    fake_torus: Optional[str]
    torus_wrap: str

    @classmethod
    def from_env(cls) -> "Config":
        env = os.environ
        return cls(
            timeline_prefix=env.get("BLUEFOG_TIMELINE"),
            log_level=env.get("BLUEFOG_TPU_LOG_LEVEL", "warn").lower(),
            log_hide_time=_flag("BLUEFOG_TPU_LOG_HIDE_TIME"),
            python_timeline=_flag("BLUEFOG_TPU_PYTHON_TIMELINE"),
            stall_warning_sec=float(env.get("BLUEFOG_TPU_STALL_WARNING_SEC",
                                            "60")),
            telemetry=_flag("BLUEFOG_TPU_TELEMETRY", default=True),
            telemetry_port=(
                None if env.get("BLUEFOG_TPU_TELEMETRY_PORT") is None
                else int(env["BLUEFOG_TPU_TELEMETRY_PORT"])),
            telemetry_consensus_every=int(env.get(
                "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY", "10")),
            telemetry_consensus_set=(
                "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY" in env),
            flight_recorder=_flag("BLUEFOG_TPU_FLIGHT_RECORDER"),
            flight_recorder_events=int(env.get(
                "BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS", "65536")),
            flight_recorder_path=env.get("BLUEFOG_TPU_FLIGHT_RECORDER_PATH",
                                         "flightrec"),
            profile=_flag("BLUEFOG_TPU_PROFILE"),
            profile_every=int(env.get("BLUEFOG_TPU_PROFILE_EVERY", "50")),
            fusion_bucket_mb=float(env.get("BLUEFOG_TPU_FUSION_BUCKET_MB",
                                           "0")),
            win_port=int(env.get("BLUEFOG_TPU_WIN_PORT", "0")),
            win_max_pending=int(env.get("BLUEFOG_TPU_WIN_MAX_PENDING",
                                        "4096")),
            win_compression=_validated_compression(
                env.get("BLUEFOG_TPU_WIN_COMPRESSION", "none").lower(),
                "BLUEFOG_TPU_WIN_COMPRESSION"),
            win_coalesce=_flag("BLUEFOG_TPU_WIN_COALESCE", default=True),
            win_coalesce_linger_ms=float(env.get(
                "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS", "1.0")),
            win_coalesce_bytes=int(env.get("BLUEFOG_TPU_WIN_COALESCE_BYTES",
                                           str(1 << 20))),
            win_tx_queue=int(env.get("BLUEFOG_TPU_WIN_TX_QUEUE", "1024")),
            win_native=_flag("BLUEFOG_TPU_WIN_NATIVE", default=True),
            win_stripes=_int_or_auto("BLUEFOG_TPU_WIN_STRIPES", floor=1),
            win_decode_threads=_int_or_auto(
                "BLUEFOG_TPU_WIN_DECODE_THREADS", floor=0),
            win_retries=int(env.get("BLUEFOG_TPU_WIN_RETRIES", "1")),
            win_retry_backoff_ms=float(env.get(
                "BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS", "50")),
            win_timeout=float(env.get("BLUEFOG_TPU_WIN_TIMEOUT", "300")),
            trace_sample=_parse_trace_sample(
                env.get("BLUEFOG_TPU_TRACE_SAMPLE")),
            win_xla=_flag("BLUEFOG_TPU_WIN_XLA", default=True),
            fused_step=_flag("BLUEFOG_TPU_FUSED_STEP"),
            probe=_flag("BLUEFOG_TPU_PROBE", default=True),
            link_obs=_flag("BLUEFOG_TPU_LINK_OBS", default=True),
            slo=_validated_slo(env.get("BLUEFOG_TPU_SLO")),
            tune=_flag("BLUEFOG_TPU_TUNE"),
            tune_divergence=float(env.get("BLUEFOG_TPU_TUNE_DIVERGENCE",
                                          "3.0")),
            tune_dwell_steps=int(env.get("BLUEFOG_TPU_TUNE_DWELL_STEPS",
                                         "20")),
            async_mode=_flag("BLUEFOG_TPU_ASYNC"),
            async_staleness_steps=int(env.get(
                "BLUEFOG_TPU_ASYNC_STALENESS_STEPS", "0")),
            async_staleness_policy=_validated_staleness_policy(
                env.get("BLUEFOG_TPU_ASYNC_STALENESS_POLICY",
                        "reject").lower()),
            async_collect_every=int(env.get(
                "BLUEFOG_TPU_ASYNC_COLLECT_EVERY", "64")),
            churn=_flag("BLUEFOG_TPU_CHURN"),
            churn_heartbeat_ms=float(env.get(
                "BLUEFOG_TPU_CHURN_HEARTBEAT_MS", "250")),
            churn_suspect_ms=float(env.get(
                "BLUEFOG_TPU_CHURN_SUSPECT_MS", "1500")),
            churn_straggler_steps=int(env.get(
                "BLUEFOG_TPU_CHURN_STRAGGLER_STEPS", "0")),
            elastic_join=_flag("BLUEFOG_TPU_ELASTIC_JOIN"),
            gang_dir_path=env.get("BLUEFOG_TPU_GANG_DIR_PATH"),
            join_timeout_ms=float(env.get(
                "BLUEFOG_TPU_JOIN_TIMEOUT_MS", "30000")),
            chaos=env.get("BLUEFOG_TPU_CHAOS"),
            hier=_flag("BLUEFOG_TPU_HIER"),
            hier_outer_every=int(env.get("BLUEFOG_TPU_HIER_OUTER_EVERY",
                                         "1")),
            hier_inner=env.get("BLUEFOG_TPU_HIER_INNER", "exp2").lower(),
            hier_outer=env.get("BLUEFOG_TPU_HIER_OUTER", "exp2").lower(),
            hier_outer_compression=_validated_compression(
                env.get("BLUEFOG_TPU_HIER_OUTER_COMPRESSION",
                        "none").lower(),
                "BLUEFOG_TPU_HIER_OUTER_COMPRESSION"),
            hier_outer_self_weight=float(env.get(
                "BLUEFOG_TPU_HIER_OUTER_SELF_WEIGHT", "0.5")),
            sharded_gossip=_flag("BLUEFOG_TPU_SHARDED_GOSSIP", default=True),
            schedule_synth=_flag("BLUEFOG_TPU_SCHEDULE_SYNTH", default=True),
            schedule_synth_sketch=_validated_sketch(env.get(
                "BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH", "auto").lower()),
            placement=_flag("BLUEFOG_TPU_PLACEMENT", default=True),
            placement_iters=int(env.get("BLUEFOG_TPU_PLACEMENT_ITERS",
                                        "1000")),
            placement_round_budget=float(env.get(
                "BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET", "2.0")),
            fake_torus=env.get("BLUEFOG_TPU_FAKE_TORUS"),
            torus_wrap=env.get("BLUEFOG_TPU_TORUS_WRAP", "auto"))


_cfg: Optional[Config] = None


def get() -> Config:
    global _cfg
    if _cfg is None:
        _cfg = Config.from_env()
    return _cfg


def reload() -> Config:
    global _cfg
    _cfg = None
    return get()


@contextlib.contextmanager
def override(**fields):
    """The config with ``fields`` replaced, for the enclosed block (the
    benchmark's ``--compression`` of the window codec); ``os.environ`` is
    not touched, and the previous config comes back on exit."""
    global _cfg
    prev = get()
    _cfg = dataclasses.replace(prev, **fields)
    try:
        yield _cfg
    finally:
        _cfg = prev
