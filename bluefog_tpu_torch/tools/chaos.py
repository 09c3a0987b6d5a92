"""Chaos harness: kill a rank mid-gossip, watch the survivors re-form.

    python -m bluefog_tpu_torch.tools chaos [--np 4] [--steps 360] \
        [--kill-rank 3] [--kill-step 40] [--device cpu] [--smoke]

The port of ``bluefog_tpu/tools/chaos.py``: the same scenarios, flags,
defaults, ``CHAOS_RESULT`` records and verdicts, over the port's
``bfrun`` (``python -m bluefog_tpu_torch.run``), churn supervisor, gang
directory, async window mode, link observatory and tuner.  Each gang
process holds its window rows on the card unless ``--device cpu``
(processes beyond the machine's card count share the cards round robin);
there is no fallback to the CPU.  Where the JAX harness rides the jax
coordinator's key-value store, the port's rides the ``torch.distributed``
TCP store that process 0 hosts for the gang (``bfrun``'s rendezvous):
the gangs issue no collective after the rendezvous, so a dead peer
never hangs one.

Delay scenario (``--delay-smoke`` / ``--delay``): the same gang with a
``delay:`` fault instead of a kill, run TWICE — synchronous gossip (a
step barrier every step: the lockstep coupling the window family had
before async mode) and barrier-free async gossip (``BLUEFOG_TPU_ASYNC=1``
push-sum accumulates, bounded-staleness fold, exact-collect backstop).
Asserts the operational claim end to end:

  * sync mode DEGRADES toward the slowest rank: the survivors' step time
    during the fault rises to the delayed rank's cadence;
  * async mode holds survivor step throughput at the no-fault baseline
    (bounded ratio) — a straggler costs its contributions' freshness,
    not the fleet's throughput;
  * the delayed rank is NOT evicted when it is merely slow, even with
    ``BLUEFOG_TPU_CHURN_STRAGGLER_STEPS`` armed (the staleness policy,
    not membership, absorbs it — the widened async step-lag bound);
  * both modes reach the same consensus optimum (matched final loss):
    push-sum mass conservation holds through rejection + the backstop.

The step barrier rides the rendezvous store, like the exit barrier.

Link-observatory scenario (``--links-smoke`` / ``--links``): the async
gang again, but judged on the LINK OBSERVATORY instead of throughput — a
``linkdelay:`` fault holds one rank's outbound DATA links at +60 ms and
the harness asserts the affected edges' online delay EWMAs converge on
the injected delay while unaffected edges stay flat, measured-vs-modeled
divergence crosses the alert threshold, exactly the matching
``BLUEFOG_TPU_SLO`` rule fires on the receiver ranks (breach counter +
degraded ``/healthz`` links block + one flight-recorder dump) while a
co-armed quiet rule stays silent, every rank computes the identical
merged link matrix, and ``tools top`` renders one complete frame against
the live gang's real ``/metrics`` endpoints.

Self-tuning control-plane scenario (``--tune-smoke`` / ``--tune``): the
same async gang started on a DELIBERATELY wrong topology for the coming
fault — a full mesh, so a ``linkdelay:`` fault (which sleeps the sender
once per outbound DATA message) taxes the delayed rank once per peer per
step.  Run TWICE: with ``BLUEFOG_TPU_TUNE=1`` the tuner must measure the
hot edges, commit EXACTLY ONE numbered adaptation epoch that re-routes
onto a cheap topology and recover >= 2x of the lost gossip throughput
without a restart (``/healthz`` "tuner" block, ``tools top`` tune
column); with ``BLUEFOG_TPU_TUNE=0`` pinned, the same fault must leave
the schedule bitwise unchanged and register ZERO ``bf_tune_*`` series —
the default-off contract.

Elastic legs (``--join-smoke`` / ``--join-leg``, ``--kill0-smoke`` /
``--kill0-leg``): a coordinator-free gang (``bfrun --elastic``) loses a
process, and a fresh one joins through the persisted gang directory
(``bfrun --join @<prefix>``) and takes its seat by one grow epoch.

Kill scenario (the default): launches a multi-process gang under
``bfrun --chaos`` running a small decentralized-optimization workload
over the one-sided window path (each rank descends toward its own target
and neighbor-averages through ``win_put`` / ``win_update``), SIGKILLs one
rank mid-run, and asserts the churn controller's whole promise end to
end:

  * the survivors reach failure consensus and commit a new membership
    epoch WITHOUT a global restart (``bf_membership_changes_total``,
    ``/healthz`` "membership" block);
  * gossip re-plans onto a survivor-only topology (``set_topology``
    re-entered live; windows rebuilt from owned rows) within a bounded
    number of steps of the kill;
  * the run converges to the survivor-consensus optimum (the mean of the
    surviving ranks' targets — the same fixed point an uninterrupted
    survivor-only run reaches);
  * post-recovery step time stays within 1.5x the pre-failure median.

Why this workload shape: the gang rides ONLY the window transport (TCP)
for gossip and membership — the exact paths that keep working when the
gang is broken.  No collective is issued across processes after the
rendezvous, and the rendezvous store is used purely for barriers.

``--worker`` is the internal per-rank entry point ``bfrun`` launches; the
driver is what operators run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

__all__ = ["main", "build_parser"]

_RESULT_TAG = "CHAOS_RESULT "
# The chaos victim's unix clock at the top of the step it dies in (the
# start of every detection the drivers report).
_KILL_TAG = "CHAOS_KILL "


# ---------------------------------------------------------------------------
# Worker (one gang rank)
# ---------------------------------------------------------------------------

def _init_rendezvous(device: str) -> None:
    """``bf.init_distributed`` over bfrun's rendezvous, gloo for the
    rendezvous and its store (NCCL refuses two ranks on one card); the
    window rows live on ``device``.  On CUDA a process takes card
    ``BFTPU_LOCAL_ID`` modulo the machine's count, so a gang of more
    processes than cards shares them."""
    if os.environ.get("BFTPU_COORDINATOR") is None:
        raise SystemExit("chaos --worker must be launched under bfrun")
    import bluefog_tpu_torch as bf
    bf.init_distributed(backend="gloo", device=device)


def _store():
    """The rendezvous's key-value store (process 0 hosts it)."""
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _kv_get(key: str, timeout_ms: int) -> str:
    """Block until ``key`` is set (at most ``timeout_ms``) and read it."""
    import datetime
    store = _store()
    store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    return store.get(key).decode()


def _median_ms(samples) -> float:
    return float(statistics.median(samples)) * 1e3 if samples else 0.0


def _robust_window_ms(samples, parts: int = 3) -> float:
    """Load-robust step-time statistic (ms): the MIN over the window's
    sub-window medians.  A transient host-load burst on a shared CI box
    inflates at most one sub-window's median, so the min tracks the
    window's true uncontended cadence — while a STRUCTURAL slowdown (the
    sync leg's lockstep coupling, a genuinely delayed rank) inflates
    every sub-window and still shows at full size.  A single whole-window
    median was the delay leg's flake: one load lull or burst on either
    side of the ratio tipped the 3.0x / 1.5x bounds."""
    if not samples:
        return 0.0
    k = max(1, len(samples) // parts)
    meds = [statistics.median(samples[i:i + k])
            for i in range(0, len(samples), k)]
    return float(min(meds)) * 1e3


def _done_barrier(active_procs, my_proc: int, grace: float) -> None:
    """Two-phase exit ordering over the rendezvous store (no collective).
    Load-bearing for the gang's shutdown order: the store lives inside
    proc 0, and a survivor still waiting on it when proc 0 exits fails
    its wait — a fake casualty the harness would misread as churn.
    Phase 1: everyone announces its loop is done and waits for the other
    ACTIVE survivors (dead procs are exactly the ones that cannot answer,
    so they are never waited on).  Phase 2: non-store procs announce exit
    and leave immediately; proc 0 waits for those announcements and
    leaves LAST."""
    try:
        store = _store()
        others = [p for p in sorted(active_procs) if p != my_proc]
        store.set(f"bf/chaos_done/{my_proc}", "1")
        for p in others:
            _kv_get(f"bf/chaos_done/{p}", 60_000)
        if my_proc != 0:
            store.set(f"bf/chaos_exit/{my_proc}", "1")
            return
        for p in others:
            _kv_get(f"bf/chaos_exit/{p}", 30_000)
    except Exception as e:  # noqa: BLE001 — degrade to a plain grace sleep
        print(f"chaos worker: done-barrier degraded to sleep ({e})",
              file=sys.stderr, flush=True)
        time.sleep(grace)


def _healthz(port: int) -> dict:
    """This process's own ``/healthz`` over HTTP (503 when degraded —
    still JSON): the operator-facing surface, not the in-process dict."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode())


def worker_main(args) -> int:
    os.environ.setdefault("BLUEFOG_TPU_TELEMETRY", "1")
    from bluefog_tpu_torch.utils import config, telemetry
    config.reload()
    _init_rendezvous(args.device)
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    me = bf.rank()
    target = float(me)
    x = torch.full((args.dim,), target, dtype=torch.float32,
                   device=bf.device())
    name = "chaos_x"
    W.win_create(x[None].clone(), name, zero_init=True)
    sup = ChurnSupervisor()
    port = telemetry.start_http_server(0)

    x, times, recovery_step, view, put_errors, _epochs, changes = \
        _gossip_loop(args, sup, W, name, me, x, args.steps)
    info = sup.info()
    hz = _healthz(port)
    snap = telemetry.snapshot()
    # Pre-failure baseline: the steady window right BEFORE the kill, not
    # the whole prefix — the first dozens of steps are warm-up (drain
    # threads idle, heartbeats not yet flowing) and would understate the
    # baseline the 1.5x regression bound is judged against.
    pre = times[max(2, args.kill_step - 60):args.kill_step] \
        if args.kill_step < len(times) else times[2:]
    post = (times[recovery_step + 2:]
            if recovery_step is not None else [])
    print(_RESULT_TAG + json.dumps({
        "rank": me,
        "proc": bf.process_ranks().process,
        "epoch": info["epoch"],
        "active_ranks": info["active_ranks"],
        "changes_total": info["changes_total"],
        "evicted": bool(view.evicted if view is not None else False),
        "steps": len(times),
        "recovery_step": recovery_step,
        "x_mean": float(x.mean()),
        "put_errors": put_errors,
        "pre_median_ms": round(_median_ms(pre), 3),
        "post_median_ms": round(_median_ms(post), 3),
        # Per-50-step medians: the raw trend, so a failed regression bound
        # can be told apart from ambient host-load noise at a glance.
        "seg_ms": [round(_median_ms(times[i:i + 50]), 2)
                   for i in range(0, len(times), 50)],
        "recovery_observed":
            snap.get("bf_churn_recovery_seconds_count", 0) >= 1,
        "healthz_membership": hz.get("membership"),
        "changes": changes,
        "device": str(x.device),
    }), flush=True)
    # Exit in lockstep: heartbeats keep running while slower survivors
    # finish (finish-time skew must not read as churn), and proc 0 — the
    # rendezvous store's host — must leave LAST.
    evicted = bool(view is not None and view.evicted)
    active_procs = set() if evicted else {
        W._store.distrib.rank_owner[r] for r in info["active_ranks"]}
    sys.stdout.flush()
    sys.stderr.flush()
    _done_barrier(active_procs, bf.process_ranks().process, args.grace)
    # os._exit, not sys.exit: tearing down a process group that holds a
    # killed member would wait for it, and a non-store survivor must
    # leave with NOTHING between its exit announcement and the exit.
    os._exit(0)


def _parse_results(stdout: str) -> dict:
    """Collect every CHAOS_RESULT record from the gang's multiplexed
    stdout.  bfrun interleaves the processes' output: several records can
    land on ONE physical line (no newline in between) and a record can
    carry trailing bytes from another stream — split on the tag itself
    and raw_decode exactly one JSON object per fragment."""
    results = {}
    for line in stdout.splitlines():
        parts = line.split(_RESULT_TAG)
        for frag in parts[1:]:
            try:
                rec, _end = json.JSONDecoder().raw_decode(frag)
            except json.JSONDecodeError:
                continue  # torn record (process died mid-write)
            results[rec["rank"]] = rec
    return results


# ---------------------------------------------------------------------------
# Elastic gang workers (coordinator-free bootstrap + mid-run join)
# ---------------------------------------------------------------------------
# The join/kill0 legs run the SAME decentralized-optimization workload as
# the kill leg, but the gang bootstraps through ops/gang.py's replicated
# endpoint directory instead of the rendezvous: no process group at all,
# so killing rank 0's host removes one gossip peer, not the rendezvous
# store.  A fresh process joins mid-run (`bfrun --join
# @<prefix>`), is granted the vacant rank(s) placement-aware, and the gang
# commits exactly one grow epoch — convergence then targets the FULL-gang
# optimum again.


def _gossip_loop(args, sup, W, name, me, x, steps, step0=0,
                 deadline=None):
    """The shared descend + win_put + combine-what-you-have loop; returns
    (x, times, recovery_step, last_view, put_errors, epochs, changes),
    ``changes`` a ``[epoch, commit unix time, recovery seconds]`` a
    committed change.  A process that the chaos spec kills prints its
    unix clock (``CHAOS_KILL``) at the top of that step.

    ``deadline`` (unix seconds) aligns loop ENDS across the gang: the
    founding members and a late-admitted joiner start at different wall
    times, but everyone must stop gossiping together — a member that
    keeps descending against a joiner's frozen last value would drift
    off the consensus optimum the assertions check."""
    from bluefog_tpu_torch.utils.chaos import parse_chaos
    kills = {f.step for f in parse_chaos(os.environ.get(
        "BLUEFOG_TPU_CHAOS", "")) if f.kind == "kill" and f.rank == me}
    times = []
    recovery_step = None
    view = None
    put_errors = 0
    epochs = []
    changes = []
    target = float(me)
    seen_srcs = set()  # in-neighbors that have ever contributed gossip
    for step in range(step0, step0 + steps):
        if deadline is not None and time.time() >= deadline:
            break
        if step in kills:
            print(_KILL_TAG + json.dumps({"rank": me, "step": step,
                                          "unix": time.time()}), flush=True)
        t0 = time.perf_counter()
        change = sup.step(step)
        if change is not None:
            view = change
            epochs.append(change.epoch)
            changes.append([change.epoch, sup.ctrl.last_change_unix,
                            (sup.last_recovery or {}).get("seconds")])
            if change.evicted:
                break
            recovery_step = step
            seen_srcs.clear()  # fresh window, fresh staging
        # Local descent toward this rank's own target...
        x = x - args.lr * (x - target)
        # ...then asynchronous neighbor averaging: push my iterate to the
        # out-neighbors, combine whatever my in-neighbors have delivered so
        # far (combine-what-you-have: a neighbor whose put has not landed
        # yet simply sits this round out — no waiting, no barrier).
        try:
            W.win_put(x[None], name)
        except ConnectionError:
            put_errors += 1  # a dead peer not yet voted out
        seen_srcs.update(
            s for s, v in W.get_win_version(name, me).items() if v > 0)
        if seen_srcs:
            w = 1.0 / (len(seen_srcs) + 1)
            out = W.win_update(name, self_weight=w,
                               neighbor_weights={s: w for s in seen_srcs})
            x = out[0].float()
        times.append(time.perf_counter() - t0)
        if args.pace_ms:
            time.sleep(args.pace_ms / 1e3)
    return x, times, recovery_step, view, put_errors, epochs, changes


def _elastic_report(role, me, proc, sup, x, extra):
    """One CHAOS_RESULT record for the elastic legs (shared shape between
    founding members and the joiner)."""
    import bluefog_tpu_torch as bf
    info = sup.info()
    rec = {
        "role": role,
        "rank": me,
        "proc": proc,
        "epoch": info["epoch"],
        "active_ranks": info["active_ranks"],
        "changes_total": info["changes_total"],
        "x_mean": float(x.mean()),
        "gang": bf.gang_info(),
    }
    rec.update(extra)
    print(_RESULT_TAG + json.dumps(rec), flush=True)


def _publish_metrics_endpoint(proc: int) -> None:
    """Serve this process's ``/metrics`` and ``/healthz`` on an ephemeral
    port and write ``127.0.0.1:<port>`` beside the gang directory's
    replicas (``<prefix>.<proc>.metrics``): where the elastic driver
    finds the live gang's endpoints for one ``tools top`` frame."""
    from bluefog_tpu_torch.utils import config, telemetry
    prefix = config.get().gang_dir_path
    if not prefix:
        return
    port = telemetry.start_http_server(0)
    path = f"{prefix}.{proc}.metrics"
    with open(path + ".tmp", "w") as f:
        f.write(f"127.0.0.1:{port}")
    os.replace(path + ".tmp", path)


def _parse_kills(stdout: str) -> dict:
    """Every ``CHAOS_KILL`` record of the gang's stdout: rank -> unix."""
    kills = {}
    for line in stdout.splitlines():
        for frag in line.split(_KILL_TAG)[1:]:
            try:
                rec, _end = json.JSONDecoder().raw_decode(frag)
            except json.JSONDecodeError:
                continue
            kills[rec["rank"]] = rec["unix"]
    return kills


def _metrics_endpoints(prefix: str, procs) -> Optional[list]:
    """The published telemetry endpoints of ``procs``; None until every
    one has published."""
    eps = []
    for proc in sorted(procs):
        try:
            with open(f"{prefix}.{proc}.metrics") as f:
                eps.append(f.read().strip())
        except OSError:
            return None
    return eps


def _top_live_frame(prefix: str, procs, leg: str) -> dict:
    """Once the grow epoch has committed, one frame of ``python -m
    bluefog_tpu_torch.tools top --once`` against the endpoints of the
    gang's active ``procs`` (``_publish_metrics_endpoint``), printed; its
    line count, the endpoints up and the seconds it took."""
    eps = _metrics_endpoints(prefix, procs)
    print(f"chaos {leg}: gang live at the grow epoch, telemetry endpoints "
          f"{','.join(eps)}", flush=True)
    t0 = time.perf_counter()
    top = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools", "top", "--once",
         "--plain", "--endpoints", ",".join(eps)], env=_gang_env(),
        capture_output=True, text=True, timeout=60)
    frame = top.stdout.rstrip("\n")
    print(frame, flush=True)
    up = sum(1 for ep in eps for ln in frame.splitlines()
             if ln.startswith(ep) and " DOWN" not in ln)
    return {"rc": top.returncode, "lines": len(frame.splitlines()),
            "endpoints": len(eps), "up": up,
            "seconds": round(time.perf_counter() - t0, 3)}


def _process_start_unix() -> Optional[float]:
    """This process's start on the unix clock, from its start tick in
    ``/proc/self/stat`` against ``/proc/uptime`` (10 ms resolution); None
    where the system has no ``/proc``."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks /
                              os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def _admission_stamps(stderr: str) -> list:
    """The admission stamps (``gang._admission_stamp``) in a process's
    stderr, in order."""
    from bluefog_tpu_torch.ops.gang import ADMISSION_STAMP
    recs = []
    for ln in stderr.splitlines():
        i = ln.find(ADMISSION_STAMP)
        if i < 0:
            continue
        try:
            recs.append(json.loads(ln[i + len(ADMISSION_STAMP):]))
        except ValueError:
            continue
    return recs


def _admission_split(launch: float, deadline: float, join_stderr: str,
                     gang_stderr: str, members: dict) -> dict:
    """Where the joiner's seconds went: each admission stamp of the
    joiner as seconds after the join launch, the granting member's split
    of the request the joiner sent (its arrival after the launch, then
    the service pool taking it, the row snapshot and the send, after the
    arrival), and each side's margin to the gang's shared deadline: the
    joiner's entry into its gossip loop, and each member's grow commit.
    Both sides' stamps are on the log's info level, which the join leg
    sets unless ``BLUEFOG_TPU_LOG_LEVEL`` is set."""
    steps = []
    loop = None
    nonces = set()
    for rec in _admission_stamps(join_stderr):
        rec["s"] = round(rec.pop("unix") - launch, 4)
        steps.append(rec)
        if rec["step"] == "loop":
            loop = rec["s"]
        if rec["step"] == "join_req":
            nonces.add(rec.get("nonce"))
    at = {}
    for rec in _admission_stamps(gang_stderr):
        if rec.get("nonce") in nonces:
            at.setdefault(rec["step"], rec["unix"])
    grant = None
    if {"request", "pool", "rows", "sent"} <= set(at):
        rx = at["request"]
        grant = {"received_s": round(rx - launch, 4),
                 "pool_s": round(at["pool"] - rx, 4),
                 "rows_s": round(at["rows"] - rx, 4),
                 "sent_s": round(at["sent"] - rx, 4)}
    grows = [c[1] for _, r in sorted(members.items())
             for c in r.get("changes", []) if c[0] == 2 and c[1]]
    return {"steps": steps, "grant": grant,
            "deadline_s": round(deadline - launch, 4),
            "joiner_margin_s": (None if loop is None
                                else round(deadline - launch - loop, 4)),
            "members_margin_s": [round(deadline - g, 4) for g in grows]}


def _init_world(device: str) -> None:
    """``bf.init`` over the whole virtual world (``BFTPU_LOCAL_DEVICES``,
    which ``bfrun --elastic`` / ``--join`` sets to the world's rank
    count): rank ownership is per process, through the gang directory."""
    import bluefog_tpu_torch as bf
    bf.init(int(os.environ.get("BFTPU_LOCAL_DEVICES", "1")),
            device=device)


def elastic_worker_main(args) -> int:
    """One FOUNDING member of a coordinator-free gang: bootstraps from the
    pre-assigned endpoint list (``bfrun --elastic``), never joins the
    rendezvous, serves join grants, and survives any peer's death — rank
    0's included."""
    os.environ.setdefault("BLUEFOG_TPU_TELEMETRY", "1")
    import torch

    from bluefog_tpu_torch.ops import gang
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    from bluefog_tpu_torch.utils import config
    config.reload()
    _init_world(args.device)
    gang.init_elastic()
    d = W._store.distrib
    me = d.my_rank
    import bluefog_tpu_torch as bf
    x = torch.full((args.dim,), float(me), dtype=torch.float32,
                   device=bf.device())
    name = "gang_x"
    W.win_create(x[None].clone(), name, zero_init=True)
    sup = ChurnSupervisor()
    _publish_metrics_endpoint(d.my_proc)
    x, times, recovery_step, view, put_errors, epochs, changes = \
        _gossip_loop(args, sup, W, name, me, x, args.steps,
                     deadline=args.deadline)
    evicted = bool(view is not None and view.evicted)
    pre = times[max(2, args.kill_step - 60):args.kill_step] \
        if args.kill_step < len(times) else times[2:]
    post = (times[recovery_step + 2:]
            if recovery_step is not None else [])
    _elastic_report("member", me, d.my_proc, sup, x, {
        "evicted": evicted,
        "steps": len(times),
        "recovery_step": recovery_step,
        "epochs": epochs,
        "put_errors": put_errors,
        "pre_median_ms": round(_median_ms(pre), 3),
        "post_median_ms": round(_median_ms(post), 3),
        "changes": changes,
        "device": str(x.device),
    })
    sys.stdout.flush()
    sys.stderr.flush()
    # No coordinator, no exit barrier needed: keep heartbeating (and
    # serving gossip) through the grace window so slower finishers — the
    # late-admitted joiner above all — converge before we disappear.
    time.sleep(args.grace)
    os._exit(0)


def join_worker_main(args) -> int:
    """The JOINING process: contacts any live member through the persisted
    directory (``BFTPU_GANG_JOIN=@<prefix>``), waits for the grow epoch to
    commit, creates its windows from the granted owned-row snapshot, and
    gossips as a full member from then on."""
    from bluefog_tpu_torch.ops.gang import _admission_stamp
    started = _process_start_unix()
    if started is not None:
        _admission_stamp("process", unix=started)
    _admission_stamp("main")
    os.environ.setdefault("BLUEFOG_TPU_TELEMETRY", "1")
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import gang
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    from bluefog_tpu_torch.utils import config
    _admission_stamp("import")
    config.reload()
    _init_world(args.device)
    _admission_stamp("init_world")
    # The CUDA context, which the transport's pinned rows and the grant's
    # rows on the card need, as a step of its own.
    torch.zeros(1, device=bf.device())
    _admission_stamp("device_context")
    target_spec = os.environ.get("BFTPU_GANG_JOIN")
    if not target_spec:
        raise SystemExit("chaos --role joiner needs BFTPU_GANG_JOIN "
                         "(launch through `bfrun --join`)")
    grant = gang.join_gang(target_spec)
    _publish_metrics_endpoint(grant.proc)
    sup = ChurnSupervisor()
    admitted_after = None
    t0 = time.monotonic()
    step = 0
    view = None
    while time.monotonic() - t0 < args.join_wait:
        change = sup.step(step)
        if change is not None:
            view = change
        step += 1
        if not sup.ctrl.joining:
            admitted_after = round(time.monotonic() - t0, 3)
            _admission_stamp("admitted")
            break
        time.sleep(0.05)
    me = min(grant.ranks)
    if admitted_after is None:
        _elastic_report("joiner", me, grant.proc, sup, torch.zeros(1),
                        {"admitted": False, "steps": 0})
        sys.stdout.flush()
        os._exit(1)
    # The grow epoch is committed and the survivor topology re-planned
    # (sup.step ran the growth recovery): materialize the windows from
    # the grant's owned-row snapshot — a survivor's consensus estimate —
    # and gossip as an ordinary member.  Peers' puts that raced ahead of
    # win_create were parked and replay in arrival order.
    name = "gang_x"
    w = grant.windows.get(name)
    if w is None:
        rows = torch.zeros((len(grant.ranks), args.dim), dtype=torch.float32,
                           device=bf.device())
    else:
        rows = torch.stack([w["rows"][r] for r in sorted(grant.ranks)])
    W.win_create(rows.clone(), name, zero_init=True)
    x = rows[0].float().clone()
    _admission_stamp("loop")
    print(f"chaos joiner: entering gossip loop at {time.time():.3f} "
          f"(deadline {args.deadline}, steps cap {args.steps}, "
          f"step0 {step})", file=sys.stderr, flush=True)
    x2, times, _rec, view, put_errors, epochs, changes = _gossip_loop(
        args, sup, W, name, me, x, args.steps, step0=step,
        deadline=args.deadline)
    _elastic_report("joiner", me, grant.proc, sup, x2, {
        "admitted": True,
        "admitted_after_sec": admitted_after,
        "grant_epoch": grant.epoch,
        "granted_ranks": list(grant.ranks),
        "evicted": bool(view is not None and view.evicted),
        "steps": len(times),
        "epochs": epochs,
        "put_errors": put_errors,
        "changes": changes,
        "device": str(x2.device),
    })
    sys.stdout.flush()
    sys.stderr.flush()
    time.sleep(min(args.grace, 2.0))
    os._exit(0)


def run_elastic_demo(args, kill_rank: int) -> int:
    """Driver for the join and kill-rank-0 legs: launch a coordinator-free
    gang under ``bfrun --elastic --chaos kill:...``, wait for the shrink
    epoch to land in the persisted directory, then admit a replacement
    through ``bfrun --join @<prefix>`` and judge the whole promise:

      * the gang survives the kill (rank 0's included — no coordinator);
      * the directory serves the joiner's bootstrap from disk;
      * exactly ONE grow epoch commits (epoch 2: shrink then grow);
      * every member — the joiner included — converges to the FULL-gang
        optimum (matched final loss vs a never-shrunk run).
    """
    import tempfile

    from bluefog_tpu_torch.ops.gang import GangDirectory
    n = args.np
    spec = f"kill:rank={kill_rank}:step={args.kill_step}"
    survivors = sorted(set(range(n)) - {kill_rank})
    tmpdir = tempfile.mkdtemp(prefix="bf-gang-demo-")
    prefix = os.path.join(tmpdir, "gang")
    env = _gang_env()
    env.update({
        "BLUEFOG_TPU_CHURN": "1",
        "BLUEFOG_TPU_ELASTIC_JOIN": "1",
        "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
        "BLUEFOG_TPU_CHURN_SUSPECT_MS": "500",
        "BLUEFOG_TPU_WIN_RETRIES": "1",
        "BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS": "25",
        "BLUEFOG_TPU_TELEMETRY": "1",
    })
    # The joiner's and its granting member's admission stamps
    # (`_admission_split`) are on the info level.
    env.setdefault("BLUEFOG_TPU_LOG_LEVEL", "info")
    # Everyone — founding members and the late joiner — stops gossiping
    # at one shared wall-clock deadline, so the final iterates are a
    # joint consensus snapshot, not a race against exit skew.
    deadline = time.time() + args.run_sec
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(n),
           "--devices-per-proc", "1", "--elastic", "--gang-dir", prefix,
           "--chaos", spec, "--",
           sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
           "--worker", "--device", args.device, "--role", "member",
           "--steps", str(args.steps), "--dim", str(args.dim),
           "--lr", str(args.lr), "--pace-ms", str(args.pace_ms),
           "--grace", str(args.grace), "--kill-step", str(args.kill_step),
           "--deadline", repr(deadline)]
    leg = "kill-rank-0" if kill_rank == 0 else "join"
    print(f"chaos {leg}: launching {n}-process coordinator-free gang, "
          f"{spec} ({args.steps} steps, directory @{prefix})...",
          flush=True)
    t_start = time.perf_counter()
    # Output to FILES, not pipes: the driver must keep polling the
    # directory while the gang runs, and four ranks' stderr would fill a
    # pipe long before the run ends.
    gang_out = open(os.path.join(tmpdir, "gang.out"), "w+")
    gang_err = open(os.path.join(tmpdir, "gang.err"), "w+")
    gang_proc = subprocess.Popen(cmd, env=env, stdout=gang_out,
                                 stderr=gang_err, text=True)
    failures = []
    join_results = {}
    join_launch = None
    join_stderr = ""
    top_info = None
    try:
        # Phase 1: the kill lands and the survivors commit the shrink
        # epoch — observable from OUTSIDE through the persisted replicas.
        poll_deadline = time.monotonic() + args.timeout / 2
        shrunk = False
        while time.monotonic() < poll_deadline:
            if gang_proc.poll() is not None:
                break
            try:
                merged = GangDirectory.load_any(prefix)
                if merged.epoch >= 1 and merged.vacant_ranks():
                    shrunk = True
                    break
            except (FileNotFoundError, OSError):
                pass
            time.sleep(0.2)
        if not shrunk:
            _fail(failures, "the persisted gang directory never reached a "
                            "committed shrink epoch with a vacant rank")
        else:
            # Phase 2: admit a replacement through the directory — the
            # exact bootstrap path an operator's replacement pod takes.
            join_cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np",
                        "1", "--devices-per-proc", str(n),
                        "--join", f"@{prefix}", "--gang-dir", prefix,
                        "--",
                        sys.executable, "-m", "bluefog_tpu_torch.tools",
                        "chaos", "--worker", "--device", args.device,
                        "--role", "joiner",
                        "--steps", str(args.steps),
                        "--dim", str(args.dim), "--lr", str(args.lr),
                        "--pace-ms", str(args.pace_ms),
                        "--grace", str(args.grace),
                        "--join-wait", str(args.join_wait),
                        "--deadline", repr(deadline)]
            join_out = open(os.path.join(tmpdir, "join.out"), "w+")
            join_err = open(os.path.join(tmpdir, "join.err"), "w+")
            join_launch = time.time()
            join_proc = subprocess.Popen(join_cmd, env=env, stdout=join_out,
                                         stderr=join_err, text=True)
            # While the joiner runs: once the grow epoch has committed (in
            # the persisted directory), one `tools top` frame against the
            # live gang.
            join_deadline = time.monotonic() + args.timeout / 2
            while join_proc.poll() is None and top_info is None \
                    and time.monotonic() < join_deadline:
                try:
                    merged = GangDirectory.load_any(prefix)
                    if merged.epoch >= 2 and not merged.vacant_ranks() \
                            and _metrics_endpoints(prefix, merged.active):
                        top_info = _top_live_frame(prefix, merged.active,
                                                   leg)
                except (FileNotFoundError, OSError, ValueError):
                    pass
                time.sleep(0.2)
            try:
                join_rc = join_proc.wait(
                    timeout=max(1.0, join_deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                join_proc.kill()
                join_rc = join_proc.wait(timeout=30)
            join_out.seek(0)
            join_results = _parse_results(join_out.read())
            join_err.seek(0)
            join_stderr = join_err.read()
            join_out.close()
            join_err.close()
            if join_rc != 0:
                _fail(failures, f"join bfrun exited {join_rc}")
        rc = gang_proc.wait(timeout=args.timeout)
        if rc != 0:
            _fail(failures, f"gang bfrun exited {rc} (the chaos kill must "
                            "be tolerated, any other failure is real)")
    finally:
        if gang_proc.poll() is None:
            gang_proc.kill()
            gang_proc.wait(timeout=30)
        gang_out.seek(0)
        gang_stdout = gang_out.read()
        gang_err.seek(0)
        gang_stderr = gang_err.read()
        gang_out.close()
        gang_err.close()
    wall = time.perf_counter() - t_start
    results = _parse_results(gang_stdout)
    members = {r: v for r, v in results.items()
               if v.get("role") == "member"}
    joiners = [v for v in join_results.values()
               if v.get("role") == "joiner"]
    if sorted(members) != survivors:
        _fail(failures, f"expected member reports from survivors "
                        f"{survivors}, got {sorted(members)}")
    if not joiners:
        _fail(failures, "no report from the joining process")
    # Full-gang optimum: the joiner revives the killed rank's seat (and
    # its target), so the network optimum is the NEVER-SHRUNK mean.
    target_mean = sum(range(n)) / n
    reports = ([(f"rank {r} (member)", v) for r, v in sorted(
        members.items())]
        + [(f"rank {v.get('rank')} (joiner)", v) for v in joiners])
    for label, r in reports:
        line = (f"  {label}: epoch {r['epoch']}, active "
                f"{r['active_ranks']}, x_mean {r['x_mean']:.4f} "
                f"(target {target_mean:.4f}), changes "
                f"{r['changes_total']}")
        if r.get("admitted_after_sec") is not None:
            line += f", admitted after {r['admitted_after_sec']}s"
        line += f", {r.get('steps', '?')} steps"
        if r.get("device"):
            line += f", rows on {r['device']}"
        print(line, flush=True)
        if r.get("evicted"):
            _fail(failures, f"{label}: evicted")
        # Exactly one shrink + exactly one grow epoch, gang-wide (the
        # joiner entered at the shrink epoch, so it sees one commit).
        want_changes = 2 if r.get("role") == "member" else 1
        if r["epoch"] != 2 or r["changes_total"] != want_changes:
            _fail(failures,
                  f"{label}: expected exactly one shrink + one grow "
                  f"epoch (epoch 2, {want_changes} change(s)), got epoch "
                  f"{r['epoch']} with {r['changes_total']} changes")
        if sorted(r["active_ranks"]) != list(range(n)):
            _fail(failures,
                  f"{label}: final active ranks {r['active_ranks']} != "
                  f"the full gang {list(range(n))}")
        if abs(r["x_mean"] - target_mean) > args.loss_tol:
            _fail(failures,
                  f"{label}: consensus {r['x_mean']:.4f} is "
                  f"{abs(r['x_mean'] - target_mean):.4f} from the "
                  f"full-gang optimum {target_mean:.4f} "
                  f"(tol {args.loss_tol})")
    for v in joiners:
        if not v.get("admitted"):
            _fail(failures, "the joiner was never admitted (no grow "
                            "epoch committed)")
        elif sorted(v.get("granted_ranks", [])) != [kill_rank]:
            _fail(failures,
                  f"joiner was granted {v.get('granted_ranks')}, expected "
                  f"the vacant rank [{kill_rank}]")
    # Reported, not judged (the JAX harness reports neither): detection,
    # the victim's clock at its kill to each member's shrink commit, and
    # the members' recovery seconds; the live `tools top` frame.
    kill_unix = _parse_kills(gang_stdout).get(kill_rank)
    shrinks = [r["changes"][0] for _, r in sorted(members.items())
               if r.get("changes")]
    detection = ([round(c[1] - kill_unix, 4) for c in shrinks]
                 if kill_unix else None)
    print(f"chaos {leg}: detection {detection}"
          f" s (the kill to each member's shrink commit), recovery "
          f"{[round(c[2], 4) for c in shrinks if c[2] is not None]} s, "
          f"joiner admitted after "
          f"{[v.get('admitted_after_sec') for v in joiners]} s", flush=True)
    if join_launch is not None:
        split = _admission_split(join_launch, deadline, join_stderr,
                                 gang_stderr, members)
        print(f"chaos {leg}: admission split {json.dumps(split)}",
              flush=True)
    if top_info is not None:
        print(f"chaos {leg}: tools top rendered {top_info['lines']} lines, "
              f"{top_info['up']}/{top_info['endpoints']} endpoints up "
              f"(rc {top_info['rc']}, {top_info['seconds']} s)", flush=True)
    if failures:
        print(f"\nchaos {leg} FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        tail = "\n".join(gang_stderr.splitlines()[-40:])
        print(f"\ngang stderr tail:\n{tail}", file=sys.stderr)
        jtail = "\n".join(join_stderr.splitlines()[-25:])
        if jtail:
            print(f"\njoiner stderr tail:\n{jtail}", file=sys.stderr)
        return 1
    import shutil
    shutil.rmtree(tmpdir, ignore_errors=True)
    print(f"chaos {leg} OK: rank {kill_rank} killed at step "
          f"{args.kill_step}, survivors committed the shrink, a fresh "
          f"process bootstrapped from the directory, took rank "
          f"{kill_rank} via one grow epoch, and the gang converged to "
          f"the full-gang optimum {target_mean:.3f} (wall {wall:.1f}s)",
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# Delay-scenario worker (sync vs async gossip under a straggler fault)
# ---------------------------------------------------------------------------

def _kv_barrier(tag: str, my_proc: int, n: int,
                timeout_ms: int = 180_000) -> None:
    """All-process rendezvous over the rendezvous store (the chaos gangs
    never issue a collective after the rendezvous).  ``tag`` must be
    unique per barrier instance."""
    _store().set(f"bf/sbar/{tag}/{my_proc}", "1")
    for p in range(n):
        if p != my_proc:
            _kv_get(f"bf/sbar/{tag}/{p}", timeout_ms)


def _push_sum_setup(name: str, args, full_mesh: bool = False):
    """The push-sum gangs' common start (the delay, links and tune
    workers): the rendezvous, the full mesh with ``full_mesh``,
    associated P on, and a window whose exposed memory holds this rank's
    starting value (P = 1)."""
    os.environ.setdefault("BLUEFOG_TPU_TELEMETRY", "1")
    from bluefog_tpu_torch.utils import config
    config.reload()
    _init_rendezvous(args.device)
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topology_util
    from bluefog_tpu_torch.ops import window as W
    me = bf.rank()
    if full_mesh:
        bf.set_topology(topology_util.FullyConnectedGraph(bf.size()),
                        is_weighted=True)
    W.turn_on_win_ops_with_associated_p()
    x = torch.full((args.dim,), float(me), dtype=torch.float32,
                   device=bf.device())
    W.win_create(torch.zeros((1, args.dim), dtype=torch.float32,
                             device=bf.device()), name, zero_init=True)
    win = W._store.get(name)
    with win.lock:
        win.main[me].copy_(x)
    return bf, W, me, x


def delay_worker_main(args) -> int:
    """One rank of the delay-scenario gang: scalar push-sum consensus
    over ``win_accumulate`` / ``win_update_then_collect`` (owned layout,
    associated-P on), descending toward this rank's own target — the
    network optimum is the mean of the targets, so the final de-biased
    value is the matched-loss oracle both modes must reach.

    ``--mode sync``: a store step barrier EVERY step — lockstep gossip,
    the whole gang steps at the slowest rank's cadence.  ``--mode
    async``: no per-step barrier; the only rendezvous is the
    exact-collect backstop every ``BLUEFOG_TPU_ASYNC_COLLECT_EVERY``
    steps (flush + barrier + stale-residual fold), mirroring the
    optimizer family's backstop."""
    name = "delay_x"
    bf, W, me, x = _push_sum_setup(name, args)
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    from bluefog_tpu_torch.utils import config, telemetry
    nproc = bf.process_ranks().nprocs
    my_proc = bf.process_ranks().process
    target = float(me)
    sup = ChurnSupervisor()
    outs = sorted(bf.out_neighbor_ranks(me))
    share = 1.0 / (len(outs) + 1.0)
    dst_w = {o: share for o in outs}
    every = config.get().async_collect_every if args.mode == "async" else 0

    def settle(tag):
        """Flush + rendezvous + drain-settle + residual fold: the chaos
        gang's stand-in for win_fence (whose trailing barrier is a
        collective these gangs do not issue)."""
        W.win_flush()
        _kv_barrier(tag, my_proc, nproc)
        time.sleep(0.05)    # peers' blocking sends are on TCP; let the
        _kv_barrier(tag + "b", my_proc, nproc)  # drain threads apply
        W.win_fold_stale_residuals(name)

    times = []
    view = None
    for step in range(args.steps):
        t0 = time.perf_counter()
        change = sup.step(step)
        if change is not None:
            view = change
            if change.evicted:
                break
        if args.mode == "async":
            # Publish the step clock (what the optimizer family's
            # _async_step_begin does): trace tags carry it as the origin
            # step, so receivers age this rank's gossip exactly.
            W.set_async_step(step)
            telemetry.set_gauge("bf_async_step_lag",
                                float(W.async_step_lag()), rank=str(me))
        # Subgradient-push: descend the numerator at the de-biased point,
        # then one column-stochastic accumulate round + collect.
        p = max(W.win_associated_p(name, me), 1e-3)
        z = x / p
        x = x - args.lr * (z - target) * p
        W.win_accumulate(x[None], name, self_weight=share,
                         dst_weights=dst_w)
        if args.mode == "sync":
            _kv_barrier(f"s{step}", my_proc, nproc)
        elif every and (step + 1) % every == 0:
            settle(f"c{step}")
        x = W.win_update_then_collect(name)[0].clone()
        times.append(time.perf_counter() - t0)
        if args.pace_ms:
            time.sleep(args.pace_ms / 1e3)

    evicted = bool(view is not None and view.evicted)
    info = sup.info()
    if not evicted:
        # Final exact collect: after the settle nothing is in flight and
        # every policy-held residual is folded, so the de-biased value is
        # the exact conserved estimate (the matched-loss oracle).
        settle("final")
        x = W.win_update_then_collect(name)[0].clone()
    z = x / max(W.win_associated_p(name, me), 1e-3)
    snap = telemetry.snapshot()
    stale = {k: v for k, v in snap.items()
             if k.startswith("bf_win_stale_")}
    lo, hi = args.fault_step, args.fault_step + args.fault_steps
    pre = times[max(2, lo - 40):lo]
    fault = times[lo:hi]
    # Min-of-sub-medians, not one whole-window median: both sides get the
    # same load-burst filtering, so the sync/async ratio bounds judge the
    # structural coupling, not ambient CI noise (see _robust_window_ms).
    pre_ms = _robust_window_ms(pre)
    fault_ms = _robust_window_ms(fault)
    print(_RESULT_TAG + json.dumps({
        "rank": me,
        "proc": my_proc,
        "mode": args.mode,
        "epoch": info["epoch"],
        "changes_total": info["changes_total"],
        "active_ranks": info["active_ranks"],
        "evicted": evicted,
        "steps": len(times),
        "z_mean": float(z.mean()),
        "pre_median_ms": round(pre_ms, 3),
        "fault_median_ms": round(fault_ms, 3),
        "stale_counters": stale,
        "async_step_lag": snap.get(f'bf_async_step_lag{{rank="{me}"}}'),
        "device": str(x.device),
    }), flush=True)
    active_procs = set() if evicted else set(range(nproc))
    sys.stdout.flush()
    sys.stderr.flush()
    _done_barrier(active_procs, my_proc, args.grace)
    os._exit(0)


def run_delay_demo(args) -> int:
    """Launch the delay gang twice — sync then async — and judge the
    tentpole's operational claims (see the worker docstring)."""
    n = args.np
    delay_rank = (n - 1) if args.delay_rank is None else args.delay_rank
    if delay_rank == 0:
        raise SystemExit("chaos: rank 0 hosts the rendezvous store; "
                         "delay any other rank")
    spec = (f"delay:rank={delay_rank}:step={args.fault_step}"
            f":steps={args.fault_steps}:ms={args.delay_ms}")
    target_mean = sum(range(n)) / n

    def leg(mode):
        cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(n),
               "--devices-per-proc", "1", "--chaos", spec, "--",
               sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
               "--worker", "--device", args.device, "--mode", mode,
               "--steps", str(args.steps), "--dim", str(args.dim),
               "--lr", str(args.lr), "--pace-ms", str(args.pace_ms),
               "--grace", str(args.grace),
               "--fault-step", str(args.fault_step),
               "--fault-steps", str(args.fault_steps)]
        env = _gang_env()
        env.update({
                "BLUEFOG_TPU_CHURN": "1",
            "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
            "BLUEFOG_TPU_CHURN_SUSPECT_MS": "800",
            "BLUEFOG_TPU_TELEMETRY": "1",
            # Step-lag eviction ARMED: the async leg must prove a
            # merely-slow rank survives it (the widened bound).
            "BLUEFOG_TPU_CHURN_STRAGGLER_STEPS": "10",
            "BLUEFOG_TPU_TRACE_SAMPLE": "2",
        })
        if mode == "async":
            env.update({
                "BLUEFOG_TPU_ASYNC": "1",
                "BLUEFOG_TPU_ASYNC_STALENESS_STEPS": "8",
                "BLUEFOG_TPU_ASYNC_STALENESS_POLICY": "reject",
                "BLUEFOG_TPU_ASYNC_COLLECT_EVERY":
                    str(args.collect_every),
            })
        else:
            env.pop("BLUEFOG_TPU_ASYNC", None)
        print(f"chaos delay: launching {n}-process {mode} gang, {spec} "
              f"({args.steps} steps)...", flush=True)
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=args.timeout)
        return proc, _parse_results(proc.stdout)

    failures = []
    t0 = time.perf_counter()
    legs = {mode: leg(mode) for mode in ("sync", "async")}
    wall = time.perf_counter() - t0
    floor = args.pace_ms + 2.0
    survivor_ratio = {}
    for mode, (proc, results) in legs.items():
        if proc.returncode != 0:
            _fail(failures, f"{mode}: bfrun exited {proc.returncode}")
            print(f"\n{mode} gang stderr tail:\n"
                  + "\n".join(proc.stderr.splitlines()[-30:]),
                  file=sys.stderr)
            continue
        if sorted(results) != list(range(n)):
            _fail(failures, f"{mode}: expected reports from all {n} ranks,"
                            f" got {sorted(results)}")
            continue
        ratios = []
        for rank, r in sorted(results.items()):
            line = (f"  [{mode}] rank {rank}: step ms pre/fault "
                    f"{r['pre_median_ms']:.2f}/{r['fault_median_ms']:.2f},"
                    f" z_mean {r['z_mean']:.4f} (target {target_mean:.4f})"
                    f", epoch {r['epoch']}"
                    + (f", lag {r['async_step_lag']}"
                       if r.get("async_step_lag") is not None else ""))
            print(line, flush=True)
            # Matched final loss: both modes reach the consensus optimum.
            if abs(r["z_mean"] - target_mean) > args.loss_tol:
                _fail(failures,
                      f"{mode} rank {rank}: consensus {r['z_mean']:.4f} "
                      f"is {abs(r['z_mean'] - target_mean):.4f} from the "
                      f"optimum {target_mean:.4f} (tol {args.loss_tol})")
            # The merely-slow rank must never be voted out — in EITHER
            # mode (async proves the widened step-lag bound).
            if r["evicted"] or r["epoch"] != 0 or r["changes_total"] != 0:
                _fail(failures,
                      f"{mode} rank {rank}: membership changed (epoch "
                      f"{r['epoch']}, changes {r['changes_total']}, "
                      f"evicted {r['evicted']}) — a merely-slow rank was "
                      "treated as churn")
            if rank != delay_rank:
                pre = max(r["pre_median_ms"], floor)
                ratios.append(max(r["fault_median_ms"], floor) / pre)
        if ratios:
            survivor_ratio[mode] = max(ratios)
    if "sync" in survivor_ratio and "async" in survivor_ratio:
        sr, ar = survivor_ratio["sync"], survivor_ratio["async"]
        print(f"chaos delay: survivor fault/pre step-time ratio — "
              f"sync {sr:.2f}x vs async {ar:.2f}x "
              f"(delay {args.delay_ms}ms, pace {args.pace_ms}ms)",
              flush=True)
        # Sync gossip degrades toward the slowest rank's cadence...
        if sr < args.sync_degrade:
            _fail(failures,
                  f"sync survivors did not degrade (ratio {sr:.2f}x < "
                  f"{args.sync_degrade}x) — the lockstep leg is not "
                  "measuring the coupling")
        # ...while async survivors hold the no-fault baseline.
        if ar > args.async_ratio:
            _fail(failures,
                  f"async survivors degraded {ar:.2f}x > bound "
                  f"{args.async_ratio}x — barrier-free gossip is not "
                  "holding throughput under the straggler")
        async_results = legs["async"][1]
        if not any(r.get("stale_counters")
                   for r in async_results.values()):
            _fail(failures,
                  "async leg never exercised the staleness policy (no "
                  "bf_win_stale_* counters ticked) — the bound/delay "
                  "parameters are not producing stale contributions")
    if failures:
        print("\nchaos delay FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print(f"chaos delay OK: rank {delay_rank} delayed "
          f"{args.delay_ms}ms x {args.fault_steps} steps — sync degraded "
          f"{survivor_ratio['sync']:.2f}x, async held "
          f"{survivor_ratio['async']:.2f}x, no eviction, matched loss "
          f"(wall {wall:.1f}s)", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Link-observatory scenario (linkdelay fault -> online estimator + SLO)
# ---------------------------------------------------------------------------

def _top_frame(nproc: int, key: str):
    """One COMPLETE ``tools top`` frame against every rank's live
    endpoint (their ports from the store): ``(polls, frame)``."""
    from bluefog_tpu_torch.tools import top as topmod
    eps = [f"127.0.0.1:{_kv_get(f'bf/{key}/{pp}', 60_000)}"
           for pp in range(nproc)]
    polls = {ep: topmod.scrape(ep, timeout=10.0) for ep in eps}
    return polls, topmod.render_frame(polls)


def _exchange_link_rows(tag: str, my_proc: int, nproc: int, rows: dict,
                        timeout_ms: int = 120_000) -> list:
    """Ship my ``bf_link_*`` rows through the store; every process's, in
    process order."""
    _store().set(f"bf/{tag}/{my_proc}", json.dumps(rows))
    return [rows if pp == my_proc else json.loads(
        _kv_get(f"bf/{tag}/{pp}", timeout_ms)) for pp in range(nproc)]


def links_worker_main(args) -> int:
    """One rank of the link-observatory gang: the same barrier-free
    push-sum workload as the async delay leg, with every wire message
    trace-tagged (``BLUEFOG_TPU_TRACE_SAMPLE=1``) so the link
    observatory's online per-edge estimator runs dense.  A ``linkdelay``
    chaos fault holds one rank's outbound DATA links at +``ms`` from
    ``fault_step`` to the END of the run; mid-fault this worker captures
    its ``/healthz`` links block and SLO latch (and proc 0 renders one
    live ``tools top`` frame against every rank's real ``/metrics``
    endpoint), and at the end every rank ships its ``bf_link_*``
    snapshot through the store and computes the IDENTICAL merged link
    matrix — the gauge-MAX merge ``bf.link_report()`` performs over the
    aggregate-snapshot collective on a real gang."""
    name = "links_x"
    bf, W, me, x = _push_sum_setup(name, args)
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    from bluefog_tpu_torch.utils import config, linkobs, telemetry
    nproc = bf.process_ranks().nprocs
    my_proc = bf.process_ranks().process
    target = float(me)
    sup = ChurnSupervisor()
    outs = sorted(bf.out_neighbor_ranks(me))
    share = 1.0 / (len(outs) + 1.0)
    dst_w = {o: share for o in outs}
    every = config.get().async_collect_every
    port = telemetry.start_http_server(0)
    _store().set(f"bf/links_port/{my_proc}", str(port))

    def settle(tag):
        W.win_flush()
        _kv_barrier(tag, my_proc, nproc)
        time.sleep(0.05)
        _kv_barrier(tag + "b", my_proc, nproc)
        W.win_fold_stale_residuals(name)

    # Mid-fault capture point: late enough that the exact-collect
    # backstop has coupled the gang at least once inside the fault
    # window (so the receivers' delay EWMAs have fed on many delayed
    # messages), early enough that the fault is still engaged.
    capture_step = args.fault_step + args.fault_steps - 5
    hz_mid = slo_mid = None
    top_ok = None
    top_lines = 0
    view = None
    steps_run = 0
    for step in range(args.steps):
        change = sup.step(step)
        if change is not None:
            view = change
            if change.evicted:
                break
        W.set_async_step(step)
        telemetry.set_gauge("bf_async_step_lag",
                            float(W.async_step_lag()), rank=str(me))
        p = max(W.win_associated_p(name, me), 1e-3)
        z = x / p
        x = x - args.lr * (z - target) * p
        W.win_accumulate(x[None], name, self_weight=share,
                         dst_weights=dst_w)
        if every and (step + 1) % every == 0:
            settle(f"c{step}")
        x = W.win_update_then_collect(name)[0].clone()
        steps_run += 1
        if step == capture_step:
            hz = _healthz(port)
            hz_mid = {"status": hz.get("status"),
                      "links": hz.get("links")}
            slo_mid = linkobs.slo_state()
            if my_proc == 0:
                # The dashboard leg: one COMPLETE frame against every
                # rank's live endpoint, mid-fault.
                polls, frame = _top_frame(nproc, "links_port")
                up = sum(1 for mh in polls.values()
                         if mh[0] is not None)
                top_ok = bool(up == nproc and "link matrix" in frame
                              and "DOWN" not in frame)
                top_lines = len(frame.splitlines())
        if args.pace_ms:
            time.sleep(args.pace_ms / 1e3)

    evicted = bool(view is not None and view.evicted)
    info = sup.info()
    if not evicted:
        settle("final")
    # Ship my bf_link_* rows; every rank merges the same snapshots into
    # the same matrix (report_from_snapshot is pure).
    snap = telemetry.snapshot()
    link_rows = {k: v for k, v in snap.items()
                 if k.startswith("bf_link_")}
    snaps = _exchange_link_rows("links_snap", my_proc, nproc, link_rows)
    report = linkobs.report_from_snapshot(
        linkobs.merge_link_snapshots(snaps))
    cfg = config.get()
    dump_exists = bool(cfg.flight_recorder_path) and os.path.exists(
        f"{cfg.flight_recorder_path}.{me}.bin")
    print(_RESULT_TAG + json.dumps({
        "rank": me,
        "proc": my_proc,
        "mode": "links",
        "steps": steps_run,
        "evicted": evicted,
        "changes_total": info["changes_total"],
        "hot_edge": report.get("hot_edge"),
        "max_divergence": report.get("max_divergence_ratio"),
        "edges": report.get("edges"),
        "slo_mid": slo_mid,
        "hz_mid": hz_mid,
        "slo_breach_counts": {
            k: v for k, v in snap.items()
            if k.startswith("bf_slo_breaches_total")},
        "dump_exists": dump_exists,
        "top_ok": top_ok,
        "top_frame_lines": top_lines,
        "device": str(x.device),
    }), flush=True)
    active_procs = set() if evicted else set(range(nproc))
    sys.stdout.flush()
    sys.stderr.flush()
    _done_barrier(active_procs, my_proc, args.grace)
    os._exit(0)


def run_links_demo(args) -> int:
    """Driver for ``--links-smoke``: a 4-process gang with a 60 ms
    ``linkdelay`` fault on one rank's outbound data links, judged on the
    link observatory's whole promise:

      * the affected edges' online delay EWMAs converge on the injected
        delay while every unaffected edge stays flat;
      * measured-vs-modeled divergence on the hot edges crosses the
        alert threshold;
      * exactly the matching SLO rule fires on the receiver ranks —
        breach counter, degraded ``/healthz`` links block, one
        flight-recorder dump — and the co-armed quiet rule never does;
      * every rank computes the IDENTICAL merged link matrix (the
        ``bf.link_report()`` agreement claim, over KV-shipped
        snapshots);
      * ``tools top`` renders one complete frame against the live gang.
    """
    import tempfile

    from bluefog_tpu_torch.utils.linkobs import DIVERGENCE_ALERT
    n = args.np
    delay_rank = (n - 1) if args.delay_rank is None else args.delay_rank
    if delay_rank == 0:
        raise SystemExit("chaos: rank 0 hosts the rendezvous store; "
                         "delay any other rank")
    spec = (f"linkdelay:rank={delay_rank}:step={args.fault_step}"
            f":steps={args.fault_steps}:ms={args.delay_ms}")
    # Breach threshold at a third of the injected delay: a couple of
    # delayed samples push the EWMA past it, and no healthy CPU-loopback
    # edge gets anywhere near it.
    rule = f"link_delay_us>={int(args.delay_ms * 1e3 / 3)}"
    quiet_rule = "step_lag>=100000"
    rec_dir = tempfile.mkdtemp(prefix="bf-links-flightrec-")
    rec_prefix = os.path.join(rec_dir, "flightrec")
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(n),
           "--devices-per-proc", "1", "--chaos", spec, "--",
           sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
           "--worker", "--device", args.device, "--mode", "links",
           "--steps", str(args.steps), "--dim", str(args.dim),
           "--lr", str(args.lr), "--pace-ms", str(args.pace_ms),
           "--grace", str(args.grace),
           "--fault-step", str(args.fault_step),
           "--fault-steps", str(args.fault_steps)]
    env = _gang_env()
    env.update({
        "BLUEFOG_TPU_CHURN": "1",
        "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
        # Wide suspicion: the fault only delays DATA ops (heartbeats
        # ride undelayed), but a loaded CI box must not turn the slow
        # rank into a churn event mid-measurement.
        "BLUEFOG_TPU_CHURN_SUSPECT_MS": "1500",
        "BLUEFOG_TPU_TELEMETRY": "1",
        # Every message tagged: the estimator feeds on each commit.
        "BLUEFOG_TPU_TRACE_SAMPLE": "1",
        "BLUEFOG_TPU_ASYNC": "1",
        "BLUEFOG_TPU_ASYNC_STALENESS_STEPS": "64",
        # Tight collect cadence: the backstop couples the gang inside
        # the fault window, so the receivers' EWMAs feed on dozens of
        # delayed messages before the mid-fault capture.
        "BLUEFOG_TPU_ASYNC_COLLECT_EVERY":
            str(min(args.collect_every, 20)),
        "BLUEFOG_TPU_FLIGHT_RECORDER": "1",
        "BLUEFOG_TPU_FLIGHT_RECORDER_PATH": rec_prefix,
        "BLUEFOG_TPU_SLO": f"{rule};{quiet_rule}",
    })
    print(f"chaos links: launching {n}-process gang, {spec}, "
          f"SLO \"{rule};{quiet_rule}\" ({args.steps} steps)...",
          flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=args.timeout)
    wall = time.perf_counter() - t0
    results = _parse_results(proc.stdout)
    failures = []
    if proc.returncode != 0:
        _fail(failures, f"bfrun exited {proc.returncode}")
    if sorted(results) != list(range(n)):
        _fail(failures, f"expected reports from all {n} ranks, got "
                        f"{sorted(results)}")
    receivers = []
    hot_edges = set()
    if results:
        # The affected edges (and so the expected breach set) come from
        # the merged matrix itself: every edge out of the delayed rank.
        any_rec = next(iter(results.values()))
        affected = [e for e in (any_rec.get("edges") or [])
                    if e["src"] == delay_rank]
        unaffected = [e for e in (any_rec.get("edges") or [])
                      if e["src"] != delay_rank]
        receivers = sorted({e["dst"] for e in affected})
        if not affected:
            _fail(failures, "merged matrix carries no edge out of the "
                            f"delayed rank {delay_rank}")
        if not unaffected:
            _fail(failures, "merged matrix carries no unaffected edge "
                            "to compare against")
        if affected and unaffected:
            lo_aff = min(e["delay_us"] for e in affected)
            hi_un = max(e["delay_us"] for e in unaffected)
            if lo_aff < 0.5 * args.delay_ms * 1e3:
                _fail(failures,
                      f"affected-edge delay EWMA {lo_aff:.0f}us never "
                      f"converged on the injected {args.delay_ms}ms "
                      "(want >= half)")
            if hi_un > 0.5 * lo_aff:
                _fail(failures,
                      f"an unaffected edge reads {hi_un:.0f}us — not "
                      f"flat against the hot edges' {lo_aff:.0f}us")
    for rank, r in sorted(results.items()):
        hot = r.get("hot_edge") or {}
        hot_edges.add((hot.get("src"), hot.get("dst")))
        slo = r.get("slo_mid") or {}
        breached = sorted((slo.get("breached") or {}))
        counts = r.get("slo_breach_counts") or {}
        print(f"  rank {rank}: hot {hot.get('src')}->{hot.get('dst')} "
              f"({hot.get('delay_us', 0):.0f}us), divergence "
              f"x{r.get('max_divergence', 0):.1f}, mid-fault breached "
              f"{breached}, dump={r.get('dump_exists')}", flush=True)
        if r.get("evicted") or r.get("changes_total"):
            _fail(failures, f"rank {rank}: membership churned (a merely "
                            "slow LINK was treated as a dead peer)")
        if hot.get("src") != delay_rank:
            _fail(failures, f"rank {rank}: hot edge {hot} does not "
                            f"leave the delayed rank {delay_rank}")
        if (r.get("max_divergence") or 0.0) <= DIVERGENCE_ALERT:
            _fail(failures,
                  f"rank {rank}: max divergence "
                  f"{r.get('max_divergence')} never crossed the alert "
                  f"threshold {DIVERGENCE_ALERT}")
        want_breach = rank in receivers
        if want_breach:
            if breached != [rule]:
                _fail(failures,
                      f"rank {rank}: mid-fault breach set {breached} != "
                      f"exactly [{rule!r}] (quiet rule must stay quiet)")
            hz = r.get("hz_mid") or {}
            if hz.get("status") != "degraded":
                _fail(failures, f"rank {rank}: /healthz status "
                                f"{hz.get('status')!r} not degraded "
                                "mid-breach")
            links = hz.get("links") or {}
            if rule not in (links.get("slo") or {}).get("breached", []):
                _fail(failures, f"rank {rank}: /healthz links block "
                                f"carries no breach ({links})")
            if not any(rule in k for k in counts):
                _fail(failures, f"rank {rank}: bf_slo_breaches_total "
                                f"never ticked for the rule ({counts})")
            if not r.get("dump_exists"):
                _fail(failures, f"rank {rank}: no flight-recorder dump "
                                "on first breach")
        else:
            if breached:
                _fail(failures, f"rank {rank}: breached {breached} on a "
                                "rank with no delayed in-edge")
            if r.get("dump_exists"):
                _fail(failures, f"rank {rank}: spurious flight-recorder "
                                "dump without a breach")
    if len(hot_edges) > 1:
        _fail(failures, f"ranks disagree on the hot edge: {hot_edges} — "
                        "the merged matrix is not consistent")
    r0 = results.get(0) or {}
    if r0 and r0.get("top_ok") is not True:
        _fail(failures, "tools top did not render a complete frame "
                        f"against the live gang (top_ok={r0.get('top_ok')},"
                        f" {r0.get('top_frame_lines', 0)} lines)")
    import shutil
    shutil.rmtree(rec_dir, ignore_errors=True)
    if failures:
        print("\nchaos links FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        tail = "\n".join(proc.stderr.splitlines()[-40:])
        print(f"\ngang stderr tail:\n{tail}", file=sys.stderr)
        return 1
    print(f"chaos links OK: rank {delay_rank}'s outbound data links held "
          f"at +{args.delay_ms}ms — edges {sorted(hot_edges)} ran hot, "
          f"divergence crossed x{DIVERGENCE_ALERT}, SLO {rule!r} fired on "
          f"ranks {receivers} only (counter + degraded /healthz + dump), "
          f"all ranks agreed on the matrix, top rendered "
          f"{r0.get('top_frame_lines', 0)} lines (wall {wall:.1f}s)",
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# Self-tuning control-plane scenario (linkdelay fault -> re-route epoch)
# ---------------------------------------------------------------------------

def tune_worker_main(args) -> int:
    """One rank of the self-tuning control-plane gang: the async
    push-sum workload started on a FULL MESH — the deliberately wrong
    topology for the coming ``linkdelay`` fault, which sleeps the sender
    once per outbound DATA message, so the delayed rank pays
    ``(n-1) * ms`` per step until something re-routes it.  The tuner is
    that something: at every exact-collect boundary the gang exchanges
    ``bf_link_*`` snapshots through the store and feeds the IDENTICAL
    merged matrix, then ticks the tuner inside the quiesced barrier
    window (no data in flight, so a topology swap's window free/recreate
    never races a peer's ``win_accumulate``) — every rank derives the
    same adaptation at the same step.  Per-step wall times are segmented
    into pre-fault / fault-before-epoch / fault-after-epoch so the driver
    can price the recovery."""
    name = "tune_x"
    bf, W, me, x = _push_sum_setup(name, args, full_mesh=True)
    from bluefog_tpu_torch import topology as topology_util
    from bluefog_tpu_torch.run.supervisor import ChurnSupervisor
    from bluefog_tpu_torch.utils import config, telemetry, tuner
    nproc = bf.process_ranks().nprocs
    my_proc = bf.process_ranks().process
    tuned = bool(config.get().tune)
    target = float(me)
    sup = ChurnSupervisor()
    every = config.get().async_collect_every
    port = telemetry.start_http_server(0)
    _store().set(f"bf/tune_port/{my_proc}", str(port))

    def send_plan():
        # Re-read EVERY step: a tuner epoch can have re-entered
        # set_topology since the last one.
        return topology_util.GetSendWeights(bf.load_topology(), me)

    def sched_sig():
        self_w, dst_w = send_plan()
        return {"outs": sorted(int(d) for d in dst_w),
                "self_weight": round(float(self_w), 9),
                "dst_weights": {str(int(d)): round(float(w), 9)
                                for d, w in sorted(dst_w.items())}}

    def settle(tag, step):
        W.win_flush()
        _kv_barrier(tag, my_proc, nproc)
        time.sleep(0.05)
        _kv_barrier(tag + "b", my_proc, nproc)
        W.win_fold_stale_residuals(name)
        if step >= args.fault_step:
            # Control-plane exchange at the quiesced boundary.  Both
            # tuner calls are no-ops when BLUEFOG_TPU_TUNE=0.
            snap = telemetry.snapshot()
            rows = {k: v for k, v in snap.items()
                    if k.startswith("bf_link_")}
            tuner.feed_snapshots(_exchange_link_rows(
                f"tune_snap/{step}", my_proc, nproc, rows))
            tuner.tick(step)
            _kv_barrier(tag + "t", my_proc, nproc)

    sig0 = sched_sig()
    capture_step = args.steps - 5
    hz_mid = None
    top_ok = top_has_epoch = None
    top_lines = 0
    pre_dt = []
    fault_dt = []  # (seconds, tuner epoch at step START)
    view = None
    steps_run = 0
    for step in range(args.steps):
        t0 = time.perf_counter()
        epoch_at = int((tuner.health_summary() or {}).get("epoch", 0))
        change = sup.step(step)
        if change is not None:
            view = change
            if change.evicted:
                break
        W.set_async_step(step)
        telemetry.set_gauge("bf_async_step_lag",
                            float(W.async_step_lag()), rank=str(me))
        p = max(W.win_associated_p(name, me), 1e-3)
        z = x / p
        x = x - args.lr * (z - target) * p
        self_w, dst_w = send_plan()
        W.win_accumulate(x[None], name, self_weight=self_w,
                         dst_weights=dst_w)
        if every and (step + 1) % every == 0:
            settle(f"c{step}", step)
        x = W.win_update_then_collect(name)[0].clone()
        steps_run += 1
        dt = time.perf_counter() - t0
        if step < args.fault_step:
            pre_dt.append(dt)
        else:
            # The adaptation step itself is attributed to the PRE-epoch
            # segment (epoch read at step start): its wall time is mixed.
            fault_dt.append((dt, epoch_at))
        if step == capture_step:
            hz = _healthz(port)
            hz_mid = {"status": hz.get("status"),
                      "tuner": hz.get("tuner")}
            if my_proc == 0:
                # The dashboard leg: one COMPLETE frame against every
                # rank's live endpoint, post-adaptation.
                polls, frame = _top_frame(nproc, "tune_port")
                up = sum(1 for mh in polls.values()
                         if mh[0] is not None)
                top_ok = bool(up == nproc and "tune" in frame
                              and "DOWN" not in frame)
                top_has_epoch = "1:topology" in frame
                top_lines = len(frame.splitlines())
        if args.pace_ms:
            time.sleep(args.pace_ms / 1e3)

    evicted = bool(view is not None and view.evicted)
    info = sup.info()
    if not evicted:
        W.win_flush()
        _kv_barrier("final", my_proc, nproc)
    th = tuner.health_summary() or {}
    snap = telemetry.snapshot()
    fault_all = [d for d, _ in fault_dt]
    fault_early = [d for d, ep in fault_dt if ep == 0]
    fault_late = [d for d, ep in fault_dt if ep >= 1]
    print(_RESULT_TAG + json.dumps({
        "rank": me,
        "proc": my_proc,
        "mode": "tune",
        "tuned": tuned,
        "steps": steps_run,
        "evicted": evicted,
        "changes_total": info["changes_total"],
        "pre_ms": _robust_window_ms(pre_dt),
        "fault_ms": _robust_window_ms(fault_all),
        "fault_early_ms": _median_ms(fault_early),
        "fault_late_ms": _robust_window_ms(fault_late),
        "n_fault_late": len(fault_late),
        "epoch": int(th.get("epoch", 0)),
        "reverts": int(th.get("reverts", 0)),
        "last_knob": th.get("last_knob"),
        "topology_tag": th.get("topology"),
        "knobs": th.get("knobs"),
        "hz_mid": hz_mid,
        "tune_series": sorted(k for k in snap
                              if k.startswith("bf_tune_")),
        "sig_start": sig0,
        "sig_end": sched_sig(),
        "top_ok": top_ok,
        "top_has_epoch": top_has_epoch,
        "top_frame_lines": top_lines,
        "device": str(x.device),
    }), flush=True)
    active_procs = set() if evicted else set(range(nproc))
    sys.stdout.flush()
    sys.stderr.flush()
    _done_barrier(active_procs, my_proc, args.grace)
    os._exit(0)


def run_tune_demo(args) -> int:
    """Driver for ``--tune-smoke``: the same 4-process gang and
    ``linkdelay`` fault run TWICE —

      * ``BLUEFOG_TPU_TUNE=1``: the tuner must commit EXACTLY ONE
        numbered adaptation epoch (every rank agrees on it and on the
        chosen topology), cut the delayed rank's out-degree, recover
        >= ``--tune-ratio`` (default 2x) of the lost gossip throughput
        without any restart, surface the epoch in the ``/healthz``
        "tuner" block and the ``tools top`` tune column, and never
        revert;
      * ``BLUEFOG_TPU_TUNE=0`` pinned: the identical fault must change
        NOTHING — zero ``bf_tune_*`` series registered, no "tuner"
        health block, send schedule bitwise identical start-to-end,
        full-mesh out-degree preserved.

    The recovery lever is structural, not statistical: the fault sleeps
    the sender per outbound DATA message, so full mesh costs the delayed
    rank ``(n-1) * ms`` per step and the re-routed ring costs ``ms`` —
    the throughput ratio is the out-degree ratio."""
    n = args.np
    delay_rank = (n - 1) if args.delay_rank is None else args.delay_rank
    if delay_rank == 0:
        raise SystemExit("chaos: rank 0 hosts the rendezvous store; "
                         "delay any other rank")
    spec = (f"linkdelay:rank={delay_rank}:step={args.fault_step}"
            f":steps={args.fault_steps}:ms={args.delay_ms}")
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(n),
           "--devices-per-proc", "1", "--chaos", spec, "--",
           sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
           "--worker", "--device", args.device, "--mode", "tune",
           "--steps", str(args.steps), "--dim", str(args.dim),
           "--lr", str(args.lr), "--pace-ms", str(args.pace_ms),
           "--grace", str(args.grace),
           "--fault-step", str(args.fault_step),
           "--fault-steps", str(args.fault_steps)]
    base_env = _gang_env()
    base_env.update({
        "BLUEFOG_TPU_CHURN": "1",
        "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
        "BLUEFOG_TPU_CHURN_SUSPECT_MS": "1500",
        "BLUEFOG_TPU_TELEMETRY": "1",
        "BLUEFOG_TPU_TRACE_SAMPLE": "1",
        "BLUEFOG_TPU_ASYNC": "1",
        "BLUEFOG_TPU_ASYNC_STALENESS_STEPS": "64",
        "BLUEFOG_TPU_ASYNC_COLLECT_EVERY": str(args.collect_every),
        # Loopback delay EWMAs are scheduling noise (tens to hundreds
        # of microseconds, easily 3x apart edge to edge); the injected
        # fault is 100-1000x the floor.  A raised trigger is immune to
        # the noise, still fires on the first post-fault feed, and
        # keeps the "exactly one epoch per change" assertion honest.
        "BLUEFOG_TPU_TUNE_DIVERGENCE": "10",
        "BLUEFOG_TPU_TUNE_DWELL_STEPS": str(max(2, args.collect_every)),
    })
    legs = {}
    walls = {}
    for leg, flag in (("tuned", "1"), ("pinned", "0")):
        env = dict(base_env)
        env["BLUEFOG_TPU_TUNE"] = flag
        print(f"chaos tune [{leg}]: launching {n}-process gang "
              f"(BLUEFOG_TPU_TUNE={flag}), {spec} "
              f"({args.steps} steps)...", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=args.timeout)
        walls[leg] = time.perf_counter() - t0
        legs[leg] = (proc, _parse_results(proc.stdout))
    failures = []
    for leg, (proc, results) in legs.items():
        if proc.returncode != 0:
            _fail(failures, f"[{leg}] bfrun exited {proc.returncode}")
        if sorted(results) != list(range(n)):
            _fail(failures, f"[{leg}] expected reports from all {n} "
                            f"ranks, got {sorted(results)}")
        for rank, r in sorted(results.items()):
            print(f"  {leg} rank {rank}: pre {r.get('pre_ms', 0):.1f}ms, "
                  f"fault-early {r.get('fault_early_ms', 0):.1f}ms, "
                  f"fault-late {r.get('fault_late_ms', 0):.1f}ms, "
                  f"epoch {r.get('epoch')} ({r.get('last_knob')}), "
                  f"reverts {r.get('reverts')}, "
                  f"out-degree {len((r.get('sig_end') or {}).get('outs', []))}",
                  flush=True)
            if r.get("evicted") or r.get("changes_total"):
                _fail(failures, f"[{leg}] rank {rank}: membership "
                                "churned (a merely slow link was treated "
                                "as a dead peer)")
    tuned_res = legs["tuned"][1]
    pinned_res = legs["pinned"][1]
    # -- tuned leg: one epoch, cluster agreement, measured recovery -------
    tags = set()
    for rank, r in sorted(tuned_res.items()):
        if r.get("epoch") != 1:
            _fail(failures, f"[tuned] rank {rank}: {r.get('epoch')} "
                            "adaptation epochs != exactly 1 for one "
                            "persistent fault")
        if r.get("reverts"):
            _fail(failures, f"[tuned] rank {rank}: adaptation reverted "
                            "(probation judged the re-route a regression)")
        tags.add(r.get("topology_tag"))
        if "bf_tune_epoch" not in (r.get("tune_series") or []):
            _fail(failures, f"[tuned] rank {rank}: no bf_tune_* series "
                            f"registered ({r.get('tune_series')})")
        tb = (r.get("hz_mid") or {}).get("tuner") or {}
        if int(tb.get("epoch", -1)) != 1:
            _fail(failures, f"[tuned] rank {rank}: /healthz tuner block "
                            f"missing or wrong epoch ({tb})")
    if len(tags) != 1 or None in tags:
        _fail(failures, f"[tuned] ranks disagree on the re-routed "
                        f"topology: {tags} — the measured model is not "
                        "cluster-consistent")
    dr_t = tuned_res.get(delay_rank) or {}
    dr_p = pinned_res.get(delay_rank) or {}
    if dr_t and len((dr_t.get("sig_end") or {}).get("outs", [])) >= n - 1:
        _fail(failures, "[tuned] delayed rank's out-degree was not "
                        "reduced — the adaptation never re-routed it")
    if dr_t and dr_t.get("n_fault_late", 0) < 6:
        _fail(failures, "[tuned] too few post-adaptation steps "
                        f"({dr_t.get('n_fault_late')}) to judge recovery")
    un = float(dr_p.get("fault_ms") or 0.0)
    tu = float(dr_t.get("fault_late_ms") or 0.0)
    ratio = (un / tu) if tu > 0.0 else 0.0
    if ratio < args.tune_ratio:
        _fail(failures, f"delayed rank recovered only {ratio:.2f}x "
                        f"(untuned fault median {un:.1f}ms vs tuned "
                        f"post-adaptation {tu:.1f}ms; want >= "
                        f"{args.tune_ratio}x)")
    r0 = tuned_res.get(0) or {}
    if r0 and (r0.get("top_ok") is not True
               or r0.get("top_has_epoch") is not True):
        _fail(failures, "[tuned] tools top did not render the tune "
                        f"column's epoch (top_ok={r0.get('top_ok')}, "
                        f"has_epoch={r0.get('top_has_epoch')}, "
                        f"{r0.get('top_frame_lines', 0)} lines)")
    # -- pinned leg: BLUEFOG_TPU_TUNE=0 is bitwise inert ------------------
    for rank, r in sorted(pinned_res.items()):
        if r.get("epoch") or r.get("reverts"):
            _fail(failures, f"[pinned] rank {rank}: adapted with the "
                            "tuner off")
        if r.get("tune_series"):
            _fail(failures, f"[pinned] rank {rank}: bf_tune_* series "
                            "registered with BLUEFOG_TPU_TUNE=0: "
                            f"{r.get('tune_series')}")
        if (r.get("hz_mid") or {}).get("tuner") is not None:
            _fail(failures, f"[pinned] rank {rank}: /healthz grew a "
                            "tuner block with the tuner off")
        if r.get("sig_start") != r.get("sig_end"):
            _fail(failures, f"[pinned] rank {rank}: send schedule "
                            "changed under the fault "
                            f"({r.get('sig_start')} -> {r.get('sig_end')})")
        if len((r.get("sig_end") or {}).get("outs", [])) != n - 1:
            _fail(failures, f"[pinned] rank {rank}: full-mesh out-degree "
                            "not preserved")
    if failures:
        print("\nchaos tune FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        for leg, (proc, _) in legs.items():
            tail = "\n".join(proc.stderr.splitlines()[-40:])
            print(f"\n[{leg}] gang stderr tail:\n{tail}", file=sys.stderr)
        return 1
    print(f"chaos tune OK: rank {delay_rank} held at +{args.delay_ms}ms "
          f"on a full mesh — tuner committed exactly 1 epoch "
          f"({sorted(tags)[0]}), recovered {ratio:.1f}x (>= "
          f"{args.tune_ratio}x) of the lost throughput without restart, "
          f"and BLUEFOG_TPU_TUNE=0 stayed bitwise inert "
          f"(walls tuned {walls['tuned']:.1f}s / pinned "
          f"{walls['pinned']:.1f}s)", flush=True)
    return 0


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _fail(msgs, what):
    msgs.append(what)


def _gang_env() -> dict:
    """The gang's environment: this process's, with the port's package
    importable from wherever bfrun starts the workers."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def run_demo(args) -> int:
    n = args.np
    if args.spec:
        # The assertions below are kill-shaped (survivor set, recovery
        # bound anchored on the kill step): a --spec override must carry
        # exactly one kill so the harness judges against the right gang.
        # Other fault mixes run under `bfrun --chaos` directly.
        from bluefog_tpu_torch.utils.chaos import killed_ranks, parse_chaos
        kills = killed_ranks(parse_chaos(args.spec))
        if len(kills) != 1:
            raise SystemExit(
                "chaos: --spec must contain exactly one kill fault "
                f"(got {kills}); drive delay/partition-only mixes with "
                "`bfrun --chaos` directly")
        kill_rank = kills[0]
        args.kill_step = next(f.step for f in parse_chaos(args.spec)
                              if f.kind == "kill")
        spec = args.spec
    else:
        kill_rank = (n - 1) if args.kill_rank is None else args.kill_rank
        spec = f"kill:rank={kill_rank}:step={args.kill_step}"
    if kill_rank == 0:
        # The rendezvous store lives inside rank 0: its death is a
        # whole-gang loss (every barrier fails), not a gossip-churn event.
        # The elastic legs (--kill0-leg) run without a rendezvous; this
        # harness just refuses the footgun.
        raise SystemExit("chaos: rank 0 hosts the rendezvous store "
                         "and cannot be the kill target — pick any other "
                         "rank")
    survivors = sorted(set(range(n)) - {kill_rank})
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", str(n),
           "--devices-per-proc", "1", "--chaos", spec, "--",
           sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
           "--worker", "--device", args.device, "--steps", str(args.steps),
           "--dim", str(args.dim), "--lr", str(args.lr),
           "--pace-ms", str(args.pace_ms), "--grace", str(args.grace),
           "--kill-step", str(args.kill_step)]
    import tempfile
    rec_dir = tempfile.mkdtemp(prefix="bf-chaos-flightrec-")
    rec_prefix = os.path.join(rec_dir, "flightrec")
    env = _gang_env()
    env.update({
        "BLUEFOG_TPU_CHURN": "1",
        "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
        "BLUEFOG_TPU_CHURN_SUSPECT_MS": "500",
        "BLUEFOG_TPU_WIN_RETRIES": "1",
        "BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS": "25",
        "BLUEFOG_TPU_TELEMETRY": "1",
        # Black-box leg: recorder armed + sampled wire trace tags, so the
        # committed membership change makes every survivor dump a
        # postmortem the driver can merge (the CI path for reading the
        # flight recorder after a kill — not just unit tests).
        "BLUEFOG_TPU_FLIGHT_RECORDER": "1",
        "BLUEFOG_TPU_TRACE_SAMPLE": "4",
        "BLUEFOG_TPU_FLIGHT_RECORDER_PATH": rec_prefix,
    })
    print(f"chaos: launching {n}-process gang, {spec} "
          f"({args.steps} steps)...", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=args.timeout)
    wall = time.perf_counter() - t0
    results = _parse_results(proc.stdout)

    failures = []
    if proc.returncode != 0:
        _fail(failures, f"bfrun exited {proc.returncode} (the chaos kill "
                        "must be tolerated, any other failure is real)")
    if sorted(results) != survivors:
        _fail(failures, f"expected reports from survivors {survivors}, "
                        f"got {sorted(results)}")
    target_mean = sum(float(r) for r in survivors) / len(survivors)
    for rank in sorted(results):
        r = results[rank]
        line = (f"  rank {rank}: epoch {r['epoch']}, active "
                f"{r['active_ranks']}, x_mean {r['x_mean']:.4f} "
                f"(target {target_mean:.4f}), recovery@{r['recovery_step']}"
                f", step ms pre/post {r['pre_median_ms']:.2f}/"
                f"{r['post_median_ms']:.2f}, put_errors {r['put_errors']}")
        print(line, flush=True)
        if r["epoch"] < 1:
            _fail(failures, f"rank {rank}: no membership epoch committed")
        if list(r["active_ranks"]) != survivors:
            _fail(failures, f"rank {rank}: active ranks {r['active_ranks']}"
                            f" != survivors {survivors}")
        if r["recovery_step"] is None:
            _fail(failures, f"rank {rank}: never recovered")
        elif r["recovery_step"] - args.kill_step > args.recovery_bound:
            _fail(failures,
                  f"rank {rank}: recovery took "
                  f"{r['recovery_step'] - args.kill_step} steps "
                  f"(bound {args.recovery_bound})")
        if not r["recovery_observed"]:
            _fail(failures, f"rank {rank}: bf_churn_recovery_seconds "
                            "histogram never observed")
        m = r.get("healthz_membership")
        if not m or m.get("epoch", 0) < 1:
            _fail(failures, f"rank {rank}: /healthz carries no committed "
                            f"membership block ({m})")
        if abs(r["x_mean"] - target_mean) > args.loss_tol:
            _fail(failures,
                  f"rank {rank}: consensus value {r['x_mean']:.4f} is "
                  f"{abs(r['x_mean'] - target_mean):.4f} from the "
                  f"survivor optimum {target_mean:.4f} "
                  f"(tol {args.loss_tol})")
        # Step-time regression: medians floored at pace + 5 ms — on a
        # small shared CI box the op time is a few ms and ambient load
        # swings it by more than that, so an anomalously QUIET pre-window
        # must not fabricate a regression a genuinely slow post-recovery
        # path (tens of ms: leftover retries, a peer not dropped) would
        # still trip.
        floor = args.pace_ms + 5.0
        pre = max(r["pre_median_ms"], floor)
        post = max(r["post_median_ms"], floor)
        if post / pre > args.step_ratio:
            _fail(failures, f"rank {rank}: post-recovery step time "
                            f"{post:.2f}ms > {args.step_ratio}x "
                            f"pre-failure {pre:.2f}ms")
    # Flight-recorder postmortem: every survivor dumps its black box at
    # the committed membership change (run/supervisor.py); the dumps must
    # decode into one valid merged trace — the exact artifact an operator
    # reads after a real kill.
    try:
        from bluefog_tpu_torch.tools import tracegossip
        rec_files = tracegossip.dump_files(rec_prefix)
        missing = [r for r in survivors if r not in rec_files]
        if missing:
            _fail(failures, "no flight-recorder dump from survivor(s) "
                            f"{missing} (found {sorted(rec_files)})")
        else:
            dumps = tracegossip.load_dumps(rec_prefix)
            out, stats = tracegossip.merge_gossip(rec_prefix, dumps=dumps)
            with open(out) as f:
                merged = json.load(f)
            lanes = {e.get("pid") for e in merged}
            if not set(survivors) <= lanes:
                _fail(failures, f"merged trace lanes {sorted(lanes)} miss "
                                f"survivors {survivors}")
            print(f"chaos: flight-recorder postmortem OK — "
                  f"{stats['events']} events from ranks {stats['ranks']}, "
                  f"{stats['flows_matched']} cross-rank flow arrow(s)",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — a broken dump IS the failure
        _fail(failures, f"flight-recorder postmortem failed: {e}")
    finally:
        import shutil
        shutil.rmtree(rec_dir, ignore_errors=True)
    if failures:
        print("\nchaos FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        tail = "\n".join(proc.stderr.splitlines()[-40:])
        print(f"\ngang stderr tail:\n{tail}", file=sys.stderr)
        return 1
    print(f"chaos OK: rank {kill_rank} killed at step {args.kill_step}, "
          f"{len(survivors)} survivors re-formed and converged to "
          f"{target_mean:.3f} (wall {wall:.1f}s)", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The JAX harness's flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.tools chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worker", action="store_true",
                   help="internal: run as one gang rank (launched by the "
                        "driver through bfrun)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where each gang process holds its window rows "
                        "(default cuda: the card; processes beyond the "
                        "card count share the cards round robin)")
    p.add_argument("--mode", default=None,
                   choices=["sync", "async", "links", "tune"],
                   help="internal (with --worker): delay-scenario gossip "
                        "mode — sync steps behind a per-step barrier, "
                        "async is barrier-free push-sum, links is the "
                        "link-observatory leg, tune is the self-tuning "
                        "control-plane leg")
    p.add_argument("--role", default=None, choices=["member", "joiner"],
                   help="internal (with --worker): elastic-leg role — "
                        "member = coordinator-free founding rank, joiner "
                        "= mid-run join via BFTPU_GANG_JOIN")
    p.add_argument("--join-wait", type=float, default=30.0,
                   help="joiner: seconds to wait for the grow epoch to "
                        "commit after the grant")
    p.add_argument("--deadline", type=float, default=None,
                   help="internal: shared unix-time gossip stop point "
                        "for the elastic legs")
    p.add_argument("--run-sec", type=float, default=30.0,
                   help="elastic legs: wall-clock gossip budget (the "
                        "shared deadline every worker stops at)")
    p.add_argument("--join-leg", action="store_true",
                   help="run the elastic JOIN leg: coordinator-free "
                        "4-proc gang, kill a non-zero rank, admit a "
                        "fresh process through the persisted directory, "
                        "assert one grow epoch + full-gang convergence")
    p.add_argument("--kill0-leg", action="store_true",
                   help="run the elastic KILL-RANK-0 leg: same gang, "
                        "SIGKILL rank 0 — the gang must survive (no "
                        "coordinator) and admit a replacement for rank 0")
    p.add_argument("--join-smoke", action="store_true",
                   help="CI smoke profile of the join leg")
    p.add_argument("--kill0-smoke", action="store_true",
                   help="CI smoke profile of the kill-rank-0 leg")
    p.add_argument("--delay", action="store_true",
                   help="run the delay scenario (sync + async legs) "
                        "instead of the kill scenario")
    p.add_argument("--delay-smoke", action="store_true",
                   help="CI smoke profile of the delay scenario")
    p.add_argument("--links", action="store_true",
                   help="run the link-observatory scenario: linkdelay "
                        "fault, online per-edge delay estimation, "
                        "divergence alerting, SLO breach + /healthz + "
                        "flight-recorder dump, cluster-matrix agreement, "
                        "live tools-top frame")
    p.add_argument("--links-smoke", action="store_true",
                   help="CI smoke profile of the link-observatory "
                        "scenario")
    p.add_argument("--tune", action="store_true",
                   help="run the self-tuning control-plane scenario: "
                        "linkdelay fault on a full-mesh gang, tuned "
                        "(BLUEFOG_TPU_TUNE=1) and pinned (=0) legs — "
                        "one adaptation epoch, >= 2x throughput "
                        "recovery, bitwise-inert default")
    p.add_argument("--tune-smoke", action="store_true",
                   help="CI smoke profile of the self-tuning scenario")
    p.add_argument("--tune-ratio", type=float, default=2.0,
                   help="tuned leg's recovery floor: the delayed rank's "
                        "untuned fault step-time median over its tuned "
                        "post-adaptation median must meet this "
                        "(default 2.0)")
    p.add_argument("--delay-rank", type=int, default=None,
                   help="rank the delay fault targets (default: the "
                        "last one)")
    p.add_argument("--delay-ms", type=float, default=60.0,
                   help="per-step sleep the fault injects (default 60)")
    p.add_argument("--fault-step", type=int, default=60,
                   help="first delayed step (past warm-up)")
    p.add_argument("--fault-steps", type=int, default=25,
                   help="how many consecutive steps stay delayed")
    p.add_argument("--collect-every", type=int, default=50,
                   help="async leg's exact-collect backstop cadence")
    p.add_argument("--sync-degrade", type=float, default=3.0,
                   help="sync survivors' fault/pre step-time ratio must "
                        "EXCEED this (proof the lockstep leg couples)")
    p.add_argument("--async-ratio", type=float, default=1.5,
                   help="async survivors' fault/pre step-time ratio must "
                        "stay UNDER this (the ~10%% claim, widened for "
                        "shared-CI noise; the tight bound belongs to the "
                        "quiet multi-host rig)")
    p.add_argument("--np", type=int, default=4,
                   help="gang size (default 4)")
    p.add_argument("--steps", type=int, default=360,
                   help="training steps per rank (default 360)")
    p.add_argument("--dim", type=int, default=128,
                   help="parameter-vector length (default 128)")
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--pace-ms", type=float, default=5.0,
                   help="per-step pacing sleep (stabilizes step-time "
                        "medians on loaded hosts)")
    p.add_argument("--grace", type=float, default=3.0,
                   help="post-loop heartbeat grace before exiting, so "
                        "finish-time skew never reads as churn")
    p.add_argument("--kill-rank", type=int, default=None,
                   help="rank to SIGKILL (default: the last one)")
    p.add_argument("--kill-step", type=int, default=120,
                   help="step at which the kill fires (late enough that "
                        "the pre-failure baseline is measured in steady "
                        "state, past the warm-up)")
    p.add_argument("--spec", default=None,
                   help="full chaos spec override (bfrun --chaos grammar); "
                        "default kill:rank=<kill-rank>:step=<kill-step>")
    p.add_argument("--recovery-bound", type=int, default=250,
                   help="max steps between the kill and the survivors' "
                        "re-plan (default 250)")
    p.add_argument("--loss-tol", type=float, default=0.15,
                   help="|consensus - survivor target mean| bound")
    p.add_argument("--step-ratio", type=float, default=1.5,
                   help="post/pre step-time median bound")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--smoke", action="store_true",
                   help="CI smoke profile (same assertions, smaller run)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        if args.role == "member" and os.environ.get("BFTPU_GANG_JOIN"):
            # `bfrun --elastic --grow S` relaunches the SAME command for
            # the late joiner, distinguished only by BFTPU_GANG_JOIN —
            # the same branch a real join-aware training program makes.
            args.role = "joiner"
        if args.role == "member":
            return elastic_worker_main(args)
        if args.role == "joiner":
            return join_worker_main(args)
        if args.mode == "tune":
            return tune_worker_main(args)
        if args.mode == "links":
            return links_worker_main(args)
        if args.mode is not None:
            return delay_worker_main(args)
        return worker_main(args)
    if args.join_leg or args.join_smoke or args.kill0_leg \
            or args.kill0_smoke:
        if args.join_smoke or args.kill0_smoke:
            args.run_sec = min(args.run_sec, 24.0)
            args.dim = min(args.dim, 32)
            args.pace_ms = min(args.pace_ms, 3.0)
            args.kill_step = min(args.kill_step, 80)
        args.steps = max(args.steps, 100_000)  # the deadline governs
        # The combine-what-you-have workload oscillates around the
        # optimum (each step descends before averaging); the elastic
        # legs judge the GANG's mean, so individual ranks get a bit more
        # slack than the kill leg's post-recovery steady state.
        args.loss_tol = max(args.loss_tol, 0.2)
        if args.kill0_leg or args.kill0_smoke:
            return run_elastic_demo(args, kill_rank=0)
        kill_rank = ((args.np - 2 if args.np > 2 else 1)
                     if args.kill_rank is None else args.kill_rank)
        if kill_rank == 0:
            raise SystemExit("chaos --join-leg: use --kill0-leg for the "
                             "rank-0 scenario")
        return run_elastic_demo(args, kill_rank=kill_rank)
    if args.tune or args.tune_smoke:
        if args.tune_smoke:
            args.dim = min(args.dim, 32)
            args.pace_ms = min(args.pace_ms, 3.0)
            args.fault_step = min(args.fault_step, 20)
        # The fault runs to the END of the run, long enough past the
        # adaptation epoch (first post-fault collect boundary + dwell)
        # that the post-adaptation segment carries a stable median; the
        # tight collect cadence is the control-plane exchange cadence.
        args.fault_steps = max(args.fault_steps, 50)
        args.collect_every = min(args.collect_every, 5)
        args.steps = args.fault_step + args.fault_steps
        return run_tune_demo(args)
    if args.links or args.links_smoke:
        if args.links_smoke:
            args.dim = min(args.dim, 32)
            args.pace_ms = min(args.pace_ms, 3.0)
            args.fault_step = min(args.fault_step, 40)
        # The fault runs to the END of the run (EWMAs decay fast once
        # traffic heals — 0.8^40 would erase a converged estimate before
        # the final snapshot), and long enough that collect backstops
        # couple the gang several times inside the fault window.
        args.fault_steps = max(args.fault_steps, 40)
        args.steps = args.fault_step + args.fault_steps
        return run_links_demo(args)
    if args.delay or args.delay_smoke:
        if args.delay_smoke:
            args.steps = min(args.steps, 160)
            args.dim = min(args.dim, 32)
            args.pace_ms = min(args.pace_ms, 3.0)
        return run_delay_demo(args)
    if args.smoke:
        args.steps = min(args.steps, 300)
        args.dim = min(args.dim, 64)
    return run_demo(args)


if __name__ == "__main__":
    sys.exit(main())
