"""Chaos fault injection for elastic-gossip testing.

The port of ``bluefog_tpu/utils/chaos.py``: the same grammar, the same
faults, host logic only.  ``bfrun --chaos <spec>`` (or a launcher that sets
it by hand) exports the spec to every rank as
``BLUEFOG_TPU_CHAOS``; each rank's churn supervisor parses it and
self-injects the faults that name its rank at the named steps.  Injection
is in-process by design: the launcher cannot know when "step N" happens,
the rank can — and a SIGKILL from inside the step loop is exactly the
mid-gossip crash the churn controller must survive.

Spec grammar (comma-separated faults, each ``kind:key=val:...``):

  ``kill:rank=K:step=N``
      Rank K SIGKILLs itself at step N — an un-catchable crash, payloads
      in flight, no goodbye.  The gold-standard churn event.

  ``delay:rank=K:step=N[:steps=M][:ms=D]``
      Rank K sleeps D ms (default 200) in each of steps N..N+M-1 (default
      M=10) — a persistent straggler.  With
      ``BLUEFOG_TPU_CHURN_STRAGGLER_STEPS`` set, the survivors evict it.

  ``partition:rank=K:step=N[:steps=M]``
      Rank K drops ALL its outbound transport traffic for steps N..N+M-1
      (default M=20) — its listener still accepts TCP, so the probe stays
      green while heartbeats go silent, exercising the hard-silence
      detection path.

  ``linkdelay:rank=K:step=N[:steps=M][:ms=D]``
      Rank K's outbound DATA sends each sleep D ms (default 60) for steps
      N..N+M-1 (default M=10) — a slow LINK, not a slow rank: the sleep
      lands between the window layer's trace-tag stamp and the wire, so
      the link observatory (utils/linkobs.py) measures it as real one-way
      delay on every edge out of K, while control traffic (heartbeats,
      fences, membership) is never delayed and churn suspicion stays
      quiet.

The launcher side (``run/run.py``) uses :func:`killed_ranks` to know which
rank deaths are EXPECTED — a chaos-killed rank's exit must not trigger the
normal any-failure-kills-the-gang policy, or there would be no survivors
left to observe recovering.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["Fault", "parse_chaos", "killed_ranks", "ChaosInjector"]

_KINDS = ("kill", "delay", "partition", "linkdelay")
_DEFAULTS = {"delay": {"steps": 10, "ms": 200.0},
             "partition": {"steps": 20},
             "linkdelay": {"steps": 10, "ms": 60.0},
             "kill": {}}


@dataclass(frozen=True)
class Fault:
    kind: str           # kill | delay | partition | linkdelay
    rank: int           # global rank the fault targets
    step: int           # first step the fault is active
    steps: int = 1      # how many consecutive steps it stays active
    ms: float = 0.0     # delay duration per step (delay only)

    def active_at(self, step: int) -> bool:
        return self.step <= step < self.step + self.steps


def parse_chaos(spec: Optional[str]) -> List[Fault]:
    """Parse a chaos spec string; raises ``ValueError`` on malformed input
    (a typo'd fault spec silently injecting nothing would make a chaos run
    vacuously green)."""
    if not spec:
        return []
    faults: List[Fault] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        kind = parts[0]
        if kind not in _KINDS:
            raise ValueError(
                f"chaos: unknown fault kind {kind!r} in {item!r}; expected "
                f"one of {', '.join(_KINDS)}")
        kv = {}
        for p in parts[1:]:
            key, sep, val = p.partition("=")
            if not sep or key not in ("rank", "step", "steps", "ms"):
                raise ValueError(f"chaos: bad field {p!r} in {item!r}")
            kv[key] = float(val) if key == "ms" else int(val)
        if "rank" not in kv or "step" not in kv:
            raise ValueError(
                f"chaos: {item!r} needs at least rank= and step=")
        if kv["rank"] < 0 or kv["step"] < 0:
            raise ValueError(f"chaos: negative rank/step in {item!r}")
        defaults = dict(_DEFAULTS[kind])
        defaults.update(kv)
        if kind == "kill":
            defaults.pop("steps", None)
            defaults.pop("ms", None)
            faults.append(Fault("kill", defaults["rank"], defaults["step"]))
        else:
            faults.append(Fault(kind, defaults["rank"], defaults["step"],
                                steps=max(1, int(defaults["steps"])),
                                ms=float(defaults.get("ms", 0.0))))
    return faults


def killed_ranks(faults: List[Fault]) -> List[int]:
    """Ranks whose death the launcher must tolerate (kill faults)."""
    return sorted({f.rank for f in faults if f.kind == "kill"})


class ChaosInjector:
    """Per-process fault applier.  ``apply(step)`` is called once per
    training step by the churn supervisor; it fires the faults that target
    one of this process's ranks."""

    def __init__(self, my_ranks, faults: Optional[List[Fault]] = None,
                 transport=None, peer_addrs=None):
        if faults is None:
            from bluefog_tpu_torch.utils import config
            faults = parse_chaos(config.get().chaos)
        mine = set(int(r) for r in my_ranks)
        self.faults = [f for f in faults if f.rank in mine]
        self.transport = transport
        # Every peer (host, port) — the partition fault drops the lot.
        self.peer_addrs = list(peer_addrs or [])
        self._partitioned = False
        self._link_delay_ms = 0.0

    def apply(self, step: int) -> None:
        partition_now = False
        link_delay_ms = 0.0
        for f in self.faults:
            if f.kind == "kill" and f.step == step:
                from bluefog_tpu_torch.utils.logging import get_logger
                get_logger().warning(
                    "chaos: rank %d SIGKILL at step %d", f.rank, step)
                import sys
                sys.stdout.flush()
                sys.stderr.flush()
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "delay" and f.active_at(step):
                time.sleep(f.ms / 1e3)
            elif f.kind == "partition" and f.active_at(step):
                partition_now = True
            elif f.kind == "linkdelay" and f.active_at(step):
                link_delay_ms = max(link_delay_ms, f.ms)
        if self.transport is not None and \
                link_delay_ms != self._link_delay_ms:
            self.transport.set_send_delay(link_delay_ms / 1e3)
            self._link_delay_ms = link_delay_ms
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning(
                "chaos: outbound data-link delay %s at step %d",
                f"{link_delay_ms:.0f} ms ENGAGED" if link_delay_ms
                else "healed", step)
        if self.transport is not None and partition_now != self._partitioned:
            self.transport.set_partition(
                self.peer_addrs if partition_now else None)
            self._partitioned = partition_now
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning(
                "chaos: outbound partition %s at step %d",
                "ENGAGED" if partition_now else "healed", step)
