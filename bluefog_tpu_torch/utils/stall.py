"""Stall detection: warn when a blocking wait exceeds a threshold.

The port of ``bluefog_tpu/utils/stall.py`` (the reference's
``CheckForStalledTensors``, ``operations.cc:388-433``, warns every 60 s).
The waits the port has are timed: ``synchronize`` of a collective,
``win_wait``, ``barrier`` and the window mutex grants.  A daemon thread
warns with the op's name once a wait passes
``BLUEFOG_TPU_STALL_WARNING_SEC`` (0 disables; default 60), and
``/healthz`` lists the overdue ones.  The thread reads host clocks and
dicts only: it never touches CUDA.

Like the reference's warning, it names the missing ranks: across processes
the window transport registers a peer probe (:func:`set_peer_probe`) that
says which peers' endpoints do not answer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

from bluefog_tpu_torch.utils import config
from bluefog_tpu_torch.utils.logging import get_logger

__all__ = ["watch", "StallMonitor", "set_peer_probe"]

# Installed by ops.window.install_distrib(); returns the sorted list of ranks
# whose owning process is unreachable (empty list = all peers answered).
_peer_probe: Optional[Callable[[], List[int]]] = None


def set_peer_probe(probe: Optional[Callable[[], List[int]]]) -> None:
    """Register (or clear, with ``None``) the liveness probe used to name
    missing peers in stall warnings."""
    global _peer_probe
    _peer_probe = probe


class StallMonitor:
    """Tracks outstanding named waits; a daemon thread warns on overdue ones
    every threshold interval (reference: rank-0 check every 60 s)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._outstanding = {}  # id -> (name, start_ts, warned_count)
        self._next_id = 0
        self._thread = None
        self._paused = False

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="bf-stall-monitor")
            self._thread.start()

    def _run(self):
        while True:
            # Fixed short tick: the threshold can change between ticks (tests,
            # env reload), so never sleep proportionally to a stale value.
            time.sleep(0.25)
            threshold = config.get().stall_warning_sec
            if threshold <= 0 or self._paused:
                continue
            now = time.monotonic()
            with self._lock:
                items = list(self._outstanding.items())
            peers = None  # probed at most once per sweep (it does real I/O)
            for key, (name, start, warned) in items:
                overdue = now - start
                if overdue > threshold * (warned + 1):
                    if peers is None:
                        peers = self._probe_peers()
                    from bluefog_tpu_torch.utils import telemetry
                    telemetry.inc("bf_stall_warnings_total", op=name)
                    get_logger().warning(
                        "One or more operations appear stalled: %r has been "
                        "waiting %.0f s (threshold %.0f s). A missing peer "
                        "process or a hung collective is the usual cause.%s",
                        name, overdue, threshold, peers)
                    with self._lock:
                        if key in self._outstanding:
                            self._outstanding[key] = (name, start, warned + 1)

    @staticmethod
    def _probe_peers() -> str:
        """Render the missing-rank suffix for a stall warning (reference
        format: ``Missing ranks: 0, 2`` per stalled tensor)."""
        probe = _peer_probe
        if probe is None:
            return ""
        try:
            missing = probe()
        except Exception:  # probe failure must never kill the monitor
            return ""
        if missing:
            return (" Unreachable peer ranks: "
                    + ", ".join(str(r) for r in missing) + ".")
        return " All peer transports are reachable (hung device op?)."

    def begin(self, name: str) -> int:
        if config.get().stall_warning_sec <= 0:
            return -1
        self._ensure_thread()
        with self._lock:
            key = self._next_id
            self._next_id += 1
            self._outstanding[key] = (name, time.monotonic(), 0)
        return key

    def end(self, key: int) -> None:
        if key < 0:
            return
        with self._lock:
            self._outstanding.pop(key, None)

    def overdue_ops(self) -> List[tuple]:
        """``[(name, waited_sec)]`` for outstanding waits past the
        threshold — the stall-monitor view ``/healthz`` reflects (the
        counter records history; this is the live state)."""
        threshold = config.get().stall_warning_sec
        if threshold <= 0 or self._paused:
            return []
        now = time.monotonic()
        with self._lock:
            return [(name, now - start)
                    for name, start, _ in self._outstanding.values()
                    if now - start > threshold]

    def pause(self) -> None:
        """Silence stall warnings while the session is suspended (an
        interactive user idling at a prompt is not a stalled peer)."""
        self._paused = True

    def unpause(self) -> None:
        self._paused = False


_monitor = StallMonitor()


@contextmanager
def watch(name: str):
    """Wrap a blocking wait so the monitor can flag it if it stalls."""
    key = _monitor.begin(name)
    try:
        yield
    finally:
        _monitor.end(key)
