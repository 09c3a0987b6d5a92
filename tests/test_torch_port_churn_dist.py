"""Churn across processes: a gang of 4 gloo processes loses one to SIGKILL.

The port of the JAX package's chaos demo (``tools/chaos.py`` ``run_demo``:
4 processes of one rank, rank 3 killed, rank 0 hosting the rendezvous), on
the CPU: ``BLUEFOG_TPU_CHURN=1`` with 80 ms heartbeats and a 500 ms suspect
window, ``BLUEFOG_TPU_CHAOS=kill:rank=3:step=2``, each process training a
``DistributedPushSumOptimizer`` (owned layout, lr 0: pure gossip).  The
survivors, without a leader or a collective, commit one view (epoch 1,
ranks 0-2), rebuild their windows from their owned rows bit for bit and
keep push-sum mass on the surviving ranks: after a churn-aware fence the
survivors' total P equals what they held when they resumed, within 1e-9
(float64 sums of thirds).  Killed process: exit -9; each process has its
own timeout; the file runs in about 30 s.  The same gang under
``DistributedWinPutOptimizer(fused=True)`` builds its program anew at
the new epoch.

Then, in one process: the supervisor's step ticks the tuner (the port's
``set_async_step`` no longer does), and it refuses without churn or a
transport.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROCS = 4
TIMEOUT = 90
MASS_TOL = 1e-9


def _file_barrier(tmp: Path, tag: str, me: int, members, timeout=30.0):
    """A test-side rendezvous through files (no collective: the process
    group holds a dead member)."""
    (tmp / f"{tag}.{me}").write_text("1")
    deadline = time.monotonic() + timeout
    while not all((tmp / f"{tag}.{p}").exists() for p in members):
        if time.monotonic() > deadline:
            raise TimeoutError(f"file barrier {tag}")
        time.sleep(0.02)


def _local_mass(W, name):
    win = W._store.get(name)
    with win.lock:
        return sum(win.p_main.values()) + sum(win.p_staging.values())


def _worker(out: str, tmp: str, kind: str):
    import hashlib

    import torch

    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.optim import DistributedPushSumOptimizer
    from bluefog_tpu_torch.run import supervisor as S
    from bluefog_tpu_torch.utils import telemetry
    tmp = Path(tmp)
    bf.init_distributed(device="cpu")
    me = bf.process_ranks().process
    x = torch.full((1, 64), float(me + 1))
    if kind == "push_sum":
        opt = DistributedPushSumOptimizer(torch.optim.SGD([x], lr=0.0),
                                          auto_collect_rounds=0)
    else:
        from bluefog_tpu_torch.optim import DistributedWinPutOptimizer
        opt = DistributedWinPutOptimizer(torch.optim.SGD([x], lr=0.1),
                                         fused=True)
    builds = []
    name = opt._names[0]
    sup = S.maybe_supervisor()
    seen = {}

    def on_change(view):
        win = W._store.get(name)
        seen["rebuilt"] = [hashlib.sha256(win.main[r].numpy().tobytes())
                           .hexdigest() for r in win.owned]
        seen["p_main"] = dict(win.p_main)
    sup.on_change = on_change
    pre = {}
    res = {"proc": me}
    t0 = time.monotonic()
    step = 0
    while opt.membership_change is None and time.monotonic() - t0 < 30:
        win = W._store.get(name)
        pre = {"rows": [hashlib.sha256(win.main[r].numpy().tobytes())
                        .hexdigest() for r in win.owned],
               "p_main": dict(win.p_main)}
        if kind != "push_sum":
            x.grad = torch.full_like(x, 0.01 * (me + 1))
        opt.step()          # rank 3 SIGKILLs itself at the top of step 2
        step += 1
        builds.append(opt._fused_impl.builds if opt._fused_impl else 0)
        time.sleep(0.1)
    v = opt.membership_change
    res.update(epoch=v.epoch, active=list(v.active_ranks),
               removed=list(v.removed_ranks), evicted=opt.evicted,
               recovered_at=step, rows_equal=sup.last_recovery["rows_equal"],
               snapshot_rows=pre["rows"], rebuilt_rows=seen["rebuilt"],
               p_restored=seen["p_main"] == pre["p_main"])
    res["builds"] = builds
    survivors = [0, 1, 2]
    if kind != "push_sum":
        for _ in range(3):
            x.grad = torch.full_like(x, 0.01 * (me + 1))
            opt.step()
        res["builds_after"] = opt._fused_impl.builds
        res["fused_steps"] = opt._fused_impl.fused_steps
        res["statuses"] = opt._fused_impl.last_statuses
        res["finite"] = bool(torch.isfinite(x).all())
        res["healthz"] = telemetry.health().get("membership")
        res["recoveries"] = telemetry.snapshot().get(
            "bf_churn_recovery_seconds_count")
        with open(out, "w") as f:
            json.dump(res, f)
        _file_barrier(tmp, "done", me, survivors)
        opt.free()
        bf.shutdown()
        return
    _file_barrier(tmp, "recovered", me, survivors)
    time.sleep(0.5)                 # old-epoch mass in flight lands
    res["mass_resumed"] = _local_mass(W, name)
    _file_barrier(tmp, "measured", me, survivors)
    for _ in range(5):
        opt.step()
    W.win_fence()                   # among the survivors, no collective
    res["mass_end"] = _local_mass(W, name)
    res["p_end"] = list(W._store.get(name).p_main.values())
    opt.collect()
    res["p_collected"] = list(W._store.get(name).p_main.values())
    snap = telemetry.snapshot()
    res["recoveries"] = snap.get("bf_churn_recovery_seconds_count")
    res["healthz"] = telemetry.health().get("membership")
    res["send_errors"] = opt.churn_send_errors
    with open(out, "w") as f:
        json.dump(res, f)
    _file_barrier(tmp, "done", me, survivors)
    bf.shutdown()


def _gang(tmp_path, kind):
    """The 4 workers of ``kind``; the 3 survivors' results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kids = []
    for p in range(PROCS):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "BLUEFOG_TPU_", "MASTER_",
                                    "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES=str(PROCS), BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_ID=str(p), BFTPU_LOCAL_DEVICES="1",
                   BFTPU_WIN_HOST="127.0.0.1",
                   BLUEFOG_TPU_CHURN="1",
                   BLUEFOG_TPU_CHURN_HEARTBEAT_MS="80",
                   BLUEFOG_TPU_CHURN_SUSPECT_MS="500",
                   BLUEFOG_TPU_WIN_RETRIES="1",
                   BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS="25",
                   BLUEFOG_TPU_CHAOS="kill:rank=3:step=2")
        kids.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / f"p{p}.json"),
             str(tmp_path), kind], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for k in kids:
            try:
                logs.append(k.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                k.kill()
                logs.append(k.communicate()[0])
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
                k.wait()
    assert kids[3].returncode == -signal.SIGKILL, logs[3][-3000:]
    for p in range(3):
        assert kids[p].returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    return [json.loads((tmp_path / f"p{p}.json").read_text())
            for p in range(3)]


def test_survivors_commit_one_view_and_keep_push_sum_mass(tmp_path):
    res = _gang(tmp_path, "push_sum")
    for r in res:
        assert (r["epoch"], r["active"], r["removed"]) == (1, [0, 1, 2], [3])
        assert not r["evicted"]
        assert r["rows_equal"] == {"pushsum.fused": True}
        assert r["rebuilt_rows"] == r["snapshot_rows"]
        assert r["p_restored"]
        assert r["recoveries"] == 1.0
        assert r["healthz"]["epoch"] == 1
        assert r["healthz"]["active_ranks"] == [0, 1, 2]
        assert all(p > 0 for p in r["p_end"] + r["p_collected"])
    resumed = sum(r["mass_resumed"] for r in res)
    end = sum(r["mass_end"] for r in res)
    collected = sum(sum(r["p_collected"]) for r in res)
    assert 0 < resumed <= 4.0
    assert abs(end - resumed) <= MASS_TOL
    assert abs(collected - resumed) <= MASS_TOL


def test_fused_win_put_survives_and_rekeys(tmp_path):
    """The same gang under ``DistributedWinPutOptimizer(fused=True)``: one
    committed view, the rows rebuilt bit for bit, and the fused program
    built anew at the new epoch (on the CPU it runs uncaptured), its puts'
    statuses 0 after."""
    res = _gang(tmp_path, "win_put")
    for r in res:
        assert (r["epoch"], r["active"], r["removed"]) == (1, [0, 1, 2], [3])
        assert r["rows_equal"] == {"winput.fused": True}
        assert r["rebuilt_rows"] == r["snapshot_rows"]
        assert r["builds"][-1] > r["builds"][0] or \
            r["builds_after"] > r["builds"][0]
        assert r["statuses"] and all(v == 0 for v in r["statuses"])
        assert r["finite"] and r["recoveries"] == 1.0
        assert r["healthz"]["active_ranks"] == [0, 1, 2]


class _FakeTransport:
    n_stripes = 1

    def __init__(self):
        self.sent = []

    def send(self, host, port, op, name, src, dst, weight, payload,
             *a, **kw):
        self.sent.append((op, bytes(payload)))

    def set_partition(self, addrs):
        pass

    def set_send_delay(self, sec):
        pass


def test_supervisor_ticks_the_tuner_and_async_step_does_not(monkeypatch):
    import types

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import membership as TM
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run import supervisor as S
    from bluefog_tpu_torch.utils import config, tuner
    ticks = []
    monkeypatch.setattr(tuner, "tick", lambda step: ticks.append(step))
    W.set_async_step(3)
    assert ticks == []
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    monkeypatch.setenv("BLUEFOG_TPU_CHURN_HEARTBEAT_MS", "100000")
    config.reload()
    bf.init(2, device="cpu")
    tr = _FakeTransport()
    W._store.distrib = types.SimpleNamespace(
        transport=tr, rank_owner={0: 0, 1: 1},
        proc_addr={0: ("127.0.0.1", 1), 1: ("127.0.0.1", 2)}, my_proc=0,
        my_rank=0)
    try:
        sup = S.ChurnSupervisor()
        assert TM.current() is sup.ctrl
        assert sup.step(5) is None and ticks == [5]
        sup.ctrl.tick()
        from bluefog_tpu_torch.ops.transport import OP_MEMBER

        # Each (peer, stripe) copy leaves on its own sender thread.
        deadline = time.monotonic() + 10
        while not tr.sent and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tr.sent and tr.sent[0][0] == OP_MEMBER
        assert json.loads(tr.sent[0][1])["step"] == 5
        sup.stop()
        assert TM.current() is None
    finally:
        W._store.distrib = None
        bf.shutdown()
        monkeypatch.delenv("BLUEFOG_TPU_CHURN")
        config.reload()


class _BlockingTransport(_FakeTransport):
    """Two stripes; a send on stripe 0 to the peer at port 2 blocks until
    released, as the native sender's does while a row is copied into
    that stripe's queue."""
    n_stripes = 2

    def __init__(self):
        super().__init__()
        import threading
        self.release = threading.Event()

    def send(self, host, port, op, name, src, dst, weight, payload,
             *a, stripe=0, **kw):
        if port == 2 and stripe == 0:
            self.release.wait(30)
        self.sent.append((port, stripe))


def test_a_blocked_heartbeat_copy_delays_no_other(monkeypatch):
    """A tick returns while one (peer, stripe) copy is blocked, and the
    other stripe's copy and the other peer's copies are sent meanwhile."""
    import types

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run import supervisor as S
    from bluefog_tpu_torch.utils import config
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    monkeypatch.setenv("BLUEFOG_TPU_CHURN_HEARTBEAT_MS", "100000")
    config.reload()
    bf.init(3, device="cpu")
    tr = _BlockingTransport()
    W._store.distrib = types.SimpleNamespace(
        transport=tr, rank_owner={0: 0, 1: 1, 2: 2},
        proc_addr={0: ("127.0.0.1", 1), 1: ("127.0.0.1", 2),
                   2: ("127.0.0.1", 3)}, my_proc=0, my_rank=0)
    try:
        sup = S.ChurnSupervisor()
        t0 = time.monotonic()
        sup.ctrl.tick()
        assert time.monotonic() - t0 < 5
        deadline = time.monotonic() + 10
        while len(tr.sent) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(tr.sent) == [(2, 1), (3, 0), (3, 1)]
        tr.release.set()
        while len(tr.sent) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(tr.sent) == [(2, 0), (2, 1), (3, 0), (3, 1)]
        sup.stop()
    finally:
        tr.release.set()
        W._store.distrib = None
        bf.shutdown()
        monkeypatch.delenv("BLUEFOG_TPU_CHURN")
        config.reload()


def test_supervisor_refuses_without_churn_or_transport(monkeypatch):
    from bluefog_tpu_torch.run import supervisor as S
    from bluefog_tpu_torch.utils import config
    monkeypatch.delenv("BLUEFOG_TPU_CHURN", raising=False)
    config.reload()
    with pytest.raises(RuntimeError, match="BLUEFOG_TPU_CHURN=1"):
        S.ChurnSupervisor()
    assert S.maybe_supervisor() is None
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    config.reload()
    try:
        with pytest.raises(RuntimeError, match="window transport"):
            S.ChurnSupervisor()
        assert S.maybe_supervisor() is None
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_CHURN")
        config.reload()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], sys.argv[3])
