"""The port's elastic run loop against the JAX package's.

The same deterministic linear problem (numpy arithmetic, step-keyed data)
runs under each package's ``run_elastic``: uninterrupted, preempted by a
SIGTERM and resumed, crashed between saves and resumed, in both save
modes.  The saved steps after pruning, the resume step, the preemption
step and the final state agree (the state within 1e-6; the step numbers
exactly).  On identical directory fixtures, ``_max_common_step``,
``_owned_rows_of``, the owned-rank invalidation and the world-size stitch
(each package's checkpoints of the same per-process copies) give the same
results.  Then ``per_process`` agreement across 2 gloo processes.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu.utils import checkpoint as JC
from bluefog_tpu.utils import elastic as JE
from bluefog_tpu_torch.utils import checkpoint as TC
from bluefog_tpu_torch.utils import elastic as TE

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6


def _problem():
    rng = np.random.RandomState(0)
    A = (np.eye(3) + 0.1 * rng.randn(3, 3)).astype(np.float32)
    b = rng.randn(4, 3).astype(np.float32)

    def step_fn(state, step):
        noise = np.random.RandomState(step).randn(4, 3).astype(np.float32)
        w = np.asarray(state["w"])
        g = (w @ A - b + 0.01 * noise).astype(np.float32)
        return {"w": (w - np.float32(0.1) * g).astype(np.float32),
                "count": int(state["count"]) + 1}
    return step_fn, {"w": np.zeros((4, 3), np.float32), "count": 0}


def _run(E, C, d, scenario):
    """One scenario under one package: the final state, the steps on disk,
    the resume start seen by ``on_restore`` and a preemption's step."""
    step_fn, state0 = _problem()
    seen = {"start": None, "preempted": None}

    def on_restore(state, start):
        seen["start"] = start

    kw = dict(ckpt_dir=d, save_every=3, keep=2, on_restore=on_restore)
    if scenario == "sync":
        kw["async_save"] = False
    if scenario == "preempt":
        def poke(_s, step):
            if step == 4:
                os.kill(os.getpid(), signal.SIGTERM)
        with pytest.raises(E.Preempted) as ei:
            E.run_elastic(step_fn, state0, num_steps=10, on_step=poke, **kw)
        seen["preempted"] = (ei.value.step, C.list_steps(d))
    if scenario == "crash":
        s = state0
        for t in range(5):
            s = step_fn(s, t)
            if (t + 1) % 2 == 0:
                C.save(d, s, step=t + 1)
    out = E.run_elastic(step_fn, state0, num_steps=10, **kw)
    return (np.asarray(out["w"]), int(out["count"]), C.list_steps(d),
            seen["start"], seen["preempted"])


@pytest.mark.parametrize("scenario", ["fresh", "sync", "preempt", "crash"])
def test_run_elastic_matches_jax(tmp_path, scenario):
    j = _run(JE, JC, str(tmp_path / "j"), scenario)
    t = _run(TE, TC, str(tmp_path / "t"), scenario)
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    assert t[1:] == j[1:]
    straight, _ = _problem()[1], None
    step_fn, s = _problem()
    for k in range(10):
        s = step_fn(s, k)
    np.testing.assert_array_equal(t[0], s["w"])     # bit-exact resume


@pytest.mark.parametrize("per", [
    [[2, 4, 6], [4, 6], [6, 4, 2]], [[2, 4], [6]], [[], [3]], [[5]],
    [[0, 3, 7], [3, 7, 9], [1, 3, 7]]])
def test_max_common_step_equals_jax(per):
    assert TE._max_common_step(per) == JE._max_common_step(per)


def _maps(base, maps):
    for i, m in enumerate(maps):
        d = os.path.join(base, f"proc{i}")
        os.makedirs(d, exist_ok=True)
        if m is not None:
            with open(os.path.join(d, "owned_ranks.json"), "w") as fh:
                json.dump(m, fh)


MAPS = [
    [{"ranks": [0, 1, 2], "nproc": 2}, {"ranks": [3], "nproc": 2}],
    [[0, 1], [2, 3]],
    [{"ranks": [0], "nproc": 3}, {"ranks": [1, 2], "nproc": 3},
     {"ranks": [3], "nproc": 3}, {"ranks": [], "nproc": 4}],
    [{"ranks": [0, 1], "nproc": 2}, None],
    [{"ranks": [0, 2], "nproc": 2}, {"ranks": [0, 3], "nproc": 2}],
]


@pytest.mark.parametrize("i", range(len(MAPS)))
@pytest.mark.parametrize("nproc", [2, 3])
def test_owned_maps_and_invalidation_equal_jax(tmp_path, i, nproc):
    out = []
    for name, E in (("j", JE), ("t", TE)):
        base = str(tmp_path / name)
        _maps(base, MAPS[i])
        dirs = E._proc_dirs(base)
        rows = E._owned_rows_of(dirs, 4)
        E._invalidate_stale_owned_ranks(base, nproc)
        files = sorted(os.path.relpath(os.path.join(r, f), base)
                       for r, _, fs in os.walk(base) for f in fs)
        out.append((rows, files, [os.path.basename(d) for d in dirs]))
    assert out[1] == out[0]


def _write_copies(C, base, maps, true):
    """Each old process's copy of an 8-row state at step 6: its own rows
    authoritative, the rest stale poison."""
    _maps(base, maps)
    for k, m in enumerate(maps):
        copy = np.full(true.shape, -1000.0, np.float32)
        rows = m["ranks"]
        copy[rows] = true[rows]
        C.save(os.path.join(base, f"proc{k}"),
               {"w": copy, "count": np.int32(6),
                "nt": {"zz": np.float32(11.0), "aa": np.float32(22.0)}},
               step=6)


@pytest.mark.parametrize("maps", [
    [{"ranks": [0, 1], "nproc": 4}, {"ranks": [2, 3], "nproc": 4},
     {"ranks": [4, 5], "nproc": 4}, {"ranks": [6, 7], "nproc": 4}],
    [{"ranks": [0, 1, 2, 3, 4, 5], "nproc": 2},
     {"ranks": [6, 7], "nproc": 2}],
])
def test_world_size_stitch_equals_jax(tmp_path, maps):
    """Four (or two, non-uniform) old processes' copies of an 8-rank state;
    a 4-rank resume stitches the authoritative rows, averages them and
    resumes from step 6 in both packages, with the same values."""
    true = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    res = []
    for name, E, C in (("j", JE, JC), ("t", TE, TC)):
        base = str(tmp_path / name)
        _write_copies(C, base, maps, true)
        seen = {}

        def on_restore(state, start):
            seen["start"] = start
            seen["w"] = np.asarray(state["w"]).copy()
            seen["nt"] = (float(state["nt"]["zz"]), float(state["nt"]["aa"]))

        def step_fn(state, step):
            return {"w": np.asarray(state["w"]) + np.float32(1.0),
                    "count": state["count"], "nt": state["nt"]}
        out = E.run_elastic(
            step_fn, {"w": np.zeros((4, 3), np.float32),
                      "count": np.int32(0),
                      "nt": {"zz": np.float32(0.0), "aa": np.float32(0.0)}},
            ckpt_dir=base, num_steps=8, save_every=100,
            on_restore=on_restore)
        res.append((seen["start"], seen["w"], seen["nt"],
                    np.asarray(out["w"]), int(out["count"])))
    assert res[1][0] == res[0][0] == 6
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=TOL)
    np.testing.assert_allclose(res[1][1], np.broadcast_to(true.mean(0),
                                                          (4, 3)), rtol=TOL)
    assert res[1][2] == res[0][2] == (11.0, 22.0)
    np.testing.assert_allclose(res[1][3], res[0][3], rtol=TOL)
    assert res[1][4] == res[0][4] == 6


def _worker(out, base, prune):
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo")
    r = dist.get_rank()
    # Process 1 pruned its frontier away: the resume must take the newest
    # step both hold.
    d = os.path.join(base, f"proc{r}")
    for s in ([2, 4, 6] if r == 0 or not prune else [2, 4]):
        TC.save(d, {"w": np.full(3, float(s), np.float32), "count": s},
                step=s)
    dist.barrier()
    seen = {}

    def on_restore(state, start):
        seen["start"] = start

    outp = TE.run_elastic(
        lambda st, t: {"w": np.asarray(st["w"]) + 1, "count": st["count"]
                       + 1},
        {"w": np.zeros(3, np.float32), "count": 0}, ckpt_dir=base,
        num_steps=8, save_every=100, per_process=True,
        on_restore=on_restore)
    torch.save({"start": seen.get("start"), "count": outp["count"],
                "w": outp["w"].tolist(), "steps": TC.list_steps(d)}, out)
    dist.barrier()
    dist.destroy_process_group()


def test_per_process_agreement_two_processes(tmp_path):
    """``per_process=True`` over 2 gloo processes: the resume step is the
    newest one every process saved (4, when process 1 lacks 6), newer
    local steps are dropped, and both finish from it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kids = []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "MASTER_", "WORLD_SIZE",
                                    "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(p),
                   OMP_NUM_THREADS="1")
        kids.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / f"r{p}.pt"),
             str(tmp_path / "ck"), "1"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [k.communicate(timeout=120)[0] for k in kids]
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
    import torch
    for p, k in enumerate(kids):
        assert k.returncode == 0, logs[p][-3000:]
        res = torch.load(tmp_path / f"r{p}.pt", weights_only=False)
        assert res["start"] == 4 and res["count"] == 8
        assert res["w"] == [8.0] * 3
        assert res["steps"][-1] == 8 and 6 not in res["steps"]


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], sys.argv[3] == "1")
