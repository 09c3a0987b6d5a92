"""The port's one-sided windows across processes against its one-process
path.

Gloo process groups on the CPU, launched as ``tests/test_torch_port_dist.py``
launches them (this file runs itself as the worker under ``bfrun``'s
``BFTPU_*`` rendezvous): 2 processes of 2 ranks and 4 processes of 2 ranks,
the two layouts of the JAX package's ``test_multiprocess_windows``
(``tests/test_window.py`` L385).  Every payload that crosses a process
travels over the port's own window transport (``ops/transport.py``), not
the process group.  Each layout runs its scenarios in one launch:

- every window op, fenced after each op, in the rank and the owned layouts
  and through both transport paths (native, ``BLUEFOG_TPU_WIN_NATIVE=0``):
  the owned rows, versions and P scalars equal the one-process port's bit
  for bit on the same inputs (the one-process port is held to the JAX
  package bit for bit in ``tests/test_torch_port_window.py``);
- ``bf16`` compression within ``rtol=1e-2``; ``sparse:0.25`` keeps the
  accumulated mass (what arrived plus the sender's residual is what was
  sent, within float32 rounding);
- the remote mutex excludes a writer in another process; a GET that no
  one answers times out with a ``ConnectionError``;
- the three optimizers a few steps, held to the JAX package's invariants
  (``tests/test_multiprocess_collectives.py`` L280-454): the consensus
  spread of the gathered parameters shrinks (the first combine, and over
  the run); push-sum's P
  sums to n within ``rtol=1e-4`` and its mass over P is the true mean
  within 2e-3, at every collect of a randomized column-stochastic
  accumulate and after the optimizer's ``collect``; ``gather`` returns
  the rank-major view.
"""

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
COLS = 6
JOIN_TIMEOUT = 150       # seconds a process group may take before it fails
LAYOUTS = {"2x2": (2, 2), "4x2": (4, 2)}
PATHS = ("native", "python")
WIN_LAYOUTS = ("rank", "owned")
SPARSE_ROUNDS = 3
PUSHSUM_ROUNDS = 12
OPT_STEPS = 4
OPT_CASES = (("win_put", "owned"), ("win_put", "rank"),
             ("pull_get", "owned"), ("push_sum", "owned"))


def rank_major(n, seed=SEED):
    return np.random.RandomState(seed).randn(n, COLS).astype(np.float32)


def window_ops(bf, x, own, layout):
    """The window ops on ``x`` (rank-major numpy) under the world's
    ExponentialGraph, each followed by a fence: the owned ranks' rows,
    versions and P scalars, keyed by what they are.  A local read that a
    later remote write must not overtake ends in a barrier: a process
    that leaves a fence first may send before a slower one has read."""
    n = bf.size()
    rows = list(own) if layout == "owned" else list(range(n))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows]))

    def owned_rows(out):
        return out if layout == "owned" else out[list(own)]

    step1 = {(r, (r + 1) % n): 0.3 + 0.05 * r for r in range(n)}
    step2 = {(r, (r + 2) % n): 0.35 for r in range(n)}
    out = {}
    bf.turn_on_win_ops_with_associated_p()
    bf.win_create(t(x), "w", zero_init=True)
    bf.win_put(t(1.5 * x), "w", dst_weights=step1)       # partial dsts
    bf.win_fence()
    out["versions_put"] = [bf.get_win_version("w", r) for r in own]
    bf.barrier()
    bf.win_accumulate(t(x), "w", self_weight=0.45, dst_weights=step2)
    bf.win_fence()
    bf.win_get("w", src_weights={(r, (r - 1) % n): 0.6 for r in range(n)})
    bf.win_fence()
    # Partial weights: the other in-edges stay pending.
    out["update_partial"] = owned_rows(bf.win_update(
        "w", self_weight=0.3, neighbor_weights={
            (r, (r - 1) % n): 0.7 for r in range(n)}, reset_weights=True))
    out["versions_pending"] = [bf.get_win_version("w", r) for r in own]
    bf.win_fence()
    out["collect"] = owned_rows(bf.win_update_then_collect("w"))
    out["p"] = [float(bf.win_associated_p("w", r)) for r in own]
    bf.turn_off_win_ops_with_associated_p()
    bf.win_fence()
    snap = bf.win_state_dict("w")
    bf.barrier()
    bf.win_put(t(x), "w")
    bf.win_fence()
    bf.win_load_state_dict("w", snap)
    bf.win_fence()
    bf.win_accumulate(t(0.5 * x), "w")
    bf.win_fence()
    out["after_restore"] = owned_rows(bf.win_update("w"))
    bf.win_fence()
    # A require_mutex put from another thread waits while the mutexes of
    # ranks 1 and 2 are held (here or, for a rank another process owns,
    # through the transport).
    done = threading.Event()
    with bf.win_mutex("w", ranks=[1, 2]):
        th = threading.Thread(target=lambda: (
            bf.win_put(t(x), "w", require_mutex=True), done.set()))
        th.start()
        time.sleep(0.2)
        out["blocked_while_held"] = not done.is_set()
    th.join(timeout=60)
    out["ran_after_release"] = done.is_set()
    bf.win_fence()
    out["after_mutex_put"] = owned_rows(bf.win_update("w"))
    bf.win_fence()
    bf.win_free("w")
    # The next sequence's "w" must not take a put meant for this one.
    bf.barrier()
    return out


def _restart_transport(native: bool) -> None:
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config
    os.environ["BLUEFOG_TPU_WIN_NATIVE"] = "1" if native else "0"
    config.reload()
    W._shutdown_transport()
    W.init_transport()
    assert W._store.distrib.transport.native_path == native


def _sparse_mass(bf, x, own):
    """``SPARSE_ROUNDS`` fenced accumulates of ``x`` under sparse:0.25:
    the staging each owned rank received and the residuals its sends left
    behind."""
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config
    with config.override(win_compression="sparse:0.25"):
        bf.win_create(torch.from_numpy(x[list(own)]), "s", zero_init=True)
        for _ in range(SPARSE_ROUNDS):
            bf.win_accumulate(torch.from_numpy(x[list(own)]), "s")
            bf.win_fence()
        staging = bf.win_state_dict("s")["staging"]
        residuals = {k[1:]: v.clone() for k, v in W._ef_residuals.items()
                     if k[0] == "s"}
        bf.win_free("s")
    return {"staging": staging, "residuals": residuals}


def _remote_mutex(bf, x, own, comm):
    """Process 0 holds the mutex of process 1's first rank; process 1's own
    acquire of it, started while it is held, must complete after process
    0 let go (the wall clocks of one machine)."""
    import torch.distributed as dist
    bf.win_create(torch.from_numpy(x[list(own)]), "m", zero_init=True)
    target = comm.per_process     # process 1's first rank
    stamp = None
    if comm.process == 0:
        with bf.win_mutex("m", ranks=[target]):
            dist.barrier()
            time.sleep(0.3)
            stamp = time.time()   # released after this
    elif comm.process == 1:
        dist.barrier()
        with bf.win_mutex("m", ranks=[target]):
            stamp = time.time()   # acquired before this
    else:
        dist.barrier()
    bf.win_fence()
    bf.win_free("m")
    return stamp


def _get_timeout(bf, x, own, comm):
    """Every other process frees its window; process 0's GET goes
    unanswered and must time out with a ConnectionError."""
    import torch.distributed as dist
    from bluefog_tpu_torch.utils import config
    bf.win_create(torch.from_numpy(x[list(own)]), "g", zero_init=True)
    dist.barrier()
    if comm.process != 0:
        bf.win_free("g")
    dist.barrier()
    err = None
    if comm.process == 0:
        with config.override(win_timeout=1.0):
            try:
                bf.win_get("g")
            except ConnectionError as e:
                err = str(e)
    dist.barrier()
    bf.win_free("g")
    return err


def _pushsum_invariant(bf, x, own, comm):
    """The JAX package's randomized push-sum invariant: a random
    column-stochastic accumulate a round (the same on every process),
    fenced, then the collect; the world's P and mass at every collect."""
    from bluefog_tpu_torch import topology as topo
    n = bf.size()
    g = bf.load_topology()
    outs = {r: list(topo.out_neighbor_ranks(g, r)) for r in range(n)}
    bf.turn_on_win_ops_with_associated_p()
    v = torch.from_numpy(x[list(own)].copy())
    bf.win_create(v, "ps", zero_init=True)
    psums, masses = [], []
    for step in range(PUSHSUM_ROUNDS):
        wrng = np.random.RandomState(1000 + step)
        dst_w, self_share = {}, np.zeros(n)
        for r in range(n):
            raw = wrng.uniform(0.2, 1.0, size=len(outs[r]) + 1)
            raw = raw / raw.sum()
            self_share[r] = raw[0]
            for o, wgt in zip(outs[r], raw[1:]):
                dst_w[(r, o)] = wgt
        bf.win_accumulate(v, "ps", self_weight=self_share,
                          dst_weights=dst_w)
        bf.win_fence()
        v = bf.win_update_then_collect("ps")
        p = bf.win_associated_p("ps")[list(own)]
        tot = comm.all_reduce(torch.cat([
            v.double().sum(0), torch.tensor([float(p.sum())],
                                            dtype=torch.float64)])).wait()
        masses.append(tot[:-1])
        psums.append(float(tot[-1]))
    bf.win_fence()
    bf.win_free("ps")
    bf.turn_off_win_ops_with_associated_p()
    return {"psum": psums, "mass": masses}


def _optimizer(bf, family, layout, own, comm):
    """``OPT_STEPS`` steps of a window optimizer on quadratic losses (rank
    r pulls toward its target): the spread of the gathered parameters
    before and after each combine, the gather, and push-sum's P and mass
    after ``collect``."""
    from bluefog_tpu_torch.optim import window_optimizers as WO
    n = bf.size()
    rng = np.random.RandomState(SEED + 1)
    targets = torch.from_numpy(rng.randn(n, COLS).astype(np.float32))
    init = torch.from_numpy(rng.randn(n, COLS).astype(np.float32))
    rows = list(own) if layout == "owned" else list(range(n))
    w = init[rows].clone()
    cls = {"win_put": WO.DistributedWinPutOptimizer,
           "pull_get": WO.DistributedPullGetOptimizer,
           "push_sum": WO.DistributedPushSumOptimizer}[family]
    opt = cls(torch.optim.SGD([w], lr=0.1), layout=layout,
              window_prefix=f"{family}_{layout}")

    def spread():
        g = opt.gather()[0]
        return float((g - g.mean(0)).abs().max())
    rec = {"before": [], "after": []}
    for step in range(OPT_STEPS):
        if family == "push_sum" and step == OPT_STEPS - 1:
            # Nothing in flight before the last step: after its collect
            # the world's mass is the last adapted parameters'.
            opt.collect()
        w.grad = w.detach() - targets[rows]
        opt.adapt()
        rec["before"].append(spread())
        if family == "push_sum":
            adapted = opt.gather()[0].double()
        opt.combine()
        rec["after"].append(spread())
    rec["gather"] = opt.gather()[0].clone()
    rec["own_rows"] = w.detach()[[rows.index(r) for r in own]].clone()
    if family == "push_sum":
        opt.collect()
        p = torch.from_numpy(opt.associated_p()[list(own)])
        tot = comm.all_reduce(torch.cat([
            w.detach()[[rows.index(r) for r in own]].double().sum(0),
            p.sum().reshape(1)])).wait()
        rec["psum"] = float(tot[-1])
        rec["mass_over_p"] = tot[:-1] / tot[-1]
        rec["adapted_mean"] = adapted.mean(0)
    opt.free()
    bf.win_fence()
    return rec


def scenario(bf) -> dict:
    from bluefog_tpu_torch.ops import window as W
    n, own = bf.size(), bf.owned_ranks()
    comm = bf.process_ranks()
    x = rank_major(n)
    res = {"owned": own}
    for path in PATHS:
        if (path == "native") != W._store.distrib.transport.native_path:
            _restart_transport(path == "native")
        for layout in WIN_LAYOUTS:
            res[f"{path}/{layout}"] = window_ops(bf, x, own, layout)
    _restart_transport(True)
    from bluefog_tpu_torch.utils import config
    with config.override(win_compression="bf16"):
        res["bf16/owned"] = window_ops(bf, x, own, "owned")
    res["sparse"] = _sparse_mass(bf, x, own)
    res["mutex_stamp"] = _remote_mutex(bf, x, own, comm)
    res["get_timeout"] = _get_timeout(bf, x, own, comm)
    res["pushsum_invariant"] = _pushsum_invariant(bf, x, own, comm)
    for family, layout in OPT_CASES:
        res[f"opt/{family}/{layout}"] = _optimizer(bf, family, layout, own,
                                                   comm)
    return res


def _worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    bf.init_distributed(device="cpu")
    try:
        torch.save(scenario(bf), args.out)
        bf.barrier()
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path, procs: int, per: int) -> list:
    port = _free_port()
    children = []
    for p in range(procs):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "BLUEFOG_TPU_WIN", "MASTER_",
                                    "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES=str(per),
                   OMP_NUM_THREADS="1", BFTPU_WIN_HOST="127.0.0.1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES=str(procs), BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_ID=str(p))
        children.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / f"proc{p}.pt")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for c in children:
            logs.append(c.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the {procs}-process group hung past {JOIN_TIMEOUT} s")
    for p, c in enumerate(children):
        assert c.returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    return [torch.load(tmp / f"proc{p}.pt", weights_only=False)
            for p in range(procs)]


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def run(request, tmp_path_factory):
    """``(layout, processes' results, one-process window ops)``."""
    procs, per = LAYOUTS[request.param]
    parts = _launch(tmp_path_factory.mktemp(request.param), procs, per)
    import bluefog_tpu_torch as bf
    n = procs * per
    bf.init(n, device="cpu")
    try:
        want = window_ops(bf, rank_major(n), list(range(n)), "rank")
    finally:
        bf.turn_off_win_ops_with_associated_p()
        bf.shutdown()
    return request.param, parts, want


BITWISE_KEYS = ("versions_put", "update_partial", "versions_pending",
                "collect", "p", "after_restore", "after_mutex_put")


def _owned_want(want, own, key):
    v = want[key]
    if isinstance(v, torch.Tensor):
        return v[own]
    return [v[r] for r in own]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("layout", WIN_LAYOUTS)
@pytest.mark.parametrize("key", BITWISE_KEYS)
def test_fenced_window_ops_match_one_process_bitwise(run, path, layout, key):
    _, parts, want = run
    for part in parts:
        got = part[f"{path}/{layout}"][key]
        exp = _owned_want(want, part["owned"], key)
        if isinstance(exp, torch.Tensor):
            assert got.shape == exp.shape
            np.testing.assert_array_equal(got.numpy(), exp.numpy())
        else:
            assert got == exp


@pytest.mark.parametrize("path", PATHS)
def test_mutex_holds_writers_across_processes(run, path):
    """Each process's require_mutex put waits while ranks 1 and 2 are held
    (where its ranks send to one of them), and runs after the release."""
    layout, parts, _ = run
    procs, per = LAYOUTS[layout]
    n = procs * per
    for part in parts:
        res = part[f"{path}/owned"]
        assert res["ran_after_release"]
        sends_to_held = any((r + 2 ** k) % n in (1, 2)
                            for r in part["owned"]
                            for k in range(int(np.log2(n))))
        if sends_to_held:
            assert res["blocked_while_held"]


@pytest.mark.parametrize("key", ("update_partial", "collect",
                                 "after_restore", "after_mutex_put"))
def test_bf16_compression_within_tolerance(run, key):
    _, parts, want = run
    for part in parts:
        got = part["bf16/owned"][key].numpy()
        exp = _owned_want(want, part["owned"], key).numpy()
        np.testing.assert_allclose(got, exp, rtol=1e-2, atol=1e-2)


def test_sparse_compression_keeps_the_accumulated_mass(run):
    """What each edge's receiver holds plus what its sender still owes is
    every accumulate's full row (weight 1 on every out-edge)."""
    layout, parts, _ = run
    procs, per = LAYOUTS[layout]
    n = procs * per
    x = rank_major(n)
    staging, residual = {}, {}
    for part in parts:
        for k, v in part["sparse"]["staging"].items():
            staging[tuple(int(a) for a in k.split(":"))] = v.numpy()
        for (src, dst), v in part["sparse"]["residuals"].items():
            residual[(dst, src)] = v.numpy()
    crossing = 0
    for (dst, src), got in staging.items():
        owed = residual.get((dst, src))
        if dst // per != src // per:
            assert owed is not None, (dst, src)
            crossing += 1
            got = got + owed.reshape(got.shape)
        else:
            assert owed is None
        np.testing.assert_allclose(got, SPARSE_ROUNDS * x[src], rtol=1e-5,
                                   atol=1e-5)
    assert crossing > 0


def test_remote_mutex_excludes_a_writer_in_another_process(run):
    _, parts, _ = run
    assert parts[1]["mutex_stamp"] > parts[0]["mutex_stamp"]


def test_unanswered_get_times_out_cleanly(run):
    _, parts, _ = run
    err = parts[0]["get_timeout"]
    assert err is not None and "no reply" in err, err


def test_push_sum_invariant_at_every_collect(run):
    layout, parts, _ = run
    procs, per = LAYOUTS[layout]
    n = procs * per
    x = rank_major(n)
    for part in parts:
        inv = part["pushsum_invariant"]
        np.testing.assert_allclose(inv["psum"], float(n), rtol=1e-4)
        for mass, psum in zip(inv["mass"], inv["psum"]):
            np.testing.assert_allclose(mass.numpy(), x.sum(0), rtol=2e-3,
                                       atol=2e-3)
            np.testing.assert_allclose(mass.numpy() / psum, x.mean(0),
                                       rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", [f"{f}/{lay}" for f, lay in OPT_CASES])
def test_window_optimizers_shrink_the_spread(run, case):
    """The first combine shrinks the spread of the adapted parameters, and
    the run ends below where it started.  A later step need not shrink
    it: the puts complete locally and ``win_update`` combines what has
    arrived (win_put's self term is the previous combine, as in the JAX
    package)."""
    _, parts, _ = run
    for part in parts:
        rec = part[f"opt/{case}"]
        assert rec["after"][0] < rec["before"][0], rec
        assert rec["after"][-1] < rec["before"][0], rec


@pytest.mark.parametrize("case", [f"{f}/{lay}" for f, lay in OPT_CASES])
def test_gather_returns_the_rank_major_view(run, case):
    _, parts, _ = run
    full = torch.cat([part[f"opt/{case}"]["own_rows"] for part in parts])
    for part in parts:
        np.testing.assert_array_equal(part[f"opt/{case}"]["gather"].numpy(),
                                      full.numpy())


def test_push_sum_optimizer_conserves_p_and_mass(run):
    layout, parts, _ = run
    procs, per = LAYOUTS[layout]
    for part in parts:
        rec = part["opt/push_sum/owned"]
        np.testing.assert_allclose(rec["psum"], float(procs * per),
                                   rtol=1e-4)
        np.testing.assert_allclose(rec["mass_over_p"].numpy(),
                                   rec["adapted_mean"].numpy(), rtol=2e-3,
                                   atol=2e-3)


if __name__ == "__main__":
    _worker()
