"""The port's one-sided windows against the JAX package's, in one process.

Each case of ``tests/test_window.py`` that runs in one process, on the same
seeded numpy inputs through ``bluefog_tpu`` (8 virtual CPU devices) and
``bluefog_tpu_torch`` (``device="cpu"``): the results, the version counters
and the associated-P scalars are equal bit for bit in float32.  Then the
port's own rules: the topology lock, a self-publish that lands mid-combine,
the refused tensors and the parts not ported yet."""

import threading
import time
import types

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import window as JW
from bluefog_tpu_torch import basics
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.utils import config

N = 8


class Side:
    """One package behind one interface: ``to`` makes its input from a
    numpy array, ``back`` reads its output as one."""

    def __init__(self, name):
        self.name = name
        self.bf = jbf if name == "jax" else tbf
        self.topo = jtopo if name == "jax" else ttopo
        self.W = JW if name == "jax" else TW

    def init(self, graph, *args, devices=None):
        if self.name == "jax":
            jbf.init(lambda: getattr(jtopo, graph)(N, *args), devices=devices)
        else:
            tbf.init(N, device="cpu",
                     topology_fn=lambda: getattr(ttopo, graph)(N, *args))

    def to(self, x):
        return x if self.name == "jax" else torch.from_numpy(np.array(x))

    @staticmethod
    def back(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def close(self):
        if self.name == "jax":
            jbf.win_free()
            jbf.turn_off_win_ops_with_associated_p()
        else:
            tbf.turn_off_win_ops_with_associated_p()
            tbf.shutdown()


def both(devices, fn):
    """``fn(side)`` on each package; returns ``(jax result, port result)``."""
    out = []
    for name in ("jax", "port"):
        side = Side(name)
        try:
            out.append(fn(side, devices))
        finally:
            side.close()
    return out


def rank_major(seed=0, shape=(N, 5)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def ring_edges(weight):
    return {(r, s): weight for r in range(N) for s in [(r - 1) % N,
                                                       (r + 1) % N]}


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(a, "shape"):
        np.testing.assert_array_equal(Side.back(b), Side.back(a))
    else:
        assert a == b


# ---------------------------------------------------------------------------
# Each single-process case of tests/test_window.py, in both packages
# ---------------------------------------------------------------------------

def _create_update_free(s, devices):
    s.init("RingGraph", devices=devices)
    x = s.to(rank_major())
    made = [s.bf.win_create(x, "w"), s.bf.win_create(x, "w")]
    names = s.bf.get_current_created_window_names()
    out = s.back(s.bf.win_update("w"))
    freed = [s.bf.win_free("w"), s.bf.win_free("w")]
    return made, names, out, freed, s.bf.get_current_created_window_names()


def _put_then_update(s, devices):
    s.init("RingGraph", devices=devices)
    x = rank_major(1)
    s.bf.win_create(s.to(x), "w", zero_init=True)
    s.bf.win_put(s.to(2.0 * x), "w")
    return s.back(s.bf.win_update("w", self_weight=0.5,
                                  neighbor_weights=ring_edges(0.25)))


def _put_partial_destinations(s, devices):
    s.init("RingGraph", devices=devices)
    x = rank_major(2)
    s.bf.win_create(s.to(x), "w", zero_init=True)
    s.bf.win_put(s.to(x), "w",
                 dst_weights={(r, (r + 1) % N): 0.3 for r in range(N)})
    versions = [s.bf.get_win_version("w", r) for r in range(N)]
    return versions, s.back(s.bf.win_update(
        "w", self_weight=1.0, neighbor_weights=ring_edges(1.0)))


def _partial_update_weights(s, devices):
    s.init("RingGraph", devices=devices)
    x = rank_major(3)
    s.bf.win_create(s.to(x), "w", zero_init=True)
    s.bf.win_put(s.to(x), "w")
    ccw = {(r, (r - 1) % N): 0.7 for r in range(N)}
    out = s.back(s.bf.win_update("w", self_weight=0.3, neighbor_weights=ccw,
                                 reset_weights=True))
    pending = s.bf.get_win_version("w", 0)
    out2 = s.back(s.bf.win_update("w", self_weight=1.0,
                                  neighbor_weights=ring_edges(1.0),
                                  reset_weights=True))
    return out, pending, out2, s.bf.get_win_version("w", 0)


def _accumulate(s, devices):
    s.init("RingGraph", devices=devices)
    x = rank_major(4, (N, 2))
    s.bf.win_create(s.to(x), "w", zero_init=True)
    s.bf.win_accumulate(s.to(x), "w")
    s.bf.win_accumulate(s.to(0.5 * x), "w", dst_weights={
        (r, (r + 1) % N): 0.6 for r in range(N)})
    return s.back(s.bf.win_update("w", self_weight=1.0,
                                  neighbor_weights=ring_edges(1.0)))


def _get(s, devices):
    s.init("RingGraph", devices=devices)
    x = rank_major(5)
    s.bf.win_create(s.to(x), "w", zero_init=True)
    s.bf.win_get("w", src_weights=ring_edges(0.5))
    first = s.back(s.bf.win_update("w", self_weight=1.0,
                                   neighbor_weights=ring_edges(1.0)))
    s.bf.win_get("w")
    return first, s.back(s.bf.win_update("w"))


def _versions(s, devices):
    s.init("RingGraph", devices=devices)
    x = s.to(rank_major(6))
    s.bf.win_create(x, "w")
    seen = [s.bf.get_win_version("w", 0)]
    s.bf.win_put(x, "w")
    seen.append(s.bf.get_win_version("w", 0))
    s.bf.win_put(x, "w")
    seen.append(s.bf.get_win_version("w", 0))
    s.bf.win_update("w")
    seen.append(s.bf.get_win_version("w", 0))
    return seen


def _exponential_default_weights(s, devices):
    """The topology's default weights, uniform and weighted, through the
    nonblocking handles."""
    s.init("ExponentialGraph", devices=devices)
    x = rank_major(7, (N, 3, 4))
    s.bf.win_create(s.to(x), "w")
    h = s.bf.win_put_nonblocking(s.to(1.5 * x), "w", self_weight=0.25)
    s.bf.win_wait(h)
    uniform = s.back(s.bf.win_update("w"))
    s.bf.win_free("w")
    s.bf.set_topology(s.topo.RingGraph(N), is_weighted=True)
    s.bf.win_create(s.to(x), "w")
    s.bf.win_accumulate(s.to(x), "w")
    return uniform, s.back(s.bf.win_update("w"))


CASES = {"create_update_free": _create_update_free,
         "put_then_update": _put_then_update,
         "put_partial_destinations": _put_partial_destinations,
         "partial_update_weights": _partial_update_weights,
         "accumulate": _accumulate, "get": _get, "versions": _versions,
         "default_weights": _exponential_default_weights}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_ops_match_jax_bitwise(devices, case):
    want, got = both(devices, CASES[case])
    assert_same(want, got)


def test_associated_p_push_sum_invariant_matches_jax(devices):
    """Randomized column-stochastic push-sum: every round's collected rows
    and P vector bit for bit, P summing to n, and the de-biased rows
    reaching the initial average."""
    x = rank_major(8, (N, 3))
    shares = np.random.RandomState(9).uniform(0.2, 0.8, size=(150, N))

    def run(s, devices):
        s.init("RingGraph", 2, devices=devices)  # directed: send to r + 1
        s.bf.turn_on_win_ops_with_associated_p()
        s.bf.win_create(s.to(x), "w", zero_init=True)
        cur, trace = s.to(x), []
        for share in shares:
            s.bf.win_accumulate(
                cur, "w", self_weight=1.0 - share,
                dst_weights={(r, (r + 1) % N): float(share[r])
                             for r in range(N)})
            cur = s.bf.win_update_then_collect("w")
            p = np.asarray(s.bf.win_associated_p("w"))
            assert abs(p.sum() - N) < 1e-9, "P mass not conserved"
            trace.append((s.back(cur).copy(), p))
        return trace

    want, got = both(devices, run)
    assert_same(want, got)
    rows, p = got[-1]
    np.testing.assert_allclose(rows / p[:, None],
                               np.tile(x.mean(0), (N, 1)), atol=1e-3)


def test_win_state_dict_resume_matches_jax(devices):
    """A snapshot mid-push-sum, restored into a fresh window, replays the
    uninterrupted run bit for bit, and the snapshots of both packages hold
    the same state."""
    x = rank_major(10, (N, 4))
    edges = {(r, (r + 1) % N): 0.5 for r in range(N)}

    def run(s, devices):
        def fresh():
            s.init("RingGraph", 2, devices=devices)
            s.bf.turn_on_win_ops_with_associated_p()
            s.bf.win_create(s.to(x), "ck", zero_init=True)

        def step(cur):
            s.bf.win_accumulate(cur, "ck", self_weight=0.5, dst_weights=edges)
            return s.bf.win_update_then_collect("ck")

        fresh()
        cur = s.to(x)
        for _ in range(3):
            cur = step(cur)
        snap = s.bf.win_state_dict("ck")
        mid = cur
        for _ in range(3):
            cur = step(cur)
        final, p_final = s.back(cur).copy(), s.bf.win_associated_p("ck")
        s.close()
        fresh()
        s.bf.win_load_state_dict("ck", snap)
        cur = mid
        for _ in range(3):
            cur = step(cur)
        np.testing.assert_array_equal(s.back(cur), final)
        np.testing.assert_array_equal(s.bf.win_associated_p("ck"), p_final)
        return {k: {kk: (s.back(v) if hasattr(v, "shape") and np.ndim(v)
                         else float(v)) for kk, v in snap[k].items()}
                for k in ("main", "staging", "versions", "main_versions",
                          "p_main", "p_staging")}

    want, got = both(devices, run)
    assert_same(want, got)


def test_win_load_state_dict_validates():
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    try:
        tbf.win_create(torch.zeros(N, 3), "v")
        snap = tbf.win_state_dict("v")
        tbf.win_free("v")
        tbf.win_create(torch.zeros(N, 5), "v")  # another shape
        with pytest.raises(ValueError, match="does not match"):
            tbf.win_load_state_dict("v", snap)
        with pytest.raises(ValueError, match="'main' must map"):
            tbf.win_load_state_dict("v", {"main": torch.zeros(N, 5)})
    finally:
        tbf.shutdown()


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------

@pytest.fixture
def ring():
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    yield
    tbf.turn_off_win_ops_with_associated_p()
    tbf.shutdown()


def test_set_topology_fails_with_windows(ring):
    """Reference: set_topology refuses while windows exist
    (``torch_basics_test.py:63-93``); shutdown frees them."""
    tbf.win_create(torch.from_numpy(rank_major()), "w")
    with pytest.raises(RuntimeError, match="windows exist"):
        tbf.set_topology(ttopo.ExponentialGraph(N))
    tbf.win_free("w")
    assert tbf.set_topology(ttopo.ExponentialGraph(N))
    tbf.win_create(torch.from_numpy(rank_major()), "w")
    tbf.shutdown()
    assert TW._store.windows == {}


def test_win_mutex_excludes_writers(ring):
    """Holding a rank's mutex blocks ``require_mutex`` puts to it until it
    is released (reference ``test_win_mutex_full:705``)."""
    x = torch.ones(N, 2)
    tbf.win_create(x, "w", zero_init=True)
    progressed = threading.Event()

    def writer():
        tbf.win_put(x, "w", require_mutex=True)
        progressed.set()

    with tbf.win_mutex("w", ranks=list(range(N))):
        t = threading.Thread(target=writer)
        t.start()
        time.sleep(0.15)
        assert not progressed.is_set(), "put proceeded despite held mutex"
    t.join(timeout=5)
    assert progressed.is_set()
    with tbf.win_mutex("w", for_self=True):   # rank 0 and its out-nbrs
        assert all(TW._store.get("w").mutexes[r]._is_owned()
                   for r in (0, 1, N - 1))
    tbf.win_fence()


class _PublishOnRead(dict):
    """Staging whose first read of ``key`` publishes into main first: a
    self-publish that lands between win_update's snapshot and its swap."""

    def __init__(self, items, key, publish):
        super().__init__(items)
        self.key, self.publish = key, publish

    def __getitem__(self, k):
        if k == self.key and self.publish is not None:
            publish, self.publish = self.publish, None
            publish()
        return super().__getitem__(k)


@pytest.mark.parametrize("assoc_p", [False, True])
def test_publish_mid_combine_serializes_after_the_update(devices, assoc_p):
    """``main_versions``: main keeps the publish, the update returns its
    own combine, and P is the combined mass times the publish's factor;
    the same in both packages (``bluefog_tpu/ops/window.py`` L147-150,
    L2063-2080)."""
    x = rank_major(11, (N, 3))

    def run(s, devices):
        s.init("RingGraph", devices=devices)
        if assoc_p:
            s.bf.turn_on_win_ops_with_associated_p()
        s.bf.win_create(s.to(x), "w")
        s.bf.win_put(s.to(2.0 * x), "w")
        win = s.W._store.get("w")
        pub = s.to(3.0 * x)
        if s.name == "jax":
            pub = np.asarray(pub)
        win.staging = _PublishOnRead(win.staging, (0, N - 1), lambda: (
            s.W._publish_self(win, pub, 0.5)))
        out = s.back(s.bf.win_update("w"))
        main = [s.back(win.main[r]) for r in range(N)]
        return out, main, list(s.bf.win_associated_p("w"))

    want, got = both(devices, run)
    assert_same(want, got)
    out, main, p = got
    # The publish scaled every rank's main; each keeps it, and the update
    # still returns its combine.
    for r in range(N):
        np.testing.assert_array_equal(main[r], (3.0 * x[r].astype(np.float64)
                                                * 0.5).astype(np.float32))
        assert not np.array_equal(out[r], main[r])
    # The combine's P is 1/3 + 2 * 1/3 = 1 a rank, times the factor 0.5.
    assert p == ([0.5] * N if assoc_p else [1.0] * N)


def test_refuses_a_tensor_on_another_device(ring):
    with pytest.raises(ValueError, match="windows live on cpu"):
        tbf.win_create(torch.zeros(N, 2, device="meta"), "w")
    tbf.win_create(torch.zeros(N, 2), "w")
    with pytest.raises(ValueError, match="windows live on cpu"):
        tbf.win_put(torch.zeros(N, 2, device="meta"), "w")
    with pytest.raises(ValueError, match="rank-major"):
        tbf.win_put(torch.zeros(N - 1, 2), "w")


def test_refuses_edges_outside_the_topology(ring):
    tbf.win_create(torch.zeros(N, 2), "w")
    with pytest.raises(ValueError, match="not an out-neighbor"):
        tbf.win_put(torch.zeros(N, 2), "w", dst_weights={(0, 4): 1.0})
    with pytest.raises(ValueError, match="shape"):
        tbf.win_put(torch.zeros(N, 2), "w", self_weight=np.ones(3))


def test_not_ported_parts_raise_with_their_item(ring, monkeypatch):
    """The async mode (item 17c, ported) creates its windows with an empty
    stale-residual store; a leading dim that is neither the world nor the
    owned ranks is refused, and so are windows across processes before
    the transport is up (the JAX package's check: ``bf.init_distributed``
    starts it)."""
    with pytest.raises(ValueError, match="neither the world size"):
        tbf.win_create(torch.zeros(2, 3), "w")
    monkeypatch.setenv("BLUEFOG_TPU_ASYNC", "1")
    config.reload()
    try:
        assert TW.configure_async()
        assert tbf.win_create(torch.zeros(N, 3), "w")
        assert tbf.win_state_dict("w")["stale_residual"] == {}
        tbf.win_free("w")
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_ASYNC")
        config.reload()
        TW.configure_async()
    monkeypatch.setattr(basics, "process_ranks",
                        lambda: types.SimpleNamespace(nprocs=2))
    with pytest.raises(RuntimeError, match="init_distributed"):
        tbf.win_create(torch.zeros(N, 3), "w")


def test_nonblocking_ops_poll_and_fence(ring):
    x = torch.from_numpy(rank_major(12))
    tbf.win_create(x, "w", zero_init=True)
    handles = [tbf.win_put_nonblocking(x, "w"),
               tbf.win_accumulate_nonblocking(x, "w"),
               tbf.win_get_nonblocking("w")]
    tbf.win_fence()
    assert all(tbf.win_poll(h) for h in handles)
    assert all(tbf.win_wait(h) for h in handles)   # fenced: nothing left
    assert TW._store.handles == {}
    tbf.win_flush()
