"""The port's fused window step (``ops/fused_step.py``) against its eager
step and the JAX package's fused step.

* Bitwise: the win_put and push-sum families, two fusion buckets, through
  the loopback rig of ``test_torch_port_win_xla.py`` (even ranks here, odd
  ranks behind a local server transport feeding the same store) for every
  codec: the fused step leaves the parameters and every window's state
  bit for bit where the eager step leaves them (each drain waits until
  every frame the step sent has been applied, so both fold the same set).
* Against JAX: the same least-squares problem and gradients through the
  JAX package's fused step and the port's, 3 steps, within 1e-6 (the
  largest difference measured is asserted and printed).
* The program cache rebuilds on a topology generation and a membership
  epoch, as the JAX package's (its ``test_fused_step.py`` L198); the knob
  off builds nothing; an unlowerable configuration warns once and runs the
  eager step; ``modeled_overlap`` is the JAX package's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import fused_step as JF
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import basics as tbasics
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import fused_step as TF
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.ops import xlaffi
from bluefog_tpu_torch.optim import window_optimizers as TWO
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry as TT

from test_torch_port_win_xla import KNOBS, Loopback, _assert_state_equal

N = 8
SHAPES = [(20,), (4, 3)]          # two leaves: two real buckets


@pytest.fixture
def env(monkeypatch):
    def set_env(**kv):
        for k in KNOBS + ("BLUEFOG_TPU_FUSED_STEP",):
            monkeypatch.delenv(k, raising=False)
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        tconfig.reload()
        jconfig.reload()
        xlaffi._reset_for_tests()
    set_env()
    yield set_env
    for k in KNOBS + ("BLUEFOG_TPU_FUSED_STEP",):
        monkeypatch.delenv(k, raising=False)
    tconfig.reload()
    jconfig.reload()
    xlaffi._reset_for_tests()
    TW._drop_ef_residuals()


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn((N,) + s, generator=g))
            for s in SHAPES]


def _grads(params, step):
    g = torch.Generator().manual_seed(100 + step)
    for p in params:
        p.grad = p.detach() * 0.01 + torch.randn(p.shape, generator=g) * 1e-3


def _loopback_run(env, fused, family, codec, with_p, steps=4):
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_NATIVE=1,
        BLUEFOG_TPU_WIN_XLA=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
        BLUEFOG_TPU_WIN_COMPRESSION=codec)
    TT.reset()
    rig = Loopback()
    params = _params()
    cls = TWO.DistributedWinPutOptimizer if family == "put" \
        else TWO.DistributedPushSumOptimizer
    if with_p and family == "put":
        TW.turn_on_win_ops_with_associated_p()
    opt = cls(torch.optim.SGD(params, lr=0.5, momentum=0.9), fused=fused,
              fusion_buckets=2)
    assert len(opt._names) == 2, opt._names
    expect = [0]
    orig = TW._update_rows

    def synced(name, **kw):
        rig.wait(expect[0])
        return orig(name, **kw)
    try:
        for name, rngs in zip(opt._names, opt._bucket_ranges):
            rig.server.register_window(name, sum(b - a for a, b in rngs))
        rig.install()
        TW._update_rows = synced
        for s in range(steps):
            _grads(params, s)
            # The ring's out-edges of the even ranks, all to odd ranks: 8
            # remote edges a window.
            expect[0] += N * len(opt._names)
            opt.step(require_mutex=False)
        if fused:
            assert opt._fused_impl.fused_steps == steps
            assert opt._fused_impl.builds == 1
            assert TT.snapshot()["bf_fused_step_puts_total"] == \
                steps * len(opt._names)
            assert TT.snapshot()["bf_fused_step_active"] == 1.0
        else:
            assert opt._fused_impl is None
        states = {n: TW.win_state_dict(n) for n in opt._names}
        return [p.detach().clone() for p in params], states
    finally:
        TW._update_rows = orig
        TW._store.distrib = rig.saved
        opt.free()
        rig.names = []
        rig.close()


@pytest.mark.parametrize("family,with_p", [("put", False), ("put", True),
                                           ("pushsum", True)])
@pytest.mark.parametrize("codec", ["none", "bf16", "sparse:0.5"])
def test_fused_equals_eager_bitwise(env, family, codec, with_p):
    pe, se = _loopback_run(env, False, family, codec, with_p)
    pf, sf = _loopback_run(env, True, family, codec, with_p)
    for a, b in zip(pe, pf):
        assert torch.equal(a, b)
    for name in se:
        _assert_state_equal(sf[name], se[name])


def _problem():
    rng = np.random.RandomState(0)
    A = rng.randn(N, 16, 4).astype(np.float32)
    y = rng.randn(N, 16, 1).astype(np.float32)
    init = {"b": (rng.randn(N, 20) * 0.5).astype(np.float32),
            "w": (rng.randn(N, 4, 1) * 2.0).astype(np.float32)}
    return A, y, init


def _jax_fused(devices, family, steps):
    A, y, init = _problem()
    graph = jtopo.RingGraph(N) if family == "put" else jtopo.RingGraph(N, 1)
    jbf.init(lambda: graph, devices=devices[:N])
    cls = jbf.optim.DistributedWinPutOptimizer if family == "put" \
        else jbf.optim.DistributedPushSumOptimizer
    opt = cls(optax.sgd(0.05), fused=True, fusion_buckets=2)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(params)

    def loss(p, A_r, y_r):
        return jnp.mean((A_r @ p["w"] + p["b"].mean() - y_r) ** 2)
    grad = jax.jit(jax.vmap(jax.grad(loss)))
    for _ in range(steps):
        params, state = opt.step(params, grad(params, A, y), state,
                                 require_mutex=False)
    assert opt._fused_impl.fused_steps == steps
    out = {k: np.asarray(v) for k, v in params.items()}
    opt.free()
    jbf.turn_off_win_ops_with_associated_p()
    return out


def _port_fused(family, steps):
    A, y, init = _problem()
    graph = ttopo.RingGraph(N) if family == "put" else ttopo.RingGraph(N, 1)
    tbf.init(N, device="cpu", topology_fn=lambda: graph)
    params = [torch.tensor(init[k], requires_grad=True) for k in ("b", "w")]
    cls = TWO.DistributedWinPutOptimizer if family == "put" \
        else TWO.DistributedPushSumOptimizer
    opt = cls(torch.optim.SGD(params, lr=0.05), fused=True,
              fusion_buckets=2)
    try:
        for _ in range(steps):
            b, w = params
            b.grad = w.grad = None
            ((torch.from_numpy(A) @ w + b.mean(dim=1)[:, None, None]
              - torch.from_numpy(y)) ** 2).mean(dim=(1, 2)).sum().backward()
            opt.step(require_mutex=False)
        assert opt._fused_impl.fused_steps == steps
        assert len(opt._names) == 2
        return {k: p.detach().numpy().copy() for k, p in zip("bw", params)}
    finally:
        opt.free()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


@pytest.mark.parametrize("family", ["put", "pushsum"])
def test_fused_trajectory_matches_jax(env, devices, family):
    want = _jax_fused(devices, family, 3)
    got = _port_fused(family, 3)
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"fused {family}: max |port - jax| = {err:.3e}")
    assert err <= 1e-6


def test_program_cache_invalidation_counts(env):
    """A topology generation and a committed membership epoch each force
    one rebuild; an unchanged configuration replays the cached program."""
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    params = _params()
    opt = TWO.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.5),
                                         fused=True, fusion_buckets=2)
    try:
        for s in range(2):
            _grads(params, s)
            opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 1
        tbasics._ctx.topology_version += 1
        _grads(params, 2)
        opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 2
        opt.membership_change = types.SimpleNamespace(epoch=7,
                                                      evicted=False)
        _grads(params, 3)
        opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 3
        _grads(params, 4)
        opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 3
        assert opt._fused_impl.fused_steps == 5
        # A hyperparameter is baked into a captured program: a new lr is
        # a new key.
        opt.base.param_groups[0]["lr"] = 0.25
        _grads(params, 5)
        opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 4
    finally:
        opt.free()
        tbf.shutdown()


def test_free_and_init_rebuild_the_program(env):
    """``free()`` drops the programs (their plans die with the windows):
    after ``init()`` the next fused step builds anew."""
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    params = _params()
    opt = TWO.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.5),
                                         fused=True, fusion_buckets=2)
    try:
        _grads(params, 0)
        opt.step(require_mutex=False)
        opt.free()
        assert opt._fused_impl._programs == {}
        opt.init()
        _grads(params, 1)
        opt.step(require_mutex=False)
        assert opt._fused_impl.builds == 2
        assert opt._fused_impl.fused_steps == 2
    finally:
        opt.free()
        tbf.shutdown()


def test_knob_off_is_inert(env):
    """``BLUEFOG_TPU_FUSED_STEP=0`` and ``fused=None``: no program, no
    ``bf_fused_step_*`` series; ``=1`` takes the fused step."""
    TT.reset()
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    params = _params()
    opt = TWO.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.5),
                                         fusion_buckets=2)
    try:
        for s in range(2):
            _grads(params, s)
            opt.step(require_mutex=False)
        assert opt._fused_impl is None
        assert not any(k.startswith("bf_fused") for k in TT.snapshot())
        env(BLUEFOG_TPU_FUSED_STEP=1)
        _grads(params, 2)
        opt.step(require_mutex=False)
        assert opt._fused_impl.fused_steps == 1
    finally:
        opt.free()
        tbf.shutdown()


@pytest.mark.parametrize("kw", [{"fuse": False}], ids=["per_parameter"])
def test_unlowerable_configuration_warns_once(env, monkeypatch, kw):
    from bluefog_tpu_torch.utils import logging as bflog
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    TT.reset()
    warns = []
    logger = bflog.get_logger()
    orig = logger.warning
    monkeypatch.setattr(logger, "warning", lambda msg, *a, **k: (
        warns.append(msg % a if a else msg), orig(msg, *a, **k)))
    params = _params()
    opt = TWO.DistributedWinPutOptimizer(torch.optim.SGD(params, lr=0.5),
                                         fused=True, **kw)
    eager_params = _params()
    eager = TWO.DistributedWinPutOptimizer(
        torch.optim.SGD(eager_params, lr=0.5), window_prefix="eager",
        fused=False, **kw)
    try:
        for s in range(3):
            _grads(params, s)
            _grads(eager_params, s)
            opt.step(require_mutex=False)
            eager.step(require_mutex=False)
        msgs = [m for m in warns if "falling back to the eager path" in m]
        assert len(msgs) == 1, msgs
        assert opt._fused_impl.fused_steps == 0
        assert TT.snapshot().get("bf_fused_step_active") == 0.0
        for a, b in zip(params, eager_params):
            assert torch.equal(a, b)
    finally:
        opt.free()
        eager.free()
        tbf.shutdown()


@pytest.mark.parametrize("sizes", [[100], [100, 200, 300], [5] * 7])
def test_modeled_overlap_equals_jax(sizes):
    assert TF.modeled_overlap(sizes) == JF.modeled_overlap(sizes)


def test_fused_schedule_is_stamped_and_plans_the_edges(env):
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    try:
        edges = {(r, (r + 1) % N): 0.5 for r in range(N)}
        sched = TF.compile_fused_schedule(edges, N)
        assert sched.lowering == "fused"
        plan = sched.window_plan()
        assert {(s, d): w for s in range(N) for d, w in plan[s]} == edges
    finally:
        tbf.shutdown()
