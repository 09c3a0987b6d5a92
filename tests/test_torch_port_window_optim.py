"""The port's window optimizers (win_put, pull-get, push-sum) against the
JAX package's, in one process.

On the linear problem of ``tests/test_optimizers.py`` (with a bias leaf, so
that the fused row joins two leaves): 3-step trajectories from the same
parameters, each package's gradients taken at its own parameters, within
1e-6 (float32: the two packages' gradients round their sums apart, and
torch's SGD adds ``-lr * g`` with one fused multiply-add where optax
rounds twice); the push-sum weights and the de-biased rows too.  On a
2-layer LM at width 32 through the plain twin of K1-K3, within 1e-4.  The
JAX optimizers run their eager step (``fused=False``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import models as jmodels
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops.flash_attention import flash_attention_impl as j_flash
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl
from bluefog_tpu_torch.optim import window_optimizers as TWO
from bluefog_tpu_torch.replicas import RankReplicas
from bluefog_tpu_torch.utils import config

N, DIM, SAMPLES, LR, STEPS = 8, 4, 16, 0.05, 3
FAMILIES = {"win_put": ("DistributedWinPutOptimizer", "ExponentialGraph", ()),
            "pull_get": ("DistributedPullGetOptimizer", "ExponentialGraph",
                         ()),
            # Push-sum on a directed ring: column-stochastic only.
            "push_sum": ("DistributedPushSumOptimizer", "RingGraph", (1,))}
VARIANTS = {"fused": {}, "per_leaf": {"fuse": False},
            "every_2nd_step": {"num_steps_per_communication": 2}}


@pytest.fixture(autouse=True)
def _configs_from_the_environment():
    """Both packages' configs read afresh from the environment: a test
    that ran before in this process may have left the JAX package's cached
    config with ``BLUEFOG_TPU_ASYNC=1``, which arms its async mode, where
    win_put steps as if ``overlap=True``."""
    jconfig.reload()
    config.reload()


def make_problem(seed=0):
    """Per-rank least squares, ``y_i = A_i w* + noise`` (the JAX tests')."""
    rng = np.random.RandomState(seed)
    w_star = rng.randn(DIM, 1)
    A = rng.randn(N, SAMPLES, DIM)
    y = A @ w_star + 0.01 * rng.randn(N, SAMPLES, 1)
    init = {"b": (rng.randn(N, 1) * 0.5).astype(np.float32),
            "w": (rng.randn(N, DIM, 1) * 2.0).astype(np.float32)}
    return A.astype(np.float32), y.astype(np.float32), init


def _jax_run(devices, family, variant, steps=STEPS):
    cls, graph, args = FAMILIES[family]
    A, y, init = make_problem()
    jbf.init(lambda: getattr(jtopo, graph)(N, *args), devices=devices[:N])
    opt = getattr(jbf.optim, cls)(optax.sgd(LR), fused=False,
                                  **VARIANTS[variant]) \
        if family != "pull_get" else getattr(jbf.optim, cls)(
            optax.sgd(LR), **VARIANTS[variant])
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(params)

    def loss(p, A_r, y_r):
        return jnp.mean((A_r @ p["w"] + p["b"] - y_r) ** 2)

    grad = jax.jit(jax.vmap(jax.grad(loss)))
    for _ in range(steps):
        params, state = opt.step(params, grad(params, A, y), state)
    out = {k: np.asarray(v) for k, v in params.items()}
    if family == "push_sum":
        out["p"] = np.asarray(opt.associated_p())
        out.update({f"debias_{k}": np.asarray(v)
                    for k, v in opt.debias(params).items()})
    opt.free()
    jbf.turn_off_win_ops_with_associated_p()
    return out


def _port_opt(family, variant, params, **kw):
    cls, graph, args = FAMILIES[family]
    tbf.init(N, device="cpu",
             topology_fn=lambda: getattr(ttopo, graph)(N, *args))
    return getattr(TWO, cls)(torch.optim.SGD(params, lr=LR),
                             **VARIANTS[variant], **kw)


def _port_grads(params, A, y):
    b, w = params
    b.grad = w.grad = None
    ((torch.from_numpy(A) @ w + b[:, None] - torch.from_numpy(y)) ** 2
     ).mean(dim=(1, 2)).sum().backward()


def _port_run(family, variant, steps=STEPS, overlap=False):
    A, y, init = make_problem()
    params = [torch.tensor(init[k], requires_grad=True) for k in ("b", "w")]
    kw = {"overlap": True} if overlap else {}
    opt = _port_opt(family, variant, params, **kw)
    try:
        for _ in range(steps):
            _port_grads(params, A, y)
            opt.step()
        assert opt.step_count == steps
        out = {k: p.detach().numpy().copy() for k, p in zip("bw", params)}
        if family == "push_sum":
            out["p"] = opt.associated_p()
            out.update({f"debias_{k}": t.numpy() for k, t in
                        zip("bw", opt.debias())})
        opt.free()
        return out, A, y
    finally:
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_window_optimizer_matches_jax(devices, family, variant):
    want = _jax_run(devices, family, variant)
    got, _, _ = _port_run(family, variant)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    if family == "push_sum":
        assert abs(got["p"].sum() - N) < 1e-9 and (got["p"] > 0).all()


def _global_mse(w, b, A, y):
    pred = np.einsum("msd,ndo->mnso", A, w) + b[None, :, None]
    return float(np.mean((pred - y[:, None]) ** 2))


def test_win_put_optimizer_overlap_converges():
    """``overlap=True``: the put runs behind the caller's compute (one
    step of staleness); the ranks still reach a consensus minimizer (the
    JAX package's ``test_win_put_optimizer_overlap_converges``)."""
    got, A, y = _port_run("win_put", "fused", steps=150, overlap=True)
    assert _global_mse(got["w"], got["b"], A, y) < 0.1


def test_push_sum_collect_conserves_mass():
    A, y, init = make_problem()
    params = [torch.tensor(init[k], requires_grad=True) for k in ("b", "w")]
    opt = _port_opt("push_sum", "fused", params)
    try:
        for _ in range(5):
            _port_grads(params, A, y)
            opt.step()
        opt.collect()
        assert abs(opt.associated_p().sum() - N) < 1e-9
    finally:
        opt.free()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


def test_window_state_dict_guards_and_resume():
    """A snapshot taken mid-run resumes the run bit for bit; misuse fails
    loudly (no windows, or another fuse layout)."""
    A, y, init = make_problem()

    def run(snap_at=None, restore=None, steps=6):
        params = [torch.tensor(init[k], requires_grad=True)
                  for k in ("b", "w")]
        opt = _port_opt("push_sum", "fused", params)
        try:
            if restore is not None:
                with torch.no_grad():
                    for p, v in zip(params, restore[0]):
                        p.copy_(v)
                opt.load_window_state_dict(restore[1])
            snap = None
            for i in range(steps):
                if i == snap_at:
                    snap = ([p.detach().clone() for p in params],
                            opt.window_state_dict())
                _port_grads(params, A, y)
                opt.step()
            return [p.detach().clone() for p in params], snap
        finally:
            opt.free()
            TW.turn_off_win_ops_with_associated_p()
            tbf.shutdown()

    final, snap = run(snap_at=3)
    resumed, _ = run(restore=snap, steps=3)
    for a, b in zip(final, resumed):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    params = [torch.zeros(N, 1), torch.zeros(N, DIM, 1)]
    opt = _port_opt("win_put", "fused", params)
    try:
        snap = opt.window_state_dict()
        opt.free()
        with pytest.raises(RuntimeError, match="no windows exist"):
            opt.load_window_state_dict(snap)
        opt2 = TWO.DistributedWinPutOptimizer(
            torch.optim.SGD(params, lr=LR), fuse=False)
        with pytest.raises(ValueError, match="fuse= setting or window_prefix"):
            opt2.load_window_state_dict(snap)
        opt2.free()
    finally:
        tbf.shutdown()


def test_not_ported_options_raise_with_their_item(monkeypatch):
    params = [torch.zeros(N, 4)]
    tbf.init(N, device="cpu")
    try:
        sgd = torch.optim.SGD(params, lr=LR)
        # The fused step and its buckets are ported (item 19b): they build
        # their windows, one a bucket, and step.
        two = torch.optim.SGD([torch.zeros(N, 4), torch.zeros(N, 2)], lr=LR)
        for kw, names in (({"fused": True}, ["winput.fused"]),
                          ({"fusion_buckets": 2},
                           ["winput.fusedb0", "winput.fusedb1"])):
            opt = TWO.DistributedWinPutOptimizer(two, **kw)
            assert opt._names == names
            opt.step()
            opt.free()
        # Sharded gossip is ported; its layout and fusion requirements
        # raise the JAX package's ValueErrors.
        sharded = {"shard_specs": [("ep",)], "num_shards": 2}
        groups = {"shard_specs": [("ep",)],
                  "shard_groups": [list(range(N // 2)),
                                   list(range(N // 2, N))]}
        for kw, match in (({**sharded, "fuse": False}, "fuse=True"),
                          ({**sharded, "layout": "owned"},
                           "rank-major layout"),
                          ({**groups, "fuse": False}, "fuse=True")):
            with pytest.raises(ValueError, match=match):
                TWO.DistributedWinPutOptimizer(sgd, **kw)
        monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
        config.reload()
        with pytest.raises(NotImplementedError, match="item 20"):
            TWO.DistributedPushSumOptimizer(sgd)
        assert tbf.get_current_created_window_names() == []
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_CHURN", raising=False)
        config.reload()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


def test_fused_step_variable_is_refused(monkeypatch):
    """With ``fused=None`` the optimizers follow
    ``BLUEFOG_TPU_FUSED_STEP``: set to 1, win_put and push-sum take the
    fused step (the pull family has none and steps eagerly, as in the JAX
    package), and ``fused=False`` pins the eager step.  (The name is kept
    from when the variable was refused.)"""
    tbf.init(N, device="cpu")
    monkeypatch.setenv("BLUEFOG_TPU_FUSED_STEP", "1")
    config.reload()
    try:
        p = torch.zeros(N, 3)
        p.grad = torch.ones(N, 3)
        sgd = torch.optim.SGD([p], lr=LR)
        for cls, fused_steps in ((TWO.DistributedWinPutOptimizer, 1),
                                 (TWO.DistributedPullGetOptimizer, None),
                                 (TWO.DistributedPushSumOptimizer, 1)):
            opt = cls(sgd)
            opt.step()
            impl = getattr(opt, "_fused_impl", None)
            assert (impl.fused_steps if impl else None) == fused_steps
            opt.free()
            TW.turn_off_win_ops_with_associated_p()
        assert tbf.get_current_created_window_names() == []
        opt = TWO.DistributedWinPutOptimizer(sgd, fused=False)
        opt.step()
        assert opt._fused_impl is None
        opt.free()
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_FUSED_STEP")
        config.reload()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


# ---------------------------------------------------------------------------
# A 2-layer LM at width 32 through the plain twin of K1-K3
# ---------------------------------------------------------------------------

LM_N, V, LAYERS, E, HEADS, SEQ, BATCH = 4, 64, 2, 32, 2, 16, 2


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_trajectory_matches_jax(devices, family):
    cls, graph, args = FAMILIES[family]
    tokens = np.random.RandomState(1).randint(
        0, V, (LM_N, BATCH, SEQ)).astype(np.int32)
    jbf.init(lambda: getattr(jtopo, graph)(LM_N, *args),
             devices=devices[:LM_N])
    cfg = jmodels.TransformerConfig(vocab_size=V, num_layers=LAYERS,
                                    num_heads=HEADS, embed_dim=E,
                                    max_seq_len=SEQ, dtype=jnp.float32)
    model = jmodels.TransformerLM(cfg, attn_impl=j_flash(block_q=16,
                                                         block_k=16))
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[0]))["params"]
    params = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (LM_N,) + x.shape), init)
    jopt = getattr(jbf.optim, cls)(optax.sgd(0.05))
    state = jopt.init(params)

    def loss_fn(p, x):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(x, -1, axis=1)).mean()

    vgrad = jax.jit(jax.vmap(jax.grad(loss_fn)))
    for _ in range(STEPS):
        params, state = jopt.step(params, vgrad(params, jnp.asarray(tokens)),
                                  state)
    want = jax.tree.map(np.asarray, params)
    jopt.free()
    jbf.turn_off_win_ops_with_associated_p()

    tbf.init(LM_N, device="cpu",
             topology_fn=lambda: getattr(ttopo, graph)(LM_N, *args))
    try:
        tcfg = TransformerConfig(vocab_size=V, num_layers=LAYERS,
                                 num_heads=HEADS, embed_dim=E,
                                 max_seq_len=SEQ, dtype=torch.float32)
        rep = RankReplicas(lambda: TransformerLM(tcfg,
                                                 flash_attention_impl()),
                           LM_N, "cpu")
        rep.load_state_dict(transformer_params_from_jax(
            jax.tree.map(np.asarray, init)))
        opt = getattr(TWO, cls)(torch.optim.SGD([rep.flat], lr=0.05))
        x = torch.from_numpy(tokens).long()
        for _ in range(STEPS):
            rep.zero_grad()
            for r in range(LM_N):
                logits = rep.modules[r](x[r])
                F.cross_entropy(logits.reshape(-1, V),
                                torch.roll(x[r], -1, 1).reshape(-1)
                                ).backward()
            opt.step()
        opt.free()
        for r in range(LM_N):
            ref = transformer_params_from_jax(
                jax.tree.map(lambda a: a[r], want))
            got = rep.rank_params(r)
            for name, w in ref.items():
                np.testing.assert_allclose(got[name].detach().numpy(),
                                           w.numpy(), rtol=0, atol=1e-4,
                                           err_msg=name)
    finally:
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()
