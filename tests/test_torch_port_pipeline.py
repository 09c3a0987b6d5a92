"""The port's pipeline schedules (``parallel/pipeline.py``) and the dp x tp
x pp (x ep) compositions (``parallel/composed.py``) against the JAX
package's, on seeded inputs.

The JAX side runs as its own tests run it: ``shard_map`` over a ``pp`` axis
of the 8-device CPU mesh (``(dp, tp, pp)`` and ``(dp, mp, pp)`` for the
compositions).  The port runs its stages rank-major in one process.

Tolerances: GPipe's forward within 1e-5 / 1e-6 of the sequential stack and
of JAX's ``pipeline_apply``, its gradients 1e-4 / 1e-5
(``test_pipeline_matches_sequential`` and ``test_pipeline_grads_match_
sequential``'s limits); 1F1B, interleaved and ZB-H1 against JAX's
``pipeline_train_step``(``_interleaved``) and the sequential stack: the loss
1e-5 relative, the gradients rtol 1e-4 / atol 1e-6; ``v = 1`` bit for bit
the plain 1F1B; the compositions' loss 1e-5 relative and parameters rtol
2e-5 / atol 2e-6 (dp x tp x pp) and 2e-4 / 2e-5 (with ep), the JAX tests'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu.models.transformer import Block as JBlock
from bluefog_tpu.models.transformer import local_attention
from bluefog_tpu.models import TransformerConfig as JConfig
from bluefog_tpu.ops import collective as JC
from bluefog_tpu.ops import schedule as JS
from bluefog_tpu import topology as jtopo
from bluefog_tpu.parallel import moe as JM
from bluefog_tpu.parallel import pipeline as JP
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import stacked_block_params_from_jax
from bluefog_tpu_torch.ops import schedule as S
from bluefog_tpu_torch.parallel import composed as TC
from bluefog_tpu_torch.parallel import pipeline as TP


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).requires_grad_(
        grad)


def _mlp(rng, n, d, scale=0.5):
    return ((rng.randn(n, d, d) * scale).astype(np.float32),
            (rng.randn(n, d) * 0.1).astype(np.float32))


def _j_stage(p, xb):
    W, b = p
    return jnp.tanh(xb @ W[0] + b[0])


def _t_stage(p, xb):
    W, b = p
    return torch.tanh(xb @ W + b)


def _j_mse(y, t):
    return jnp.mean((y - t) ** 2)


def _t_mse(y, t):
    return ((y - t) ** 2).mean()


def _pp_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("pp",))


def test_pipeline_matches_sequential():
    """GPipe over 4 stages: the outputs equal the stages run in sequence,
    and JAX's ``pipeline_apply``."""
    n, M, mb, d = 4, 6, 3, 8
    rng = np.random.RandomState(0)
    Ws = (rng.randn(n, d, d) * 0.5).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)
    j_out = jax.jit(jax.shard_map(
        lambda W, xb: JP.pipeline_apply(lambda w, z: jnp.tanh(z @ w[0]), W,
                                        xb, axis_name="pp"),
        mesh=_pp_mesh(n), in_specs=(P("pp"), P()), out_specs=P(),
        check_vma=False))(Ws, x)
    out = TP.pipeline_apply(lambda w, z: torch.tanh(z @ w), _t(Ws), _t(x),
                            axis=n)
    ref = _t(x)
    for i in range(n):
        ref = torch.tanh(ref @ _t(Ws[i]))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-6)


def test_pipeline_grads_match_sequential():
    """Autograd through the GPipe schedule equals sequential backprop and
    JAX's ``jax.grad`` through its scan, in the parameters and in the
    microbatches."""
    n, M, mb, d = 4, 5, 2, 6
    rng = np.random.RandomState(1)
    Ws = (rng.randn(n, d, d) * 0.5).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)

    def j_loss(Ws):
        out = jax.shard_map(
            lambda W, xb: JP.pipeline_apply(
                lambda w, z: jnp.tanh(z @ w[0]), W, xb, axis_name="pp"),
            mesh=_pp_mesh(n), in_specs=(P("pp"), P()), out_specs=P(),
            check_vma=False)(Ws, x)
        return jnp.sum(out ** 2)
    j_g = np.asarray(jax.jit(jax.grad(j_loss))(Ws))

    tW, tx = _t(Ws, True), _t(x, True)
    out = TP.pipeline_apply(lambda w, z: torch.tanh(z @ w), tW, tx, axis=n)
    gW, gx = torch.autograd.grad((out ** 2).sum(), (tW, tx))
    sW, sx = _t(Ws, True), _t(x, True)
    h = sx
    for i in range(n):
        h = torch.tanh(h @ sW[i])
    rW, rx = torch.autograd.grad((h ** 2).sum(), (sW, sx))
    np.testing.assert_allclose(gW.numpy(), rW.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gW.numpy(), j_g, rtol=1e-4, atol=1e-5)


def _sequential(Wf, bf, x, tgt):
    """The mean over microbatches of the stack's loss, and its gradients."""
    Wf, bf = _t(Wf, True), _t(bf, True)
    losses = []
    for xb, tb in zip(_t(x), _t(tgt)):
        h = xb
        for s in range(Wf.shape[0]):
            h = torch.tanh(h @ Wf[s] + bf[s])
        losses.append(_t_mse(h, tb))
    loss = torch.stack(losses).mean()
    return (float(loss.detach()),) + torch.autograd.grad(loss, (Wf, bf))


@pytest.mark.parametrize("split_backward", [False, True])
def test_1f1b_matches_jax_and_sequential(split_backward):
    """1F1B (and ZB-H1's split backward): the loss and each stage's
    gradients equal JAX's ``pipeline_train_step`` and the stages run in
    sequence."""
    n, M, mb, d = 4, 8, 3, 5
    rng = np.random.RandomState(0)
    Ws, bs = _mlp(rng, n, d)
    x = rng.randn(M, mb, d).astype(np.float32)
    tgt = rng.randn(M, mb, d).astype(np.float32)
    j_loss, j_g = jax.jit(jax.shard_map(
        lambda p, xb, tb: JP.pipeline_train_step(
            _j_stage, p, xb, tb, _j_mse, axis_name="pp",
            split_backward=split_backward),
        mesh=_pp_mesh(n), in_specs=((P("pp"), P("pp")), P(), P()),
        out_specs=(P(), (P("pp"), P("pp"))), check_vma=False))(
            (Ws, bs), x, tgt)
    loss, (gW, gb) = TP.pipeline_train_step(
        _t_stage, (_t(Ws), _t(bs)), _t(x), _t(tgt), _t_mse, axis=n,
        split_backward=split_backward)
    s_loss, sW, sb = _sequential(Ws, bs, x, tgt)
    for want_loss, want_W, want_b in ((float(j_loss), np.asarray(j_g[0]),
                                       np.asarray(j_g[1])),
                                      (s_loss, sW.numpy(), sb.numpy())):
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        np.testing.assert_allclose(gW.numpy(), want_W, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gb.numpy(), want_b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("split_backward", [False, True])
def test_interleaved_1f1b_matches_jax_and_sequential(split_backward):
    """Interleaved 1F1B, v = 2 chunks a rank (global stage ``c * n + r`` at
    ``[r][c]``), plain and ZB-H1: the loss and every chunk's gradients
    equal JAX's ``pipeline_train_step_interleaved`` and the 8-stage stack."""
    n, v, M, mb, d = 4, 2, 6, 3, 5
    S_ = n * v
    rng = np.random.RandomState(0)
    Wf = (rng.randn(S_, d, d) * 0.4).astype(np.float32)
    bf = (rng.randn(S_, d) * 0.1).astype(np.float32)
    order = [[c * n + r for c in range(v)] for r in range(n)]
    Ws, bs = Wf[order], bf[order]                   # (n, v, ...)
    x = rng.randn(M, mb, d).astype(np.float32)
    tgt = rng.randn(M, mb, d).astype(np.float32)

    def body(p, xb, tb):
        loss, g = JP.pipeline_train_step_interleaved(
            lambda q, z: jnp.tanh(z @ q[0] + q[1]),
            jax.tree.map(lambda a: a[0], p), xb, tb, _j_mse,
            axis_name="pp", split_backward=split_backward)
        return loss, jax.tree.map(lambda a: a[None], g)
    j_loss, j_g = jax.jit(jax.shard_map(
        body, mesh=_pp_mesh(n), in_specs=((P("pp"), P("pp")), P(), P()),
        out_specs=(P(), (P("pp"), P("pp"))), check_vma=False))(
            (Ws, bs), x, tgt)
    loss, (gW, gb) = TP.pipeline_train_step_interleaved(
        _t_stage, (_t(Ws), _t(bs)), _t(x), _t(tgt), _t_mse, axis=n,
        split_backward=split_backward)
    s_loss, sW, sb = _sequential(Wf, bf, x, tgt)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), s_loss, rtol=1e-5)
    for got, j, seq in ((gW, j_g[0], sW), (gb, j_g[1], sb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), seq.numpy()[order],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("split_backward", [False, True])
def test_interleaved_v1_degenerates_to_plain_1f1b(split_backward):
    """One chunk a rank reproduces ``pipeline_train_step`` bit for bit."""
    n, M, mb, d = 4, 5, 2, 4
    rng = np.random.RandomState(3)
    Ws, bs = _mlp(rng, n, d, 0.4)
    x, tgt = _t(rng.randn(M, mb, d)), _t(rng.randn(M, mb, d))
    l1, g1 = TP.pipeline_train_step(_t_stage, (_t(Ws), _t(bs)), x, tgt,
                                    _t_mse, axis=n,
                                    split_backward=split_backward)
    l2, g2 = TP.pipeline_train_step_interleaved(
        _t_stage, (_t(Ws)[:, None], _t(bs)[:, None]), x, tgt, _t_mse,
        axis=n, split_backward=split_backward)
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b[:, 0])


class _SavedBytes:
    """The peak bytes of the tensors autograd saves, counted once a storage
    and released when the graph that saved them is freed; the parameters'
    storages are left out (they live anyway)."""

    def __init__(self, skip):
        self.skip = {t.untyped_storage().data_ptr() for t in skip}
        self.live, self.refs, self.now, self.peak = {}, {}, 0, 0

    def pack(self, t):
        key = t.untyped_storage().data_ptr()
        if key not in self.skip:
            if key not in self.refs:
                self.now += t.untyped_storage().nbytes()
                self.peak = max(self.peak, self.now)
            self.refs[key] = self.refs.get(key, 0) + 1
        return _Held(self, key, t)

    def release(self, key):
        if key in self.refs:
            self.refs[key] -= 1
            if not self.refs[key]:
                del self.refs[key]
                self.now -= self.live.pop(key, 0)


class _Held:
    def __init__(self, counter, key, t):
        self.counter, self.key, self.t = counter, key, t
        counter.live.setdefault(key, t.untyped_storage().nbytes())

    def __del__(self):
        self.counter.release(self.key)


def test_1f1b_memory_below_gpipe_autodiff():
    """At M = 32 microbatches over n = 4 stages, the tensors autograd holds
    at once under 1F1B (one stage's graph at a time) plus its stash stay
    below GPipe-through-autograd's (every stage's graph until the
    backward), counted through ``saved_tensors_hooks``."""
    n, M, mb, d = 4, 32, 8, 64
    rng = np.random.RandomState(1)
    Ws = _t(rng.randn(n, d, d) * 0.3, True)
    bs = torch.zeros(n, d, requires_grad=True)
    x, tgt = _t(rng.randn(M, mb, d)), _t(rng.randn(M, mb, d))

    onef1b = _SavedBytes([Ws, bs])
    with torch.autograd.graph.saved_tensors_hooks(onef1b.pack,
                                                  lambda h: h.t):
        TP.pipeline_train_step(_t_stage, (Ws, bs), x, tgt, _t_mse, axis=n)
    stash = n * n * mb * d * 4                # (n, v * S) slots, f32
    gpipe = _SavedBytes([Ws, bs])
    with torch.autograd.graph.saved_tensors_hooks(gpipe.pack,
                                                  lambda h: h.t):
        y = TP.pipeline_apply(_t_stage, (Ws, bs), x, axis=n)
        _t_mse(y, tgt).backward()
    assert onef1b.peak > 0 and gpipe.peak > 0
    assert onef1b.peak + stash < gpipe.peak, (onef1b.peak, stash,
                                              gpipe.peak)


def test_pipeline_transformer_blocks():
    """TransformerLM blocks as pipeline stages: the flax blocks stacked
    ``(pp, ...)`` as ``dryrun_multichip`` stacks them, carried across by
    ``stacked_block_params_from_jax``, through GPipe equal JAX's pipeline of
    the same blocks; stacked ``(pp, v, ...)`` they train by interleaved
    1F1B with the sequential stack's gradients."""
    cfg = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
               max_seq_len=8)
    jblock = JBlock(JConfig(dtype=jnp.float32, **cfg), local_attention)
    rng = np.random.RandomState(2)
    M, mb, S_ = 4, 2, 8
    x = rng.randn(M, mb, S_, 32).astype(np.float32)
    ps = [jblock.init(jax.random.PRNGKey(i), x[0]) for i in range(4)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *ps[:2])
    j_out = jax.jit(jax.shard_map(
        lambda W, xb: JP.pipeline_apply(
            lambda w, z: jblock.apply(jax.tree.map(lambda a: a[0], w), z),
            W, xb, axis_name="pp"),
        mesh=_pp_mesh(2), in_specs=(P("pp"), P()), out_specs=P(),
        check_vma=False))(stacked, x)
    tcfg = TT.TransformerConfig(dtype=torch.float32, **cfg)
    stage = TP.blocks_stage(tcfg)
    params = {k: v[:, None] for k, v in stacked_block_params_from_jax(
        jax.device_get(stacked), lead=1).items()}     # (pp, L = 1, ...)
    with torch.no_grad():
        out = TP.pipeline_apply(stage, params, _t(x), axis=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=2e-5,
                               atol=2e-5)

    # (pp = 2, v = 2): rank r's chunk c is global stage c * 2 + r
    chunked = jax.tree.map(lambda *a: jnp.stack(a).reshape(
        (2, 2) + a[0].shape).swapaxes(0, 1), *ps)
    cparams = {k: v[:, :, None] for k, v in stacked_block_params_from_jax(
        jax.device_get(chunked), lead=2).items()}
    tgt = _t(rng.randn(M, mb, S_, 32))
    loss, grads = TP.pipeline_train_step_interleaved(
        stage, cparams, _t(x), tgt, _t_mse, axis=2)
    flat = {k: v.transpose(0, 1).reshape((4,) + v.shape[2:]).clone()
            .requires_grad_() for k, v in cparams.items()}   # global order
    losses = []
    for xb, tb in zip(_t(x), tgt):
        h = xb
        for s in range(4):
            h = stage({k: v[s] for k, v in flat.items()}, h)
        losses.append(_t_mse(h, tb))
    ref = torch.stack(losses).mean()
    ref.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(
            g.transpose(0, 1).reshape(flat[k].shape).numpy(),
            flat[k].grad.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def _dp_tp_pp_inputs():
    dp, tp, pp, M, mb, d, hid = 2, 2, 2, 4, 3, 6, 8
    rng = np.random.RandomState(0)
    Wi = (rng.randn(pp, d, hid) * 0.4).astype(np.float32)
    Wo = (rng.randn(pp, hid, d) * 0.4).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)
    tgt = rng.randn(M, mb, d).astype(np.float32)
    return dp, tp, pp, Wi, Wo, x, tgt


def test_dp_tp_pp_composed_in_one_program(devices):
    """dp x tp x pp: each dp replica's 1F1B pipeline of Megatron MLP
    stages, then the decentralized ring combine over dp (the exact average
    at dp 2): the updated shards and the loss equal JAX's run of the same
    step in one ``shard_map`` program."""
    dp, tp, pp, Wi, Wo, x, tgt = _dp_tp_pp_inputs()
    lr, hs = 0.1, Wi.shape[-1] // tp
    mesh = Mesh(np.asarray(devices[:8]).reshape(dp, tp, pp),
                ("dp", "tp", "pp"))
    j_sched = JS.compile_static(jtopo.RingGraph(dp), use_topo_weights=False)

    def stage_fn(p, xb):
        wi, wo = p
        h = jnp.maximum(xb @ wi[0, 0, 0], 0.0)
        return lax.psum(h @ wo[0, 0, 0], "tp")

    def body(p, xb, tb):
        loss, g = JP.pipeline_train_step(
            stage_fn, p, xb[0], tb[0],
            lambda y, t: jnp.mean((y - t) ** 2) / lax.axis_size("tp"),
            axis_name="pp")
        p = jax.tree.map(lambda a, b: a - lr * b, p, g)
        p = jax.tree.map(lambda a: JC.neighbor_allreduce(a, j_sched, "dp"), p)
        return p, (loss * lax.axis_size("tp"))[None]
    P3 = P("dp", "tp", "pp")
    step = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=((P3, P3), P("dp"), P("dp")),
        out_specs=((P3, P3), P("dp")), check_vma=False))
    Wi_l = np.stack([Wi[:, :, k * hs:(k + 1) * hs] for k in range(tp)])
    Wo_l = np.stack([Wo[:, k * hs:(k + 1) * hs, :] for k in range(tp)])
    lead = lambda a: np.broadcast_to(a[None], (dp,) + a.shape)  # noqa: E731
    (jWi, jWo), j_loss = step((lead(Wi_l), lead(Wo_l)), lead(x), lead(tgt))

    sched = S.compile_static(topo.RingGraph(dp), use_topo_weights=False)
    # the port's layout: (dp, pp, tp, ...)
    (Wi1, Wo1), loss = TC.dp_tp_pp_step(
        (_t(lead(Wi_l.swapaxes(0, 1))), _t(lead(Wo_l.swapaxes(0, 1)))),
        _t(lead(x)), _t(lead(tgt)), lr=lr, sched=sched)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-5)
    np.testing.assert_allclose(Wi1.transpose(1, 2).numpy(), np.asarray(jWi),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(Wo1.transpose(1, 2).numpy(), np.asarray(jWo),
                               rtol=2e-5, atol=2e-6)


def test_dp_tp_pp_ep_composed_in_one_program(devices):
    """dp x tp x pp x ep, tp and ep on one ``mp`` axis as on 8 devices:
    each stage a tp-sharded MLP plus a switch-MoE sublayer with one expert
    an mp rank and a replicated router; one step equals JAX's in every
    parameter family (tp shards, experts, router copies) and the loss."""
    dp, mp, pp = 2, 2, 2
    d, hid, E, M, mb, cap = 6, 8, 2, 4, 4, 4
    lr, hs = 0.1, hid // mp
    rng = np.random.RandomState(0)
    Wi = (rng.randn(pp, d, hid) * 0.4).astype(np.float32)
    Wo = (rng.randn(pp, hid, d) * 0.4).astype(np.float32)
    We = (rng.randn(pp, E, d, d) * 0.4).astype(np.float32)
    Wr = (rng.randn(pp, d, E) * 0.4).astype(np.float32)
    x = rng.randn(M, mb, d).astype(np.float32)
    tgt = rng.randn(M, mb, d).astype(np.float32)
    mesh = Mesh(np.asarray(devices[:8]).reshape(dp, mp, pp),
                ("dp", "mp", "pp"))
    j_sched = JS.compile_static(jtopo.RingGraph(dp), use_topo_weights=False)

    def stage_fn(p, xb):
        wi, wo, we, wr = (a.reshape(a.shape[3:]) for a in p)
        h = jnp.maximum(xb @ wi, 0.0)
        y = lax.psum(h @ wo, "mp")
        y2 = JM.moe_apply(lambda w, z: jnp.tanh(z @ w), we, y, y @ wr,
                          axis_name="mp", capacity=cap)
        return y + y2

    def body(p, xb, tb):
        loss, g = JP.pipeline_train_step(
            stage_fn, p, xb[0], tb[0],
            lambda y, t: jnp.mean((y - t) ** 2) / lax.axis_size("mp"),
            axis_name="pp")
        gwi, gwo, gwe, gwr = g
        gwr = lax.psum(gwr, "mp")
        p = jax.tree.map(lambda a, b: a - lr * b, p, (gwi, gwo, gwe, gwr))
        p = jax.tree.map(lambda a: JC.neighbor_allreduce(a, j_sched, "dp"), p)
        return p, (loss * lax.axis_size("mp"))[None]
    P4 = P("dp", "mp", "pp")
    step = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=((P4,) * 4, P("dp"), P("dp")),
        out_specs=((P4,) * 4, P("dp")), check_vma=False))
    per_mp = (np.stack([Wi[:, :, k * hs:(k + 1) * hs] for k in range(mp)]),
              np.stack([Wo[:, k * hs:(k + 1) * hs, :] for k in range(mp)]),
              np.stack([We[:, k] for k in range(mp)]),
              np.stack([Wr for _ in range(mp)]))       # (mp, pp, ...)
    lead = lambda a: np.broadcast_to(a[None], (dp,) + a.shape)  # noqa: E731
    j_new, j_loss = step(tuple(lead(a) for a in per_mp), lead(x), lead(tgt))

    sched = S.compile_static(topo.RingGraph(dp), use_topo_weights=False)
    new, loss = TC.dp_tp_pp_ep_step(
        tuple(_t(lead(a.swapaxes(0, 1))) for a in per_mp), _t(lead(x)),
        _t(lead(tgt)), lr=lr, sched=sched, capacity=cap)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-5)
    for name, got, want in zip(("Wi", "Wo", "We", "Wr"), new, j_new):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   np.asarray(want), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb"])
def test_pipeline_training_main_loss_falls(schedule):
    from bluefog_tpu_torch import pipeline_training as PT
    res = PT.main(["--device", "cpu", "--steps", "12", "--schedule",
                   schedule])
    assert res["losses"][-1] < res["losses"][0]
    assert res["forward_max_abs_err"] <= 1e-5
