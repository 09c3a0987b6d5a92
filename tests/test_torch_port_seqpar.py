"""The port's sequence parallelism against the JAX package on the CPU.

Ring and Ulysses attention in the rank-major form (the ``n`` shards stacked
on the batch dim) against the JAX package's ``ring_attention`` and
``ulysses_attention`` under ``shard_map`` on the virtual CPU mesh, as
``tests/test_parallel.py`` runs them (forward within 2e-5); their gradients
against ``jax.grad`` of the JAX package's dense ``local_attention``, which
is mathematically equal and runs in seconds where the JAX ring's gradient
runs the Pallas kernels in interpret mode (within 1e-4); the LM's logits
through the ring and Ulysses against the JAX package's dense LM (within
1e-4); the dp x sp step that ``__graft_entry__.dryrun_multichip`` composes
(within 1e-4); the long-context example; how the ring batches its hops
into kernel calls; that a one-process axis takes the rank-major form; and
that Ulysses' moves run under their profiler ranges.  Inputs are made from
a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu import models as jmodels
from bluefog_tpu import topology as jtopo
from bluefog_tpu.models.transformer import local_attention as j_local
from bluefog_tpu.ops import schedule as jsched
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.parallel import (ring_attention as j_ring,
                                  ring_attention_impl as j_ring_impl,
                                  ulysses_attention as j_ulysses)
from bluefog_tpu_torch import basics, long_context_training
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops.flash_attention import flash_attention_lse
from bluefog_tpu_torch.ops.p2p import ProcessRanks
from bluefog_tpu_torch.optim import optimizers as O
from bluefog_tpu_torch.parallel import ring_attention as R
from bluefog_tpu_torch.parallel.ulysses import (ulysses_attention,
                                                ulysses_attention_impl)
from bluefog_tpu_torch.profile_step import ULYSSES_OPS
from bluefog_tpu_torch.replicas import RankReplicas

B, S, H, D = 2, 32, 8, 16
FWD_TOL, GRAD_TOL, LM_TOL = 2e-5, 1e-4, 1e-4


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _port(fn, n, causal, q, k, v):
    """The port's attention over the rank-major ``n``-shard axis, on global
    ``(B, S, H, D)`` tensors."""
    out = fn(*(R.shard_sequence(t, n) for t in (q, k, v)), axis=n,
             causal=causal)
    return R.unshard_sequence(out, n)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_forward_matches_jax_shard_map(devices, which, n, causal):
    q, k, v, _ = _qkv(n)
    jfn = j_ring if which == "ring" else j_ulysses
    mesh = Mesh(np.asarray(devices[:n]), ("sp",))
    want = jax.jit(jax.shard_map(
        lambda a, b, c: jfn(a, b, c, axis_name="sp", causal=causal),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3,
        out_specs=P(None, "sp"), check_vma=False))(q, k, v)
    tfn = R.ring_attention if which == "ring" else ulysses_attention
    got = _port(tfn, n, causal, *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_gradients_match_jax_dense(which, n, causal):
    q, k, v, cot = _qkv(10 + n)
    want = jax.grad(lambda a, b, c: jnp.sum(
        j_local(a, b, c, causal=causal) * cot), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tfn = R.ring_attention if which == "ring" else ulysses_attention
    out = _port(tfn, n, causal, tq, tk, tv)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL)


def test_ring_of_one_shard_is_flash_attention_lse():
    q, k, v, _ = map(torch.from_numpy, _qkv(3))
    want, _ = flash_attention_lse(q, k, v, causal=True)
    assert torch.equal(R.ring_attention(q, k, v, axis=1), want)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_one_process_axis_is_rank_major(which):
    """A ``ProcessRanks`` of one process holds every shard: it takes the
    rank-major form (no transport), with the same result."""
    n = 4
    axis = ProcessRanks(n, 0, 1)
    assert R.sequence_axis(axis) == (n, 0, n, None)
    q, k, v, _ = (R.shard_sequence(torch.from_numpy(t), n)
                  for t in _qkv(5))
    tfn = R.ring_attention if which == "ring" else ulysses_attention
    assert torch.equal(tfn(q, k, v, axis=axis), tfn(q, k, v, axis=n))


def test_ulysses_moves_run_under_their_profiler_ranges():
    """Each of Ulysses' moves is one autograd node: q, k and v scattered,
    the output gathered, and in the backward the inverse moves under the
    ``_backward`` names, which ``profile_step`` reports."""
    n = 4
    q, k, v, cot = (R.shard_sequence(torch.from_numpy(t), n)
                    for t in _qkv(6))
    q.requires_grad_()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = ulysses_attention(q, k.requires_grad_(), v.requires_grad_(),
                                axis=n)
        (out * cot).sum().backward()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert {name: counts.get(name) for name in ULYSSES_OPS} == {
        "ulysses::scatter_heads": 3, "ulysses::scatter_heads_backward": 3,
        "ulysses::gather_seq": 1, "ulysses::gather_seq_backward": 1}


@pytest.mark.parametrize("causal", [True, False])
def test_ring_batches_hops_and_skips_masked_blocks(monkeypatch, causal):
    """One flash call a hop over the shards that attend, stacked on the
    batch dim: under causal every shard at hop 0 (causal), shards ``i >=
    t`` at hop ``t`` (non-causal); a masked block never reaches it, and a
    shard's q gets exactly zero gradient from the blocks it does not see."""
    n = 4
    calls = []

    def counted(q, k, v, *, causal):
        calls.append((q.shape[0], causal))
        return flash_attention_lse(q, k, v, causal=causal)
    monkeypatch.setattr(R, "flash_attention_lse", counted)
    q, k, v, _ = (torch.from_numpy(t) for t in _qkv(4))
    q.requires_grad_()
    out = R.ring_attention(*(R.shard_sequence(t, n) for t in (q, k, v)),
                           axis=n, causal=causal)
    if causal:
        assert calls == [(n * B, True)] + [((n - t) * B, False)
                                           for t in range(1, n)]
    else:
        assert calls == [(n * B, False)] * n
    # Shard 0's output depends on shard 0's keys only: the gradient of its
    # output reaches no later shard's q.
    first = R.unshard_sequence(out, n)[:, :S // n].sum()
    (g,) = torch.autograd.grad(first, q)
    assert torch.count_nonzero(g[:, S // n:]) == 0


def _jax_lm(pos, seq, attn=None, **kw):
    cfg = jmodels.TransformerConfig(vocab_size=64, num_layers=2,
                                    num_heads=4, embed_dim=64,
                                    max_seq_len=seq, dtype=jnp.float32,
                                    pos_encoding=pos, **kw)
    return cfg, jmodels.TransformerLM(cfg, attn_impl=attn)


def _port_cfg(cfg):
    return TransformerConfig(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        embed_dim=cfg.embed_dim, max_seq_len=cfg.max_seq_len,
        dtype=torch.float32, pos_encoding=cfg.pos_encoding)


@pytest.mark.parametrize("pos", ["learned", "rope"])
@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_lm_logits_match_jax_dense_lm(which, pos):
    """Each shard embeds its own global positions: learned positions need
    ``max_seq_len`` to cover the whole sequence, RoPE turns by them."""
    n, seq = 4, 64
    cfg, jm = _jax_lm(pos, seq)
    tokens = np.random.RandomState(1).randint(0, 64, (2, seq)).astype(
        np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    impl = (R.ring_attention_impl(n) if which == "ring"
            else ulysses_attention_impl(n))
    tm = TransformerLM(_port_cfg(cfg), impl)
    tm.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, params)))
    tok = torch.from_numpy(tokens).long()
    pos_ids = torch.arange(seq).expand(2, seq)
    got = tm(R.shard_sequence(tok, n),
             positions=R.shard_sequence(pos_ids, n))
    np.testing.assert_allclose(R.unshard_sequence(got, n).detach().numpy(),
                               want, rtol=0, atol=LM_TOL)


def test_dp_sp_step_matches_jax():
    """``__graft_entry__.dryrun_multichip``'s dp x sp step (L86-158) at dp
    = 2, sp = 2: each dp rank's GQA + RoPE LM over 2 ring shards, the
    loss's targets rolled over the LOCAL shard (L133, reproduced as it
    is), the shards' gradients summed, ATC SGD(0.1) with the dp ranks
    combined over the one-peer Exp2 walk.  Built from the port's public
    pieces: ``RankReplicas``, ``ring_attention_impl``, the ATC
    optimizer."""
    dp, sp = 2, 2
    Bt, SEQ = 2 * dp, 16 * sp
    cfg = jmodels.TransformerConfig(vocab_size=64, num_layers=2,
                                    num_heads=4, num_kv_heads=2,
                                    pos_encoding="rope", embed_dim=32,
                                    max_seq_len=SEQ, dtype=jnp.float32)
    model = jmodels.TransformerLM(cfg, attn_impl=j_ring_impl("sp"))
    tokens = jnp.asarray(np.random.RandomState(2).randint(
        0, 64, (Bt, SEQ)).astype(np.int32))
    positions = jnp.tile(jnp.arange(SEQ)[None, :], (Bt, 1))
    params0 = jmodels.TransformerLM(cfg).init(jax.random.PRNGKey(0), tokens)
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (dp,) + x.shape),
                          params0)
    base = optax.sgd(0.1)
    dyn = jsched.compile_dynamic(jtopo.one_peer_exp2_phases(dp), dp)
    combine = JF.make_combiner(JF.CommunicationType.neighbor_allreduce,
                               axis_name="dp", dyn_sched=dyn)

    def train_step(params, state, tokens, positions):
        p = jax.tree.map(lambda x: x[0], params)
        st = jax.tree.map(lambda x: x[0], state)

        def loss_fn(p):
            logits = model.apply(p, tokens, positions=positions)
            targets = jnp.roll(tokens, -1, axis=1)
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, targets[..., None], -1)
            return nll.mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        grads = jax.tree.map(lambda g: lax.psum(g, "sp"), grads)
        new_p, new_st = JF.atc_step(base, combine, p, grads, st)
        loss = lax.pmean(loss, ("dp", "sp"))
        return (jax.tree.map(lambda x: x[None], new_p),
                jax.tree.map(lambda x: x[None], new_st), loss)

    mesh = Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    state = jax.jit(jax.shard_map(
        lambda p: jax.tree.map(lambda x: x[None], JF.dist_init(
            base, jax.tree.map(lambda x: x[0], p))),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp")))(params)
    new, _, loss = jax.jit(jax.shard_map(
        train_step, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp", "sp"), P("dp", "sp")),
        out_specs=(P("dp"), P("dp"), P()), check_vma=False))(
            params, state, tokens, positions)

    basics.init(dp, device="cpu")
    try:
        rep = RankReplicas(lambda: TransformerLM(
            _port_cfg(cfg), R.ring_attention_impl(sp)), dp, "cpu")
        rep.load_state_dict(transformer_params_from_jax(
            jax.tree.map(np.asarray, params0["params"])))
        opt = O.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([rep.flat], lr=0.1), use_dynamic_topology=True,
            phases=ttopo.one_peer_exp2_phases(dp))
        tok = torch.from_numpy(np.array(tokens)).long()
        pos = torch.arange(SEQ).expand(Bt // dp, SEQ)
        losses = []
        for r, mod in enumerate(rep.modules):
            shards = R.shard_sequence(tok[r * 2:(r + 1) * 2], sp)
            logits = mod(shards, positions=R.shard_sequence(pos, sp))
            targets = torch.roll(shards, -1, 1)          # the local shard's
            nll = torch.nn.functional.cross_entropy(
                logits.reshape(-1, 64), targets.reshape(-1),
                reduction="none").reshape(sp, -1)
            local = nll.mean(1)                          # each shard's loss
            local.sum().backward()                       # psum over sp
            losses.append(local.detach())
        opt.step()
        got_loss = float(torch.stack(losses).mean())
        assert got_loss == pytest.approx(float(loss), abs=1e-5)
        for r, mod in enumerate(rep.modules):
            want = transformer_params_from_jax(jax.tree.map(
                lambda x: np.asarray(x[r]), new["params"]))
            for name, p in mod.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), rtol=0,
                                           atol=LM_TOL, err_msg=name)
        # The dp ranks' data differ, and one exact Exp2 phase averaged them.
        np.testing.assert_array_equal(rep.flat[0].detach().numpy(),
                                      rep.flat[1].detach().numpy())
    finally:
        basics.shutdown()


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_long_context_example_learns(capsys, attention):
    res = long_context_training.main([
        "--device", "cpu", "--seq-len", "512", "--steps", "12",
        "--attention", attention, "--rope"])
    assert res["losses"][-1] < res["losses"][0]
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith("done: loss")
    assert ("no device materialized" in out) == (attention == "ring")
