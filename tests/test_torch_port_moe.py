"""The port's switch-MoE (``parallel/moe.py``, ``SwitchMlp`` and the MoE LM)
against the JAX package's, on seeded inputs.

The routing plan first, so that a token routed to another expert fails as a
flip and not as a loose tolerance: which expert keeps each token and its
slot (``keep``, ``slot``, ``dispatch``) are equal bit for bit; the gate and
the combine weights within one float32 ulp (``softmax`` sums its row in
another order, 3e-8 here); the balance loss within 1e-6.  The 2-layer,
32-wide, 4-expert LM in float32: the plans of every block equal, logits and
every gradient at 1e-4 (``test_torch_port_llama``'s tolerance), the per-layer
aux loss at 1e-6.  ``moe_apply`` against the JAX function under
``shard_map`` on the 8-device CPU mesh at 1e-6, forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu import models as jmodels
from bluefog_tpu.parallel import moe as JM
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import (jax_ravel_order,
                                              params_from_jax,
                                              transformer_params_from_jax)
from bluefog_tpu_torch.parallel import moe as TM
from bluefog_tpu_torch.replicas import RankReplicas

V, L, E, HEADS, EXPERTS = 64, 2, 32, 4, 4
ULP = 6e-8   # one float32 ulp at 1.0 (router probabilities are below it)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,n_exp,cap", [(40, 4, 16), (40, 4, 6), (64, 8, 5)],
                         ids=["roomy", "overflow", "overflow-8"])
def test_plan_dispatch_and_balance_match_jax(T, n_exp, cap, masked):
    rng = np.random.RandomState(T + n_exp + cap)
    logits = rng.randn(3, T, n_exp).astype(np.float32)
    valid = (rng.rand(3, T) > 0.25).astype(np.float32) if masked else None
    j_valid = jnp.asarray(valid if masked else np.ones((3, T), np.float32))
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    tv = None if valid is None else torch.from_numpy(valid)

    j_gate, j_keep, j_slot = jax.vmap(
        lambda lg, v: JM._plan(lg, n_exp, cap, v))(jl, j_valid)
    t_gate, t_keep, t_slot = TM._plan(tl, n_exp, cap, tv)
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_allclose(t_gate.numpy(), np.asarray(j_gate), rtol=0,
                               atol=ULP)
    if cap * n_exp < T:          # not every token can have a slot
        assert (np.asarray(j_keep).sum(-1) < (valid if masked else 1)).any()

    j_comb, j_disp = jax.vmap(
        lambda lg, v: JM.switch_dispatch(lg, n_exp, cap, v))(jl, j_valid)
    t_comb, t_disp = TM.switch_dispatch(tl, n_exp, cap, tv)
    np.testing.assert_array_equal(t_disp.numpy(), np.asarray(j_disp))
    np.testing.assert_allclose(t_comb.numpy(), np.asarray(j_comb), rtol=0,
                               atol=ULP)

    if masked:
        j_aux = jax.vmap(JM.load_balance_loss)(jl, j_valid)
    else:
        j_aux = jax.vmap(JM.load_balance_loss)(jl)
    np.testing.assert_allclose(TM.load_balance_loss(tl, tv).numpy(),
                               np.asarray(j_aux), rtol=0, atol=1e-6)


def test_plan_refuses_a_router_of_another_width():
    lg = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError) as want:
        JM._plan(jnp.asarray(lg), 4, 2)
    with pytest.raises(ValueError) as got:
        TM._plan(torch.from_numpy(lg), 4, 2)
    assert str(got.value) == str(want.value)


def _kw(**extra):
    kw = dict(vocab_size=V, num_layers=L, num_heads=HEADS, embed_dim=E,
              max_seq_len=16, num_experts=EXPERTS)
    kw.update(extra)
    return kw


def _models(dtype="f32", **extra):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(dtype=jd,
                                                         **_kw(**extra)))
    tm = TT.TransformerLM(TT.TransformerConfig(dtype=td, **_kw(**extra)))
    return jm, tm


def _tokens(seed, batch=2, seq=16):
    return np.random.RandomState(seed).randint(0, V, (batch, seq)).astype(
        np.int32)


def _carry(jm, tm, tokens, seed=0):
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                              jnp.asarray(tokens))["params"])
    tm.load_state_dict(transformer_params_from_jax(params))
    return params


def _jax_run(jm, params, tokens):
    """Logits, every block's router logits, the sown aux losses, and the
    gradients of the next-token cross-entropy."""
    x = jnp.asarray(tokens)
    logits, state = jm.apply({"params": params}, x,
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = state["intermediates"]
    routers = [np.asarray(inter[f"block_{i}"]["moe"]["router"]
                          ["__call__"][0]) for i in range(jm.cfg.num_layers)]
    aux = [float(inter[f"block_{i}"]["moe"]["moe_aux_loss"][0])
           for i in range(jm.cfg.num_layers)]

    def loss(p):
        out = jm.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.roll(x, -1, axis=1)).mean()
    grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    return np.asarray(logits), routers, aux, grads


def _port_run(tm, tokens):
    routers = []
    hooks = [blk.moe.router.register_forward_hook(
        lambda mod, args, out: routers.append(out.detach()))
        for blk in tm.blocks]
    x = torch.from_numpy(tokens).long()
    aux = []
    logits = tm(x, moe_aux=aux)
    F.cross_entropy(logits.float().reshape(-1, V),
                    torch.roll(x, -1, 1).reshape(-1)).backward()
    for h in hooks:
        h.remove()
    return (logits.detach().float().numpy(), [r.numpy() for r in routers],
            [float(a) for a in aux],
            {k: p.grad for k, p in tm.named_parameters()})


def _plans(routers, cfg, tokens_total):
    """(expert kept or -1, slot) of every token, per block."""
    g = min(cfg.router_group_size, tokens_total)
    G = -(-tokens_total // g)
    cap = max(1, int(cfg.expert_capacity_factor * g / cfg.num_experts))
    valid = (torch.arange(G * g) < tokens_total).float().reshape(G, g)
    out = []
    for lg in routers:
        _, keep, slot = TM._plan(torch.from_numpy(lg), cfg.num_experts, cap,
                                 valid)
        kept = keep.sum(-1) > 0
        out.append((torch.where(kept, keep.argmax(-1), -1).numpy(),
                    slot.argmax(-1).numpy()))
    return out


def _check_lm(jm, tm, tokens):
    params = _carry(jm, tm, tokens)
    j_logits, j_routers, j_aux, j_grads = _jax_run(jm, params, tokens)
    t_logits, t_routers, t_aux, t_grads = _port_run(tm, tokens)
    T = tokens.size
    assert len(t_routers) == len(j_routers) == jm.cfg.num_layers
    for i, ((je, js), (te, ts)) in enumerate(zip(
            _plans(j_routers, tm.cfg, T), _plans(t_routers, tm.cfg, T))):
        np.testing.assert_array_equal(te, je, err_msg=f"block {i} experts")
        np.testing.assert_array_equal(ts, js, err_msg=f"block {i} slots")
    np.testing.assert_allclose(t_aux, j_aux, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    want = transformer_params_from_jax(j_grads)
    assert set(want) == set(t_grads)
    for name, g in want.items():
        np.testing.assert_allclose(t_grads[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    return j_routers


@pytest.mark.parametrize("case", ["one-group", "ragged-groups", "overflow"])
def test_moe_lm_logits_grads_and_aux_match_jax(case):
    """``ragged-groups``: T = 39 tokens in groups of 5 (8 groups, one pad
    token masked out of routing); ``overflow``: capacity 2 a group of 8, so
    tokens drop."""
    extra, batch, seq = {}, 2, 16
    if case == "ragged-groups":
        extra, batch, seq = dict(router_group_size=5), 3, 13
    if case == "overflow":
        extra = dict(router_group_size=8, expert_capacity_factor=1.0)
    jm, tm = _models(**extra)
    tokens = _tokens(11, batch, seq)
    routers = _check_lm(jm, tm, tokens)
    if case == "overflow":
        experts, _ = _plans(routers, tm.cfg, tokens.size)[0]
        assert (experts < 0).any()    # some tokens dropped


def test_bf16_plans_are_reported():
    """In bfloat16 the router still runs in float32, on tokens that carry
    the two packages' bf16 rounding differences; the share of tokens
    routed otherwise is reported, and it is small."""
    jm, tm = _models("bf16")
    tokens = _tokens(12)
    params = _carry(jm, tm, tokens)
    _, j_routers, _, _ = _jax_run(jm, params, tokens)
    _, t_routers, _, _ = _port_run(tm, tokens)
    T = tokens.size
    assert len(t_routers) == len(j_routers) == L
    flips = sum(int((je != te).sum()) for (je, _), (te, _) in zip(
        _plans(j_routers, tm.cfg, T), _plans(t_routers, tm.cfg, T)))
    share = flips / (T * L)
    print(f"bf16 MoE LM: {flips} of {T * L} routing decisions differ "
          f"({share:.3%})")
    assert share <= 0.05


def test_remat_adds_no_aux_twice():
    """Under remat the recompute reruns every block; ``moe_aux`` holds the
    forward's one entry a block, equal to the plain forward's."""
    _, plain = _models()
    plain.reset_parameters(torch.Generator().manual_seed(0))
    _, remat = _models(remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_tokens(13)).long()
    outs = {}
    for name, m in (("plain", plain), ("remat", remat)):
        aux = []
        logits = m(x, moe_aux=aux)
        (logits.sum() + 0.01 * sum(aux)).backward()
        outs[name] = (aux, {k: p.grad for k, p in m.named_parameters()})
    assert len(outs["remat"][0]) == L
    np.testing.assert_array_equal([float(a) for a in outs["remat"][0]],
                                  [float(a) for a in outs["plain"][0]])
    for k, g in outs["plain"][1].items():
        np.testing.assert_allclose(outs["remat"][1][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_decode_with_moe_raises_as_jax():
    jm, tm = _models()
    tokens = _tokens(14)
    params = _carry(jm, tm, tokens)
    from bluefog_tpu.models.transformer import init_cache as j_init_cache
    with pytest.raises(NotImplementedError) as want:
        jm.apply({"params": params}, jnp.asarray(tokens[:, :1]),
                 positions=jnp.zeros((2, 1), jnp.int32),
                 cache=j_init_cache(jm.cfg, 2, 8))
    with pytest.raises(NotImplementedError) as got:
        tm(torch.from_numpy(tokens[:, :1]).long(),
           positions=torch.zeros(2, 1, dtype=torch.long),
           cache=TT.init_cache(tm.cfg, 2, 8, device="cpu"))
    assert str(got.value) == str(want.value)


def test_flat_is_the_jax_ravel_with_moe():
    """The ``moe`` subtree sorts between ``RMSNorm_1`` and ``proj``, and
    inside it ``experts_down``, ``experts_up``, ``router``; the experts are
    stored in flax's layout, the router kernel ``(in, out)``."""
    kw = _kw(num_layers=3)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(dtype=jnp.float32,
                                                         **kw))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(_tokens(15)))["params"])
    assert list(params["block_0"]) == ["RMSNorm_0", "RMSNorm_1", "moe",
                                       "proj", "qkv"]
    assert list(params["block_0"]["moe"]) == ["experts_down", "experts_up",
                                              "router"]
    make = lambda: TT.TransformerLM(  # noqa: E731
        TT.TransformerConfig(dtype=torch.float32, **kw))
    sd = transformer_params_from_jax(params)
    got = params_from_jax(make(), params)
    assert sorted(sd) == sorted(got)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k].numpy(),
                                      err_msg=k)
    rep = RankReplicas(make, 1, "cpu", order=jax_ravel_order(make()))
    rep.load_state_dict(sd)
    np.testing.assert_array_equal(rep.flat[0].numpy(),
                                  np.asarray(ravel_pytree(params)[0]))


@pytest.mark.parametrize("layers,count", [(6, 1846667264), (4, 1276200960)])
def test_full_width_moe_parameter_count_matches_jax(layers, count):
    """``chip_smoke.py``'s ``moe_train``: the 1.3B LM's widths with 8 GELU
    experts, counted without allocating."""
    kw = dict(vocab_size=32000, num_layers=layers, num_heads=16,
              embed_dim=2048, max_seq_len=2048, num_experts=8)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 8), jnp.int32))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = TT.TransformerLM(TT.TransformerConfig(**kw))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == count


def test_experts_draw_lecun_normal_per_expert():
    """``lecun_normal(batch_axis=(0,))``: fan-in is dim 1 of the stacked
    ``(E, in, out)`` weight, not ``E * in``."""
    _, tm = _models(embed_dim=64)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    up = tm.blocks[0].moe.experts_up.detach()
    down = tm.blocks[0].moe.experts_down.detach()
    assert float(up.std()) == pytest.approx(1 / np.sqrt(64), rel=0.05)
    assert float(down.std()) == pytest.approx(1 / np.sqrt(256), rel=0.05)


def test_moe_apply_matches_jax_shard_map(devices):
    """Eight ranks, one expert each: the forward, and the gradients under
    the convention of the docstring (each rank's objective divided by the
    axis size; the router logits' gradient summed over the ranks)."""
    n, T, d, h = 8, 24, 6, 10
    rng = np.random.RandomState(16)
    x = rng.randn(T, d).astype(np.float32)
    logits = rng.randn(T, n).astype(np.float32)
    w1 = (0.5 * rng.randn(n, d, h)).astype(np.float32)
    w2 = (0.5 * rng.randn(n, h, d)).astype(np.float32)
    target = rng.randn(T, d).astype(np.float32)
    mesh = Mesh(np.asarray(devices[:n]), ("ep",))

    def j_expert(p, xe):
        return jnp.tanh(xe @ p[0]) @ p[1]

    def j_rank(w1b, w2b, xb, lgb):
        def loss(w1e, w2e, lg):
            y, aux = JM.moe_apply(j_expert, (w1e, w2e), xb, lg,
                                  axis_name="ep", with_aux=True)
            return (jnp.sum(y * target) + aux) / n, y
        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(w1b[0], w2b[0], lgb)
        return y[None], g[0][None], g[1][None], g[2][None]
    j_y, j_g1, j_g2, j_gl = jax.jit(jax.shard_map(
        j_rank, mesh=mesh, in_specs=(P("ep"), P("ep"), P(), P()),
        out_specs=(P("ep"),) * 4, check_vma=False))(w1, w2, x, logits)

    rep = lambda a: torch.from_numpy(np.broadcast_to(  # noqa: E731
        a, (n,) + a.shape).copy())
    tw1, tw2 = (torch.from_numpy(w).requires_grad_() for w in (w1, w2))
    tx, tl = rep(x), rep(logits).requires_grad_()
    y, aux = TM.moe_apply(lambda p, xe: torch.tanh(xe @ p[0]) @ p[1],
                          (tw1, tw2), tx, tl, with_aux=True)
    ((y * torch.from_numpy(target)).sum((1, 2)) + aux).div(n).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j_y), rtol=0,
                               atol=1e-6)
    assert (y[0] == y).all()              # every rank holds the same sum
    np.testing.assert_allclose(tw1.grad.numpy(), np.asarray(j_g1), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tw2.grad.numpy(), np.asarray(j_g2), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(j_gl), rtol=0,
                               atol=1e-6)
    # Each rank's router gradient is partial: their sum is the gradient of
    # the true loss, the dense oracle's.
    xd = torch.from_numpy(x)
    lgd = torch.from_numpy(logits).requires_grad_()
    w1d, w2d = (torch.from_numpy(w).requires_grad_() for w in (w1, w2))
    cap = max(1, (2 * T) // n)
    gate, keep, slot = TM._plan(lgd, n, cap)
    dense = sum(((gate * keep[:, e])[:, None] * slot)
                @ (torch.tanh(((slot.T * keep[:, e][None, :]) @ xd) @ w1d[e])
                   @ w2d[e]) for e in range(n))
    ((dense * torch.from_numpy(target)).sum()
     + TM.load_balance_loss(lgd)).backward()
    np.testing.assert_allclose(tl.grad.sum(0).numpy(), lgd.grad.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw1.grad.numpy(), w1d.grad.numpy(), rtol=0,
                               atol=1e-5)
