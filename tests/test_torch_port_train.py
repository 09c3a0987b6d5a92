"""The slice end to end: decentralized TransformerLM training in the port
against the JAX package, from the same weights and per-rank tokens.

3 steps over the dynamic one-peer topology of ExponentialGraph(4) on 4
ranks; per-rank losses and parameters agree at 1e-4 (float32, XLA-CPU and
torch-CPU order their matmul sums differently)."""

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
from bluefog_tpu.ops.flash_attention import flash_attention_impl as j_flash
from bluefog_tpu_torch import benchmark
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl
from bluefog_tpu_torch.optim import optimizers as TO
from bluefog_tpu_torch.replicas import RankReplicas

N, V, L, E, HEADS, SEQ, BATCH, STEPS = 4, 128, 2, 64, 4, 32, 2, 3
LR = 0.0125 * N


def _jax_run(devices, tokens, order, momentum):
    jbf.init(devices=devices[:N])
    cfg = jmodels.TransformerConfig(vocab_size=V, num_layers=L,
                                    num_heads=HEADS, embed_dim=E,
                                    max_seq_len=SEQ, dtype=jnp.float32)
    model = jmodels.TransformerLM(cfg, attn_impl=j_flash(block_q=16,
                                                         block_k=16))
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[0]))["params"]
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N,) + x.shape),
                          init)
    cls = (jbf.optim.DistributedAdaptThenCombineOptimizer if order == "atc"
           else jbf.optim.DistributedAdaptWithCombineOptimizer)
    opt = cls(optax.sgd(LR, momentum=momentum or None),
              use_dynamic_topology=True)
    state = opt.init(params)

    def loss_fn(p, x):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(x, -1, axis=1)).mean()

    vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn)))
    x = jnp.asarray(tokens)
    losses = []
    for _ in range(STEPS):
        loss, grads = vgrad(params, x)
        params, state = opt.step(params, grads, state)
        losses.append(np.asarray(loss))
    return (jax.tree.map(np.asarray, init), np.stack(losses),
            jax.tree.map(np.asarray, params))


def _port_run(init_params, tokens, order, momentum):
    tbf.init(N, device="cpu")
    try:
        cfg = TransformerConfig(vocab_size=V, num_layers=L, num_heads=HEADS,
                                embed_dim=E, max_seq_len=SEQ,
                                dtype=torch.float32)
        rep = RankReplicas(lambda: TransformerLM(cfg, flash_attention_impl()),
                           N, "cpu")
        rep.load_state_dict(transformer_params_from_jax(init_params))
        base = torch.optim.SGD([rep.flat], lr=LR, momentum=momentum,
                               dampening=0)
        cls = (TO.DistributedAdaptThenCombineOptimizer if order == "atc"
               else TO.DistributedAdaptWithCombineOptimizer)
        opt = cls(base, use_dynamic_topology=True)
        x = torch.from_numpy(tokens).long()
        losses = []
        for _ in range(STEPS):
            rep.zero_grad()
            step_losses = []
            for r in range(N):
                logits = rep.modules[r](x[r])
                loss = F.cross_entropy(logits.reshape(-1, V),
                                       torch.roll(x[r], -1, 1).reshape(-1))
                loss.backward()
                step_losses.append(loss.item())
            opt.step()
            losses.append(step_losses)
        assert opt.step_count == STEPS
        return np.asarray(losses), rep
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("order,momentum", [("atc", 0.9), ("atc", 0.0),
                                            ("awc", 0.9)])
def test_trajectory_matches_jax(devices, order, momentum):
    tokens = np.random.RandomState(0).randint(
        0, V, (N, BATCH, SEQ)).astype(np.int32)
    init, j_losses, j_params = _jax_run(devices, tokens, order, momentum)
    t_losses, rep = _port_run(init, tokens, order, momentum)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    # Different data per rank: the ranks must have drifted apart.
    assert np.ptp(t_losses[-1]) > 1e-3
    for r in range(N):
        want = transformer_params_from_jax(
            jax.tree.map(lambda a: a[r], j_params))
        got = rep.rank_params(r)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                       rtol=0, atol=1e-4, err_msg=name)


def test_benchmark_runs_on_cpu():
    """The trainer entry point end to end at a tiny size on the CPU."""
    args = benchmark.build_parser().parse_args([
        "--device", "cpu", "--model", "transformer", "--flash-attention",
        "--atc", "--dynamic",
        "--num-layers", "1", "--embed-dim", "32", "--num-heads", "2",
        "--seq-len", "16", "--batch-size", "2", "--vocab-size", "64",
        "--momentum", "0", "--ranks", "4", "--num-warmup-batches", "1",
        "--num-iters", "2", "--num-batches-per-iter", "1"])
    try:
        res = benchmark.measure(args)
    finally:
        tbf.shutdown()
    assert res["steps"] == 3 and len(res["losses"]) == 4
    assert all(np.isfinite(res["losses"]))
    assert res["spread"]["after_combine"] < res["spread"]["after_adapt"]
    assert res["tokens_per_s"] > 0


def _llama_kw(variant):
    kw = dict(vocab_size=V, num_layers=L, num_heads=HEADS, embed_dim=E,
              max_seq_len=SEQ)
    if variant == "llama":
        kw.update(num_kv_heads=2, pos_encoding="rope", mlp="swiglu")
    if variant == "moe":
        kw.update(num_experts=4, router_group_size=32)
    return kw


def _jax_llama_run(devices, tokens, variant, compression="none",
                   remat=None, chunked=False):
    """The JAX package's ATC over the dynamic topology, SGD without
    momentum; each step's gradients and parameters on the host."""
    from bluefog_tpu.ops.chunked_loss import chunked_softmax_cross_entropy
    jbf.init(devices=devices[:N])
    cfg = jmodels.TransformerConfig(dtype=jnp.float32, remat=remat is not None,
                                    remat_policy=remat or "full",
                                    **_llama_kw(variant))
    model = jmodels.TransformerLM(cfg, attn_impl=j_flash(block_q=16,
                                                         block_k=16))
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[0]))["params"]
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (N,) + x.shape),
                          init)
    opt = jbf.optim.DistributedAdaptThenCombineOptimizer(
        optax.sgd(LR), use_dynamic_topology=True, compression=compression)
    state = opt.init(params)

    def loss_fn(p, x):
        tgt = jnp.roll(x, -1, axis=1)
        if chunked:
            h = model.apply({"params": p}, x, return_hidden=True)
            return chunked_softmax_cross_entropy(h, p["lm_head"]["kernel"],
                                                 tgt, chunk=8)
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, x), tgt).mean()

    vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn)))
    losses = []
    for _ in range(STEPS):
        loss, grads = vgrad(params, jnp.asarray(tokens))
        params, state = opt.step(params, jax.device_get(grads), state)
        params = jax.device_get(params)
        losses.append(np.asarray(loss))
    return (jax.tree.map(np.asarray, init), np.stack(losses),
            jax.tree.map(np.asarray, params))


def _port_llama_run(init_params, tokens, variant, compression="none",
                    remat=None, chunked=False, order="jax"):
    from bluefog_tpu_torch.models.convert import jax_ravel_order
    from bluefog_tpu_torch.ops.chunked_loss import \
        chunked_softmax_cross_entropy
    tbf.init(N, device="cpu")
    try:
        cfg = TransformerConfig(dtype=torch.float32, remat=remat is not None,
                                remat_policy=remat or "full",
                                **_llama_kw(variant))
        make = lambda: TransformerLM(cfg, flash_attention_impl())  # noqa
        rep = RankReplicas(make, N, "cpu", order=(
            jax_ravel_order(make()) if order == "jax" else None))
        rep.load_state_dict(transformer_params_from_jax(init_params))
        opt = TO.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([rep.flat], lr=LR), use_dynamic_topology=True,
            compression=compression)
        x = torch.from_numpy(tokens).long()
        losses = []
        for _ in range(STEPS):
            rep.zero_grad()
            step_losses = []
            for r in range(N):
                mod, tgt = rep.modules[r], torch.roll(x[r], -1, 1)
                if chunked:
                    loss = chunked_softmax_cross_entropy(
                        mod(x[r], return_hidden=True), mod.lm_head.weight,
                        tgt, chunk=8)
                else:
                    loss = F.cross_entropy(mod(x[r]).reshape(-1, V),
                                           tgt.reshape(-1))
                loss.backward()
                step_losses.append(loss.item())
            opt.step()
            losses.append(step_losses)
        return np.asarray(losses), rep
    finally:
        tbf.shutdown()


def _param_diff(rep, j_params):
    """Largest absolute difference of any rank's parameter."""
    worst = 0.0
    for r in range(N):
        want = transformer_params_from_jax(
            jax.tree.map(lambda a: a[r], j_params))
        got = rep.rank_params(r)
        for name, w in want.items():
            worst = max(worst, float(np.abs(
                got[name].detach().numpy() - w.numpy()).max()))
    return worst


def test_llama_remat_chunked_trajectory_matches_jax(devices):
    """A tiny Llama-style LM (GQA, RoPE, SwiGLU) with remat (``dots:1``)
    and the chunked loss, 3 ATC steps over the dynamic topology on 4
    ranks, through the flash path (the twin on the CPU, interpret mode in
    the JAX package): losses and parameters at 1e-4."""
    tokens = np.random.RandomState(1).randint(
        0, V, (N, BATCH, SEQ)).astype(np.int32)
    init, j_losses, j_params = _jax_llama_run(devices, tokens, "llama",
                                              remat="dots:1", chunked=True)
    t_losses, rep = _port_llama_run(init, tokens, "llama", remat="dots:1",
                                    chunked=True)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    assert np.ptp(t_losses[-1]) > 1e-3
    assert _param_diff(rep, j_params) <= 1e-4


def test_moe_remat_trajectory_matches_jax(devices):
    """The slice's path at a tiny size: a 2-layer, 4-expert MoE LM (routing
    groups of 32 tokens, two a sequence pair) with full remat, 3 ATC steps
    over the dynamic topology on 4 ranks, through the flash path: losses
    and parameters at 1e-4."""
    tokens = np.random.RandomState(2).randint(
        0, V, (N, BATCH, SEQ)).astype(np.int32)
    init, j_losses, j_params = _jax_llama_run(devices, tokens, "moe",
                                              remat="full")
    t_losses, rep = _port_llama_run(init, tokens, "moe", remat="full")
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    assert np.ptp(t_losses[-1]) > 1e-3
    assert _param_diff(rep, j_params) <= 1e-4


def _benchmark(extra):
    args = benchmark.build_parser().parse_args([
        "--device", "cpu", "--model", "transformer", "--flash-attention",
        "--num-layers", "1", "--embed-dim", "32", "--num-heads", "2",
        "--seq-len", "16", "--batch-size", "2", "--vocab-size", "64",
        "--momentum", "0", "--ranks", "4", "--num-warmup-batches", "1",
        "--num-iters", "2", "--num-batches-per-iter", "1"] + extra)
    try:
        return benchmark.measure(args, quiet=True)
    finally:
        tbf.shutdown()


def test_benchmark_moe_runs_on_cpu():
    """``--num-experts`` with remat: it trains, and ``--mfu`` reports the
    JAX benchmark's note instead of an MFU."""
    res = _benchmark(["--atc", "--dynamic", "--num-experts", "4", "--remat",
                      "--mfu"])
    assert res["steps"] == 3 and all(np.isfinite(res["losses"]))
    assert res["spread"]["after_combine"] < res["spread"]["after_adapt"]
    assert "mfu" not in res and "dense models only" in res["mfu_note"]
    # 1 block: the attention, the router (32 x 4) and 4 experts of 32 x 128
    # both ways.
    assert res["params_per_rank"] == (64 * 32 + 16 * 32 + 2 * 32 + 32 * 96
                                      + 32 * 32 + 32 * 4 + 2 * 4 * 32 * 128
                                      + 32 + 64 * 32)


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_benchmark_gradient_allreduce_keeps_replicas_equal(compression):
    """``--dist-optimizer gradient_allreduce``: the ranks' spread is
    exactly 0 after every step, and their losses differ (each rank its own
    data)."""
    res = _benchmark(["--dist-optimizer", "gradient_allreduce",
                      "--compression", compression])
    assert res["steps"] == 3
    assert res["spread"]["after_step"] == [0.0, 0.0, 0.0]
    assert np.ptp(res["losses"]) > 0
