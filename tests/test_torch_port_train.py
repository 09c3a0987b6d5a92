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
        "--device", "cpu", "--flash-attention", "--atc", "--dynamic",
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
