"""The port's Llama-style TransformerLM options (GQA, RoPE, SwiGLU) against
the JAX package's flax model, with carried weights and seeded tokens.

float32 logits and every parameter's gradient at 1e-4 (two matmul orders,
``tests/test_models.py``'s tolerance); ``apply_rope`` at 1e-6; the port's
flash twin against the JAX flash kernel in interpret mode at 2e-3 (as
``test_transformer_rope_flash_matches_dense``).  ``flat`` laid out by
``jax_ravel_order`` equals the JAX package's ravel bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from bluefog_tpu import models as jmodels
from bluefog_tpu.models import transformer as JT
from bluefog_tpu.ops.flash_attention import flash_attention_impl as j_flash
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import (jax_ravel_order,
                                              params_from_jax,
                                              transformer_params_from_jax)
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl
from bluefog_tpu_torch.replicas import RankReplicas

V, L, E, HEADS, SEQ = 64, 2, 32, 4, 16
VARIANTS = {
    "gqa": dict(num_kv_heads=2),
    "mqa": dict(num_kv_heads=1),
    "rope": dict(pos_encoding="rope"),
    "swiglu": dict(mlp="swiglu"),
    "gqa_rope_swiglu": dict(num_kv_heads=2, pos_encoding="rope",
                            mlp="swiglu"),
}


def _kw(variant, **extra):
    kw = dict(vocab_size=V, num_layers=L, num_heads=HEADS, embed_dim=E,
              max_seq_len=SEQ)
    kw.update(VARIANTS.get(variant, {}), **extra)
    return kw


def _models(variant, flash=False, **extra):
    jm = jmodels.TransformerLM(
        jmodels.TransformerConfig(dtype=jnp.float32, **_kw(variant, **extra)),
        attn_impl=j_flash(block_q=16, block_k=16) if flash else None)
    tm = TT.TransformerLM(
        TT.TransformerConfig(dtype=torch.float32, **_kw(variant, **extra)),
        flash_attention_impl() if flash else None)
    return jm, tm


def _tokens(seed=0, batch=2, seq=SEQ):
    return np.random.RandomState(seed).randint(0, V, (batch, seq)).astype(
        np.int32)


def _carry(jm, tm, tokens, seed=0):
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                              jnp.asarray(tokens))["params"])
    tm.load_state_dict(transformer_params_from_jax(params))
    return params


def _jax_loss_and_grads(jm, params, tokens):
    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(jnp.asarray(tokens), -1, axis=1)).mean()
    logits = jm.apply({"params": params}, jnp.asarray(tokens))
    return np.asarray(logits), jax.grad(loss)(params)


def _port_loss_and_grads(tm, tokens):
    x = torch.from_numpy(tokens).long()
    logits = tm(x)
    F.cross_entropy(logits.reshape(-1, V),
                    torch.roll(x, -1, 1).reshape(-1)).backward()
    return logits.detach().numpy(), {k: p.grad for k, p in
                                     tm.named_parameters()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_and_grads_match_jax(variant):
    tokens = _tokens(1)
    jm, tm = _models(variant)
    params = _carry(jm, tm, tokens)
    j_logits, j_grads = _jax_loss_and_grads(jm, params, tokens)
    t_logits, t_grads = _port_loss_and_grads(tm, tokens)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4)
    want = transformer_params_from_jax(jax.tree.map(np.asarray, j_grads))
    assert set(want) == set(t_grads)
    for name, g in want.items():
        np.testing.assert_allclose(t_grads[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_flash_twin_matches_jax_flash_kernel_on_gqa_rope():
    """The port's flash path (the plain twin on the CPU) against the JAX
    package's Pallas kernels in interpret mode, GQA + RoPE, S=32."""
    tokens = _tokens(2, seq=32)
    jm, tm = _models("gqa_rope_swiglu", flash=True, max_seq_len=64)
    params = _carry(jm, tm, tokens)
    j_logits, j_grads = _jax_loss_and_grads(jm, params, tokens)
    t_logits, t_grads = _port_loss_and_grads(tm, tokens)
    np.testing.assert_allclose(t_logits, j_logits, rtol=2e-3, atol=2e-3)
    want = transformer_params_from_jax(jax.tree.map(np.asarray, j_grads))
    for name, g in want.items():
        np.testing.assert_allclose(t_grads[name].numpy(), g.numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def test_repeat_kv_is_jnp_repeat_not_tiling():
    """Query head j reads kv head j // rep (``jnp.repeat``); tiling would
    read j % kv_h, which differs once kv_h > 1 and rep > 1."""
    x = np.random.RandomState(3).randn(2, 5, 3, 4).astype(np.float32)
    got = TT.repeat_kv(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.repeat(x, 2, axis=2)))
    assert not np.array_equal(got, np.tile(x, (1, 1, 2, 1)))


def test_apply_rope_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 3, 8).astype(np.float32)
    pos = rng.randint(0, 100, (2, 7)).astype(np.int32)
    want = np.asarray(JT.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = TT.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # position 0 is the identity rotation
    ident = TT.apply_rope(torch.from_numpy(x), torch.zeros(2, 7))
    np.testing.assert_allclose(ident.numpy(), x, rtol=1e-6)
    # bfloat16 in, bfloat16 out: rotated in float32, cast once
    xb = torch.from_numpy(x).bfloat16()
    got_b = TT.apply_rope(xb, torch.from_numpy(pos).long())
    assert got_b.dtype == torch.bfloat16
    want_b = TT.apply_rope(xb.float(), torch.from_numpy(pos).long())
    np.testing.assert_array_equal(got_b.float().numpy(),
                                  want_b.bfloat16().float().numpy())


def test_rope_shift_invariance_and_no_wpe():
    """RoPE attends by relative position: shifting every position id by a
    constant leaves the logits unchanged; the model holds no ``wpe``."""
    _, tm = _models("rope", max_seq_len=512)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    assert not any("wpe" in n for n, _ in tm.named_parameters())
    x = torch.from_numpy(_tokens(5)).long()
    pos = torch.arange(SEQ)[None, :]
    base = tm(x, positions=pos).detach().numpy()
    shifted = tm(x, positions=pos + 100).detach().numpy()
    np.testing.assert_allclose(shifted, base, rtol=1e-4, atol=1e-4)


def test_explicit_positions_match_jax():
    tokens = _tokens(6)
    jm, tm = _models("gqa_rope_swiglu", max_seq_len=64)
    params = _carry(jm, tm, tokens)
    pos = np.arange(SEQ)[None, :] + 7
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    positions=jnp.asarray(pos))
    got = tm(torch.from_numpy(tokens).long(), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(num_heads=4, num_kv_heads=3),
    dict(embed_dim=90, num_heads=6, pos_encoding="rope"),
    dict(pos_encoding="alibi"),
    dict(mlp="relu"),
    dict(mlp="swiglu", num_experts=4),
    dict(remat=True, remat_policy="dots:abc"),
    dict(remat=True, remat_policy="dots:-1"),
    dict(remat=True, remat_policy="mixed"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jmodels.TransformerConfig(**kw)
    with pytest.raises(ValueError) as got:
        TT.TransformerConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("variant", ["mha"] + list(VARIANTS))
def test_flat_is_the_jax_ravel(variant):
    """``RankReplicas(order=jax_ravel_order(model))`` lays the LM's
    parameters out as ``ravel_pytree`` of the flax tree (sorted keys,
    ``block_10`` before ``block_2``, Dense kernels ``(in, out)``); the
    module order does not."""
    kw = _kw(variant, num_layers=11)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(dtype=jnp.float32,
                                                         **kw))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(_tokens(7)))["params"])
    want = np.asarray(ravel_pytree(params)[0])
    make = lambda: TT.TransformerLM(  # noqa: E731
        TT.TransformerConfig(dtype=torch.float32, **kw))
    sd = transformer_params_from_jax(params)
    np.testing.assert_array_equal(
        sorted(sd), sorted(params_from_jax(make(), params)))
    rep = RankReplicas(make, 1, "cpu", order=jax_ravel_order(make()))
    rep.load_state_dict(sd)
    np.testing.assert_array_equal(rep.flat[0].numpy(), want)
    plain = RankReplicas(make, 1, "cpu")
    plain.load_state_dict(sd)
    assert not np.array_equal(plain.flat[0].numpy(), want)


def test_full_width_parameter_count_matches_jax():
    """The Llama-style 1.6B of ``chip_smoke.py``'s ``llama_train``: 24
    layers, width 2048, 16 heads, 4 kv heads, RoPE, SwiGLU, vocab 32000;
    counted without allocating (``jax.eval_shape``, the meta device)."""
    kw = dict(vocab_size=32000, num_layers=24, num_heads=16, num_kv_heads=4,
              embed_dim=2048, max_seq_len=2048, pos_encoding="rope",
              mlp="swiglu")
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 8), jnp.int32))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = TT.TransformerLM(TT.TransformerConfig(**kw))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == 1590790144
