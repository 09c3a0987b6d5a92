"""The port's TransformerLM with weights carried from the JAX package's flax
model: logits agree at 1e-4 in float32 (two matmul orders), 5e-2 in
bfloat16 (activations rounded at the same places in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jmodels
from bluefog_tpu.ops.flash_attention import flash_attention_impl as j_flash
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

V, L, E, HEADS, SEQ = 128, 2, 64, 4, 32


def _jax_model(dtype, attn="flash"):
    cfg = jmodels.TransformerConfig(vocab_size=V, num_layers=L,
                                    num_heads=HEADS, embed_dim=E,
                                    max_seq_len=SEQ, dtype=dtype)
    impl = j_flash(block_q=16, block_k=16) if attn == "flash" else None
    return jmodels.TransformerLM(cfg, attn_impl=impl)


def _port_model(dtype, attn="flash"):
    cfg = TransformerConfig(vocab_size=V, num_layers=L, num_heads=HEADS,
                            embed_dim=E, max_seq_len=SEQ, dtype=dtype)
    return TransformerLM(cfg, flash_attention_impl() if attn == "flash"
                         else None)


def _params(model, tokens, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    return jax.tree.map(np.asarray, variables["params"])


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, V, (2, SEQ)).astype(np.int32)


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_logits_f32_match_jax(attn):
    tokens = _tokens()
    jm = _jax_model(jnp.float32, attn)
    params = _params(jm, tokens)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    tm = _port_model(torch.float32, attn)
    tm.load_state_dict(transformer_params_from_jax(params))
    out = tm(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == (2, SEQ, V)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-4)


def test_logits_bf16_match_jax():
    tokens = _tokens(1)
    jm = _jax_model(jnp.bfloat16)
    params = _params(jm, tokens, seed=1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    tm = _port_model(torch.bfloat16)
    tm.load_state_dict(transformer_params_from_jax(params))
    out = tm(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32  # the lm-head runs in float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=5e-2)


def test_param_names_and_shapes_carry_over():
    tokens = _tokens()
    params = _params(_jax_model(jnp.float32), tokens)
    sd = transformer_params_from_jax(params)
    tm = _port_model(torch.float32)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("key", [
    "wte.weight", "wpe.weight", "lm_head.weight", "RMSNorm_0.scale",
    "blocks.0.qkv.weight", "blocks.0.proj.weight", "blocks.0.up.weight",
    "blocks.1.down.weight"])
def test_reset_parameters_draws_flax_default_distributions(key):
    """The port's random init and flax's default init agree in deviation
    (within 10%: at least 2048 draws each) and in support (dense kernels
    are truncated at 2 / 0.8796 deviations of N(0, 1/fan_in))."""
    ref = transformer_params_from_jax(_params(_jax_model(jnp.float32),
                                              _tokens()))[key].numpy()
    tm = _port_model(torch.float32)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    got = tm.state_dict()[key].numpy()
    if key.endswith(".scale"):
        np.testing.assert_array_equal(got, ref)
        return
    assert got.std() == pytest.approx(ref.std(), rel=0.1)
    if not key.startswith(("wte", "wpe")):
        edge = 2.0 / 0.87962566103423978 / np.sqrt(got.shape[1])
        for draws in (got, ref):
            assert np.abs(draws).max() <= edge * (1 + 1e-6)
            assert np.abs(draws).max() >= 0.95 * edge


@pytest.mark.parametrize("kw", [{"num_kv_heads": 2}, {"pos_encoding": "rope"},
                                {"mlp": "swiglu"}, {"num_experts": 4},
                                {"remat": True}])
def test_unported_options_name_roadmap(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TransformerConfig(num_heads=4, embed_dim=64, **kw)


def test_cache_path_not_ported():
    tm = _port_model(torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm(torch.zeros(1, 1, dtype=torch.long), cache=[])
