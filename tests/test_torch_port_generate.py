"""KV-cache decoding in the port (``init_cache``, ``generate``, the model's
``cache`` path) against its own full forward and the JAX package's, float32
with carried weights: teacher-forced decode logits at 1e-4
(``test_transformer_kv_cache_decode_matches_forward``'s tolerance), greedy
tokens equal to the JAX package's, and the same refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jmodels
from bluefog_tpu.models.transformer import generate as j_generate
from bluefog_tpu.models.transformer import init_cache as j_init_cache
from bluefog_tpu_torch import text_generation
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

VARIANTS = {"mha": {},
            "gqa_rope_swiglu": dict(num_kv_heads=2, pos_encoding="rope",
                                    mlp="swiglu")}


def _pair(variant, vocab=64, heads=4, embed=32, seq=16, seed=0, **extra):
    kw = dict(vocab_size=vocab, num_layers=2, num_heads=heads,
              embed_dim=embed, max_seq_len=seq, **VARIANTS[variant], **extra)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(dtype=jnp.float32,
                                                         **kw))
    tm = TT.TransformerLM(TT.TransformerConfig(dtype=torch.float32, **kw))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    tm.load_state_dict(transformer_params_from_jax(params))
    return jm, tm, params


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_full_forward(variant):
    jm, tm, params = _pair(variant)
    tokens = np.random.RandomState(5).randint(0, 64, (2, 10))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    x = torch.from_numpy(tokens).long()
    full = tm(x).detach().numpy()
    np.testing.assert_allclose(full, want, rtol=0, atol=1e-4)
    cache = TT.init_cache(tm.cfg, 2, 10, device="cpu")
    kv_h = tm.cfg.num_kv_heads or tm.cfg.num_heads
    assert cache[0][0].shape == (2, 10, kv_h, 8)
    assert cache[0][0].shape == j_init_cache(jm.cfg, 2, 10)[0][0].shape
    got = []
    with torch.no_grad():
        for t in range(10):
            logits, cache = tm(x[:, t:t + 1], positions=torch.full((2, 1), t),
                               cache=cache)
            got.append(logits[:, 0])
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_tokens_match_jax(variant):
    jm, tm, params = _pair(variant, vocab=32, embed=32, seq=24, seed=1)
    prompt = np.random.RandomState(6).randint(0, 32, (2, 5)).astype(np.int32)
    want = np.asarray(j_generate(jm, params, jnp.asarray(prompt), 12))
    got = TT.generate(tm, torch.from_numpy(prompt), 12)
    assert got.shape == (2, 12) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the first token is the argmax of the forward's last-prompt logits
    full = tm(torch.from_numpy(prompt).long())
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  full[:, -1].argmax(-1).numpy())
    assert TT.generate(tm, torch.from_numpy(prompt), 1).shape == (2, 1)


def test_prefill_through_the_flash_path():
    """A model built with ``flash_attention_impl()`` prefills through it
    (the plain twin on the CPU, K1 on the card) and decodes the same
    tokens as with dense attention."""
    _, dense, _ = _pair("gqa_rope_swiglu", vocab=32, embed=64, seq=32,
                        seed=2)
    flash = TT.TransformerLM(dense.cfg, flash_attention_impl())
    flash.load_state_dict(dense.state_dict())
    prompt = torch.from_numpy(
        np.random.RandomState(7).randint(0, 32, (2, 9))).long()
    np.testing.assert_array_equal(TT.generate(flash, prompt, 8).numpy(),
                                  TT.generate(dense, prompt, 8).numpy())


def test_sampling_takes_an_explicit_generator():
    _, tm, _ = _pair("gqa_rope_swiglu", vocab=32, seq=24, seed=3)
    prompt = torch.from_numpy(
        np.random.RandomState(8).randint(0, 32, (2, 5))).long()
    draws = [TT.generate(tm, prompt, 6, temperature=1.0,
                         generator=torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert draws[0].shape == (2, 6)
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    assert not np.array_equal(draws[0].numpy(), draws[2].numpy())


def test_refusals_match_jax():
    jm, tm, params = _pair("mha", vocab=32, seq=24, seed=4)
    prompt = np.random.RandomState(9).randint(0, 32, (2, 5))
    jp, tp = jnp.asarray(prompt), torch.from_numpy(prompt).long()
    for n, kw in ((100, {}), (0, {})):
        with pytest.raises(ValueError) as want:
            j_generate(jm, params, jp, n, **kw)
        with pytest.raises(ValueError) as got:
            TT.generate(tm, tp, n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs rng"):
        j_generate(jm, params, jp, 2, temperature=0.5)
    with pytest.raises(ValueError, match="needs a generator"):
        TT.generate(tm, tp, 2, temperature=0.5)
    cache = TT.init_cache(tm.cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="ONE token"):
        tm(tp[:, :3], positions=torch.zeros(2, 3, dtype=torch.long),
           cache=cache)
    with pytest.raises(ValueError) as want:
        jm.apply(params, jp[:, :1], cache=j_init_cache(jm.cfg, 2, 8))
    with pytest.raises(ValueError) as got:
        tm(tp[:, :1], cache=cache)
    assert str(got.value) == str(want.value)
    bidir = TT.TransformerLM(TT.TransformerConfig(
        vocab_size=32, num_layers=1, num_heads=4, embed_dim=32,
        causal=False, dtype=torch.float32))
    with pytest.raises(ValueError, match="requires causal=True"):
        bidir(tp[:, :1], positions=torch.zeros(2, 1, dtype=torch.long),
              cache=TT.init_cache(bidir.cfg, 2, 8, device="cpu"))


def test_text_generation_continues_the_text_on_cpu():
    """The example end to end on the CPU, at 100 of its 300 Adam steps:
    the greedy continuation of a prefix of the text is the text."""
    # Its ops are tiny: one thread runs them fastest, and does not contend
    # with the other test processes for the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = text_generation.main(["--device", "cpu", "--steps", "100"])
    finally:
        torch.set_num_threads(threads)
    assert res["matches_text"] is True and res["final_loss"] < 0.01
