"""float16 through the port's flash attention: its plain twins (the CPU
path) against the JAX package's Pallas kernels in interpret mode (block 16)
at the head dims of the float16 instances, forward, lse and the gradients
of both outputs, causal and not; the float16 instances' launch plan; and
the port's ``TransformerLM(dtype=float16)`` through ``flash_attention_impl``
against the JAX model at ``jnp.float16``.

Tolerances: the output 5e-3 and the gradients 5e-3 relative (plus 5e-3
absolute), one float16 rounding of the outputs after float32 math on the
same float16 inputs (float16 keeps 11 significant bits: an ulp is 2^-10 of
the value, against bfloat16's 2^-7, whose tests hold 5e-2); lse 2e-5, as
float32 (both compute it in float32 from the same inputs).  The model: the
logits 1e-2 and each parameter's gradient 1e-2 relative in norm
(activations rounded to float16 at the same places in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu import models as jmodels
from bluefog_tpu.ops import flash_attention as JF
from bluefog_tpu_torch.models.convert import transformer_params_from_jax
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops import flash_attention as TF

B, S, H = 2, 64, 2
F16_DIMS = [16, 64, 80, 128, 256]
OUT_TOL = 5e-3
LSE_TOL = 2e-5
GRAD_RTOL = GRAD_ATOL = 5e-3
MODEL_LOGITS_TOL = 1e-2
MODEL_GRAD_TOL = 1e-2
SMEM_LIMIT = 232448


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float16) for _ in range(3)]


def _jax_loss(causal):
    def loss(a, b, c):
        o, lse = JF.flash_attention_lse(a, b, c, causal=causal, block_q=16,
                                        block_k=16)
        return jnp.sum(o.astype(jnp.float32) ** 2) + jnp.sum(lse), (o, lse)
    return loss


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F16_DIMS)
def test_float16_forward_and_grads_match_jax(D, causal):
    """o in float16, lse float32, and dq, dk, dv (float16) of sum(o^2) +
    sum(lse): the lse cotangent path too."""
    q, k, v = _inputs(D, seed=D)
    (_, (oj, lj)), gj = jax.value_and_grad(
        _jax_loss(causal), argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    ot, lt = TF.flash_attention_lse(*ts, causal=causal)
    assert ot.dtype == torch.float16 and lt.dtype == torch.float32
    (ot.float().pow(2).sum() + lt.sum()).backward()
    np.testing.assert_allclose(ot.detach().float().numpy(),
                               np.asarray(oj, np.float32), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=LSE_TOL)
    for a, t in zip(gj, ts):
        assert t.grad.dtype == torch.float16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


OPERANDS = {"fwd": ("q", "k", "v"), "dq": ("q", "k", "v", "do", "o"),
            "dkv": ("q", "k", "v", "do")}


@pytest.mark.parametrize("D", [16, 64, 80, 128, 200, 256])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_float16_plan_is_the_bf16_kernels(kernel, D):
    """float16 runs the bf16 kernels' design with another element type: the
    same instance, grid, threads, tiles and shared memory, and tensor maps
    over the same 2-byte strides (fused QKV slices)."""
    qkv = (2048 * 3 * 16 * D, 3 * 16 * D, 3 * D, 1)
    st = {n: qkv for n in OPERANDS[kernel]}
    f16 = TF.launch_plan(kernel, (2, 2048, 16, D), st, True, torch.float16)
    bf16 = TF.launch_plan(kernel, (2, 2048, 16, D), st, True, torch.bfloat16)
    assert f16 == bf16
    assert f16.instance == TF.instance(torch.float16, D) == min(
        i for i in (64, 128, 256) if i >= D)
    assert f16.smem <= SMEM_LIMIT and f16.copy_bytes == 0
    assert all(m.dims[0] == D for m in f16.maps.values())


def test_float16_tags_its_launches():
    assert TF._TAGS[torch.float16] == "f16"
    assert TF.INSTANCES[torch.float16] == (64, 128, 256, TF.WIDE)


V, L, E, HEADS, SEQ = 128, 2, 64, 4, 32


def _models(seed):
    jcfg = jmodels.TransformerConfig(vocab_size=V, num_layers=L,
                                     num_heads=HEADS, embed_dim=E,
                                     max_seq_len=SEQ, dtype=jnp.float16)
    jm = jmodels.TransformerLM(jcfg, attn_impl=JF.flash_attention_impl(
        block_q=16, block_k=16))
    tokens = np.random.RandomState(seed).randint(0, V, (2, SEQ)).astype(
        np.int32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                              jnp.asarray(tokens))["params"])
    cfg = TransformerConfig(vocab_size=V, num_layers=L, num_heads=HEADS,
                            embed_dim=E, max_seq_len=SEQ, dtype=torch.float16)
    tm = TransformerLM(cfg, TF.flash_attention_impl())
    tm.load_state_dict(transformer_params_from_jax(params))
    return jm, params, tm, tokens


def test_transformer_float16_logits_match_jax():
    jm, params, tm, tokens = _models(0)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)),
                     np.float32)
    out = tm(torch.from_numpy(tokens).long())
    assert out.shape == (2, SEQ, V) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=MODEL_LOGITS_TOL)


def test_transformer_float16_grads_match_jax():
    """Each parameter's gradient of a fixed projection of the logits, the
    float32 parameters' own (compute in float16)."""
    jm, params, tm, tokens = _models(1)
    w = np.random.RandomState(2).randn(2, SEQ, V).astype(np.float32)

    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(tokens)).astype(jnp.float32)
        return jnp.sum(y * w) / y.size
    gj = transformer_params_from_jax(jax.tree.map(np.asarray,
                                                  jax.grad(loss)(params)))
    out = tm(torch.from_numpy(tokens).long()).float()
    ((out * torch.from_numpy(w)).sum() / out.numel()).backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(gj)
    for name, ref in gj.items():
        g = got[name].grad.float()
        err = float((g - ref).norm() / ref.norm())
        assert err <= MODEL_GRAD_TOL, (name, err)
