"""The port's flash attention (its plain twins, the CPU path) against the JAX
package's Pallas kernels in interpret mode over the head dims and dtypes
the kernels take: float32 at the JAX package's own small heads (D = 8, 16)
and the public models' (80, 96, 256), bfloat16 at 80 and 256; and the
arithmetic of the bf16 kernels' padding route (a head dim D runs in a wider
instance, its columns past D zero, its scale that of D).

Tolerances, as ``test_torch_port_flash.py``'s: forward and lse 2e-5,
gradients 1e-4 (float32, two summation orders); bfloat16 5e-2 (one bf16
rounding of inputs and output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.ops import flash_attention as JF
from bluefog_tpu_torch.ops import flash_attention as TF

B, S, H = 2, 64, 2
F32_DIMS = [8, 16, 24, 80, 96, 256]


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _torch(arrs, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrs]


def _jax_lse(q, k, v, causal):
    return JF.flash_attention_lse(q, k, v, causal=causal, block_q=16,
                                  block_k=16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F32_DIMS)
def test_float32_forward_and_lse_match_jax(D, causal):
    q, k, v = _inputs(D, seed=D)
    oj, lj = _jax_lse(*map(jnp.asarray, (q, k, v)), causal)
    ot, lt = TF.flash_attention_lse(*_torch((q, k, v)), causal=causal)
    assert ot.shape == (B, S, H, D) and lt.shape == (B, S, H)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", F32_DIMS)
def test_float32_grads_with_lse_cotangent_match_jax(D, causal):
    """Gradients of sum(o**2) + sum(lse): the lse cotangent path."""
    q, k, v = _inputs(D, seed=D + 1)

    def loss(a, b, c):
        o, lse = _jax_lse(a, b, c, causal)
        return jnp.sum(o ** 2) + jnp.sum(lse)

    gj = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch((q, k, v))
    o, lse = TF.flash_attention_lse(tq, tk, tv, causal=causal)
    (o.pow(2).sum() + lse.sum()).backward()
    for a, b in zip(gj, (tq, tk, tv)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("D", [80, 256])
def test_bf16_matches_jax(D):
    q, k, v = _inputs(D, seed=D + 2)
    oj = JF.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=True, block_q=32, block_k=32)
    ot = TF.flash_attention(*_torch((q, k, v), torch.bfloat16), causal=True)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.detach().float().numpy(),
                               np.asarray(oj, np.float32), rtol=0, atol=5e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [8, 36, 80])
def test_zero_padded_twin_at_the_true_scale_equals_the_twin(D, causal):
    """The padding route's arithmetic: q, k and v zero-padded to the bf16
    instance's width, the scores scaled by 1/sqrt(D) of the true D (here by
    scaling the padded q, since the twin scales by its own width), give the
    unpadded twin's output in the first D columns, zeros past them, the same
    lse, and through autograd the same gradients."""
    inst = TF.instance(torch.bfloat16, D)
    q, k, v = _inputs(D, seed=D + 3)
    ref_in = _torch((q, k, v))
    o_r, lse_r = TF.flash_attention_lse(*ref_in, causal=causal)
    (o_r.pow(2).sum() + lse_r.sum()).backward()

    pad_in = _torch((q, k, v))
    pq, pk, pv = (torch.nn.functional.pad(t, (0, inst - D)) for t in pad_in)
    o_p, lse_p = TF.flash_attention_lse(pq * (inst / D) ** 0.5, pk, pv,
                                        causal=causal)
    assert o_p.shape == (B, S, H, inst)
    assert float(o_p[..., D:].detach().abs().max()) == 0.0
    np.testing.assert_allclose(o_p[..., :D].detach().numpy(),
                               o_r.detach().numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse_p.detach().numpy(), lse_r.detach().numpy(),
                               rtol=0, atol=2e-5)
    (o_p[..., :D].pow(2).sum() + lse_p.sum()).backward()
    for a, b in zip(ref_in, pad_in):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                   rtol=0, atol=1e-4)
