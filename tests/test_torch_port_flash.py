"""The port's flash attention (plain path on the CPU) against the JAX
package's Pallas kernels in interpret mode.

Tolerances: forward and lse 2e-5, gradients 1e-4 (float32, two summation
orders); bfloat16 5e-2 (one bf16 rounding of inputs and output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.models.transformer import local_attention as j_local
from bluefog_tpu.ops import flash_attention as JF
from bluefog_tpu_torch.models.transformer import local_attention as t_local
from bluefog_tpu_torch.ops import flash_attention as TF

B, S, H, D = 2, 64, 2, 16


def _inputs(s=S, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, s, H, D).astype(np.float32) for _ in range(3)]


def _torch(arrs, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_jax(causal):
    q, k, v = _inputs()
    oj, lj = JF.flash_attention_lse(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, block_q=16, block_k=16)
    ot, lt = TF.flash_attention_lse(*_torch((q, k, v)), causal=causal)
    assert ot.shape == (B, S, H, D) and lt.shape == (B, S, H)
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_with_lse_cotangent_match_jax(causal):
    """Gradients of sum(o**2) + sum(lse): the lse cotangent path."""
    q, k, v = _inputs(seed=1)

    def loss(a, b, c):
        o, lse = JF.flash_attention_lse(a, b, c, causal=causal, block_q=16,
                                        block_k=16)
        return jnp.sum(o ** 2) + jnp.sum(lse)

    gj = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch((q, k, v))
    o, lse = TF.flash_attention_lse(tq, tk, tv, causal=causal)
    (o.pow(2).sum() + lse.sum()).backward()
    for a, b in zip(gj, (tq, tk, tv)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_matches_jax_dense(causal):
    """S=50 (no power-of-two block divides it): the port masks, the JAX
    reference here is its dense local_attention."""
    q, k, v = _inputs(s=50, seed=2)
    ref = j_local(*map(jnp.asarray, (q, k, v)), causal=causal)
    out = TF.flash_attention(*_torch((q, k, v)), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=2e-5)


def test_bf16_matches_jax():
    q, k, v = _inputs(seed=3)
    oj = JF.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=True, block_q=32, block_k=32)
    ot = TF.flash_attention(*_torch((q, k, v), torch.bfloat16), causal=True)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_allclose(ot.detach().float().numpy(),
                               np.asarray(oj, np.float32), rtol=0, atol=5e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_matches_jax(causal):
    q, k, v = _inputs(seed=4)
    ref = j_local(*map(jnp.asarray, (q, k, v)), causal=causal)
    out = t_local(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_twins_agree_with_autograd_of_dense(causal):
    """flash_bwd_ref equals autograd through flash_fwd_ref, which the chip
    check relies on when it holds K2 and K3 against the twin."""
    q, k, v = _torch(_inputs(seed=5))
    rng = np.random.RandomState(6)
    do = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
    dlse = torch.from_numpy(rng.randn(B, S, H).astype(np.float32))
    o, lse = TF.flash_fwd_ref(q, k, v, causal)
    torch.autograd.backward((o, lse), (do, dlse))
    dq, dk, dv = TF.flash_bwd_ref(q.detach(), k.detach(), v.detach(),
                                  o.detach(), lse.detach(), do, dlse, causal)
    for a, t in zip((dq, dk, dv), (q, k, v)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=0,
                                   atol=1e-4)


def test_cpu_path_launches_no_kernel():
    TF.reset_launch_counts()
    q, k, v = _torch(_inputs(seed=7))
    TF.flash_attention(q, k, v).sum().backward()
    assert (TF.flash_fwd_cuda.launches, TF.flash_dq_cuda.launches,
            TF.flash_dkv_cuda.launches) == (0, 0, 0)
