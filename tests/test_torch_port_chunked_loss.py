"""The port's chunked lm-head loss (``ops.chunked_loss``) against the JAX
package's ``chunked_softmax_cross_entropy`` and against dense
cross-entropy: value at 1e-5, gradients at 2e-4 relative and 2e-5 absolute
(``test_chunked_loss_matches_dense``'s tolerances), float32.  The port takes
``lm_head.weight`` ``(V, E)``; the JAX function takes the ``(E, V)``
kernel, so the tests pass it transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu.ops.chunked_loss import chunked_softmax_cross_entropy as j_ce
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.ops import chunked_loss as CL

t_ce = CL.chunked_softmax_cross_entropy


def _inputs(B=2, S=12, E=8, V=20, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, E).astype(np.float32),
            rng.randn(V, E).astype(np.float32),
            rng.randint(0, V, (B, S)).astype(np.int32))


@pytest.mark.parametrize("chunk", [1, 4, 5, 12, 1024])
def test_matches_jax(chunk):
    h, w, t = _inputs()
    value, grads = jax.value_and_grad(
        lambda hh, ww: j_ce(hh, ww, jnp.asarray(t), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w.T))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = t_ce(th, tw, torch.from_numpy(t), chunk=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(value), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(grads[0]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(grads[1]).T,
                               rtol=2e-4, atol=2e-5)


def test_matches_dense_through_return_hidden():
    """Through the model's ``return_hidden`` path, against dense
    cross-entropy of its logits: the loss and every parameter's gradient."""
    cfg = TT.TransformerConfig(vocab_size=64, num_layers=2, num_heads=4,
                               embed_dim=32, max_seq_len=16, num_kv_heads=2,
                               pos_encoding="rope", mlp="swiglu",
                               dtype=torch.float32)
    dense, chunked = TT.TransformerLM(cfg), TT.TransformerLM(cfg)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    chunked.load_state_dict(dense.state_dict())
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 64, (2, 16))).long()
    tgt = torch.roll(tokens, -1, 1)
    want = F.cross_entropy(dense(tokens).reshape(-1, 64), tgt.reshape(-1))
    got = t_ce(chunked(tokens, return_hidden=True), chunked.lm_head.weight,
               tgt, chunk=4)
    want.backward()
    got.backward()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    g_c = dict(chunked.named_parameters())
    for name, p in dense.named_parameters():
        np.testing.assert_allclose(g_c[name].grad.numpy(), p.grad.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_uneven_chunk_fits_down(monkeypatch):
    """chunk=8 does not divide S=12: the chunk fits down to 6, the largest
    divisor, not to a power of two."""
    h, w, t = _inputs(B=1, seed=1)
    widths = []
    real = CL._chunk_loss

    def spy(h_c, lm_head, t_c):
        widths.append(h_c.shape[1])
        return real(h_c, lm_head, t_c)

    monkeypatch.setattr(CL, "_chunk_loss", spy)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t))
    out = t_ce(*args, chunk=8)
    assert widths == [6, 6]
    ref = t_ce(*args, chunk=12)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        float(out), float(j_ce(jnp.asarray(h), jnp.asarray(w.T),
                               jnp.asarray(t), chunk=8)), rtol=1e-6)


def test_backward_recomputes_each_chunk(monkeypatch):
    """Each chunk's logits are computed again in the backward, not kept."""
    calls = []
    real = CL._chunk_loss

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(CL, "_chunk_loss", spy)
    h, w, t = _inputs(seed=2)
    th = torch.tensor(h, requires_grad=True)
    loss = t_ce(th, torch.from_numpy(w), torch.from_numpy(t), chunk=4)
    assert len(calls) == 3
    loss.backward()
    assert len(calls) == 6


def test_refuses_chunk_below_one():
    h, w, t = _inputs()
    with pytest.raises(ValueError) as want:
        j_ce(jnp.asarray(h), jnp.asarray(w.T), jnp.asarray(t), chunk=0)
    with pytest.raises(ValueError) as got:
        t_ce(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t),
             chunk=0)
    assert str(got.value) == str(want.value)
