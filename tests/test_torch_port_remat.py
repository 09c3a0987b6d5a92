"""Per-block remat in the port (``TransformerConfig(remat=True)``): the
policies ``full``, ``dots`` and ``dots:<K>`` leave outputs (1e-6) and
gradients (1e-5) as without remat, as ``test_transformer_remat_matches_plain``
holds the JAX package; each block's forward, attention included, runs twice
a step; and the gradients still land in ``RankReplicas.flat.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from bluefog_tpu import models as jmodels
from bluefog_tpu_torch.models import ViT
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import (jax_ravel_order,
                                              transformer_params_from_jax)
from bluefog_tpu_torch.ops import flash_attention as FA
from bluefog_tpu_torch.ops.chunked_loss import chunked_softmax_cross_entropy
from bluefog_tpu_torch.replicas import RankReplicas

V, E, HEADS, SEQ = 64, 32, 4, 16
KW = dict(vocab_size=V, num_layers=2, num_heads=HEADS, embed_dim=E,
          max_seq_len=SEQ, num_kv_heads=2, pos_encoding="rope", mlp="swiglu",
          dtype=torch.float32)
POLICIES = ["full", "dots", "dots:1"]


class Counted:
    """An ``attn_impl`` that counts its calls."""

    def __init__(self, impl):
        self.impl, self.calls = impl, 0

    def __call__(self, q, k, v, *, causal=True):
        self.calls += 1
        return self.impl(q, k, v, causal=causal)


def _tokens(seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, V, (2, SEQ))).long()


def _run(model, tokens):
    out = model(tokens)
    out.square().sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in
                          model.named_parameters()}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_plain(policy, flash):
    tokens = _tokens()
    base = FA.flash_attention_impl() if flash else TT.local_attention
    plain_attn, remat_attn = Counted(base), Counted(base)
    plain = TT.TransformerLM(TT.TransformerConfig(**KW), plain_attn)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    remat = TT.TransformerLM(TT.TransformerConfig(
        remat=True, remat_policy=policy, **KW), remat_attn)
    remat.load_state_dict(plain.state_dict())
    out_p, g_p = _run(plain, tokens)
    out_r, g_r = _run(remat, tokens)
    np.testing.assert_allclose(out_r.numpy(), out_p.numpy(), rtol=1e-6,
                               atol=1e-6)
    for name, g in g_p.items():
        np.testing.assert_allclose(g_r[name].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # Every block's forward runs again in the backward, attention too.
    assert plain_attn.calls == 2 and remat_attn.calls == 4


class CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(policy):
    kw = dict(KW, remat=policy is not None, remat_policy=policy or "full")
    model = TT.TransformerLM(TT.TransformerConfig(**kw))
    model.reset_parameters(torch.Generator().manual_seed(0))
    out = model(_tokens())
    with CountMatmuls() as bwd:
        out.square().sum().backward()
    return bwd.mm


@pytest.mark.parametrize("policy", POLICIES)
def test_dots_policy_keeps_matmul_outputs(policy):
    """The backward runs a block's forward matmuls again under ``full``
    only: ``dots`` keeps them (``dots:1``: block 0 keeps them, block 1
    not).  The recompute stops before ``down``, whose output no backward
    reads (``torch.utils.checkpoint``'s early stop)."""
    with CountMatmuls() as fwd:
        TT.Block(TT.TransformerConfig(**KW), TT.local_attention)(
            torch.zeros(2, SEQ, E))
    assert fwd.mm == 8   # q, kv, proj, gate, up, down, two attention bmm
    recomputed = {"full": 2, "dots": 0, "dots:1": 1}[policy]
    assert _backward_matmuls(policy) == \
        _backward_matmuls(None) + recomputed * (fwd.mm - 1)


def test_remat_matches_jax():
    """The remat model against the JAX package's remat model, carried
    weights, at the float32 tolerance of the equivalence tests."""
    tokens = _tokens(1)
    jkw = dict(KW, dtype=jnp.float32)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(
        remat=True, remat_policy="dots:1", **jkw))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens.numpy()))["params"])
    j_grads = jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p}, jnp.asarray(tokens.numpy())) ** 2))(params)
    tm = TT.TransformerLM(TT.TransformerConfig(remat=True,
                                               remat_policy="dots:1", **KW))
    tm.load_state_dict(transformer_params_from_jax(params))
    out, grads = _run(tm, tokens)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jm.apply({"params": params},
                                         jnp.asarray(tokens.numpy()))),
        rtol=0, atol=1e-4)
    for name, g in transformer_params_from_jax(
            jax.tree.map(np.asarray, j_grads)).items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_grads_land_in_flat_grad(policy):
    """Under the JAX ravel layout (Dense kernels stored ``(in, out)``, the
    modules see transposed views) every parameter's ``.grad`` stays a view
    of ``flat.grad`` after a backward, with remat and the chunked loss, and
    holds the gradient of a model that owns its parameters."""
    kw = dict(KW, remat=policy is not None, remat_policy=policy or "full")
    make = lambda: TT.TransformerLM(TT.TransformerConfig(**kw))  # noqa: E731
    rep = RankReplicas(make, 2, "cpu", order=jax_ravel_order(make()),
                       init=lambda m: m.reset_parameters(
                           torch.Generator().manual_seed(0)))
    own = TT.TransformerLM(TT.TransformerConfig(**KW))
    own.load_state_dict({k: v.detach().clone() for k, v in
                         rep.rank_params(0).items()})
    tokens = _tokens(2)
    targets = torch.roll(tokens, -1, 1)
    for _ in range(2):   # the second backward accumulates
        for mod in (rep.modules[0], own):
            chunked_softmax_cross_entropy(mod(tokens, return_hidden=True),
                                          mod.lm_head.weight, targets,
                                          chunk=8).backward()
    base = rep.flat.grad.untyped_storage().data_ptr()
    got = rep.rank_params(0)
    for name, p in own.named_parameters():
        g = got[name].grad
        assert g.untyped_storage().data_ptr() == base, name
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert bool(rep.flat.grad[0].abs().sum() > 0)
    assert not bool(rep.flat.grad[1].any())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_vit_remat_matches_plain(policy):
    kw = dict(num_classes=10, image_size=16, patch_size=8, embed_dim=32,
              num_layers=2, num_heads=2, dtype=torch.float32)
    plain = ViT(**kw)
    plain.reset_parameters(torch.Generator().manual_seed(0))
    remat = ViT(remat=True, remat_policy=policy, **kw)
    remat.load_state_dict(plain.state_dict())
    images = torch.from_numpy(
        np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32))
    outs = []
    for model in (plain, remat):
        out = model(images)
        F.cross_entropy(out, torch.tensor([1, 7])).backward()
        outs.append(out.detach())
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    g_r = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        np.testing.assert_allclose(g_r[name].grad.numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
