"""Decoder-only Transformer LM with pluggable attention.

The port of ``bluefog_tpu/models/transformer.py`` for the configuration the
training benchmark runs: learned positions, multi-head attention, GELU MLP,
RMSNorm, fused QKV, activations in ``cfg.dtype`` (bfloat16 by default) over
float32 parameters, and an lm-head in float32.  The ``attn_impl`` hook
receives ``(q, k, v, causal)`` in ``(B, S, H, D)`` layout: dense
:func:`local_attention` by default, or ``ops.flash_attention``.

Numerics follow flax: ``nn.Dense(dtype=bf16)`` casts input and kernel to
bf16; ``nn.RMSNorm`` takes its statistics in float32 with ``epsilon=1e-6``
and a learned scale; ``nn.gelu`` is the tanh approximation.

Parameters are named after the flax tree (``block_{i}.qkv`` is flax's
``block_{i}/qkv``) so ``models.convert`` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["TransformerLM", "TransformerConfig", "local_attention", "Block",
           "RMSNorm"]

_ROADMAP = "not ported yet: ROADMAP.md Queue 1 item {} ({})"
# Standard deviation of a unit normal truncated to [-2, 2]; jax's
# ``truncated_normal`` initializers divide by it to keep the set variance.
_TRUNC_NORMAL_STD = 0.87962566103423978


def local_attention(q, k, v, *, causal: bool = True):
    """Plain single-device attention: ``(B, S, H, D)`` inputs."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = logits.float().masked_fill(~mask,
                                            torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class TransformerConfig:
    """The JAX package's ``TransformerConfig``; options outside this slice
    raise ``NotImplementedError`` naming their ROADMAP item."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 embed_dim=512, mlp_ratio=4, max_seq_len=2048,
                 dtype=torch.bfloat16, remat=False, causal=True,
                 num_experts=0, num_kv_heads=None, pos_encoding="learned",
                 mlp="gelu"):
        if num_kv_heads is not None and num_kv_heads != num_heads:
            raise NotImplementedError(_ROADMAP.format(4, "GQA, num_kv_heads"))
        if pos_encoding == "rope":
            raise NotImplementedError(_ROADMAP.format(5, "RoPE"))
        if pos_encoding != "learned":
            raise ValueError(f"pos_encoding {pos_encoding!r} not in "
                             "('learned', 'rope')")
        if mlp == "swiglu":
            raise NotImplementedError(_ROADMAP.format(6, "SwiGLU MLP"))
        if mlp != "gelu":
            raise ValueError(f"mlp {mlp!r} not in ('gelu', 'swiglu')")
        if num_experts:
            raise NotImplementedError(_ROADMAP.format(7, "MoE blocks"))
        if remat:
            raise NotImplementedError(_ROADMAP.format(8, "remat"))
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.causal = causal


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: float32 statistics, ``epsilon=1e-6``, learned
    scale, output in ``dtype``."""

    def __init__(self, dim: int, dtype=torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps) * self.scale)).to(self.dtype)


def _dense(x, layer: nn.Linear, dtype):
    """flax ``nn.Dense(use_bias=False, dtype=dtype)``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_impl: Callable):
        super().__init__()
        E = cfg.embed_dim
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.RMSNorm_0 = RMSNorm(E, cfg.dtype)
        self.qkv = nn.Linear(E, 3 * E, bias=False)
        self.proj = nn.Linear(E, E, bias=False)
        self.RMSNorm_1 = RMSNorm(E, cfg.dtype)
        self.up = nn.Linear(E, cfg.mlp_ratio * E, bias=False)
        self.down = nn.Linear(cfg.mlp_ratio * E, E, bias=False)

    def forward(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        h = cfg.num_heads
        d = cfg.embed_dim // h
        B, S = x.shape[0], x.shape[1]
        y = self.RMSNorm_0(x)
        # Head-interleaved fused layout [q_h0 k_h0 v_h0 | q_h1 ...], as the
        # JAX package (a relabeling of kernel columns, not thirds).
        qkv = _dense(y, self.qkv, dt).view(B, S, h, 3, d)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        attn = self.attn_impl(q, k, v, causal=cfg.causal)
        x = x + _dense(attn.reshape(B, S, cfg.embed_dim), self.proj, dt)
        y = self.RMSNorm_1(x)
        y = F.gelu(_dense(y, self.up, dt), approximate="tanh")
        return x + _dense(y, self.down, dt)


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 attn_impl: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        attn = attn_impl or local_attention
        E = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, E)
        self.wpe = nn.Embedding(cfg.max_seq_len, E)
        self.blocks = nn.ModuleList(Block(cfg, attn)
                                    for _ in range(cfg.num_layers))
        self.RMSNorm_0 = RMSNorm(E, cfg.dtype)
        self.lm_head = nn.Linear(E, cfg.vocab_size, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from an explicit generator, with flax's default
        distributions: dense kernels ``lecun_normal`` (a normal truncated
        at two of its deviations, rescaled to variance 1/fan_in),
        embeddings ``default_embed_init`` (N(0, 1/features)), norm scales
        1.  The draws are torch's, so the values differ from flax's."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif isinstance(self.get_submodule(name.rsplit(".", 1)[0]),
                            nn.Embedding):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)
            else:
                std = 1.0 / math.sqrt(p.shape[1]) / _TRUNC_NORMAL_STD
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)

    def forward(self, tokens, cache=None):
        """Logits ``(B, S, vocab)`` in float32 for int tokens ``(B, S)``."""
        if cache is not None:
            raise NotImplementedError(_ROADMAP.format(10, "KV-cache decoding"))
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.wte(tokens).to(cfg.dtype) + self.wpe(positions).to(cfg.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.RMSNorm_0(x)
        return F.linear(x.float(), self.lm_head.weight.float())
