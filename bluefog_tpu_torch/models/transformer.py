"""Decoder-only Transformer LM with pluggable attention.

The port of ``bluefog_tpu/models/transformer.py``: learned or rotary
positions (``pos_encoding``), multi-head or grouped-query attention
(``num_kv_heads``), GELU or SwiGLU MLP (``mlp``) or a switch-routed mixture
of GELU experts (``num_experts``, :class:`SwitchMlp`), RMSNorm, fused QKV under
MHA, activations in ``cfg.dtype`` (bfloat16 by default) over float32
parameters, and an lm-head in float32.  ``remat`` recomputes each block's
activations in the backward (:func:`block_policy`), and :func:`generate`
decodes through a KV cache (:func:`init_cache`).  The ``attn_impl`` hook
receives ``(q, k, v, causal)`` in ``(B, S, H, D)`` layout: dense
:func:`local_attention` by default, or ``ops.flash_attention``.

Numerics follow flax: ``nn.Dense(dtype=bf16)`` casts input and kernel to
bf16; ``nn.RMSNorm`` takes its statistics in float32 with ``epsilon=1e-6``
and a learned scale; ``nn.gelu`` is the tanh approximation; rotary angles
and the rotation are float32, cast back once.

Parameters are named after the flax tree (``block_{i}.qkv`` is flax's
``block_{i}/qkv``) so ``models.convert`` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.profiler import record_function
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from bluefog_tpu_torch.basics import resolve_device
from bluefog_tpu_torch.parallel.moe import load_balance_loss, switch_dispatch

__all__ = ["TransformerLM", "TransformerConfig", "local_attention", "Block",
           "SwitchMlp", "RMSNorm", "apply_rope", "repeat_kv", "block_policy",
           "run_block", "init_cache", "prefill", "generate"]

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
    """The JAX package's ``TransformerConfig``, with its checks and their
    words.  ``num_experts > 0`` replaces each block's MLP with a top-1
    routed mixture of that many GELU experts (:class:`SwitchMlp`), each with
    ``expert_capacity_factor * router_group_size / num_experts`` slots a
    routing group."""

    def __init__(self, vocab_size=32000, num_layers=4, num_heads=8,
                 embed_dim=512, mlp_ratio=4, max_seq_len=2048,
                 dtype=torch.bfloat16, remat=False, remat_policy="full",
                 causal=True, num_experts=0, num_kv_heads=None,
                 pos_encoding="learned", rope_theta=10000.0, mlp="gelu",
                 expert_capacity_factor=2.0, router_group_size=4096):
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be divisible "
                             f"by num_kv_heads ({num_kv_heads})")
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding {pos_encoding!r} not in "
                             "('learned', 'rope')")
        if pos_encoding == "rope" and (embed_dim // num_heads) % 2:
            raise ValueError(
                f"rope needs an even head dim; got embed_dim {embed_dim} / "
                f"num_heads {num_heads} = {embed_dim // num_heads}")
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp {mlp!r} not in ('gelu', 'swiglu')")
        if mlp == "swiglu" and num_experts:
            raise ValueError(
                "mlp='swiglu' with num_experts > 0 is contradictory: MoE "
                "blocks replace the MLP with GELU experts")
        if not isinstance(remat_policy, str) or (
                remat_policy not in ("full", "dots")
                and not remat_policy.startswith("dots:")):
            raise ValueError(f"remat_policy {remat_policy!r} not in "
                             "('full', 'dots', 'dots:<K>')")
        if remat_policy.startswith("dots:"):
            try:
                k = int(remat_policy.split(":", 1)[1])
            except ValueError:
                raise ValueError(
                    f"malformed {remat_policy!r}: use 'dots:<int>'"
                ) from None
            if k < 0:
                raise ValueError(f"remat_policy dots:K needs K >= 0, got {k}")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.causal = causal
        self.num_experts = num_experts
        self.expert_capacity_factor = expert_capacity_factor
        self.router_group_size = router_group_size
        self.pos_encoding = pos_encoding
        self.rope_theta = rope_theta
        self.mlp = mlp


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


class _NamedEinsum(torch.autograd.Function):
    """A two-operand ``torch.einsum`` whose forward runs under the profiler
    range ``name`` and its backward under ``name + "_backward"``, so a step
    profile (``profile_step``'s ``named_ops``) can tell MoE's dispatch and
    combine apart from the other batched matmuls.  The gradient of each
    operand is the einsum of the output gradient with the other operand
    (every index of the spec appears in two of its three terms)."""

    @staticmethod
    def forward(ctx, name, spec, a, b):
        ctx.name, ctx.spec = name, spec
        ctx.save_for_backward(a, b)
        with record_function(name):
            return torch.einsum(spec, a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ins, out = ctx.spec.split("->")
        sa, sb = ins.split(",")
        ga = gb = None
        with record_function(ctx.name + "_backward"):
            if ctx.needs_input_grad[2]:
                ga = torch.einsum(f"{out},{sb}->{sa}", grad, b)
            if ctx.needs_input_grad[3]:
                gb = torch.einsum(f"{sa},{out}->{sb}", a, grad)
        return None, None, ga, gb


class SwitchMlp(nn.Module):
    """Top-1 routed mixture-of-experts MLP (Switch Transformer), the port of
    the JAX package's ``SwitchMlp``.

    Tokens route within groups of ``cfg.router_group_size``, padded to a
    whole number of groups; padding tokens route nowhere and count in no
    balance statistic.  Each expert takes ``max(1, int(factor * g / E))``
    tokens a group.  The router is a float32 Dense on the float32 tokens;
    the expert weights are stacked ``experts_up (E, d, hidden)`` and
    ``experts_down (E, hidden, d)`` in flax's layout, and the four einsums
    (dispatch, up, down, combine) run in ``cfg.dtype`` with tanh-GELU
    between up and down.  ``forward`` returns the output and the
    load-balancing auxiliary loss (the mean over groups), which the JAX
    package sows as ``intermediates/moe_aux_loss``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        E, d = cfg.num_experts, cfg.embed_dim
        hidden = cfg.mlp_ratio * d
        self.cfg = cfg
        self.router = nn.Linear(d, E, bias=False)
        self.experts_up = nn.Parameter(torch.empty(E, d, hidden))
        self.experts_down = nn.Parameter(torch.empty(E, hidden, d))

    def forward(self, x):
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, d = x.shape
        E = cfg.num_experts
        T = B * S
        g = min(cfg.router_group_size, T)
        G = -(-T // g)
        pad = G * g - T
        xt = x.reshape(T, d)
        if pad:
            xt = torch.cat([xt, xt.new_zeros(pad, d)])
        xt = xt.reshape(G, g, d)
        capacity = max(1, int(cfg.expert_capacity_factor * g / E))
        with record_function("moe::plan"):
            # A float32 Dense on float32 tokens (the weight is float32).
            logits = self.router(xt.float())
            valid = (torch.arange(G * g, device=x.device) < T).float(
            ).reshape(G, g)
            combine, dispatch = switch_dispatch(logits, E, capacity, valid)
            aux = load_balance_loss(logits, valid).mean()
        xe = _NamedEinsum.apply("moe::dispatch", "gect,gtd->gecd",
                                dispatch.to(dt), xt.to(dt))
        ye = F.gelu(torch.einsum("gecd,edh->gech", xe,
                                 self.experts_up.to(dt)), approximate="tanh")
        ye = torch.einsum("gech,ehd->gecd", ye, self.experts_down.to(dt))
        y = _NamedEinsum.apply("moe::combine", "gtec,gecd->gtd",
                               combine.to(dt), ye)
        return y.reshape(G * g, d)[:T].reshape(B, S, d), aux


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding on ``(B, S, H, D)`` q or k at ``positions``
    ``(B, S)``: dimension ``i`` pairs with ``i + D/2`` and turns by
    ``pos * theta^(-2i/D)``; angles and rotation in float32, the result cast
    back to the input dtype."""
    d2 = x.shape[-1] // 2
    freq = theta ** (-torch.arange(d2, dtype=torch.float32,
                                   device=x.device) / d2)
    ang = positions[..., None].float() * freq               # (B, S, d2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], -1).to(x.dtype)


def repeat_kv(t, rep: int):
    """``(B, S, kv_h, D)`` shared heads fanned out to ``(B, S, kv_h * rep,
    D)``: query head ``j`` reads kv head ``j // rep``, as ``jnp.repeat``
    (``.repeat`` would tile, head ``j`` reading ``j % kv_h``)."""
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def block_policy(cfg: TransformerConfig, layer_idx: int) -> Optional[str]:
    """The remat policy of block ``layer_idx``: None (no remat), ``"full"``
    or ``"dots"``; ``"dots:<K>"`` is ``"dots"`` for the first K blocks and
    ``"full"`` for the rest.  The port of ``block_class``, shared by
    ``TransformerLM`` and ``models.vit.ViT``."""
    if not cfg.remat:
        return None
    policy = cfg.remat_policy
    if policy.startswith("dots:"):
        policy = "dots" if layer_idx < int(policy.split(":", 1)[1]) else "full"
    return policy


def _save_dots():
    """``dots``: keep every matmul output (``jax.checkpoint_policies.
    checkpoint_dots``), recompute every other op in the backward.  The flash
    kernels launch through ctypes, which no dispatch mode sees: the
    recompute runs K1 again into fresh buffers, as the JAX package re-runs
    its ``pallas_call``, which is not a ``dot_general``."""
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.addmm.default, aten.bmm.default])


def run_block(block: nn.Module, policy: Optional[str], *args):
    """``block(*args)``, under ``torch.utils.checkpoint`` when ``policy``
    is set and autograd records (``"full"``: recompute the whole block in
    the backward; ``"dots"``: keep the matmul outputs)."""
    if policy is None or not torch.is_grad_enabled():
        return block(*args)
    if policy == "dots":
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=_save_dots)
    return checkpoint(block, *args, use_reentrant=False)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_impl: Callable):
        super().__init__()
        E = cfg.embed_dim
        h = cfg.num_heads
        kv_h = cfg.num_kv_heads or h
        hidden = cfg.mlp_ratio * E
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.RMSNorm_0 = RMSNorm(E, cfg.dtype)
        if kv_h == h:
            self.qkv = nn.Linear(E, 3 * E, bias=False)
        else:
            self.q = nn.Linear(E, E, bias=False)
            self.kv = nn.Linear(E, 2 * kv_h * (E // h), bias=False)
        self.proj = nn.Linear(E, E, bias=False)
        self.RMSNorm_1 = RMSNorm(E, cfg.dtype)
        if cfg.num_experts > 0:
            self.moe = SwitchMlp(cfg)
            return
        if cfg.mlp == "swiglu":
            self.gate = nn.Linear(E, hidden, bias=False)
        self.up = nn.Linear(E, hidden, bias=False)
        self.down = nn.Linear(hidden, E, bias=False)

    def forward(self, x, positions=None, cache=None, kv_sink=None):
        """Training and prefill path when ``cache is None`` (``kv_sink``, a
        list, receives the block's shared-head ``(k, v)``); a MoE block
        returns ``(x, aux)``, its load-balancing loss beside the output.
        With ``cache = (k_cache, v_cache)`` (``(B, L, kv_h, d)``) ``x`` is
        ONE new token per sequence, written into the cache in place at
        ``positions`` and attended against it; returns ``(x, cache)``."""
        cfg, dt = self.cfg, self.cfg.dtype
        h = cfg.num_heads
        d = cfg.embed_dim // h
        kv_h = cfg.num_kv_heads or h
        rope = cfg.pos_encoding == "rope"
        B, S = x.shape[0], x.shape[1]
        if rope and positions is None and cache is None:
            positions = torch.arange(S, device=x.device)[None, :]
        y = self.RMSNorm_0(x)
        if kv_h == h:
            # Head-interleaved fused layout [q_h0 k_h0 v_h0 | q_h1 ...], as
            # the JAX package (a relabeling of kernel columns, not thirds).
            qkv = _dense(y, self.qkv, dt).view(B, S, h, 3, d)
            q, k1, v1 = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        else:
            # GQA: K and V interleave per shared head, [k_g0 v_g0 | k_g1 ...].
            q = _dense(y, self.q, dt).view(B, S, h, d)
            kv = _dense(y, self.kv, dt).view(B, S, kv_h, 2, d)
            k1, v1 = kv[..., 0, :], kv[..., 1, :]
        if rope:
            # the kv_h shared heads turn once, before the fan-out
            q = apply_rope(q, positions, cfg.rope_theta)
            k1 = apply_rope(k1, positions, cfg.rope_theta)
        rep = h // kv_h
        if cache is None:
            if kv_sink is not None:
                kv_sink.append((k1, v1))
            attn = self.attn_impl(q, repeat_kv(k1, rep), repeat_kv(v1, rep),
                                  causal=cfg.causal)
        else:
            ck, cv = cache
            # decode positions are batch-uniform
            idx = positions[0, :1].long()
            ck.index_copy_(1, idx, k1.to(ck.dtype))
            cv.index_copy_(1, idx, v1.to(cv.dtype))
            # grouped attention of the single query over the cache, without
            # h-headed K/V
            L = ck.shape[1]
            qg = q.reshape(B, S, kv_h, rep, d)
            logits = torch.einsum("bqgrd,blgd->bgrql", qg, ck) / math.sqrt(d)
            mask = torch.arange(L, device=ck.device) <= idx
            logits = logits.float().masked_fill(
                ~mask, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(dt)
            attn = torch.einsum("bgrql,blgd->bqgrd", probs, cv)
        x = x + _dense(attn.reshape(B, S, cfg.embed_dim), self.proj, dt)
        y = self.RMSNorm_1(x)
        if cfg.num_experts > 0:
            y, aux = self.moe(y)
            return x + y, aux
        if cfg.mlp == "swiglu":
            y = F.silu(_dense(y, self.gate, dt)) * _dense(y, self.up, dt)
        else:
            y = F.gelu(_dense(y, self.up, dt), approximate="tanh")
        x = x + _dense(y, self.down, dt)
        return x if cache is None else (x, cache)


class TransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 attn_impl: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        attn = attn_impl or local_attention
        E = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, E)
        self.wpe = (nn.Embedding(cfg.max_seq_len, E)
                    if cfg.pos_encoding == "learned" else None)
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

    def forward(self, tokens, positions=None, return_hidden: bool = False,
                cache=None, moe_aux: Optional[list] = None):
        """Logits ``(B, S, vocab)`` in float32 for int tokens ``(B, S)``.

        ``positions``: optional ``(B, S)`` (or ``(1, S)``) position ids.
        ``return_hidden``: skip the lm-head and return the final RMSNorm
        output ``(B, S, E)``, for ``ops.chunked_loss``.  ``cache``: the
        per-block ``(k, v)`` caches of :func:`init_cache`, for one-token
        decoding at explicit ``positions``; the caches are written in place
        and ``(logits, cache)`` returned.  ``moe_aux``: a list that receives
        each MoE block's load-balancing loss, in block order (the JAX
        package's sown ``intermediates/moe_aux_loss``); a remat recompute
        adds nothing to it."""
        return self._run(tokens, positions, return_hidden, cache,
                         moe_aux=moe_aux)

    def _run(self, tokens, positions=None, return_hidden=False, cache=None,
             kv_sink: Optional[list] = None, moe_aux: Optional[list] = None):
        cfg = self.cfg
        if cache is not None:
            if cfg.num_experts > 0:
                raise NotImplementedError(
                    "KV-cache decoding with MoE blocks is not supported")
            if not cfg.causal:
                raise ValueError(
                    "KV-cache decoding requires causal=True: the decode "
                    "branch masks by cache index (causal by construction), "
                    "which would diverge from a bidirectional training "
                    "forward")
            if tokens.shape[1] != 1:
                raise ValueError(
                    f"cache decoding takes ONE token per step; got "
                    f"tokens of shape {tuple(tokens.shape)} (prefill a "
                    f"prompt with a normal forward — see generate())")
            if positions is None:
                raise ValueError(
                    "cache decoding requires explicit positions (the "
                    "cache write index); defaulting to 0 would overwrite "
                    "slot 0 every step")
        B, S = tokens.shape
        x = self.wte(tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None, :]
        if self.wpe is not None:
            x = x + self.wpe(positions).to(cfg.dtype)
        positions = positions.expand(B, S)
        for i, blk in enumerate(self.blocks):
            if cache is not None:
                x, cache[i] = blk(x, positions, cache[i])
                continue
            # The aux loss is an output of the (checkpointed) block, so a
            # recompute in the backward cannot add it twice.
            if kv_sink is not None:
                x = blk(x, positions, None, kv_sink)
            else:
                x = run_block(blk, block_policy(cfg, i), x, positions)
            if cfg.num_experts > 0:
                x, aux = x
                if moe_aux is not None:
                    moe_aux.append(aux)
        x = self.RMSNorm_0(x)
        if return_hidden:
            return x
        logits = F.linear(x.float(), self.lm_head.weight.float())
        return logits if cache is None else (logits, cache)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-block ``(k, v)`` KV caches for incremental decoding, zeros of
    shape ``(batch, max_len, kv_heads, head_dim)`` in ``cfg.dtype`` on
    ``device``: kv_heads, not num_heads, so GQA/MQA caches are ``num_heads /
    num_kv_heads`` times smaller."""
    dev = resolve_device(device)
    h = cfg.num_heads
    shape = (batch, max_len, cfg.num_kv_heads or h, cfg.embed_dim // h)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
             torch.zeros(shape, dtype=cfg.dtype, device=dev))
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def prefill(model: TransformerLM, prompt, max_len: int):
    """One forward over ``prompt`` ``(B, P)`` through the model's
    ``attn_impl`` (K1 under ``flash_attention_impl()``); returns its
    logits ``(B, P, vocab)`` and the caches of :func:`init_cache` for
    ``max_len`` positions, holding each block's shared-head K/V at
    positions ``0..P-1`` (the JAX package sows them during its prefill)."""
    B, P = prompt.shape
    entries: list = []
    logits = model._run(prompt, torch.arange(P, device=prompt.device)[None, :],
                        kv_sink=entries)
    cache = init_cache(model.cfg, B, max_len, device=prompt.device)
    for (ck, cv), (k1, v1) in zip(cache, entries):
        ck[:, :P] = k1
        cv[:, :P] = v1
    return logits, cache


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Autoregressive decoding with the KV cache, on the device of
    ``model`` and ``prompt``.

    ``prompt``: ``(B, P)`` int tokens.  Returns ``(B, max_new_tokens)``.
    ``temperature == 0`` is greedy (argmax); otherwise pass ``generator``
    for sampling.  One :func:`prefill` forward over the prompt, then
    one-token decode steps that write the cache in place.  Decode logits
    match the training forward's to numerical tolerance (another
    contraction order)."""
    cfg = model.cfg
    B, P = prompt.shape
    if max_new_tokens <= 0:
        raise ValueError(f"max_new_tokens must be >= 1; got {max_new_tokens}")
    total = P + max_new_tokens
    if cfg.pos_encoding == "learned" and total > cfg.max_seq_len:
        raise ValueError(f"prompt + max_new_tokens = {total} exceeds "
                         f"max_seq_len {cfg.max_seq_len}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(-1)
        return nxt.to(prompt.dtype)

    logits, cache = prefill(model, prompt, total)
    out = [pick(logits[:, -1])]
    for t in range(P, total - 1):
        logits, cache = model(out[-1][:, None],
                              positions=torch.full((B, 1), t,
                                                   device=prompt.device),
                              cache=cache)
        out.append(pick(logits[:, 0]))
    return torch.stack(out, dim=1)
