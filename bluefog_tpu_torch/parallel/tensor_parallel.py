"""Tensor parallelism of ``models.TransformerLM``: Megatron's layout.

The port of ``bluefog_tpu/parallel/tensor_parallel.py``.  There the layout is
a set of ``PartitionSpec``s and GSPMD runs the unchanged model on the sharded
weights, placing the collectives itself.  Here :func:`tp_param_specs` gives
the same layout from the same rule table, keyed on each parameter's flax path
(``models.convert.flax_leaf``), :func:`tp_shard_params` cuts the weights, and
:class:`TensorParallelLM` runs the LM's blocks on the shards with the
collectives written out:

- **column-parallel** ``qkv`` (GQA: ``q`` and ``kv``), ``gate``, ``up`` and the
  vocab-parallel ``lm_head``: each shard computes its slice of the output
  features.  A flax kernel is ``(in, out)`` and ``nn.Linear.weight`` ``(out,
  in)``, so the cut is dim 0 of the torch weight.  The fused QKV is
  head-interleaved, ``[q_h0 k_h0 v_h0 | q_h1 ...]``, so a contiguous cut hands
  each shard whole heads.
- **row-parallel** ``proj`` and ``down`` (dim 1 of the torch weight): each
  shard multiplies its slice of the input features and the partial products
  are summed over the shards, in ``ops.collective._rank_sum``'s order (a
  dtype narrower than float32 accumulated in float32, rounded once); across
  processes each process sums its own shards, then ``ProcessRanks.
  all_reduce`` adds the processes'.  The sum runs under the profiler range
  ``tp::row_sum`` (``profile_step``'s ``named_ops``).
- **replicated** ``wte``, ``wpe`` and the RMSNorm scales: the input of every
  column-parallel layer passes Megatron's *f* operator, the identity forward
  whose backward sums the shards' cotangents, so these parameters get their
  whole gradient, not one shard's share.  Rank-major, the shards' columns
  are one matmul and autograd sums them; across processes the backward
  all-reduces them (in float32).
- **attention** runs once a layer, the shards' heads stacked on the batch dim:
  ``(m * B, S, H / n, D)`` through ``attn_impl`` (``ops.flash_attention``: K1
  forward, K2 and K3 backward on the card, the plain twin on the CPU).  Under
  GQA with ``n`` not dividing the kv heads, a shard's rows of the ``kv``
  kernel hold part of a head group (a K without its V): the shards' ``kv``
  outputs are gathered back to whole groups before the fan-out, as GSPMD
  re-gathers K/V.
- the **vocabulary slices'** logits are gathered, so the loss sees the whole
  softmax.
- **switch-MoE blocks** (``cfg.num_experts > 0``) take one of the two layouts
  of :func:`tp_param_specs`: without ``ep_axis`` the experts are whole on
  every tp shard, and the router, the dispatch and the experts run as
  ``models.transformer.SwitchMlp`` on the block's replicated input; with
  ``ep_axis`` expert ``e`` lives on rank ``e`` of that axis (one expert a
  rank), and the block runs ``parallel.moe.moe_apply`` over it.  There every
  rank computes the same objective from the summed output, so each rank's
  row carries ``1 / E`` of it (the JAX package's divide-by-E convention) and
  the sum's backward adds them back; across processes the block's input and
  router logits pass Megatron's *f* over the expert axis, so the router and
  the residual stream get the whole gradient.  The block's load-balancing
  loss comes out as ``TransformerLM``'s does (``forward(..., moe_aux=[])``).
- **remat** (``cfg.remat``, ``cfg.remat_policy``): each block runs through
  ``models.transformer.run_block``, as in the unsharded model, so its
  recompute in the backward runs the block's collectives again (the
  shards' *f*, ``tp::row_sum``, the kv gather, the expert sums), on every
  process, in the same order, since every process backpropagates the same
  graph.

The tensor-parallel axis has the form of ``parallel.ring_attention``'s
sequence axis (``ops.p2p.shard_axis``): an ``int`` ``n`` holds all ``n`` shards
rank-major in this process, stacked on a leading dim of every cut weight; an
``ops.p2p.ProcessRanks`` spreads them over the world's ranks, each process
holding its owned ranks' shards.  Across processes every process computes the
same loss from the gathered logits and runs its backward (Megatron's
convention: the loss is not divided by the axis size).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.profiler import record_function

from bluefog_tpu_torch.models.convert import flax_leaf
from bluefog_tpu_torch.models.transformer import (RMSNorm, SwitchMlp,
                                                  TransformerConfig,
                                                  apply_rope, block_policy,
                                                  run_block)
from bluefog_tpu_torch.ops.collective import _rank_sum
from bluefog_tpu_torch.ops.flash_attention import flash_attention
from bluefog_tpu_torch.ops.p2p import ProcessRanks, shard_axis
from bluefog_tpu_torch.parallel.moe import load_balance_loss, moe_apply

__all__ = ["tp_param_specs", "tp_shard_params", "TensorParallelLM"]

Axis = Union[int, ProcessRanks]


def P(*spec):
    """A partition spec over a leaf's flax layout, one entry a dim: the
    axis that dim is cut over, or None (``jax.sharding.PartitionSpec``)."""
    return tuple(spec)


# (suffix of the flattened param path, spec builder)
_RULES = (
    ("qkv/kernel", lambda ax: P(None, ax)),      # column parallel: heads
    ("/q/kernel", lambda ax: P(None, ax)),       # GQA query heads
    ("/kv/kernel", lambda ax: P(None, ax)),      # GQA K/V heads: head-
    # aligned only while tp <= num_kv_heads; past that the shards' kv
    # outputs are gathered back to whole groups (TensorParallelLM._kv)
    ("up/kernel", lambda ax: P(None, ax)),       # column parallel: mlp hidden
    ("gate/kernel", lambda ax: P(None, ax)),     # SwiGLU gate: column
    ("proj/kernel", lambda ax: P(ax, None)),     # row parallel (sum after)
    ("down/kernel", lambda ax: P(ax, None)),     # row parallel (sum after)
    ("lm_head/kernel", lambda ax: P(None, ax)),  # vocab parallel
)


def tp_param_specs(model: nn.Module, axis: Axis, *,
                   ep_axis: Optional[Axis] = None
                   ) -> Dict[str, Optional[Tuple[Axis, int]]]:
    """The layout of an unsharded ``TransformerLM``'s parameters:
    ``{name: (axis, dim)}`` for a parameter cut on its torch dim ``dim``
    over ``axis``, ``{name: None}`` for a replicated one.

    Embeddings and norms replicate; every big matmul is cut per the
    Megatron column/row pattern of ``_RULES``.  With ``ep_axis`` the stacked
    MoE expert weights (``experts_up``/``experts_down``, leading dim E) are
    cut on that dim over ``ep_axis``.  Unrecognized kernels replicate."""
    specs = {}
    for name, p in model.named_parameters():
        _, path, dims = flax_leaf(model, name)
        flat = "/".join(path)
        spec = None
        if p.dim() == 2:
            for suffix, build in _RULES:
                if flat.endswith(suffix):
                    spec = build(axis)
                    break
        elif (ep_axis is not None and p.dim() == 3
              and flat.endswith(("experts_up", "experts_down"))):
            spec = P(ep_axis, None, None)
        specs[name] = None
        if spec is not None:
            # flax dim k is torch dim dims[k] (torch.permute(dims) gives
            # the flax layout)
            k = next(i for i, ax in enumerate(spec) if ax is not None)
            specs[name] = (spec[k], dims[k] if dims else k)
    return specs


def tp_shard_params(model: nn.Module, params, axis: Axis, *,
                    ep_axis: Optional[Axis] = None) -> dict:
    """``params`` (the unsharded ``model``'s state dict) in the layout of
    :func:`tp_param_specs`: a cut parameter becomes this process's shards
    stacked on a new leading dim, ``(m, ...)`` (every shard for an ``int``
    axis), the contiguous pieces of its cut dim in shard order; a
    replicated one stays whole.  :class:`TensorParallelLM` loads the
    result."""
    out = {}
    for name, spec in tp_param_specs(model, axis, ep_axis=ep_axis).items():
        t = torch.as_tensor(params[name])
        if spec is None:
            out[name] = t
            continue
        ax, dim = spec
        n, lo, m, _ = shard_axis(ax)
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                             f"not cut into {n} shards")
        out[name] = torch.stack(t.chunk(n, dim)[lo:lo + m])
    return out


class _ToShards(torch.autograd.Function):
    """Megatron's *f* across processes: the identity forward; the backward
    sums the processes' cotangents (in float32)."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.float().contiguous()
        ctx.transport.all_reduce(s).wait()
        return s.to(g.dtype), None


class _SumShards(torch.autograd.Function):
    """The row-parallel sum across processes: this process's shards ``(m,
    ...)`` summed in rank order in float32, then over the processes; the
    backward hands every shard the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.m = x.shape[0]
        s = _rank_sum(x, rounded=False)
        transport.all_reduce(s).wait()
        return s.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[None].expand((ctx.m,) + tuple(g.shape)), None


class _GatherShards(torch.autograd.Function):
    """The shards' last-dim slices ``(..., m * c)`` gathered over the
    processes into ``(..., n * c)``.  The backward takes this process's
    slice of the cotangent: as it is when every process holds the same
    cotangent (``replicated``: the logits, under the same loss), else summed
    over the processes first (each process's consumer read only part)."""

    @staticmethod
    def forward(ctx, x, transport, replicated):
        ctx.transport, ctx.replicated = transport, replicated
        ctx.c = x.shape[-1]
        parts = transport.all_gather(x.movedim(-1, 0).contiguous()).wait()
        return parts.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            s = g.float().contiguous()
            ctx.transport.all_reduce(s).wait()
            g = s.to(g.dtype)
        lo = ctx.transport.process * ctx.c
        return g[..., lo:lo + ctx.c], None, None


class _EpRow(torch.autograd.Function):
    """Row 0 of ``moe_apply``'s output (every row holds the same sum); the
    backward hands each of this process's ``m`` expert ranks ``1 / E`` of
    the cotangent, which the sum's backward adds over the ``E`` ranks."""

    @staticmethod
    def forward(ctx, out, n_experts):
        ctx.m, ctx.E = out.shape[0], n_experts
        return out[0].clone()

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.E)[None].expand((ctx.m,) + tuple(g.shape)), None


class _Shards(nn.Module):
    """``m`` shards of one Dense layer: ``weight`` ``(m, out, in)``, shard
    ``i`` an ``nn.Linear.weight``."""

    def __init__(self, m: int, out_features: int, in_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(m, out_features, in_features))


def _column(y, layer: _Shards, dt):
    """Every shard's slice of a column-parallel output, ``(..., m * out)``
    in shard order: one matmul of ``y`` by the shards' stacked rows."""
    w = layer.weight
    return F.linear(y.to(dt), w.reshape(-1, w.shape[-1]).to(dt))


def _cut(n: int, size: int, what: str) -> int:
    if size % n:
        raise ValueError(f"{what} ({size}) does not cut into {n} shards")
    return size // n


class _ExpertShards(nn.Module):
    """A MoE block's router (whole) and this process's ``m`` experts of an
    expert axis of ``E`` ranks, one expert a rank: ``experts_up`` ``(m, 1,
    d, hidden)``, ``experts_down`` ``(m, 1, hidden, d)``, as
    :func:`tp_shard_params` cuts the stacks."""

    def __init__(self, cfg: TransformerConfig, m: int):
        super().__init__()
        d, E = cfg.embed_dim, cfg.num_experts
        hidden = cfg.mlp_ratio * d
        self.router = nn.Linear(d, E, bias=False)
        self.experts_up = nn.Parameter(torch.empty(m, 1, d, hidden))
        self.experts_down = nn.Parameter(torch.empty(m, 1, hidden, d))


class _Block(nn.Module):
    """One block's parameters, named after ``models.transformer.Block``'s;
    the cut ones hold this process's shards (a MoE block's experts: whole,
    or this process's ranks of the expert axis, ``m_ep`` of them)."""

    def __init__(self, cfg: TransformerConfig, n: int, m: int,
                 m_ep: Optional[int] = None):
        super().__init__()
        E, h = cfg.embed_dim, cfg.num_heads
        kv_h = cfg.num_kv_heads or h
        d = E // h
        _cut(n, h, "num_heads")
        self.RMSNorm_0 = RMSNorm(E, cfg.dtype)
        if kv_h == h:
            self.qkv = _Shards(m, 3 * E // n, E)
        else:
            self.q = _Shards(m, E // n, E)
            self.kv = _Shards(m, _cut(n, 2 * kv_h * d, "the kv width"), E)
        self.proj = _Shards(m, E, E // n)
        self.RMSNorm_1 = RMSNorm(E, cfg.dtype)
        if cfg.num_experts > 0:
            self.moe = (SwitchMlp(cfg) if m_ep is None
                        else _ExpertShards(cfg, m_ep))
            return
        hidden = _cut(n, cfg.mlp_ratio * E, "the mlp hidden width")
        if cfg.mlp == "swiglu":
            self.gate = _Shards(m, hidden, E)
        self.up = _Shards(m, hidden, E)
        self.down = _Shards(m, E, hidden)


class TensorParallelLM(nn.Module):
    """``models.TransformerLM`` over a tensor-parallel ``axis``: the same
    parameter names, each cut one holding this process's shards ``(m, ...)``
    (load :func:`tp_shard_params`'s result); ``forward(tokens, positions)``
    returns the whole ``(B, S, vocab)`` float32 logits, equal to the
    unsharded model's.  MHA or GQA, learned or rotary positions, GELU or
    SwiGLU or switch-MoE blocks, with or without remat.  ``ep_axis`` (MoE
    only; ``None``: the experts whole on every shard) cuts the experts over
    an expert axis of ``num_experts`` ranks, in ``axis``' form; pass the
    same ``ep_axis`` to :func:`tp_shard_params`.  ``attn_impl`` (default
    ``ops.flash_attention``) takes ``(q, k, v, causal=)`` in ``(B, S, H,
    D)``."""

    def __init__(self, cfg: TransformerConfig, axis: Axis,
                 attn_impl: Optional[Callable] = None, *,
                 ep_axis: Optional[Axis] = None):
        super().__init__()
        self.cfg = cfg
        self.n, self.lo, self.m, self.transport = shard_axis(axis)
        self.ep_axis, self.ep_transport = ep_axis, None
        m_ep = None
        if ep_axis is not None:
            if not cfg.num_experts:
                raise ValueError("ep_axis cuts MoE experts; the model has "
                                 "none (num_experts=0)")
            n_ep, _, m_ep, self.ep_transport = shard_axis(ep_axis)
            if n_ep != cfg.num_experts:
                raise ValueError(
                    f"the expert axis has {n_ep} ranks and the model "
                    f"{cfg.num_experts} experts: moe_apply places one "
                    "expert a rank")
        self.attn = attn_impl or flash_attention
        E = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, E)
        self.wpe = (nn.Embedding(cfg.max_seq_len, E)
                    if cfg.pos_encoding == "learned" else None)
        self.blocks = nn.ModuleList(_Block(cfg, self.n, self.m, m_ep)
                                    for _ in range(cfg.num_layers))
        self.RMSNorm_0 = RMSNorm(E, cfg.dtype)
        self.lm_head = _Shards(self.m, _cut(self.n, cfg.vocab_size,
                                            "vocab_size"), E)

    # -- the collectives (rank-major: nothing to move) ---------------------

    def _f(self, y):
        return y if self.transport is None else _ToShards.apply(
            y, self.transport)

    def _row(self, a, layer: _Shards, dt):
        """The row-parallel product of the shards' inputs ``a`` ``(m, R,
        in)``, summed over the shards: ``(R, out)``."""
        partial = torch.bmm(a.to(dt), layer.weight.to(dt).transpose(1, 2))
        with record_function("tp::row_sum"):
            if self.transport is None:
                return _rank_sum(partial)
            return _SumShards.apply(partial, self.transport)

    def _f_ep(self, y):
        """Megatron's *f* over the expert axis across processes (each
        process's experts see only their share of the tokens' gradient)."""
        return y if self.ep_transport is None else _ToShards.apply(
            y, self.ep_transport)

    def _gather(self, x, replicated: bool):
        if self.transport is None:
            return x
        return _GatherShards.apply(x, self.transport, replicated)

    def _stack(self, t, B: int, S: int, hl: int):
        """``(B, S, m * hl, ...)`` head-major shards -> ``(m * B, S, hl,
        ...)``, the shards stacked on the batch dim."""
        rest = tuple(t.shape[3:])
        return t.view((B, S, self.m, hl) + rest).movedim(2, 0).reshape(
            (self.m * B, S, hl) + rest)

    def _kv(self, kv, B: int, S: int):
        """The k and v of this process's query heads, ``(m * B, S, H / n,
        D)`` each, from the shards' ``kv`` outputs ``(B, S, m * 2 kv_h D /
        n)`` (K and V interleaved per group, ``[k_g0 v_g0 | k_g1 ...]``)."""
        cfg = self.cfg
        h, kv_h = cfg.num_heads, cfg.num_kv_heads
        d = cfg.embed_dim // h
        hl, rep = h // self.n, h // kv_h
        if kv_h % self.n:
            # A shard holds part of a group: gather the groups whole.
            kv, g0 = self._gather(kv, replicated=False), 0
        else:
            g0 = self.lo * (kv_h // self.n)
        kv = kv.view(B, S, -1, 2, d)
        heads = torch.arange(self.lo * hl, (self.lo + self.m) * hl,
                             device=kv.device)
        groups = heads // rep - g0
        return tuple(self._stack(kv[..., i, :].index_select(2, groups),
                                 B, S, hl) for i in (0, 1))

    # -- the model -----------------------------------------------------------

    def _experts(self, moe: _ExpertShards, y):
        """The MoE sublayer over the expert axis: ``SwitchMlp``'s routing
        groups, each through ``moe_apply``; returns the output and the
        load-balancing loss."""
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, d = y.shape
        E = cfg.num_experts
        T = B * S
        g = min(cfg.router_group_size, T)
        if T % g:
            raise ValueError(
                f"the expert axis routes whole groups: {T} tokens do not "
                f"fill groups of {g} (router_group_size)")
        capacity = max(1, int(cfg.expert_capacity_factor * g / E))
        xt = y.reshape(T // g, g, d)
        with record_function("moe::plan"):
            logits = moe.router(xt.float())
            # SwitchMlp's statistic: every token of a whole group valid.
            aux = load_balance_loss(logits,
                                    logits.new_ones(logits.shape[:2])).mean()
        m = moe.experts_up.shape[0]

        def expert(w, z):
            up, down = w
            return F.gelu(z @ up[0].to(dt), approximate="tanh") @ \
                down[0].to(dt)
        parts = []
        for xg, lg in zip(self._f_ep(xt.to(dt)), self._f_ep(logits)):
            out = moe_apply(expert, (moe.experts_up, moe.experts_down),
                            xg.expand((m,) + tuple(xg.shape)),
                            lg.expand((m,) + tuple(lg.shape)),
                            axis=self.ep_axis, capacity=capacity)
            parts.append(_EpRow.apply(out, E))
        return torch.stack(parts).reshape(B, S, d), aux

    def _block(self, blk: _Block, x, positions):
        cfg, dt = self.cfg, self.cfg.dtype
        h = cfg.num_heads
        d = cfg.embed_dim // h
        hl = h // self.n
        B, S, E = x.shape
        y = self._f(blk.RMSNorm_0(x))
        if cfg.num_kv_heads in (None, h):
            qkv = self._stack(_column(y, blk.qkv, dt).view(B, S, -1, 3, d),
                              B, S, hl)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        else:
            q = self._stack(_column(y, blk.q, dt).view(B, S, -1, d), B, S, hl)
            k, v = self._kv(_column(y, blk.kv, dt), B, S)
        if cfg.pos_encoding == "rope":
            pos = positions.repeat(self.m, 1)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        o = self.attn(q, k, v, causal=cfg.causal)        # (m * B, S, hl, d)
        x = x + self._row(o.reshape(self.m, B * S, hl * d), blk.proj,
                          dt).view(B, S, E)
        if cfg.num_experts > 0:
            # The block's input is replicated: the experts-whole layout
            # runs SwitchMlp on it as the unsharded model does.
            y = blk.RMSNorm_1(x)
            y, aux = (blk.moe(y) if self.ep_axis is None
                      else self._experts(blk.moe, y))
            return x + y, aux
        y = self._f(blk.RMSNorm_1(x))
        if cfg.mlp == "swiglu":
            u = F.silu(_column(y, blk.gate, dt)) * _column(y, blk.up, dt)
        else:
            u = F.gelu(_column(y, blk.up, dt), approximate="tanh")
        u = u.view(B * S, self.m, -1).transpose(0, 1)
        return x + self._row(u, blk.down, dt).view(B, S, E)

    def forward(self, tokens, positions=None,
                moe_aux: Optional[list] = None):
        """Logits ``(B, S, vocab)`` in float32 for int tokens ``(B, S)``
        (``positions``: optional ``(B, S)`` or ``(1, S)`` position ids;
        ``moe_aux``: a list that receives each MoE block's load-balancing
        loss, in block order, as ``TransformerLM``'s)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.wte(tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None, :]
        if self.wpe is not None:
            x = x + self.wpe(positions).to(cfg.dtype)
        positions = positions.expand(B, S)
        for i, blk in enumerate(self.blocks):
            # The aux loss is an output of the (checkpointed) block, so a
            # recompute in the backward cannot add it twice.
            x = run_block(functools.partial(self._block, blk),
                          block_policy(cfg, i), x, positions)
            if cfg.num_experts > 0:
                x, aux = x
                if moe_aux is not None:
                    moe_aux.append(aux)
        x = self._f(self.RMSNorm_0(x).float())
        return self._gather(_column(x, self.lm_head, torch.float32),
                            replicated=True)
