"""Pipeline parallelism: GPipe, 1F1B, interleaved 1F1B and ZB-H1 schedules.

The port of ``bluefog_tpu/parallel/pipeline.py``.  The schedules are the JAX
package's, tick for tick: a lock-step loop over ticks whose body every stage
runs, the stage-to-stage handoff one hop of a lane buffer a tick.

- :func:`pipeline_apply` is GPipe: ``M`` microbatches through ``n`` stages in
  ``M + n - 1`` ticks, stage 0 taking microbatch ``t`` at tick ``t`` and the
  others their neighbor's output, the last stage's outputs replicated to
  every stage (the JAX package's masked ``psum``).  It is differentiable:
  one autograd node for the whole schedule, whose forward keeps each stage's
  graph (GPipe's O(M) residency) and whose backward runs the transposed
  schedule, the cotangents hopping up a tick.
- :func:`pipeline_train_step_interleaved` is 1F1B with ``v`` stage chunks a
  rank (rank ``r``'s chunk ``c`` is global stage ``c * n + r`` of ``S = n *
  v``), in ``2M + 2S - 2`` ticks: the forward of microbatch ``i`` on stage
  ``s`` at tick ``2i + s`` under ``torch.no_grad``, its input stashed in slot
  ``c * S + i % S``, and its backward at tick ``2i + 2S - 1 - s``, which
  recomputes the stage from the stash and takes ``torch.autograd.grad`` of a
  fresh forward (stage-granular remat: O(v S) stashed inputs a rank, no
  graph kept between ticks).  Lanes roll on rank 0 (activations) and on
  rank ``n - 1`` (cotangents), where a hop crosses into the next chunk.
  ``split_backward`` is ZB-H1: the backward tick computes only the input's
  gradient and pushes ``(x, cotangent)`` onto a W ring of depth 2; a tick
  without a backward for the chunk pops one and computes the parameters'
  gradient from a second recompute; two drain ticks finish the ring.  The
  loss is the mean over microbatches, from the last stage, on every stage.
- :func:`pipeline_train_step` is plain 1F1B, the ``v = 1`` case.

The pipeline axis has ``ops.p2p.shard_axis``'s form.  An ``int`` ``n`` is
rank-major: every stage in this process, the parameters' leading dim the
stage, a tick running each stage's work in turn, a hop a ``torch.roll`` of
the lane buffer.  An ``ops.p2p.ProcessRanks`` puts the stages on the world's
ranks, each process holding its owned ranks' stages, and a hop is
``ProcessRanks.rotate``.  Both are data movement only, so the two forms give
the same bits.  Every stage must map ``(mb, ...)`` activations to the same
shape and dtype (the lanes are one buffer), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch.func import functional_call
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops.p2p import ProcessRanks, shard_axis

__all__ = ["pipeline_apply", "pipeline_train_step",
           "pipeline_train_step_interleaved", "blocks_stage"]

Axis = Union[int, ProcessRanks]
W_RING = 2   # ZB-H1's W ring depth: parity alternation bounds it to 2


def _hops(transport):
    """``(down, up)``: one hop of a lane buffer (leading dim: the owned
    ranks), rank ``g`` receiving rank ``g - 1``'s row (down the pipeline,
    ``ppermute`` with ``i -> i + 1``) or rank ``g + 1``'s (up)."""
    if transport is None:
        return (lambda x: torch.roll(x, 1, 0)), (lambda x: torch.roll(x, -1, 0))
    return ((lambda x: transport.rotate([x], up=True)[0]),
            (lambda x: transport.rotate([x], up=False)[0]))


def _from_last(rows, n: int, transport):
    """Rank ``n - 1``'s row of the owned ranks' ``rows``, on every
    process."""
    if transport is None:
        return rows[n - 1]
    return transport.broadcast(rows, n - 1).wait()


def _leaves(params, m: int, what: str):
    leaves, spec = pytree.tree_flatten(params)
    for leaf in leaves:
        if leaf.dim() == 0 or leaf.shape[0] != m:
            raise ValueError(f"{what} leaves must lead with the {m} stages "
                             f"this process holds; got {tuple(leaf.shape)}")
    return leaves, spec


def _add(acc, grads):
    """Accumulate ``grads`` (None: unused, zero) into the list ``acc``."""
    for k, g in enumerate(grads):
        if g is not None:
            acc[k] = g if acc[k] is None else acc[k] + g


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, axis, spec, microbatches, *leaves):
        n, lo, m, transport = shard_axis(axis)
        down, _ = _hops(transport)
        M = microbatches.shape[0]
        params = [[leaf[i].detach().requires_grad_(need) for leaf, need
                   in zip(leaves, ctx.needs_input_grad[4:])]
                  for i in range(m)]
        zero = microbatches.new_zeros(microbatches.shape[1:])
        lanes = microbatches.new_zeros((m,) + tuple(microbatches.shape[1:]))
        outputs = torch.zeros_like(microbatches)
        tape = []
        for t in range(M + n - 1):
            moved = down(lanes) if t else lanes
            ys = []
            for i in range(m):
                s, mb = lo + i, t - lo - i
                if not 0 <= mb < M:
                    ys.append(zero)
                    continue
                x = (microbatches[mb] if s == 0 else moved[i]).detach()
                x.requires_grad_(s > 0 or ctx.needs_input_grad[3])
                with torch.enable_grad():
                    y = stage_fn(pytree.tree_unflatten(params[i], spec), x)
                tape.append((t, i, x, y))
                ys.append(y.detach())
                if s == n - 1:
                    outputs[mb] = ys[-1]
            lanes = torch.stack(ys)
        ctx.layout, ctx.params, ctx.tape = (n, lo, m, transport), params, tape
        ctx.ticks, ctx.mb_shape = M + n - 1, microbatches.shape
        if transport is None:
            return outputs
        return _from_last(outputs.expand((m,) + tuple(outputs.shape)), n,
                          transport)

    @staticmethod
    def backward(ctx, gout):
        n, lo, m, transport = ctx.layout
        _, up = _hops(transport)
        grads = [[None] * len(p) for p in ctx.params]
        gmb = (gout.new_zeros(ctx.mb_shape) if ctx.needs_input_grad[3]
               else None)
        cot = gout.new_zeros((m,) + tuple(ctx.mb_shape[1:]))
        tape = ctx.tape
        for t in reversed(range(ctx.ticks)):
            dx = torch.zeros_like(cot)
            while tape and tape[-1][0] == t:
                _, i, x, y = tape.pop()
                s, mb = lo + i, t - lo - i
                want = [p for p in ctx.params[i] if p.requires_grad]
                if x.requires_grad:
                    want.append(x)
                got = list(torch.autograd.grad(
                    y, want, gout[mb] if s == n - 1 else cot[i],
                    allow_unused=True))
                gx = got.pop() if x.requires_grad else None
                it = iter(got)
                _add(grads[i], [next(it) if p.requires_grad else None
                                for p in ctx.params[i]])
                if gx is not None:
                    if s == 0:
                        gmb[mb] = gx
                    else:
                        dx[i] = gx
            if t:
                cot = up(dx)
        out = []
        for k, need in enumerate(ctx.needs_input_grad[4:]):
            out.append(torch.stack([
                g[k] if g[k] is not None else torch.zeros_like(p[k])
                for g, p in zip(grads, ctx.params)]) if need else None)
        ctx.params = None
        return (None, None, None, gmb) + tuple(out)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *,
                   axis: Axis):
    """GPipe: run ``stage_fn(params, x)`` as each stage of an ``axis``-deep
    pipeline over ``microbatches`` ``(M, mb, ...)`` (the whole input, on
    every process; stage 0 reads it).  ``stage_params``: a pytree whose
    leaves lead with the stages this process holds (all ``n`` for an
    ``int`` axis); ``stage_fn`` gets one stage's.  Returns the last stage's
    ``(M, mb, ...)`` outputs on every process, differentiable in the
    parameters and the microbatches.  Across processes, every process
    computes the same loss from the result and runs its backward; the
    microbatches' gradient is on the process holding stage 0."""
    n, lo, m, transport = shard_axis(axis)
    leaves, spec = _leaves(stage_params, m, "stage_params")
    return _GPipe.apply(stage_fn, axis, spec, microbatches, *leaves)


def pipeline_train_step(stage_fn: Callable, stage_params, microbatches,
                        targets, loss_fn: Callable, *, axis: Axis,
                        split_backward: bool = False):
    """One 1F1B training step: ``(loss, stage_grads)``, ``stage_grads``
    matching ``stage_params`` (leaves leading with this process's stages).
    ``loss_fn(y, target) -> scalar`` runs on the last stage; ``loss`` is
    its mean over the microbatches, on every process.  The ``v = 1`` case of
    :func:`pipeline_train_step_interleaved`."""
    chunked = pytree.tree_map(lambda t: t[:, None], stage_params)
    loss, grads = pipeline_train_step_interleaved(
        stage_fn, chunked, microbatches, targets, loss_fn, axis=axis,
        split_backward=split_backward)
    return loss, pytree.tree_map(lambda g: g[:, 0], grads)


def pipeline_train_step_interleaved(stage_fn: Callable, chunk_params,
                                    microbatches, targets,
                                    loss_fn: Callable, *, axis: Axis,
                                    split_backward: bool = False):
    """Interleaved (virtual-stage) 1F1B, ZB-H1 with ``split_backward``.

    ``chunk_params``: a pytree whose leaves lead with ``(m, v)``, this
    process's ranks and each one's ``v`` chunks; rank ``r``'s chunk ``c`` is
    global stage ``c * n + r``.  Returns ``(loss, chunk_grads)`` with
    ``chunk_grads`` matching ``chunk_params``, the mean over the
    microbatches.  Memory: O(v S) stashed stage inputs a rank (plus the W
    ring's 2 under ``split_backward``), against GPipe-through-autograd's
    O(M) stage graphs."""
    n, lo, m, transport = shard_axis(axis)
    leaves, spec = _leaves(chunk_params, m, "chunk_params")
    down, up = _hops(transport)
    v = leaves[0].shape[1]
    S, M = n * v, microbatches.shape[0]
    lead = tuple(microbatches.shape[1:])
    params = [[[leaf[i, c].detach().requires_grad_() for leaf in leaves]
               for c in range(v)] for i in range(m)]
    grads = [[[None] * len(leaves) for _ in range(v)] for _ in range(m)]
    stash = microbatches.new_zeros((m, v * S) + lead)
    fwd = microbatches.new_zeros((m, v) + lead)
    bwd = torch.zeros_like(fwd)
    loss_acc = torch.zeros(m, dtype=torch.float32, device=microbatches.device)
    if split_backward:
        ring = [[[microbatches.new_zeros((W_RING,) + lead) for _ in range(2)]
                 for _ in range(v)] for _ in range(m)]
        head = [[0] * v for _ in range(m)]
        tail = [[0] * v for _ in range(m)]
    ticks = 2 * M + 2 * S - 2 + (2 if split_backward else 0)
    for t in range(ticks):
        act_lanes, cot_lanes = down(fwd), up(bwd)
        fwd, bwd = torch.zeros_like(fwd), torch.zeros_like(bwd)
        for i in range(m):
            r = lo + i
            # A payload leaving rank n - 1 on lane c is chunk c + 1's input
            # on rank 0; a cotangent leaving rank 0 on lane c + 1 is chunk
            # c's on rank n - 1.
            act_in = (torch.roll(act_lanes[i], 1, 0) if r == 0
                      else act_lanes[i])
            cot_in = (torch.roll(cot_lanes[i], -1, 0) if r == n - 1
                      else cot_lanes[i])
            for c in range(v):
                s = c * n + r
                p_leaves = params[i][c]
                p = pytree.tree_unflatten(p_leaves, spec)
                tf = t - s
                if tf >= 0 and tf % 2 == 0 and tf // 2 < M:
                    mb = tf // 2
                    x = microbatches[mb] if s == 0 else act_in[c]
                    with torch.no_grad():
                        fwd[i, c] = stage_fn(p, x)
                    stash[i, c * S + mb % S] = x
                tb = t - (2 * S - 1 - s)
                bwd_on = tb >= 0 and tb % 2 == 0 and tb // 2 < M
                if bwd_on:
                    j = tb // 2
                    x = stash[i, c * S + j % S].detach().requires_grad_()
                    with torch.enable_grad():
                        y = stage_fn(p, x)
                    if s == S - 1:
                        yd = y.detach().requires_grad_()
                        with torch.enable_grad():
                            lval = loss_fn(yd, targets[j])
                        cot, = torch.autograd.grad(lval, yd)
                        loss_acc[i] += lval.detach().float()
                    else:
                        cot = cot_in[c]
                    cot = cot.to(y.dtype)
                    if split_backward:
                        # B: the input's gradient alone; the parameters'
                        # waits on the W ring.
                        dx, = torch.autograd.grad(y, x, cot)
                        if tail[i][c] - head[i][c] >= W_RING:
                            raise RuntimeError("the W ring overflowed")
                        slot = tail[i][c] % W_RING
                        ring[i][c][0][slot] = x.detach()
                        ring[i][c][1][slot] = cot
                        tail[i][c] += 1
                    else:
                        *dp, dx = torch.autograd.grad(
                            y, p_leaves + [x], cot, allow_unused=True)
                        _add(grads[i][c], dp)
                    bwd[i, c] = dx
                if (split_backward and not bwd_on
                        and head[i][c] < tail[i][c]):
                    # W: pop the oldest deferred task on a tick without a B.
                    slot = head[i][c] % W_RING
                    x, cot = ring[i][c][0][slot], ring[i][c][1][slot]
                    with torch.enable_grad():
                        y = stage_fn(p, x)
                    _add(grads[i][c], torch.autograd.grad(
                        y, p_leaves, cot, allow_unused=True))
                    head[i][c] += 1
    loss = _from_last(loss_acc, n, transport) / M
    out = []
    for k, leaf in enumerate(leaves):
        out.append(torch.stack([torch.stack([
            (g[k] if g[k] is not None else torch.zeros_like(leaf[0, 0])) / M
            for g in grads[i]]) for i in range(m)]))
    return loss, pytree.tree_unflatten(out, spec)


def blocks_stage(cfg, attn_impl: Optional[Callable] = None) -> Callable:
    """A ``stage_fn`` of ``models.transformer.Block``s: ``params`` maps each
    ``Block`` parameter name (``qkv.weight``, ...) to a stack ``(L, ...)`` of
    ``L`` blocks, which run in turn on ``(B, S, E)`` activations.
    ``attn_impl`` defaults to ``ops.flash_attention`` (K1-K3 on the card,
    the plain twin on the CPU)."""
    from bluefog_tpu_torch.models.transformer import Block
    from bluefog_tpu_torch.ops.flash_attention import flash_attention
    with torch.device("meta"):
        block = Block(cfg, attn_impl or flash_attention)

    def stage(params, x):
        # One unbind a stack: its backward stacks the blocks' gradients
        # once, where indexing each block would scatter each into a zeroed
        # copy of the whole stack.
        blocks = {k: w.unbind(0) for k, w in params.items()}
        for layer in range(len(next(iter(blocks.values())))):
            x = functional_call(block, {k: w[layer]
                                        for k, w in blocks.items()}, (x,))
        return x
    return stage
