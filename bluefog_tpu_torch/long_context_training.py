"""Sequence-parallel long-context LM training.

The port of ``examples/long_context_training.py``: a TransformerLM whose
sequence is cut into ``--shards`` contiguous shards, each ``seq_len /
shards`` tokens with its own global positions, trains with Adam on one long
synthetic stream.  ``--attention ring`` streams K/V blocks around the
shards (``parallel.ring_attention``), so no shard ever holds the whole
sequence's logits or K/V; ``--attention ulysses`` trades the sharding from
sequence to heads with two all-to-alls (``parallel.ulysses``).  Both compose
with ``--rope``.  The shards run rank-major in this process, stacked on the
batch dim (the JAX example's mesh devices; ``--shards`` stands for its
device count).

The model is the JAX example's on every device (:func:`model_config`): 2
layers, 8 heads, width 128 in float32 (heads of 16), vocabulary
``--vocab``; on CUDA its attention runs through the float32 K1-K3, on the
CPU through their plain twins.

    python -m bluefog_tpu_torch.long_context_training --seq-len 8192
    python -m bluefog_tpu_torch.long_context_training --device cpu \\
        --seq-len 512 --steps 12 --attention ulysses --rope

:class:`SequenceParallelLM` is the training step, also at other widths
(``chip_smoke.py`` trains the 1.3B LM's widths over 16,384 tokens with it).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch.basics import resolve_device
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.ops.chunked_loss import chunked_softmax_cross_entropy
from bluefog_tpu_torch.parallel.ring_attention import (ring_attention_impl,
                                                       shard_sequence)
from bluefog_tpu_torch.parallel.ulysses import ulysses_attention_impl

__all__ = ["synthetic_language", "SequenceParallelLM", "build_parser",
           "model_config", "main"]


def synthetic_language(seq_len: int, vocab: int, seed: int = 0
                       ) -> np.ndarray:
    """``seq_len + 1`` tokens of the JAX example's learnable language: the
    next token is ``(cur * 3 + 1) % vocab``, with 5% noise."""
    rng = np.random.RandomState(seed)
    toks = np.zeros(seq_len + 1, np.int64)
    for i in range(seq_len):
        toks[i + 1] = (toks[i] * 3 + 1) % vocab \
            if rng.rand() > 0.05 else rng.randint(vocab)
    return toks


class SequenceParallelLM:
    """One ``TransformerLM`` (``cfg``) trained with Adam over an ``n``-shard
    rank-major sequence axis: ``tokens`` and ``targets`` ``(B, S)`` are
    cut into the shards, stacked on the batch dim with their global
    positions, and every step's loss is the mean next-token cross-entropy
    over the whole sequence (``chunked_loss``: without the logits,
    ``ops.chunked_loss``).  ``opt`` is the Adam over the parameters.  The
    weights are drawn from ``seed`` on ``init_device`` (default: the
    tokens' device); drawn on the CPU they are the same on every device."""

    def __init__(self, cfg: TransformerConfig, attention: str, n: int,
                 tokens: torch.Tensor, targets: torch.Tensor, *, lr: float,
                 chunked_loss: bool = False, seed: int = 0,
                 init_device=None):
        if attention not in ("ring", "ulysses"):
            raise ValueError(f"attention {attention!r} not in ('ring', "
                             "'ulysses')")
        impl = (ring_attention_impl(n) if attention == "ring"
                else ulysses_attention_impl(n))
        dev = tokens.device
        init = torch.device(init_device or dev)
        self.model = TransformerLM(cfg, impl).to(init)
        self.model.reset_parameters(
            torch.Generator(device=init).manual_seed(seed))
        self.model.to(dev)
        B, S = tokens.shape
        self.tokens = shard_sequence(tokens, n)
        self.targets = shard_sequence(targets, n)
        self.positions = shard_sequence(
            torch.arange(S, device=dev).expand(B, S), n)
        self.chunked_loss = chunked_loss
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)

    def forward_backward(self) -> torch.Tensor:
        """The loss of the whole sequence, its gradients in ``.grad``."""
        self.opt.zero_grad()
        model = self.model
        if self.chunked_loss:
            loss = chunked_softmax_cross_entropy(
                model(self.tokens, positions=self.positions,
                      return_hidden=True),
                model.lm_head.weight, self.targets)
        else:
            logits = model(self.tokens, positions=self.positions)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   self.targets.reshape(-1))
        loss.backward()
        return loss.detach()

    def step(self) -> torch.Tensor:
        loss = self.forward_backward()
        self.opt.step()
        return loss


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--attention", choices=["ring", "ulysses"],
                    default="ring")
    ap.add_argument("--rope", action="store_true")
    ap.add_argument("--shards", type=int, default=8,
                    help="sequence shards (the JAX example's devices)")
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args) -> TransformerConfig:
    """The JAX example's model (``examples/long_context_training.py``), the
    same whatever ``args.device``."""
    return TransformerConfig(
        vocab_size=args.vocab, num_layers=2, num_heads=8, embed_dim=128,
        max_seq_len=args.seq_len, dtype=torch.float32,
        pos_encoding="rope" if args.rope else "learned")


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the run checks that the loss fell)")
    n, S = args.shards, args.seq_len
    if S % n:
        ap.error(f"--seq-len {S} must divide over {n} shards")
    dev = resolve_device(args.device)
    cfg = model_config(args)
    toks = torch.from_numpy(synthetic_language(S, args.vocab)).to(dev)
    lm = SequenceParallelLM(cfg, args.attention, n, toks[None, :S],
                            toks[None, 1:], lr=args.lr, init_device="cpu")
    losses = []
    for i in range(args.steps):
        losses.append(float(lm.step()))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}  loss {losses[-1]:.4f} ({S} tokens over "
                  f"{n} shards, {args.attention})", flush=True)
    l0, lf = losses[0], losses[-1]
    if not lf < l0:
        raise SystemExit(f"the loss did not fall: {l0} -> {lf}")
    how = (f"ring attention streamed K/V around the shards — no device "
           f"materialized the {S}x{S} score matrix"
           if args.attention == "ring" else
           f"Ulysses all-to-all gave each shard all {S} tokens for "
           f"{cfg.num_heads}/{n} of the heads")
    print(f"done: loss {l0:.4f} -> {lf:.4f}; per-shard sequence "
          f"{S // n} tokens; {how}", flush=True)
    return {"losses": losses, "device": str(dev), "shards": n}


if __name__ == "__main__":
    main()
