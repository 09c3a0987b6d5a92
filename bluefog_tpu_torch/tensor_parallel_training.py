"""Tensor-parallel (+ data-parallel) LM training.

The port of ``examples/tensor_parallel_training.py``: a 2-layer SwiGLU LM
with 8 heads and vocabulary 256 trains with Adam on the JAX example's
learnable synthetic language, ``--ranks`` virtual devices arranged as ``dp =
ranks / tp`` data-parallel replicas of a ``--tp``-way Megatron layout
(``parallel.tensor_parallel``).  Each dp rank is a row of a ``RankReplicas``
holding its tp shards rank-major (``TensorParallelLM``), takes ``batch / dp``
sequences, and the gradients are averaged over dp before Adam (gradient
allreduce), which is what GSPMD's batch sharding computes in the JAX example.
The run checks that the loss fell and that the qkv weight is cut over tp.

The model is the JAX example's width 128 in float32 (heads of 16) on every
device (:func:`model_config`); on CUDA its head shards' attention runs
through the float32 K1-K3, on the CPU through their plain twins.
``--num-experts`` makes its blocks switch-MoE blocks (GELU experts, whole on
every tp shard) and ``--remat`` recomputes each block in the backward.

    python -m bluefog_tpu_torch.tensor_parallel_training
    python -m bluefog_tpu_torch.tensor_parallel_training --device cpu \\
        --steps 20 --tp 4
    python -m bluefog_tpu_torch.tensor_parallel_training --device cpu \\
        --steps 20 --num-experts 4 --remat
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch import basics
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from bluefog_tpu_torch.optim import optimizers as O
from bluefog_tpu_torch.parallel.tensor_parallel import (TensorParallelLM,
                                                        tp_param_specs,
                                                        tp_shard_params)
from bluefog_tpu_torch.replicas import RankReplicas

__all__ = ["synthetic_batch", "DataTensorParallelLM", "build_parser",
           "model_config", "main"]

VOCAB = 256


def synthetic_batch(batch: int, seq_len: int, seed: int = 0) -> np.ndarray:
    """``(batch, seq_len + 1)`` tokens of the JAX example's language: the
    next token is ``(cur * 5 + 3) % 256``, with 5% noise."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((batch, seq_len + 1), np.int64)
    for b in range(batch):
        for i in range(seq_len):
            toks[b, i + 1] = (toks[b, i] * 5 + 3) % VOCAB \
                if rng.rand() > 0.05 else rng.randint(VOCAB)
    return toks


class DataTensorParallelLM:
    """``dp`` data-parallel replicas of one ``TransformerLM`` (``cfg``), each
    a ``TensorParallelLM`` over ``tp`` rank-major shards and a row of one
    ``RankReplicas`` (``rep``; its ``flat`` holds a replica's shards side by
    side, so the dp combine averages each shard over dp alone).  Rank ``r``
    trains on ``tokens[r]`` against ``targets[r]`` (``(dp, B, S)``).  The
    weights are the unsharded model's ``reset_parameters`` from ``seed``,
    cut by ``tp_shard_params``; ``make_opt([flat])`` builds the distributed
    optimizer ``opt`` (``basics.init(dp)`` first)."""

    def __init__(self, cfg: TransformerConfig, tp: int, tokens, targets,
                 make_opt, seed: int = 0):
        dev = tokens.device
        dp = tokens.shape[0]
        full = TransformerLM(cfg).to(dev)
        full.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
        self.specs = tp_param_specs(full, tp)
        self.params_per_replica = sum(p.numel() for p in full.parameters())
        shards = tp_shard_params(full, full.state_dict(), tp)
        del full
        self.rep = RankReplicas(lambda: TensorParallelLM(cfg, tp), dp, dev)
        self.rep.load_state_dict(shards)
        del shards
        self.tokens, self.targets = tokens, targets
        self.opt = make_opt([self.rep.flat])

    def forward_backward(self) -> torch.Tensor:
        """The mean over the replicas of their next-token cross-entropy; each
        replica's gradients in ``rep.flat.grad``."""
        self.rep.zero_grad()
        losses = []
        for r, mod in enumerate(self.rep.modules):
            logits = mod(self.tokens[r])
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   self.targets[r].reshape(-1))
            loss.backward()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def step(self) -> torch.Tensor:
        loss = self.forward_backward()
        self.opt.step()
        return loss


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--tp", type=int, default=4, help="tensor-parallel ways")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual devices (the JAX example's device count)")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="switch-MoE blocks of this many GELU experts")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward")
    ap.add_argument("--device", default="cuda")
    return ap


def model_config(args) -> TransformerConfig:
    """The JAX example's model (``examples/tensor_parallel_training.py``),
    the same whatever ``args.device``; ``--num-experts`` makes its blocks
    switch-MoE blocks of GELU experts, ``--remat`` recomputes them."""
    return TransformerConfig(
        vocab_size=VOCAB, num_layers=2, num_heads=8, embed_dim=128,
        max_seq_len=args.seq_len, dtype=torch.float32,
        mlp="gelu" if args.num_experts else "swiglu",
        num_experts=args.num_experts, remat=args.remat)


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the run checks that the loss fell)")
    tp = args.tp
    if tp < 1 or args.ranks % tp:
        ap.error(f"--tp {tp} must divide the {args.ranks} ranks")
    dp = args.ranks // tp
    if args.batch % dp:
        ap.error(f"--batch {args.batch} must divide over {dp} dp ranks")
    dev = basics.resolve_device(args.device)
    cfg = model_config(args)
    toks = torch.from_numpy(synthetic_batch(args.batch, args.seq_len)).to(dev)
    tokens = toks[:, :-1].reshape(dp, -1, args.seq_len)
    targets = toks[:, 1:].reshape(dp, -1, args.seq_len)

    basics.init(dp, device=dev)
    try:
        lm = DataTensorParallelLM(
            cfg, tp, tokens, targets, lambda params:
            O.DistributedGradientAllreduceOptimizer(
                torch.optim.Adam(params, lr=args.lr)))
        losses = []
        for i in range(args.steps):
            losses.append(float(lm.step()))
            if (i + 1) % 50 == 0:
                print(f"step {i + 1}  loss {losses[-1]:.4f} ({dp}-way data "
                      f"x {tp}-way tensor parallel)", flush=True)
        qkv = lm.rep.modules[0].blocks[0].qkv.weight
        specs = lm.specs
    finally:
        basics.shutdown()
    l0, lf = losses[0], losses[-1]
    if not lf < l0:
        raise SystemExit(f"the loss did not fall: {l0} -> {lf}")
    # The layout took: the qkv weight is cut on its output dim over tp.
    E = cfg.embed_dim
    cut = specs["blocks.0.qkv.weight"]
    if cut != (tp, 0) or tuple(qkv.shape) != (tp, 3 * E // tp, E):
        raise SystemExit(f"qkv is not cut over tp: spec {cut}, "
                         f"shards {tuple(qkv.shape)}")
    print(f"done: loss {l0:.4f} -> {lf:.4f}; qkv weight cut on dim 0 into "
          f"{tp} shards of {tuple(qkv.shape[1:])} over dp {dp} x tp {tp}",
          flush=True)
    return {"losses": losses, "device": str(dev), "dp": dp, "tp": tp,
            "qkv_shards": list(qkv.shape)}


if __name__ == "__main__":
    main()
