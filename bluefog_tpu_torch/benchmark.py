"""Throughput benchmark: decentralized TransformerLM training on one device.

The port of the transformer branch of ``examples/benchmark.py``: synthetic
tokens from ``--seed`` (each rank its own), next-token cross-entropy against
``roll(tokens, -1, axis=1)``, SGD with ``lr = 0.0125 * ranks``, ATC or AWC
neighbor averaging over the static or dynamic one-peer topology, and the
``--num-warmup-batches`` then ``--num-iters x --num-batches-per-iter``
protocol.  All ``--ranks`` virtual ranks live on one device and run forward
and backward one after another, so one rank's activations are live at a
time; their parameters are rows of one flat buffer (``replicas``).

    python -m bluefog_tpu_torch.benchmark --flash-attention --atc --dynamic \\
        --num-layers 24 --embed-dim 2048 --num-heads 16 --seq-len 2048 \\
        --batch-size 2 --momentum 0 --ranks 4

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["build_parser", "Trainer", "measure", "consensus_spread",
           "main"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-warmup-batches", type=int, default=10)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-batches-per-iter", type=int, default=10)
    ap.add_argument("--atc", action="store_true",
                    help="adapt-then-combine order (default AWC)")
    ap.add_argument("--dynamic", action="store_true",
                    help="dynamic one-peer topology (the phase table of "
                         "ExponentialGraph(ranks))")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--flash-attention", action="store_true",
                    help="use the hand-written flash-attention kernels "
                         "instead of dense attention")
    ap.add_argument("--num-layers", type=int, default=4)
    ap.add_argument("--embed-dim", type=int, default=512)
    ap.add_argument("--num-heads", type=int, default=8)
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="SGD momentum (0 drops the momentum buffer)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="virtual ranks, all on the one device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


@torch.no_grad()
def consensus_spread(flat: torch.Tensor, chunk: int = 1 << 24) -> float:
    """Largest deviation of any rank's parameter from the rank mean."""
    worst = torch.zeros((), device=flat.device)
    for cols in flat.split(chunk, dim=1):
        worst = torch.maximum(
            worst, (cols - cols.mean(0, keepdim=True)).abs().amax())
    return float(worst)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """The benchmark's training setup: ``ranks`` replicas of the model on
    one device, their per-rank tokens, and the distributed optimizer."""

    def __init__(self, args):
        import bluefog_tpu_torch as bf
        from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
        from bluefog_tpu_torch.ops.flash_attention import \
            flash_attention_impl
        from bluefog_tpu_torch.optim import optimizers as O
        from bluefog_tpu_torch.replicas import RankReplicas

        bf.init(args.ranks, device=args.device)
        self.n, self.device = bf.size(), bf.device()
        self.cfg = TransformerConfig(
            vocab_size=args.vocab_size, num_layers=args.num_layers,
            num_heads=args.num_heads, embed_dim=args.embed_dim,
            max_seq_len=args.seq_len)
        attn = flash_attention_impl() if args.flash_attention else None
        gen = torch.Generator(device=self.device).manual_seed(args.seed)
        self.rep = RankReplicas(lambda: TransformerLM(self.cfg, attn),
                                self.n, self.device,
                                init=lambda m: m.reset_parameters(gen))
        self.tokens = torch.randint(0, args.vocab_size,
                                    (self.n, args.batch_size, args.seq_len),
                                    generator=gen, device=self.device)
        self.targets = torch.roll(self.tokens, -1, dims=2)
        base = torch.optim.SGD([self.rep.flat], lr=0.0125 * self.n,
                               momentum=args.momentum, dampening=0)
        cls = (O.DistributedAdaptThenCombineOptimizer if args.atc
               else O.DistributedAdaptWithCombineOptimizer)
        self.opt = cls(base, use_dynamic_topology=args.dynamic)

    def forward_backward(self) -> torch.Tensor:
        """Every rank's forward and backward, one after another; returns
        the per-rank losses."""
        self.rep.zero_grad()
        losses = []
        for r in range(self.n):
            logits = self.rep.modules[r](self.tokens[r])
            loss = F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                                   self.targets[r].reshape(-1))
            loss.backward()
            losses.append(loss.detach())
        return torch.stack(losses)


def measure(args) -> dict:
    """Run the benchmark; returns its numbers (rates in tokens/s over all
    ranks on the one device)."""
    tr = Trainer(args)
    n, dev, rep, opt = tr.n, tr.device, tr.rep, tr.opt
    forward_backward = tr.forward_backward

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spread = None
    losses = None
    for i in range(args.num_warmup_batches):
        losses = forward_backward()
        if i == 0 and args.atc:
            # One observed ATC step: the ranks' spread after the local
            # update and after the neighbor combine.
            opt.adapt()
            before = consensus_spread(rep.flat)
            opt.combine()
            spread = {"after_adapt": before,
                      "after_combine": consensus_spread(rep.flat)}
        else:
            opt.step()
    _sync(dev)

    rates, step_s = [], []
    tokens_per_batch = n * args.batch_size * args.seq_len
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            losses = forward_backward()
            opt.step()
        _sync(dev)
        dt = time.perf_counter() - t0
        rates.append(tokens_per_batch * args.num_batches_per_iter / dt)
        step_s.append(dt / args.num_batches_per_iter)
        print(f"iter {i}: {rates[-1]:.1f} tokens/sec across {n} ranks "
              f"on {dev}", flush=True)

    out = {
        "device": str(dev),
        "ranks": n,
        "params_per_rank": rep.numel,
        "step_ms": 1e3 * float(np.mean(step_s)),
        "tokens_per_s": float(np.mean(rates)),
        "tokens_per_s_ci": 1.96 * float(np.std(rates)),
        "losses": [float(x) for x in losses.cpu()],
        "spread": spread,
        "steps": opt.step_count,
    }
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    res = measure(args)
    print(f"total tokens/sec: {res['tokens_per_s']:.1f} +- "
          f"{res['tokens_per_s_ci']:.1f} ({res['ranks']} ranks on "
          f"{res['device']}, step {res['step_ms']:.1f} ms)")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
