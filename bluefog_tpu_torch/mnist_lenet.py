"""MNIST LeNet-5 trained with a decentralized optimizer on a synthetic MNIST.

The port of ``examples/mnist_lenet.py``.  There is no dataset download:
each class is a fixed random 28x28 prototype plus noise (the JAX
example's ``synthetic_mnist``, same generators), and every rank trains on
its own disjoint shard through ``bf.data.ShardedLoader`` (static shards,
shuffled within).  ``--ranks`` LeNet-5 replicas (``RankReplicas``, one
initialization broadcast to every rank) step with Adam or SGD under
neighbor averaging (adapt-with-combine), allreduce, gradient allreduce or
no communication; ``--dynamic`` walks the one-peer Exp2 topology.  Each
epoch prints the held-out accuracy of every rank on its own held-out
shard.  ``main(argv, variables=...)`` starts from weights in the JAX
package's layout (flax ``params``) instead of the seeded initialization.
The last line of the output is one JSON object.

    python -m bluefog_tpu_torch.mnist_lenet
    python -m bluefog_tpu_torch.mnist_lenet --device cpu --epochs 6 \\
        --per-rank-samples 256 --batch-size 64
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["build_parser", "main", "synthetic_mnist"]


def synthetic_mnist(n_ranks, per_rank, seed=0, proto_seed=42):
    """Class prototypes fixed by ``proto_seed`` (the task); ``seed`` drives
    the sampled labels and noise."""
    prototypes = np.random.RandomState(proto_seed).randn(
        10, 28, 28, 1).astype(np.float32)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=(n_ranks, per_rank))
    xs = prototypes[ys] + 0.8 * rng.randn(
        n_ranks, per_rank, 28, 28, 1).astype(np.float32)
    return xs, ys


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--per-rank-samples", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--base-optimizer", choices=["adam", "sgd"],
                    default="adam")
    ap.add_argument("--dist-optimizer",
                    choices=["neighbor_allreduce", "allreduce",
                             "gradient_allreduce", "empty"],
                    default="neighbor_allreduce")
    ap.add_argument("--dynamic", action="store_true",
                    help="one-peer dynamic Exp2 topology")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, variables=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.basics import resolve_device
    from bluefog_tpu_torch.models.convert import (jax_ravel_order,
                                                  params_from_jax)
    from bluefog_tpu_torch.models.simple import LeNet5
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.replicas import RankReplicas

    dev = resolve_device(args.device)
    bf.init(args.ranks, device=dev)
    try:
        n = bf.size()
        xs, ys = synthetic_mnist(n, args.per_rank_samples)
        xt, yt = synthetic_mnist(n, 256, seed=123)  # held out

        order = jax_ravel_order(LeNet5())
        if variables is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            rep = RankReplicas(LeNet5, n, dev, order=order,
                               init=lambda m: m.reset_parameters(gen))
        else:
            rep = RankReplicas(LeNet5, n, dev, order=order)
            rep.load_state_dict(params_from_jax(LeNet5(), variables))
        flat = rep.flat
        base = (torch.optim.Adam([flat], lr=args.lr)
                if args.base_optimizer == "adam"
                else torch.optim.SGD([flat], lr=args.lr, momentum=0.9))
        if args.dist_optimizer == "gradient_allreduce":
            opt = O.DistributedGradientAllreduceOptimizer(base)
        else:
            opt = O.DistributedAdaptWithCombineOptimizer(
                base, O.CommunicationType[args.dist_optimizer],
                use_dynamic_topology=args.dynamic)

        xt_d = torch.from_numpy(xt).to(dev)
        yt_d = torch.from_numpy(yt).to(dev)

        @torch.no_grad()
        def accuracy():
            right = sum((rep.modules[r](xt_d[r]).argmax(-1) == yt_d[r])
                        .sum() for r in range(n))
            return float(right) / yt.size

        loader = bf.data.ShardedLoader(
            {"x": xs.reshape(-1, 28, 28, 1), "y": ys.reshape(-1)},
            batch_size=args.batch_size, seed=1, static_shards=True,
            num_ranks=n, device=dev)
        losses, accs = [], []
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                rep.zero_grad()
                step = []
                for r in range(n):
                    loss = F.cross_entropy(rep.modules[r](batch["x"][r]),
                                           batch["y"][r].long())
                    loss.backward()
                    step.append(loss.detach())
                opt.step()
                losses.append(torch.stack(step).cpu().numpy())
            acc = accuracy()
            accs.append(acc)
            print(f"epoch {epoch}  held-out accuracy {acc:.4f}")
        if acc <= 0.9:
            raise RuntimeError(f"training failed: accuracy {acc}")
        print(f"final accuracy {acc:.4f} "
              f"({args.dist_optimizer}, {n} ranks, "
              f"{'dynamic' if args.dynamic else 'static'} topology)")
        res = {"device": str(dev), "ranks": n, "epochs": args.epochs,
               "accuracy": accs,
               "loss_first": float(losses[0].mean()),
               "loss_last": float(losses[-1].mean()),
               "losses": np.stack(losses)}
        print(json.dumps({k: v for k, v in res.items() if k != "losses"}),
              flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
