"""Decentralized image-classification training, the whole protocol.

The port of ``examples/resnet_training.py``: per-rank data shards, the
initial parameters broadcast from rank 0, the dist-optimizer grid
(neighbor averaging, hierarchical, allreduce, gradient allreduce, win_put,
none), adapt-with-combine or ``--atc-style``, the dynamic one-peer
topology (on unless ``--disable-dynamic-topology``), local aggregation
(``--batches-per-communication``), a learning rate warmed up linearly to
``base_lr * ranks`` and cut tenfold at 2/3 and 5/6 of training (a function
of the update count, as the JAX example's optax schedule, so the position
survives a resume), per-epoch validation, and a checkpoint an epoch with
resume (``--checkpoint-dir``; ``utils/checkpoint.py``, DCP: the JAX
package's orbax checkpoints do not load here).

The data is the JAX example's class-conditional Gaussian images, from the
same generators.  ``--model`` is ``resnet18``/``34``/``50`` (bfloat16 with
rank-local BN statistics), ``lenet`` or a small float32 ``vit``.
``main(argv, variables=...)`` starts from weights in the JAX package's
layout (flax ``params`` and ``batch_stats``) instead of the seeded
initialization.  The last line of the output is one JSON object.

    python -m bluefog_tpu_torch.resnet_training --model resnet18 --epochs 3
    python -m bluefog_tpu_torch.resnet_training --device cpu --model lenet \\
        --image-size 28 --samples-per-rank 256 --batch-size 16 --epochs 5 \\
        --base-lr 0.005
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["build_parser", "main", "make_dataset", "lr_at"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "resnet34", "resnet50", "lenet",
                             "vit"])
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--samples-per-rank", type=int, default=512)
    ap.add_argument("--val-samples", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-rank batch size")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--base-lr", type=float, default=0.0125)
    ap.add_argument("--warmup-epochs", type=float, default=1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--dist-optimizer", default="neighbor_allreduce",
                    choices=["neighbor_allreduce", "allreduce",
                             "hierarchical", "gradient_allreduce", "win_put",
                             "empty"])
    ap.add_argument("--atc-style", action="store_true")
    ap.add_argument("--disable-dynamic-topology", action="store_true")
    ap.add_argument("--batches-per-communication", type=int, default=1,
                    help="local aggregation: communicate every J batches")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save a checkpoint per epoch; resume if present")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def make_dataset(n_ranks, per_rank, image, classes, seed, *,
                 pattern_seed=0):
    """Class-conditional Gaussians: class c has mean pattern_c; the
    patterns are fixed by ``pattern_seed``, the samples drawn from
    ``seed``."""
    patterns = np.random.RandomState(pattern_seed).randn(
        classes, image, image, 3).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=(n_ranks, per_rank))
    x = 0.35 * rng.randn(n_ranks, per_rank, image, image, 3) \
        .astype(np.float32) + patterns[y]
    return x, y


def lr_at(count: int, args, n: int, batches_per_epoch: int) -> float:
    """The learning rate of update ``count``: linear from ``base_lr`` to
    ``base_lr * n`` over the warmup, then x0.1 at 2/3 and again at 5/6 of
    training (the JAX example's ``lr_schedule``, in float32 as optax
    computes it)."""
    warm = max(1, int(args.warmup_epochs * batches_per_epoch))
    total = args.epochs * batches_per_epoch
    peak = np.float32(args.base_lr * n)
    b1 = max(1, int(total * 2 / 3) - warm)
    b2 = max(b1 + 1, int(total * 5 / 6) - warm)
    if count < warm:
        frac = np.float32(1.0) - np.float32(count) / np.float32(warm)
        return float((np.float32(args.base_lr) - peak) * frac + peak)
    c = count - warm
    v = peak
    for b in (b1, b2):
        if c >= b:
            v = v * np.float32(0.1)
    return float(v)


def _make_model(args):
    from bluefog_tpu_torch.models import resnet as R
    from bluefog_tpu_torch.models.simple import LeNet5
    from bluefog_tpu_torch.models.vit import ViT
    if args.model == "lenet":
        return (lambda: LeNet5(num_classes=args.num_classes,
                               in_channels=3)), False
    if args.model == "vit":
        # The patch must divide the image: the largest divisor at most
        # image_size // 4.
        patch = next(p for p in range(max(2, args.image_size // 4), 0, -1)
                     if args.image_size % p == 0)
        return (lambda: ViT(num_classes=args.num_classes,
                            image_size=args.image_size, patch_size=patch,
                            embed_dim=64, num_layers=4, num_heads=4,
                            dtype=torch.float32)), False
    cls = getattr(R, args.model.replace("resnet", "ResNet"))
    return (lambda: cls(num_classes=args.num_classes)), True


def _optimizer(args, base):
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.optim import window_optimizers as WO
    j = args.batches_per_communication
    if args.dist_optimizer == "gradient_allreduce":
        return O.DistributedGradientAllreduceOptimizer(
            base, num_steps_per_communication=j)
    if args.dist_optimizer == "win_put":
        return WO.DistributedWinPutOptimizer(
            base, num_steps_per_communication=j)
    comm = {"neighbor_allreduce": "neighbor_allreduce",
            "allreduce": "allreduce",
            "hierarchical": "hierarchical_neighbor_allreduce",
            "empty": "empty"}[args.dist_optimizer]
    cls = (O.DistributedAdaptThenCombineOptimizer if args.atc_style
           else O.DistributedAdaptWithCombineOptimizer)
    return cls(base, O.CommunicationType[comm],
               use_dynamic_topology=not args.disable_dynamic_topology,
               num_steps_per_communication=j)


def main(argv=None, variables=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.basics import resolve_device
    from bluefog_tpu_torch.models.convert import (jax_ravel_order,
                                                  params_from_jax)
    from bluefog_tpu_torch.replicas import RankReplicas
    from bluefog_tpu_torch.utils import checkpoint

    dev = resolve_device(args.device)
    n = args.ranks
    bf.init(n, device=dev,
            local_size=None if args.dist_optimizer != "hierarchical"
            else max(1, n // 2))
    try:
        make, has_bn = _make_model(args)
        x_train, y_train = make_dataset(n, args.samples_per_rank,
                                        args.image_size, args.num_classes,
                                        args.seed)
        x_val, y_val = make_dataset(n, max(1, args.val_samples // n),
                                    args.image_size, args.num_classes,
                                    args.seed + 1)
        x_val = x_val.reshape(-1, *x_val.shape[2:])
        y_val = y_val.reshape(-1)

        order = jax_ravel_order(make())
        if variables is None:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            rep = RankReplicas(make, n, dev, order=order,
                               init=lambda m: m.reset_parameters(gen))
        else:
            rep = RankReplicas(make, n, dev, order=order)
            rep.load_state_dict(params_from_jax(make(), variables))
        flat = rep.flat
        with torch.no_grad():
            flat.copy_(bf.broadcast_parameters(flat, root_rank=0))

        batches_per_epoch = args.samples_per_rank // args.batch_size
        if batches_per_epoch < 1:
            raise SystemExit(
                f"--batch-size {args.batch_size} exceeds --samples-per-rank "
                f"{args.samples_per_rank}: no full batch per epoch")
        base = torch.optim.SGD([flat], lr=lr_at(0, args, n,
                                                 batches_per_epoch),
                               momentum=args.momentum)
        opt = _optimizer(args, base)
        count = 0

        def momentum_buffer():
            buf = base.state.get(flat, {}).get("momentum_buffer")
            return torch.zeros_like(flat) if buf is None else buf

        def buffers():
            return {f"{r}.{k}": v for r in range(n)
                    for k, v in rep.rank_buffers(r).items()}

        start_epoch = 0
        if args.checkpoint_dir:
            latest = checkpoint.latest_step(args.checkpoint_dir)
            if latest is not None:
                tmpl = {"params": flat.detach(), "momentum": momentum_buffer(),
                        "count": np.zeros((), np.int64),
                        **({"bstats": buffers()} if has_bn else {}),
                        "epoch": np.zeros((), np.int32)}
                back = checkpoint.restore(args.checkpoint_dir, step=latest,
                                          target=tmpl)
                with torch.no_grad():
                    flat.copy_(back["params"])
                    if has_bn:
                        for k, v in buffers().items():
                            v.copy_(back["bstats"][k])
                base.state[flat]["momentum_buffer"] = \
                    back["momentum"].clone()
                count = int(np.asarray(back["count"]).reshape(-1)[0])
                opt.step_count = count
                start_epoch = int(np.asarray(back["epoch"]).reshape(-1)[0]) + 1
                print(f"resumed from epoch {start_epoch - 1}")

        xv = torch.from_numpy(x_val).to(dev)

        @torch.no_grad()
        def validate():
            m = rep.modules[0]
            m.eval()
            logits = m(xv)
            m.train()
            return float((logits.argmax(-1).cpu().numpy() == y_val).mean())

        rng = np.random.RandomState(args.seed)
        acc = validate() if start_epoch >= args.epochs else None
        epoch_losses = []
        step_losses = []
        for epoch in range(start_epoch, args.epochs):
            order_ = rng.permutation(args.samples_per_rank)
            t0 = time.time()
            running = 0.0
            for b in range(batches_per_epoch):
                idx = order_[b * args.batch_size:(b + 1) * args.batch_size]
                xb = torch.from_numpy(x_train[:, idx]).to(dev)
                yb = torch.from_numpy(y_train[:, idx]).to(dev)
                rep.zero_grad()
                losses = []
                for r in range(n):
                    loss = F.cross_entropy(rep.modules[r](xb[r]),
                                           yb[r].long())
                    loss.backward()
                    losses.append(loss.detach())
                for group in base.param_groups:
                    group["lr"] = lr_at(count, args, n, batches_per_epoch)
                opt.step()
                count += 1
                step = torch.stack(losses).cpu().numpy()
                step_losses.append(step)
                running += float(step.mean())
            acc = validate()
            epoch_losses.append(running / batches_per_epoch)
            print(f"epoch {epoch}: loss {running / batches_per_epoch:.4f} "
                  f"val_acc {acc:.3f} ({time.time() - t0:.1f}s)")
            if args.checkpoint_dir:
                checkpoint.save(
                    args.checkpoint_dir,
                    {"params": flat.detach(), "momentum": momentum_buffer(),
                     "count": np.asarray(count, np.int64),
                     **({"bstats": buffers()} if has_bn else {}),
                     "epoch": np.asarray(epoch, np.int32)}, step=epoch)
        if args.dist_optimizer == "win_put":
            opt.free()
        print(f"final val_acc {acc:.3f}")
        res = {"device": str(dev), "model": args.model, "ranks": n,
               "start_epoch": start_epoch, "epoch_losses": epoch_losses,
               "val_acc": acc,
               "step_losses": (np.stack(step_losses) if step_losses
                               else np.zeros((0, n))),
               "params": flat.detach().cpu().clone()}
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("step_losses", "params")}),
              flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
