"""Mixture-of-experts training over ep x dp: switch-routed experts sharded
across an expert-parallel axis, composed with decentralized data
parallelism.

The port of ``examples/moe_training.py``.  ``--ranks`` ranks form a
``dp x ep`` grid (``ep = --experts``).  Each dp replica owns its router
and trains on its own data; the expert bank is one expert a rank of the
ep axis (``parallel.moe_apply``, rank-major over ep: Switch top-1 routing
with a static capacity).  After the local SGD step the replicas are
combined over dp: static neighbor averaging over ``RingGraph(dp)`` with
uniform weights, or with ``--combine allreduce`` the dp mean.  The
objective is the task loss plus the Switch load-balancing loss, each
rank's divided by ``ep`` (the gradient convention of ``moe_apply``).
The data, the teachers and the initial weights come from the JAX
example's numpy generators, in float32.  The last line of the output is
one JSON object.

    python -m bluefog_tpu_torch.moe_training
    python -m bluefog_tpu_torch.moe_training --device cpu --steps 60 \\
        --combine allreduce
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

__all__ = ["build_parser", "main"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--experts", type=int, default=4,
                    help="expert-parallel ways (ep axis size)")
    ap.add_argument("--tokens", type=int, default=64, help="tokens per rank")
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--aux-weight", type=float, default=0.01)
    ap.add_argument("--combine", choices=["neighbor", "allreduce"],
                    default="neighbor")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the run checks that the loss fell)")
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.basics import resolve_device
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.parallel.moe import moe_apply

    dev = resolve_device(args.device)
    n, E = args.ranks, args.experts
    if E < 2 or n % E != 0:
        raise SystemExit(f"--experts {E} must be >= 2 and divide {n}")
    dp = n // E
    T, d = args.tokens, args.dim

    rng = np.random.RandomState(0)
    # A hidden linear gating matrix decides which teacher map serves each
    # token, so the linear router can learn the true routing rule.
    teachers = rng.randn(E, d, d).astype(np.float32)
    gating = rng.randn(d, E).astype(np.float32)

    def make_batch(seed):
        r = np.random.RandomState(seed)
        x = r.randn(dp, T, d).astype(np.float32)
        region = (x @ gating).argmax(-1)
        t = np.einsum("ptd,ptde->pte", x, teachers[region])
        return (torch.from_numpy(x).to(dev),
                torch.from_numpy(t.astype(np.float32)).to(dev))

    experts = torch.from_numpy(
        rng.randn(dp, E, d, d).astype(np.float32) * 0.3).to(dev)
    router = torch.from_numpy(
        rng.randn(dp, d, E).astype(np.float32) * 0.3).to(dev)

    if args.combine == "allreduce":
        def combine(a):
            return C.allreduce(a, average=True)
    else:
        sched = S.compile_static(topo.RingGraph(dp),
                                 use_topo_weights=False) if dp > 1 else None

        def combine(a):
            return C.neighbor_allreduce(a, sched) if dp > 1 else a

    lr, auxw = args.lr, args.aux_weight

    def step(experts, router, x, t):
        experts = experts.detach().requires_grad_(True)
        router = router.detach().requires_grad_(True)
        objective = 0.0
        tasks, auxes = [], []
        for p in range(dp):
            xe = x[p].expand(E, T, d)
            lg = xe @ router[p]                          # (E, T, E)
            y, aux = moe_apply(lambda w, z: z @ w[0], (experts[p],), xe, lg,
                               with_aux=True)
            task = ((y - t[p]) ** 2).mean(dim=(1, 2))    # (E,)
            objective = objective + ((task + auxw * aux) / E).sum()
            tasks.append(task[0].detach())
            auxes.append(aux[0].detach())
        g_e, g_r = torch.autograd.grad(objective, (experts, router))
        with torch.no_grad():
            experts = combine(experts - lr * g_e)
            router = combine(router - lr * g_r)
        return experts, router, torch.stack(tasks), torch.stack(auxes)

    first = last = None
    losses = []
    for s in range(args.steps):
        x, t = make_batch(100 + s)
        experts, router, task, aux = step(experts, router, x, t)
        last = float(task.mean())
        losses.append(last)
        if s == 0:
            first = last
        if s % 25 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  task {float(task.mean()):.4f}  "
                  f"aux {float(aux.mean()):.4f}")
    if not np.isfinite(last):
        raise RuntimeError("diverged")
    if not last < first:
        raise RuntimeError(f"no progress: {first:.4f} -> {last:.4f}")
    r = router.cpu().numpy()
    spread = float(np.abs(r - r.mean(0)).max())
    print(f"final task loss {last:.4f} (from {first:.4f}); "
          f"router replica spread {spread:.4f}")
    print("MOE-TRAINING-OK")
    res = {"device": str(dev), "dp": dp, "ep": E, "combine": args.combine,
           "steps": args.steps, "first": first, "last": last,
           "losses": losses, "router_spread": spread}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
