"""Pipeline-parallel training: a deep net split into one stage a rank.

The port of ``examples/pipeline_training.py``: each of ``--stages`` ranks
holds one layer of a tanh MLP, and Adam trains it on a learnable regression
through one of the schedules of ``parallel.pipeline``: ``gpipe`` (autograd
through ``pipeline_apply``, ``M + n - 1`` ticks, every stage's graph kept),
``1f1b`` (``pipeline_train_step``: the backward recomputes each stage from its
stashed input, O(n) residency) or ``zb`` (the same with ZB-H1's split
backward: input gradients on the backward tick, weight gradients deferred to
idle ticks; the same gradients).  The stages run rank-major in this process
(the JAX example's devices).  The run checks that the pipelined forward equals
the layers run in sequence and that the loss fell.  The data are the JAX
example's, drawn from ``numpy.random.RandomState(0)``.

    python -m bluefog_tpu_torch.pipeline_training --schedule 1f1b
    python -m bluefog_tpu_torch.pipeline_training --device cpu --steps 30
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                 pipeline_train_step)

__all__ = ["build_parser", "main"]


def _stage(p, x):
    W, b = p
    return torch.tanh(x @ W + b)


def _mse(y, t):
    return ((y - t) ** 2).mean()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--microbatch-size", type=int, default=16)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--schedule", choices=["gpipe", "1f1b", "zb"],
                    default="gpipe",
                    help="gpipe: autograd through pipeline_apply (O(M) "
                         "stage graphs); 1f1b: recompute from the stash "
                         "(O(n) residency); zb: 1f1b with ZB-H1's split "
                         "backward")
    ap.add_argument("--stages", type=int, default=8,
                    help="pipeline stages (the JAX example's devices)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the run checks that the loss fell)")
    dev = basics.resolve_device(args.device)
    n, M, mb, d = args.stages, args.microbatches, args.microbatch_size, \
        args.width
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    Ws = t(rng.randn(n, d, d) * (1.0 / np.sqrt(d))).requires_grad_()
    bs = torch.zeros(n, d, device=dev, requires_grad=True)
    x = t(rng.randn(M, mb, d))
    y = torch.tanh(x @ t(rng.randn(d, d) * 0.3))    # the learnable target
    opt = torch.optim.Adam([Ws, bs], lr=args.lr)
    losses = []
    for i in range(args.steps):
        opt.zero_grad()
        if args.schedule == "gpipe":
            loss = _mse(pipeline_apply(_stage, (Ws, bs), x, axis=n), y)
            loss.backward()
        else:
            loss, (gW, gb) = pipeline_train_step(
                _stage, (Ws, bs), x, y, _mse, axis=n,
                split_backward=args.schedule == "zb")
            Ws.grad, bs.grad = gW, gb
        opt.step()
        losses.append(float(loss))
        if (i + 1) % 50 == 0:
            print(f"step {i + 1}  loss {losses[-1]:.5f} ({n} stages x {M} "
                  f"microbatches, {args.schedule})", flush=True)
    # The pipelined forward equals the layers run in sequence.
    with torch.no_grad():
        got = pipeline_apply(_stage, (Ws, bs), x, axis=n)
        ref = x
        for s in range(n):
            ref = _stage((Ws[s], bs[s]), ref)
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-5):
        raise SystemExit(f"the pipelined forward differs from the "
                         f"sequential stack by {err}")
    l0, lf = losses[0], losses[-1]
    if not lf < l0:
        raise SystemExit(f"the loss did not fall: {l0} -> {lf}")
    print(f"done: loss {l0:.5f} -> {lf:.5f}; pipelined forward matches the "
          f"sequential stack (GPipe depth {M + n - 1} ticks, 1F1B "
          f"{2 * M + 2 * n - 2})", flush=True)
    return {"losses": losses, "device": str(dev), "stages": n,
            "schedule": args.schedule, "forward_max_abs_err": err}


if __name__ == "__main__":
    main()
