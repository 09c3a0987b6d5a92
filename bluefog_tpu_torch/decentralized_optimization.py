"""The decentralized optimization algorithm library on a distributed
logistic regression, each rank holding a private data shard.

The port of ``examples/decentralized_optimization.py``:

* diffusion (adapt-then-combine over a doubly-stochastic topology);
* exact diffusion (the bias-corrected recursion over ``(I + W) / 2``);
* gradient tracking (DIGing);
* push-DIGing (gradient tracking over a directed ring through push-sum,
  with the window family: ``win_accumulate`` and
  ``win_update_then_collect`` with the associated P).

Each is a rank-major eager loop over the port's neighbor ops.  The
gradients and iterates are float64 numpy on the host, as in the JAX
example; a neighbor op rounds its operand to float32 on the device, as the
JAX package's eager ops do (no float64 there), while a window keeps the
float64 rows it was created from and hands the collected rows back in
float32, as the JAX package's window ops do.  The last line of the output is one
JSON object.

    python -m bluefog_tpu_torch.decentralized_optimization
    python -m bluefog_tpu_torch.decentralized_optimization --device cpu \\
        --method push_diging
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

__all__ = ["ALGORITHMS", "build_parser", "main", "make_problem",
           "global_minimizer"]


def make_problem(n, dim=10, samples=40, seed=0, kind="logistic"):
    rng = np.random.RandomState(seed)
    w_star = rng.randn(dim, 1)
    A = rng.randn(n, samples, dim)
    if kind == "logistic":
        prob = 1.0 / (1.0 + np.exp(-A @ w_star))
        y = (rng.rand(n, samples, 1) < prob) * 2.0 - 1.0  # labels in {-1, 1}
    else:
        y = A @ w_star + 0.01 * rng.randn(n, samples, 1)
    return A.astype(np.float64), y.astype(np.float64), w_star


def logistic_grad(w, A, y, rho=1e-2):
    """Per-rank gradient of the regularized logistic loss; w: (n, dim, 1)."""
    margins = y * (A @ w)
    sig = 1.0 / (1.0 + np.exp(margins))
    g = -(A.transpose(0, 2, 1) @ (y * sig)) / A.shape[1]
    return g + rho * w


def global_minimizer(A, y, rho=1e-2, iters=4000, lr=0.5):
    """The centralized full-batch solution all algorithms chase."""
    n, s, dim = A.shape
    Af = A.reshape(n * s, dim)[None]
    yf = y.reshape(n * s, 1)[None]
    w = np.zeros((1, dim, 1))
    for _ in range(iters):
        w -= lr * logistic_grad(w, Af, yf, rho)
    return w[0]


def _nbr(bf, x):
    """``neighbor_allreduce`` of a host float64 array, in float32 on the
    context's device; back as float64."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(bf.device())
    return bf.neighbor_allreduce(t).cpu().numpy().astype(np.float64)


def diffusion(bf, A, y, *, lr=0.5, iters=200, rho=1e-2):
    """ATC diffusion: x <- combine(x - lr * grad(x))."""
    n = A.shape[0]
    x = np.zeros((n, A.shape[2], 1))
    for _ in range(iters):
        half = x - lr * logistic_grad(x, A, y, rho)
        x = _nbr(bf, half)
    return x


def exact_diffusion(bf, A, y, *, lr=0.5, iters=600, rho=1e-2):
    """Exact diffusion: psi_k = x_k - lr grad(x_k); phi_k = psi_k + x_k -
    psi_{k-1}; x_{k+1} = ((I + W) / 2) phi_k."""
    n = A.shape[0]
    x = np.zeros((n, A.shape[2], 1))
    psi_prev = x.copy()
    for k in range(iters):
        psi = x - lr * logistic_grad(x, A, y, rho)
        phi = psi + x - psi_prev if k > 0 else psi
        x = 0.5 * phi + 0.5 * _nbr(bf, phi)
        psi_prev = psi
    return x


def gradient_tracking(bf, A, y, *, lr=0.5, iters=1000, rho=1e-2):
    """DIGing: x_{k+1} = combine(x_k) - lr q_k; q_{k+1} = combine(q_k) +
    grad(x_{k+1}) - grad(x_k)."""
    n = A.shape[0]
    x = np.zeros((n, A.shape[2], 1))
    g = logistic_grad(x, A, y, rho)
    q = g.copy()
    for _ in range(iters):
        x_new = _nbr(bf, x) - lr * q
        g_new = logistic_grad(x_new, A, y, rho)
        q = _nbr(bf, q) + g_new - g
        x, g = x_new, g_new
    return x


def push_diging(bf, A, y, *, lr=0.2, iters=1500, rho=1e-2):
    """Push-DIGing: gradient tracking on a directed graph with
    column-stochastic push weights and de-bias scalars, over the window
    family (one window carries ``cat(x, q)``)."""
    from bluefog_tpu_torch import topology as topo_mod
    n = A.shape[0]
    dim = A.shape[2]
    dev = bf.device()
    topo = bf.load_topology()
    outs = [topo_mod.out_neighbor_ranks(topo, r) for r in range(n)]
    share = np.array([1.0 / (len(o) + 1.0) for o in outs])
    dstw = {(r, o): share[r] for r in range(n) for o in outs[r]}

    bf.turn_on_win_ops_with_associated_p()
    xq = np.zeros((n, 2 * dim, 1))
    g = logistic_grad(xq[:, :dim], A, y, rho)
    xq[:, dim:] = g
    bf.win_create(torch.from_numpy(xq).to(dev), "push_diging",
                  zero_init=True)
    try:
        for _ in range(iters):
            xq = xq.copy()
            xq[:, :dim] = xq[:, :dim] - lr * xq[:, dim:]
            bf.win_accumulate(torch.from_numpy(xq).to(dev), "push_diging",
                              self_weight=share, dst_weights=dstw)
            # Back in float32, as the JAX package's window ops hand rows
            # out (no float64 there); the window itself keeps float64.
            xq = bf.win_update_then_collect("push_diging").float().cpu() \
                .numpy().astype(np.float64)
            p = np.asarray(bf.win_associated_p("push_diging"))
            z_new = xq[:, :dim] / p[:, None, None]
            g_new = logistic_grad(z_new, A, y, rho)
            xq[:, dim:] += g_new - g
            g = g_new
        p = np.asarray(bf.win_associated_p("push_diging"))
        return xq[:, :dim] / p[:, None, None]
    finally:
        bf.win_free("push_diging")
        bf.turn_off_win_ops_with_associated_p()


ALGORITHMS = {
    "diffusion": diffusion,
    "exact_diffusion": exact_diffusion,
    "gradient_tracking": gradient_tracking,
    "push_diging": push_diging,
}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", choices=list(ALGORITHMS) + ["all"],
                    default="all")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="override each algorithm's tuned default")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.basics import resolve_device

    dev = resolve_device(args.device)
    bf.init(args.ranks, device=dev)
    try:
        n = bf.size()
        A, y, _ = make_problem(n)
        w_opt = global_minimizer(A, y)
        methods = list(ALGORITHMS) if args.method == "all" \
            else [args.method]
        res = {"device": str(dev), "ranks": n, "errors": {}, "x": {}}
        for name in methods:
            if name == "push_diging":
                bf.set_topology(topology.RingGraph(n, connect_style=2))
            else:
                bf.set_topology(topology.ExponentialTwoGraph(n))
            kw = {}
            if args.lr is not None:
                kw["lr"] = args.lr
            if args.max_iters is not None:
                kw["iters"] = args.max_iters
            x = ALGORITHMS[name](bf, A, y, **kw)
            err = np.linalg.norm(x - w_opt[None]) / max(
                np.linalg.norm(w_opt), 1e-12)
            print(f"{name:18s} relative error vs global minimizer: "
                  f"{err:.3e}")
            res["errors"][name] = float(err)
            res["x"][name] = x
        print(json.dumps({k: v for k, v in res.items() if k != "x"}),
              flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
