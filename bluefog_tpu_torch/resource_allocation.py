"""Decentralized optimal exchange (resource allocation).

The port of ``examples/resource_allocation.py``: n nodes solve

    min_{x_i}  sum_i 1/2 ||A_i x_i - b_i||^2   s.t.  sum_i x_i = 0,

by distributed ADMM (local closed-form primal solves, the coupling
residual's mean through ``allreduce``) or by a dual decentralized method on
the price vector y (EXTRA, exact diffusion, gradient tracking through
``neighbor_allreduce`` over the half-weight combine ``(I + W) / 2`` of the
symmetric exponential graph); each node recovers its allocation
``x_i(y) = (A_i^T A_i)^-1 (A_i^T b_i - y)``.  The iterates are float64
numpy on the host, as in the JAX example; each collective rounds its
operand to float32 on the device, as the JAX package's eager ops do.  The
last line of the output is one JSON object.

    python -m bluefog_tpu_torch.resource_allocation --method extra
    python -m bluefog_tpu_torch.resource_allocation --device cpu \\
        --method admm
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

__all__ = ["METHODS", "build_parser", "main", "make_problem",
           "kkt_solution"]


def make_problem(n, m=10, d=5, seed=7):
    """Per-rank least squares pieces; H_i = A_i^T A_i invertible (m > d)."""
    rng = np.random.RandomState(seed)
    A = rng.rand(n, m, d)
    b = rng.rand(n, m, 1)
    Hinv = np.stack([np.linalg.inv(A[i].T @ A[i]) for i in range(n)])
    ATb = np.einsum("nmd,nmo->ndo", A, b)
    return A, b, Hinv, ATb


def kkt_solution(Hinv, ATb):
    """x_i = Hinv_i (ATb_i - y*), the price y* chosen so that the
    allocations clear: sum_i x_i = 0."""
    S = np.linalg.inv(Hinv.sum(0))
    y_star = S @ np.einsum("ndk,nko->ndo", Hinv, ATb).sum(0)
    x_star = np.einsum("ndk,nko->ndo", Hinv, ATb - y_star[None])
    return x_star, y_star


def allocations(y, Hinv, ATb):
    """x_i(y_i): each node's best response to its local price estimate."""
    return np.einsum("ndk,nko->ndo", Hinv, ATb - y)


def _dev(bf, x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(bf.device())


def _host(t):
    return t.cpu().numpy().astype(np.float64)


def rel_error(bf, x, x_star):
    """The network-averaged relative allocation error."""
    dist = np.sum((x - x_star) ** 2, axis=(1, 2)) / np.sum(x_star ** 2)
    return float(np.sqrt(bf.allreduce(_dev(bf, dist[:, None]),
                                      average=True).cpu().numpy().mean()))


def _mean(bf, x):
    return _host(bf.allreduce(_dev(bf, x), average=True))


def _nbr(bf, x):
    return _host(bf.neighbor_allreduce(_dev(bf, x)))


def admm(bf, A, b, Hinv, ATb, x_star, *, rho=1.0, iters=300):
    n, m, d = A.shape
    IpATA_inv = np.stack([
        np.linalg.inv(rho * np.eye(d) + A[i].T @ A[i]) for i in range(n)])
    x = np.zeros((n, d, 1))
    u = np.zeros((n, d, 1))
    errs = []
    for _ in range(iters):
        x = np.einsum("ndk,nko->ndo", IpATA_inv,
                      ATb + rho * (x - _mean(bf, x) - u))
        x_bar = _mean(bf, x)
        u = u + x_bar
        errs.append(rel_error(bf, x, x_star))
    return errs


def _record(bf, errs, t, iters, x, x_star, every=100):
    """The error metric is itself an allreduce: sampled sparsely."""
    if t % every == 0 or t == iters - 1:
        errs.append(rel_error(bf, x, x_star))


def extra(bf, Hinv, ATb, x_star, *, lr=0.02, iters=3000):
    """EXTRA on the dual: y <- W(y - lr g) + the correction from the
    previous combine."""
    n, d = Hinv.shape[0], Hinv.shape[1]
    y = np.zeros((n, d, 1))
    y_prev = np.zeros((n, d, 1))
    g_prev = np.zeros((n, d, 1))
    errs = []
    for t in range(iters):
        g = -allocations(y, Hinv, ATb)
        if t == 0:
            y_next = _nbr(bf, y - lr * g)
        else:
            y_next = _nbr(bf, 2 * y - y_prev - lr * (g - g_prev))
        y_prev, g_prev, y = y, g, y_next
        _record(bf, errs, t, iters, allocations(y, Hinv, ATb), x_star)
    return errs


def exact_diffusion(bf, Hinv, ATb, x_star, *, lr=0.02, iters=3000):
    n, d = Hinv.shape[0], Hinv.shape[1]
    y = np.zeros((n, d, 1))
    psi_prev = y.copy()
    errs = []
    for t in range(iters):
        g = -allocations(y, Hinv, ATb)
        psi = y - lr * g
        y = _nbr(bf, psi + y - psi_prev)
        psi_prev = psi
        _record(bf, errs, t, iters, allocations(y, Hinv, ATb), x_star)
    return errs


def gradient_tracking(bf, Hinv, ATb, x_star, *, lr=0.02, iters=3000):
    n, d = Hinv.shape[0], Hinv.shape[1]
    y = np.zeros((n, d, 1))
    g_prev = -allocations(y, Hinv, ATb)
    z = g_prev.copy()
    errs = []
    for t in range(iters):
        y = _nbr(bf, y - lr * z)
        g = -allocations(y, Hinv, ATb)
        z = _nbr(bf, z + g - g_prev)
        g_prev = g
        _record(bf, errs, t, iters, allocations(y, Hinv, ATb), x_star)
    return errs


METHODS = {"admm": admm, "extra": extra, "exact_diffusion": exact_diffusion,
           "gradient_tracking": gradient_tracking}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="extra", choices=sorted(METHODS))
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topology_util
    from bluefog_tpu_torch.basics import resolve_device

    dev = resolve_device(args.device)
    bf.init(args.ranks, device=dev)
    try:
        n = bf.size()
        # The half-weight combine W~ = (I + W) / 2: EXTRA and exact
        # diffusion diverge without it.
        G = topology_util.SymmetricExponentialGraph(n)
        W = topology_util.weight_matrix(G)
        W_half = (np.eye(n) + W) / 2
        bf.set_topology(topology_util.from_weight_matrix(W_half),
                        is_weighted=True)
        A, b, Hinv, ATb = make_problem(n)
        x_star, _ = kkt_solution(Hinv, ATb)
        if np.abs(x_star.sum(0)).max() >= 1e-8:
            raise RuntimeError("the KKT allocation does not clear")
        kwargs = {}
        if args.iters is not None:
            kwargs["iters"] = args.iters
        if args.lr is not None and args.method != "admm":
            kwargs["lr"] = args.lr
        fn = METHODS[args.method]
        errs = (fn(bf, A, b, Hinv, ATb, x_star, **kwargs)
                if args.method == "admm"
                else fn(bf, Hinv, ATb, x_star, **kwargs))
        iters_run = kwargs.get("iters",
                               300 if args.method == "admm" else 3000)
        print(f"{args.method}: relative allocation error after "
              f"{iters_run} iters = {errs[-1]:.3e}")
        res = {"device": str(dev), "ranks": n, "method": args.method,
               "iters": iters_run, "errors": errs}
        print(json.dumps(res), flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
