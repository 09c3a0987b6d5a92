"""Average consensus: every rank holds a random vector, and repeated
neighbor averaging drives all ranks to the global mean.

The port of ``examples/average_consensus.py``: ``--ranks`` virtual ranks
rank-major on one device, a static ring (``neighbor_allreduce``) or, with
``--dynamic``, the one-peer dynamic walk over ``ExponentialTwoGraph``
(``dynamic_neighbor_allreduce``, exact consensus in log2(n) steps).  The
vectors come from numpy's global generator, as in the JAX example (a
caller of ``main`` seeds it to repeat a run).  The rows are float32, as
the JAX package's eager ops hold them.  The last line of the output is
one JSON object.

    python -m bluefog_tpu_torch.average_consensus
    python -m bluefog_tpu_torch.average_consensus --device cpu --dynamic
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

__all__ = ["build_parser", "main"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=1000)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--dynamic", action="store_true",
                    help="one-peer dynamic Exp2 instead of static ring")
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
        if not args.dynamic:
            bf.set_topology(topology.RingGraph(n), is_weighted=True)
        x0 = np.random.randn(n, args.dim).astype(np.float32)
        target = torch.from_numpy(x0.mean(axis=0)).to(dev)
        x = torch.from_numpy(x0).to(dev)
        errors = []
        for t in range(args.max_iters):
            if args.dynamic:
                x = bf.dynamic_neighbor_allreduce(x, t)
            else:
                x = bf.neighbor_allreduce(x)
            err = float((x - target).abs().max())
            errors.append(err)
            if t % 20 == 0 or err < 1e-6:
                print(f"iter {t:4d}  max consensus error {err:.3e}")
            if err < 1e-6:
                break
        if err >= 1e-4:
            raise RuntimeError(f"consensus failed: {err}")
        print(f"consensus reached in {t + 1} iterations "
              f"({'dynamic exp2' if args.dynamic else 'static ring'}, "
              f"{n} ranks)")
        res = {"device": str(dev), "ranks": n, "dynamic": args.dynamic,
               "iterations": t + 1, "errors": errors,
               "x": x.cpu().numpy()}
        print(json.dumps({k: v for k, v in res.items() if k != "x"}),
              flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
