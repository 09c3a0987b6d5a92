"""Benchmark the one-sided (window) gossip family: DP-7/8/9's data plane.

The port of ``examples/window_benchmark.py``.  It times the window store
and transport that back ``win_put`` / ``win_accumulate`` / ``win_update``
and the async optimizers:

  * per-op wall time and GB/s of a ResNet-50-sized row a rank
    (``win_put`` over every edge, ``win_accumulate``, ``win_update``,
    ``win_update_then_collect``);
  * the dispatch latency of a nonblocking put (the overlap window);
  * device<->host copies of one row (the staging a remote put pays);
  * the DP-7 step (``DistributedWinPutOptimizer``, also with
    ``overlap=True``) against the synchronous DP-3 step
    (``DistributedNeighborAllreduceOptimizer``) on a small model;
  * with ``--multiproc``, itself under the port's bfrun
    (``python -m bluefog_tpu_torch.run -np 2 --devices-per-proc 2``): puts a
    second and bytes a second for each edge that crosses the process
    boundary, without and with ``bf16`` wire compression, and in the
    owned-rows layout.

Usage:
  python -m bluefog_tpu_torch.window_benchmark [--elements N] [--rounds R]
  python -m bluefog_tpu_torch.window_benchmark --multiproc
  (add ``--device cpu`` on a machine without a GPU)

The ``RANKS`` = 8 virtual ranks (the JAX example's 8-device CPU mesh) live
on one device.  Every timed call ends with
``torch.cuda.synchronize()`` on the card before the host clock is read.
The multi-process children use gloo for control and card
``BFTPU_LOCAL_ID`` modulo the cards present (both on card 0 of a one-card
machine); their rows cross the window transport's loopback socket.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

__all__ = ["main", "single_process"]

_MP_CHILD = "_WINBENCH_CHILD"
RANKS = 8


def _timeit(fn, rounds, device="cpu"):
    """Seconds a call of ``fn`` after one warm call; on the card each
    timed stretch ends with a synchronize."""
    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fn()  # warm caches / first dispatch
    sync()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    sync()
    return (time.perf_counter() - t0) / rounds


def _randn(rows, cols, device, seed):
    """Seeded float32 normal rows, drawn on ``device`` (the JAX example
    draws them with numpy on the host; 818 MB at the default width)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, cols, generator=gen, device=device)


def single_process(args) -> dict:
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.basics import resolve_device

    dev = str(resolve_device(args.device))
    cuda = dev.startswith("cuda")
    bf.init(RANKS, device=dev,
            topology_fn=lambda: topo.ExponentialTwoGraph(RANKS))
    n = bf.size()
    P = args.elements
    mb = P * 4 / 1e6
    x = _randn(n, P, dev, seed=0)
    out = {"n": n, "elements": P, "mb_per_rank": mb}
    print(f"window store: {n} ranks, {mb:.1f} MB/rank fused buffer on {dev}")
    dkind = "cuda" if cuda else "cpu"
    try:
        assert bf.win_create(x, "bench")
        edges = sum(len(bf.out_neighbor_ranks(r)) for r in range(n))

        t = _timeit(lambda: bf.win_put(x, "bench"), args.rounds, dkind)
        out["win_put_s"] = t
        print(f"win_put   (all {edges} edges): {t*1e3:8.1f} ms "
              f"({edges * mb / t / 1e3:6.2f} GB/s aggregate)")

        t = _timeit(lambda: bf.win_accumulate(x, "bench"), args.rounds,
                    dkind)
        out["win_accumulate_s"] = t
        print(f"win_accumulate               : {t*1e3:8.1f} ms")

        t = _timeit(lambda: bf.win_update("bench"), args.rounds, dkind)
        out["win_update_s"] = t
        print(f"win_update (combine)         : {t*1e3:8.1f} ms")

        t = _timeit(lambda: bf.win_update_then_collect("bench"),
                    args.rounds, dkind)
        out["win_update_then_collect_s"] = t
        print(f"win_update_then_collect      : {t*1e3:8.1f} ms")

        # Overlap window: the nonblocking put returns at once and runs on
        # the worker pool while the caller computes.
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = bf.win_put_nonblocking(x, "bench")
        t_dispatch = time.perf_counter() - t0
        bf.win_wait(h)
        out["dispatch_s"] = t_dispatch
        print(f"nonblocking dispatch latency : {t_dispatch*1e6:8.1f} us "
              f"(put completes on the worker pool)")
    finally:
        bf.win_free("bench")

    # Device<->host copies of one row: what a remote put stages.
    xd = x[0].contiguous()
    host = x[0].to("cpu", copy=True)
    t = _timeit(lambda: xd.to("cpu", copy=True), args.rounds, dkind)
    out["device_to_host_s"] = t
    print(f"device->host ({mb:.0f} MB)      : {t*1e3:8.1f} ms "
          f"({mb / t / 1e3:6.2f} GB/s)")
    t = _timeit(lambda: host.to(dev, copy=True), args.rounds, dkind)
    out["host_to_device_s"] = t
    print(f"host->device ({mb:.0f} MB)      : {t*1e3:8.1f} ms "
          f"({mb / t / 1e3:6.2f} GB/s)")

    # DP-7 async optimizer vs DP-3 synchronous on the same small model.
    D = args.model_dim
    w0 = np.random.RandomState(1).randn(n, D, 1).astype(np.float32)

    def param():
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()).to(dev))
        p.grad = torch.zeros_like(p)
        return p

    for name, make in [
            ("DP-7 win_put ", lambda p: bf.optim.DistributedWinPutOptimizer(
                torch.optim.SGD([p], lr=0.01))),
            ("DP-7 overlap ", lambda p: bf.optim.DistributedWinPutOptimizer(
                torch.optim.SGD([p], lr=0.01), window_prefix="winput_ov",
                overlap=True)),
            ("DP-3 sync nbr", lambda p:
             bf.optim.DistributedNeighborAllreduceOptimizer(
                 torch.optim.SGD([p], lr=0.01)))]:
        opt = make(param())
        t = _timeit(opt.step, args.rounds, dkind)
        out[f"opt_{name.strip().replace(' ', '_')}_s"] = t
        print(f"{name} step ({D}-param model): {t*1e3:8.2f} ms")
        if hasattr(opt, "free"):
            opt.free()
    bf.shutdown()
    return out


def multiproc_child(args) -> dict:
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo

    world = (int(os.environ["BFTPU_NUM_PROCESSES"])
             * int(os.environ.get("BFTPU_LOCAL_DEVICES", "1")))
    bf.init_distributed(lambda: topo.RingGraph(world), backend="gloo",
                        device=args.device)
    n = bf.size()
    P = args.elements
    mb = P * 4 / 1e6
    owned = bf.owned_ranks()
    owned_layout = os.environ.get("BFTPU_BENCH_OWNED") == "1"
    if owned_layout:
        # Owned-rows layout: the caller's array is (owned, P), not (n, P):
        # at large n the working set stays O(owned).
        x = _randn(len(owned), P, bf.device(), seed=0)
        assert bf.win_create(x, "mp", zero_init=True)
    else:
        x = _randn(n, P, bf.device(), seed=0)
        assert bf.win_create(x, "mp")
    my = bf.process_ranks().process
    bf.win_fence()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        bf.win_put(x, "mp")
    bf.win_fence()  # every put applied at its target
    dt = (time.perf_counter() - t0) / args.rounds
    # Ring over 2 processes: each process sends its owned ranks' rows along
    # 2 edges each; half the edges cross the process boundary.
    edges_out = sum(len(bf.out_neighbor_ranks(r)) for r in owned)
    cross = sum(1 for r in owned for t_ in bf.out_neighbor_ranks(r)
                if t_ not in owned)
    comp = os.environ.get("BLUEFOG_TPU_WIN_COMPRESSION", "none")
    wire_mb = mb * (0.5 if comp == "bf16" else 1.0)
    layout = "owned" if owned_layout else "rank-major"
    host_mb = x.numel() * 4 / 1e6
    print(f"proc{my}: win_put round {dt*1e3:.1f} ms "
          f"({edges_out} edges, {cross} cross-process, "
          f"{cross * wire_mb / dt / 1e3:.2f} GB/s DCN payload, "
          f"compression={comp}, layout={layout}, "
          f"caller array {host_mb:.0f} MB)", flush=True)
    res = {"proc": my, "compression": comp, "layout": layout,
           "round_s": dt, "edges": edges_out, "cross_edges": cross,
           "puts_per_s_per_edge": 1.0 / dt,
           "bytes_per_s_per_edge": wire_mb * 1e6 / dt,
           "device": str(bf.device())}
    print("winbench-json " + json.dumps(res), flush=True)
    bf.win_free("mp")
    bf.shutdown()
    return res


def multiproc_parent(args) -> list:
    rows = []
    for comp, owned in (("none", "0"), ("bf16", "0"), ("none", "1")):
        env = dict(os.environ, BLUEFOG_TPU_WIN_COMPRESSION=comp,
                   BFTPU_BENCH_OWNED=owned)
        env[_MP_CHILD] = "1"
        out = subprocess.run(
            [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
             "--devices-per-proc", "2", "--tag-output", sys.executable, "-m",
             "bluefog_tpu_torch.window_benchmark", "--elements",
             str(args.elements), "--rounds", str(args.rounds), "--device",
             args.device],
            env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout)
            print(out.stderr[-2000:], file=sys.stderr)
            raise SystemExit(out.returncode)
        for line in out.stdout.splitlines():
            # --tag-output writes whole lines, each as "[rank]line".
            line = line.split("]", 1)[1] if line.startswith("[") else line
            if line.startswith("proc"):
                print(line)
            elif line.startswith("winbench-json "):
                rows.append(json.loads(line.split(" ", 1)[1]))
    if len(rows) != 6:
        raise SystemExit(f"window_benchmark --multiproc: {len(rows)} of 6 "
                         "process results")
    return rows


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--elements", type=int, default=25_557_032,
                    help="elements a rank's row (default: ResNet-50's "
                         "parameters)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--model-dim", type=int, default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--multiproc", action="store_true",
                    help="cross-process edges under the port's bfrun -np 2")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary line at the end")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if os.environ.get(_MP_CHILD):
        return multiproc_child(args)
    if args.multiproc:
        rows = multiproc_parent(args)
        if args.json:
            print(json.dumps({"multiproc": rows}))
        return rows
    out = single_process(args)
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
