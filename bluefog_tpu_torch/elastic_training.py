"""Preemption-tolerant decentralized training with ``run_elastic``.

The port of ``examples/elastic_training.py``: a small MLP regression,
rank-major over ``--ranks`` virtual ranks on one device, its data sharded
statically per rank (``bf.data.ShardedLoader``), trained under
``utils.elastic.run_elastic``: a checkpoint every ``--save-every`` steps
(DCP, ``utils/checkpoint.py``), and on a SIGTERM a save and exit code 75.
Run it again with the same ``--ckpt-dir`` and it resumes from the newest
checkpoint; the final parameters are bit for bit those of an uninterrupted
run.

    python -m bluefog_tpu_torch.elastic_training --ckpt-dir /tmp/elastic
    python -m bluefog_tpu_torch.elastic_training --device cpu \\
        --ckpt-dir /tmp/elastic --preempt-at-step 25     # exits 75
    python -m bluefog_tpu_torch.elastic_training --device cpu \\
        --ckpt-dir /tmp/elastic                          # resumes

``--optimizer push_sum`` gossips through the one-sided windows
(``DistributedPushSumOptimizer``); the window store (staging mass, P)
rides the checkpoint through ``window_state_dict``, so its resume is bit
for bit too.  The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import signal

import numpy as np
import torch

__all__ = ["build_parser", "main"]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--preempt-at-step", type=int, default=0)
    ap.add_argument("--optimizer", choices=["neighbor_allreduce",
                                            "push_sum"],
                    default="neighbor_allreduce")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.basics import resolve_device
    from bluefog_tpu_torch.models.simple import MLP
    from bluefog_tpu_torch.replicas import RankReplicas
    from bluefog_tpu_torch.utils.elastic import Preempted, run_elastic

    dev = resolve_device(args.device)
    n = args.ranks
    push_sum = args.optimizer == "push_sum"
    bf.init(n, device=dev, topology_fn=(
        (lambda: bf.topology_util.RingGraph(n, connect_style=2))
        if push_sum else None))
    try:
        # The JAX example's synthetic regression task, sharded per rank.
        rng = np.random.RandomState(0)
        xs = rng.randn(n * 512, 16).astype(np.float32)
        w_true = rng.randn(16, 1).astype(np.float32)
        ys = xs @ w_true + 0.01 * rng.randn(n * 512, 1).astype(np.float32)
        loader = bf.data.ShardedLoader({"x": xs, "y": ys},
                                       batch_size=args.batch_size, seed=3,
                                       static_shards=True, num_ranks=n,
                                       device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        rep = RankReplicas(lambda: MLP(16, features=(64,), num_classes=1),
                           n, dev, init=lambda m: m.reset_parameters(gen))
        flat = rep.flat
        if push_sum:
            opt = bf.optim.DistributedPushSumOptimizer(
                torch.optim.SGD([flat], lr=args.lr))
        else:
            base = torch.optim.Adam([flat], lr=args.lr)
            # Adam's state made up front, so that the restore target holds
            # it before the first step.
            base.state[flat] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(flat),
                "exp_avg_sq": torch.zeros_like(flat)}
            opt = bf.optim.DistributedNeighborAllreduceOptimizer(base)
        base = opt.base

        def opt_state():
            return {k: v for k, v in base.state.get(flat, {}).items()}

        def rank_losses(p, x, y):
            """Each rank's mean squared error at the rows ``p``."""
            with torch.no_grad():
                saved = flat.clone()
                flat.copy_(p)
                out = torch.stack([
                    ((rep.modules[r](x[r]) - y[r]) ** 2).mean()
                    for r in range(n)])
                flat.copy_(saved)
            return out

        steps_per_epoch = loader.steps_per_epoch
        cache = {"epoch": -1, "batches": None}

        def step_fn(state, step):
            epoch = step // steps_per_epoch
            if cache["epoch"] != epoch:
                loader.set_epoch(epoch)
                cache["epoch"], cache["batches"] = epoch, list(loader)
            batch = cache["batches"][step % steps_per_epoch]
            rep.zero_grad()
            at = opt.debias()[0] if push_sum else None
            saved = None
            if at is not None:
                # The gradient at the de-biased iterate, as push-sum needs.
                with torch.no_grad():
                    saved = flat.clone()
                    flat.copy_(at)
            loss = sum(((rep.modules[r](batch["x"][r]) - batch["y"][r])
                        ** 2).mean() for r in range(n))
            loss.backward()
            if saved is not None:
                with torch.no_grad():
                    flat.copy_(saved)
            opt.step()
            out = {"params": flat, "opt": opt_state()}
            if push_sum:
                out["win"] = state["win"]  # refreshed at save time
            return out

        def on_save(state, step):
            if not push_sum:
                return state
            # The window store is side-band state the parameters cannot
            # carry: snapshot it at save time only.
            return {**state, "win": opt.window_state_dict()}

        def on_restore(state, step):
            with torch.no_grad():
                flat.copy_(state["params"])
                for k, v in state["opt"].items():
                    base.state[flat][k].copy_(v)
            if push_sum:
                opt.load_window_state_dict(state["win"])

        xs_r = torch.from_numpy(xs.reshape(n, -1, 16)).to(dev)
        ys_r = torch.from_numpy(ys.reshape(n, -1, 1)).to(dev)

        def eval_loss():
            p = opt.debias()[0] if push_sum else flat.detach()
            return float(rank_losses(p, xs_r, ys_r).mean())

        def report(state, step):
            if args.preempt_at_step and step + 1 == args.preempt_at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            if (step + 1) % args.save_every == 0:
                print(f"step {step + 1}  mean rank loss {eval_loss():.5f}",
                      flush=True)

        state0 = {"params": flat, "opt": opt_state()}
        if push_sum:
            state0["win"] = opt.window_state_dict()
        try:
            run_elastic(step_fn, state0, ckpt_dir=args.ckpt_dir,
                        num_steps=args.steps, save_every=args.save_every,
                        keep=args.keep, on_step=report,
                        on_restore=on_restore, on_save=on_save)
        except Preempted as e:
            print(f"preempted; checkpoint saved at step {e.step} — rerun "
                  "with the same --ckpt-dir to resume", flush=True)
            raise SystemExit(75)
        loss = eval_loss()
        res = {"device": str(dev), "optimizer": args.optimizer,
               "steps": args.steps, "final_loss": loss,
               "params": flat.detach().cpu().clone()}
        if push_sum:
            opt.free()
            bf.turn_off_win_ops_with_associated_p()
        print(f"done: {args.steps} steps, final mean rank loss {loss:.5f}")
        print(json.dumps({k: v for k, v in res.items() if k != "params"}),
              flush=True)
        return res
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
