"""The headline benchmark: ResNet-50 decentralized training on one card.

The port's counterpart of the repository's root ``bench.py``, which stays
the JAX package's: ResNet-50 (bf16 activations, f32 parameters, rank-local
BN statistics) at 224x224, SGD momentum 0.9 with ``lr = 0.0125 * ranks``,
ATC over the dynamic one-peer walk of ``ExponentialGraph(ranks)``, synthetic
images and labels from ``--seed``, and ``bench.py``'s protocol: 10 warmup
batches, then 10 x 10 timed batches, the mean of the 10 rates.  The
``--ranks`` virtual ranks share the one card (the JAX ``bench.py`` falls
back to local SGD on one device; the port keeps the gossip), so "per chip"
is the total over the ranks.

    python -m bluefog_tpu_torch.bench                   # batch 64 per rank
    python -m bluefog_tpu_torch.bench --batch-size 256 --compression bf16

Prints one JSON line with ``bench.py``'s keys.  Runs on CUDA unless
``--device cpu`` is given; on the CPU it is a smoke run at a tiny size
(batch 2, 64x64, 1 warmup and 2 x 2 timed batches), never a throughput,
and ``detail.cpu_fallback`` says so.  Asked for CUDA with no card, it
prints ``bench.py``'s ``"status": "no_backend"`` line and exits 3, unless
``BLUEFOG_TPU_BENCH_ALLOW_CPU=1`` asks for the CPU smoke run instead.

``detail.telemetry`` is the registry's snapshot after the run (None with
``BLUEFOG_TPU_TELEMETRY=0``) and ``detail.phase_latency`` the p50/p99 ms of
the ``bf_bench_phase_seconds`` histogram: each timed step's host time
(``optimizer-update``) and each iteration's wait for the device
(``host-sync``), as in ``bench.py``.

``detail`` carries ``bench.py``'s modeled blocks, with the same keys:
``placement`` and ``synthesis`` (the benchmark's gossip schedules priced on
the devices' interconnect model; torch devices carry no geometry, so
unless ``BLUEFOG_TPU_FAKE_TORUS`` names one, a near-square torus sized to
the ranks, labeled "(synthetic)": a data point of the cost model, never a
claim about the hardware), ``hierarchy`` (the two-level gossip's modeled
bytes a step, synthetic slices labeled) and ``sharding`` (the plan of a
labeled synthetic MoE tree), and ``links``: the link observatory's gate,
SLO rules and this process's link table, as the root ``bench.py``'s
``_links_summary`` (a one-process run crosses no window transport, so the
table is empty; the block keeps the schema), and ``churn``: the churn
controller's membership view (epoch, active ranks, changes, last change)
with ``BLUEFOG_TPU_CHURN=1``, ``{"enabled": false}`` otherwise, as the
root's ``_churn_summary``, and ``fused_step``: with
``BLUEFOG_TPU_FUSED_STEP`` set, the eager-vs-fused step time (p50/p99 ms),
speedup, build and capture seconds and the probes' measured overlap of
``bench_comm``'s loopback rig (``bench_comm._fused_timing_cell(steps=20,
warm=4)``: 32 leaves of (8, 128) over 8 fusion buckets, on the bench's
device), as the root's ``_fused_step_summary``; ``{"enabled": false}``
unless the flag is set.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from bluefog_tpu_torch import benchmark

__all__ = ["main", "modeled_blocks", "BASELINE_PER_GPU"]

BASELINE_PER_GPU = 4310.6 / 16  # img/s per V100, the reference's docs


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="images per rank (64 on the card, 2 on the CPU)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--compression", default="none",
                    help="none, bf16 or sparse:<frac>")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def _model_or_synthetic(devs):
    """The devices' interconnect model, or a labeled near-square synthetic
    torus over them."""
    from bluefog_tpu_torch.ops import placement as PL
    n = len(devs)
    model = PL.build_model(devs)
    if model is not None:
        return model, False
    r = max(int(math.isqrt(n)), 1)
    while n % r:
        r -= 1
    return PL.synthetic_torus((r, n // r), name=f"synthetic-{r}x{n // r}"), \
        True


def _placement_summary(devs, dyn):
    """The root ``bench.py``'s ``_placement_summary``: identity against
    optimized max link load of the benchmark's dynamic schedule."""
    from bluefog_tpu_torch.ops import placement as PL
    n = len(devs)
    if n < 2 or dyn is None:
        return None
    model, synthetic = _model_or_synthetic(devs)
    try:
        res = PL.optimize_placement(model, dyn, n, iters=300, seed=0)
    except ValueError:
        return None
    return {
        "model": model.name + (" (synthetic)" if synthetic else ""),
        "max_link_load_naive": res.identity_cost.max_link_load,
        "max_link_load_opt": res.optimized_cost.max_link_load,
        "improvement_ratio": round(res.improvement_ratio, 3),
    }


def _hierarchy_summary(devs, tree_bytes: float):
    """The root ``bench.py``'s ``_hierarchy_summary``: the two-level
    policy of the ``BLUEFOG_TPU_HIER_*`` knobs and each level's modeled
    bytes a step for this run's parameters; the ranks share one device,
    so the slices are a synthetic split in two, labeled."""
    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.utils import config
    cfg = config.get()
    n = len(devs)
    out = {"enabled": bool(cfg.hier)}
    if n < 2 or n % 2:
        return out
    n_slices, synthetic = 2, True
    try:
        ht = topology.hierarchical_two_level(
            n, n_slices, inner=cfg.hier_inner, outer=cfg.hier_outer,
            outer_every=cfg.hier_outer_every,
            outer_self_weight=cfg.hier_outer_self_weight)
    except ValueError:
        return out
    comp = cfg.hier_outer_compression
    factor = config.compression_byte_factor(comp)
    row_bytes = float(tree_bytes) / n
    out.update({
        "levels": 2,
        "n_slices": n_slices,
        "slice_size": ht.slice_size,
        "synthetic_slices": synthetic,
        "inner": ht.inner_kind,
        "outer": ht.outer_kind,
        "outer_every": ht.outer_every,
        "outer_compression": comp,
        "outer_self_weight": ht.outer_self_weight,
        "ici_bytes_per_step": round(row_bytes * ht.ici_edges_per_step(), 1),
        "dcn_bytes_per_step": round(
            row_bytes * ht.dcn_edges_per_outer_step() * factor
            / max(ht.outer_every, 1), 1),
    })
    return out


def _sharding_summary(devs):
    """The root ``bench.py``'s ``_sharding_summary``: the ``ShardPlan`` of
    a labeled synthetic MoE tree (the ResNet tree is all replicated) and
    its modeled bytes a step by level and shard."""
    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import sharded as SH
    from bluefog_tpu_torch.utils import config
    cfg = config.get()
    n = len(devs)
    out = {"enabled": bool(cfg.sharded_gossip)}
    if n < 4 or n % 2:
        return out
    n_shards = 4 if n % 4 == 0 else 2
    tree = {
        "router": np.zeros((n, 256), np.float32),
        "experts": np.zeros((n, n_shards, 512), np.float32),
        # An indivisible model dim: the planner falls back to replicated
        # and says so in its decision.
        "head": np.zeros((n, 7, 16), np.float32),
    }
    specs = {"router": None, "experts": ("ep", None), "head": ("ep", None)}
    try:
        plan = SH.build_plan(tree, specs, n=n, n_shards=n_shards)
        sched = S.compile_static(topology.ExponentialTwoGraph(n))
        gsched, _per = SH.compile_group_schedules(n, plan.groups)
    except ValueError:
        return out
    rep_ici, rep_dcn = SH.edge_level_counts(plan.coords, sched)
    g_ici, g_dcn = SH.edge_level_counts(plan.coords, gsched)
    rep_row = plan.rep_bytes / n
    sh_row = (plan.sh_bytes / n / plan.n_shards
              if plan.any_sharded else 0.0)
    out.update(plan.summary())
    out.update({
        "synthetic_tree": True,
        "bytes_per_step": {
            "replicated_ici": round(rep_row * rep_ici, 1),
            "replicated_dcn": round(rep_row * rep_dcn, 1),
            "sharded_ici": round(sh_row * g_ici, 1),
            # 0 by construction: in-group schedules cross no group
            # boundary; kept so that a regression shows.
            "sharded_dcn": round(sh_row * g_dcn, 1),
        },
    })
    return out


def _synthesis_summary(devs):
    """The root ``bench.py``'s ``_synthesis_summary``: the static Exp2
    schedule priced on the model, the congestion-packed baseline against
    the synthesized selection on ``serial_link_time``."""
    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.ops import synthesis as SY
    n = len(devs)
    if n < 4:
        return None
    model, synthetic = _model_or_synthetic(devs)
    try:
        w = topology.weight_matrix(topology.ExponentialTwoGraph(n))
        naive = S._naive_schedule(w)
        sched = SO.optimize_schedule(naive)
        packed = SO.congestion_aware_repack(sched, model, None,
                                            budget_factor=2.0, record=False)
        chosen, ratio = SY.select_schedule(sched, packed, model, None)
    except ValueError:
        return None
    return {
        "model": model.name + (" (synthetic)" if synthetic else ""),
        "sketch": getattr(chosen, "sketch", None),
        "provenance": S.schedule_provenance(chosen),
        "serial_naive": PL.schedule_cost(model, naive).serial_link_time,
        "serial_konig": PL.schedule_cost(model, sched).serial_link_time,
        "serial_packed": PL.schedule_cost(model, packed).serial_link_time,
        "serial_synth": PL.schedule_cost(model, chosen).serial_link_time,
        "improvement_ratio": round(ratio, 3),
    }


def modeled_blocks(ranks: int, device, params_per_rank: int) -> dict:
    """``detail``'s modeled blocks for ``ranks`` ranks on ``device`` and a
    float32 tree of ``params_per_rank`` parameters a rank."""
    import torch

    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.ops import schedule as S
    devs = [torch.device(device)] * ranks
    dyn = (S.compile_dynamic(topology.one_peer_exp2_phases(ranks), ranks)
           if ranks > 1 else None)
    tree_bytes = 4.0 * params_per_rank * ranks
    return {"placement": _placement_summary(devs, dyn),
            "synthesis": _synthesis_summary(devs),
            "hierarchy": _hierarchy_summary(devs, tree_bytes),
            "sharding": _sharding_summary(devs)}


def _links_summary() -> dict:
    """The link observatory's evidence (the root ``bench.py``'s
    ``_links_summary``): its gate, the SLO rules and breaches, and this
    process's edges and goodput."""
    from bluefog_tpu_torch.utils import config, linkobs
    if not config.get().link_obs:
        return {"enabled": False}
    rep = linkobs.local_report()
    return {"enabled": True,
            "slo_rules": rep["slo"]["rules"],
            "slo_breached": sorted(rep["slo"]["breached"]),
            "edges": rep["edges"],
            "goodput": rep["goodput"]}


def _churn_summary() -> dict:
    """The churn controller's evidence (the root ``bench.py``'s
    ``_churn_summary``): the membership view the numbers were measured
    against, or ``{"enabled": False}`` with churn off."""
    from bluefog_tpu_torch.ops import membership
    from bluefog_tpu_torch.utils import config
    if not config.get().churn:
        return {"enabled": False}
    m = membership.health_summary()
    if m is None:
        return {"enabled": True, "active": None}
    return {"enabled": True, "epoch": m["epoch"],
            "active_ranks": m["active_ranks"],
            "changes_total": m["changes_total"],
            "last_change_unix": m["last_change_unix"]}


def _fused_step_summary(device: str) -> dict:
    """The fused step's evidence (the root ``bench.py``'s
    ``_fused_step_summary``): with ``BLUEFOG_TPU_FUSED_STEP`` set, the
    timing cell of ``bench_comm``'s loopback rig; ``{"enabled": False}``
    otherwise.  A rig that fails raises (the root labels a skip)."""
    from bluefog_tpu_torch import bench_comm
    from bluefog_tpu_torch.utils import config
    if not config.get().fused_step:
        return {"enabled": False}
    prev = bench_comm._fused_env_setup()
    try:
        cell = bench_comm._fused_timing_cell(steps=20, warm=4,
                                             device=device)
    finally:
        bench_comm._fused_env_restore(prev)
    return {"enabled": True, **cell}


def _no_backend_or_cpu(reason: str) -> bool:
    """The card was asked for and is absent: with
    ``BLUEFOG_TPU_BENCH_ALLOW_CPU=1`` go on as a labeled CPU smoke run
    (True); without, print ``bench.py``'s ``no_backend`` line and exit 3,
    so that no run carries on quietly on the CPU."""
    import sys
    if os.environ.get("BLUEFOG_TPU_BENCH_ALLOW_CPU") not in (
            "1", "true", "True", "yes"):
        print(json.dumps({
            "metric": "resnet50_train_imgs_per_sec_per_chip",
            "value": None,
            "unit": "img/s/chip",
            "status": "no_backend",
            "detail": {"reason": reason},
        }), flush=True)
        raise SystemExit(3)
    print(f"bench: {reason}; BLUEFOG_TPU_BENCH_ALLOW_CPU=1 is set, so this "
          "is a CPU smoke run (labeled cpu_fallback)", file=sys.stderr)
    return True


def main(argv=None):
    import torch

    from bluefog_tpu_torch.utils import telemetry
    args = build_parser().parse_args(argv)
    cpu_fallback = args.device == "cpu"
    if not cpu_fallback and not torch.cuda.is_available():
        cpu_fallback = _no_backend_or_cpu("no CUDA device is available")
        args.device = "cpu"
    on_card = args.device != "cpu"
    batch = args.batch_size or (64 if on_card else 2)
    image = 224 if on_card else 64
    warmup, iters, per_iter = (10, 10, 10) if on_card else (1, 2, 2)
    bargs = benchmark.build_parser().parse_args([
        "--model", "resnet50", "--batch-size", str(batch),
        "--image-size", str(image), "--atc", "--dynamic",
        "--ranks", str(args.ranks), "--momentum", "0.9",
        "--compression", args.compression,
        "--num-warmup-batches", str(warmup), "--num-iters", str(iters),
        "--num-batches-per-iter", str(per_iter), "--seed", str(args.seed),
        "--device", args.device])
    res = benchmark.measure(bargs, quiet=True,
                            phase_series="bf_bench_phase_seconds")
    total = res["imgs_per_s"]
    phase_latency = {}
    for ph in ("optimizer-update", "host-sync"):
        pct = telemetry.histogram_percentiles(
            "bf_bench_phase_seconds", (50.0, 99.0), phase=ph)
        if pct:
            phase_latency[ph] = {"p50_ms": round(pct[50.0] * 1e3, 3),
                                 "p99_ms": round(pct[99.0] * 1e3, 3)}
    detail = {
        "total_imgs_per_sec": round(total, 1),
        "n_devices": 1,
        "ranks": res["ranks"],
        "per_device_batch": batch,
        "image_size": image,
        "backend": res["device"].split(":")[0],
        "stddev_pct": round(100 * float(np.std(res["rates"]))
                            / max(total, 1e-9), 2),
        "optimizer": f"ATC neighbor_allreduce (dynamic one-peer Exp2, "
                     f"{res['ranks']} ranks on one device)",
        "compression": args.compression,
        # A CPU smoke run: the code path's evidence, never a throughput.
        "cpu_fallback": cpu_fallback,
        "step_ms": res["step_ms"],
        "peak_mem_gb": res.get("peak_mem_gb"),
        "phase_latency": phase_latency or None,
        **modeled_blocks(res["ranks"], args.device, res["params_per_rank"]),
        "churn": _churn_summary(),
        "links": _links_summary(),
        "telemetry": telemetry.snapshot() if telemetry.enabled() else None,
    }
    # After the snapshot: the fused rig resets the registry.
    detail["fused_step"] = _fused_step_summary(args.device)
    if on_card:
        detail["device_name"] = torch.cuda.get_device_name(0)
    print(json.dumps({
        "metric": "resnet50_train_imgs_per_sec_per_chip",
        "value": round(total, 1),
        "unit": "img/s/chip",
        "vs_baseline": round(total / BASELINE_PER_GPU, 3),
        "detail": detail,
    }), flush=True)


if __name__ == "__main__":
    main()
