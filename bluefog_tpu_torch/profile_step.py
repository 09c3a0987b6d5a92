"""Where one training step's time goes on the card.

    python -m bluefog_tpu_torch.profile_step --flash-attention --atc \\
        --dynamic --num-layers 24 --embed-dim 2048 --num-heads 16 \\
        --seq-len 2048 --batch-size 2 --momentum 0 --ranks 4 \\
        --num-warmup-batches 1

Takes the benchmark's flags and builds its ``Trainer``; after the warmup
steps it times one step phase by phase with CUDA events (every rank's
forward and backward, the local update, the neighbor combine), then profiles
one more step with ``torch.profiler``: device time by kernel family, the
largest kernels, and the device's idle share of the step's wall time.
Prints one JSON line.  Needs a GPU.
"""

from __future__ import annotations

import json
import time

import torch

from bluefog_tpu_torch.benchmark import Trainer, build_parser

__all__ = ["main", "kernel_family"]


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash attention (K1-K3)"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "sm90_")):
        return "matmul (cuBLAS)"
    if "reduce" in low or "softmax" in low:
        return "reductions and softmax"
    if "index" in low or "gather" in low or "embedding" in low:
        return "index and gather"
    if "elementwise" in low or "vectorized" in low or "copy" in low:
        return "elementwise and copies"
    return "other"


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a GPU")
    tr = Trainer(args)
    for _ in range(max(1, args.num_warmup_batches)):
        tr.forward_backward()
        tr.opt.step()
    torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    tr.forward_backward()
    ev[1].record()
    tr.opt.adapt()
    ev[2].record()
    tr.opt.combine()
    ev[3].record()
    torch.cuda.synchronize()
    phases = {"forward_backward_ms": ev[0].elapsed_time(ev[1]),
              "adapt_ms": ev[1].elapsed_time(ev[2]),
              "combine_ms": ev[2].elapsed_time(ev[3])}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.forward_backward()
        tr.opt.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    families: dict = {}
    for e in kernels:
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "phases": phases,
        "profiled_step_wall_ms": wall_ms,
        "kernel_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)


if __name__ == "__main__":
    main()
