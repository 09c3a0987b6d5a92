"""Where one training step's time goes on the card.

    python -m bluefog_tpu_torch.profile_step --model resnet50 --atc \\
        --dynamic --batch-size 64 --ranks 4 --num-warmup-batches 2
    python -m bluefog_tpu_torch.profile_step --model transformer \\
        --flash-attention --atc --dynamic --num-layers 24 --embed-dim 2048 \\
        --num-heads 16 --seq-len 2048 --batch-size 2 --momentum 0 --ranks 4 \\
        --num-warmup-batches 1
    python -m bluefog_tpu_torch.profile_step --model transformer \\
        --flash-attention --atc --dynamic --num-layers 6 --embed-dim 2048 \\
        --num-heads 16 --num-experts 8 --remat --seq-len 2048 \\
        --batch-size 2 --momentum 0 --ranks 4 --num-warmup-batches 1

Takes the benchmark's flags and builds its ``Trainer``; after the warmup
steps it times one step phase by phase with CUDA events (every rank's
forward and backward, the local update, the neighbor combine), then profiles
one more step with ``torch.profiler``: device time by kernel family, the
largest kernels, the operators whose kernels take the most device time
(inclusive: ``aten::repeat_interleave`` is the GQA fan-out of K and V,
``ExpandBackward0`` its reduction in the backward; ``moe::plan`` is the
MoE routing plan, ``moe::dispatch`` and ``moe::combine`` its one-hot
einsums, each with its ``_backward``), and the device's idle share of the
step's wall time.  Under ``--dist-optimizer gradient_allreduce`` the step
after the forward and backward is timed whole (``step_ms``): the gradients'
average and the update are one call.  Under ``--dist-optimizer win_put``
the combine is ``window_ms``: the puts, the window update and the copy of
its result into the parameters.  Where the combine is a call of its own
(ATC, the window optimizers), ``combine_trace`` profiles one more combine
alone: its kernels with their launches, and the device's idle share.  Takes the benchmark's flags
(``--remat``, ``--chunked-loss``, ``--num-kv-heads``, ``--num-experts``
...).  Prints one JSON line.  Needs a GPU; :func:`profile` does the same on
a built ``Trainer``, or on any object with ``forward_backward()`` and a
plain torch optimizer ``opt`` (``long_context_training.
SequenceParallelLM``: the step is then timed whole after the forward and
backward) or a distributed one (``tensor_parallel_training.
DataTensorParallelLM``); :func:`trace` profiles any one call (a pipeline
step).
"""

from __future__ import annotations

import json
import time

import torch

from bluefog_tpu_torch.benchmark import Trainer, build_parser
from bluefog_tpu_torch.optim.window_optimizers import _WindowOptimizerBase

__all__ = ["main", "profile", "trace", "kernel_family", "MOE_OPS",
           "ULYSSES_OPS", "TP_OPS"]

# Operators reported by name (inclusive device time): the GQA fan-out and
# its backward, the chunked loss, RoPE's and SwiGLU's ops, the MoE
# routing plan with its dispatch and combine einsums (``SwitchMlp``'s
# profiler ranges), Ulysses' two moves, forward and backward
# (``parallel.ulysses``), and the tensor-parallel row sums
# (``parallel.tensor_parallel``).
_BWD = "autograd::engine::evaluate_function: "
MOE_OPS = ("moe::plan", "moe::dispatch", "moe::dispatch_backward",
           "moe::combine", "moe::combine_backward")
ULYSSES_OPS = ("ulysses::scatter_heads", "ulysses::scatter_heads_backward",
               "ulysses::gather_seq", "ulysses::gather_seq_backward")
TP_OPS = ("tp::row_sum",)
NAMED_OPS = ("aten::repeat_interleave", _BWD + "ExpandBackward0",
             "aten::logsumexp", _BWD + "GatherBackward0", "aten::cos",
             "aten::sin", "aten::cat", "aten::silu") + MOE_OPS + ULYSSES_OPS \
    + TP_OPS


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash attention (K1-K3)"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
        return "batch norm"
    # Before the matmul match: cuDNN's convolutions are implicit GEMMs
    # whose names also hold "sm90_", "xmma" or "gemm".
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "convolution (cuDNN)"
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
    print(json.dumps(profile(tr, args.model)), flush=True)


def profile(tr: Trainer, model: str = "") -> dict:
    """One step of ``tr`` timed phase by phase, then one profiled step:
    the dict ``main`` prints."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    tr.forward_backward()
    ev[1].record()
    window = isinstance(tr.opt, _WindowOptimizerBase)
    # Gradient allreduce, or a plain torch optimizer: one call a step.
    grad_ar = not window and getattr(tr.opt, "order", "gradient_allreduce") \
        == "gradient_allreduce"
    if grad_ar:
        tr.opt.step()
    else:
        tr.opt.adapt()
    ev[2].record()
    if not grad_ar:
        tr.opt.combine()
    ev[3].record()
    torch.cuda.synchronize()
    phases = {"forward_backward_ms": ev[0].elapsed_time(ev[1])}
    if grad_ar:
        phases["step_ms"] = ev[1].elapsed_time(ev[2])
    else:
        # A window optimizer's combine: puts + win_update + the copy back.
        combine = "window_ms" if window else "combine_ms"
        phases.update({"adapt_ms": ev[1].elapsed_time(ev[2]),
                       combine: ev[2].elapsed_time(ev[3])})

    extra = {}
    if not grad_ar:
        # The combine alone under the profiler: its kernels, their
        # launches and device time, and the device's idle share there.
        tr.forward_backward()
        tr.opt.adapt()
        extra["combine_trace"] = trace(tr.opt.combine)
        extra["combine_trace"].pop("device")
    out = trace(lambda: (tr.forward_backward(), tr.opt.step()))
    return {
        "device": out.pop("device"),
        "model": model,
        "phases": phases,
        **out,
        **extra,
        # The profiler slows the host: against the step timed by events.
        "idle_share_of_event_step":
            1.0 - out["kernel_busy_ms"] / sum(phases.values()),
    }


def trace(step) -> dict:
    """One call of ``step()`` under ``torch.profiler``: its wall time, the
    device's busy time and idle share, device time by kernel family, the
    largest kernels and operators, and the named operators."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    cpu_keys = {e.key for e in avgs
                if e.device_type == torch.autograd.DeviceType.CPU}
    # A profiler range (``record_function``: the optimizer's step, the MoE
    # ranges) also shows on the device's timeline under its own name,
    # spanning the kernels it launched; counting it would count them twice.
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in cpu_keys]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    families: dict = {}
    for e in kernels:
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ops = [e for e in avgs
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.device_time_total)[:25]
    named = {e.key.replace(_BWD, ""): e for e in ops if e.key in NAMED_OPS}
    return {
        "device": torch.cuda.get_device_name(0),
        "profiled_step_wall_ms": wall_ms,
        "kernel_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top],
        "top_ops": [{"name": e.key[:90], "count": e.count,
                     "device_ms": e.device_time_total / 1e3}
                    for e in top_ops],
        "named_ops": {k: {"count": e.count,
                          "device_ms": e.device_time_total / 1e3}
                      for k, e in sorted(named.items())},
    }


if __name__ == "__main__":
    main()
