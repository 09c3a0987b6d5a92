"""Throughput benchmark: decentralized training on one device.

The port of ``examples/benchmark.py``: the model by ``--model`` (the ResNet
family, VGG, LeNet, ViT, or the transformer LM), synthetic data from
``--seed`` (each rank its own: bf16 images and labels, or tokens with
next-token targets), cross-entropy, SGD with ``lr = 0.0125 * ranks``,
neighbor averaging (ATC or AWC, static or dynamic one-peer topology), the
global average, or none (``--dist-optimizer``), optionally compressed on
the wire (``--compression``), and the ``--num-warmup-batches`` then
``--num-iters x --num-batches-per-iter`` protocol.  All ``--ranks`` virtual
ranks live on one device and run forward and backward one after another, so
one rank's activations are live at a time; their parameters are rows of one
flat buffer (``replicas``), laid out in the JAX package's ravel order, and
their BN statistics stay rank-local.  Launched by ``bfrun`` or
``torchrun`` (their environment present), it runs under
``basics.init_distributed`` instead: each process trains the ranks it owns
(one a card) and the combine crosses processes; ``--ranks`` is then the
launcher's.  The LM takes the JAX benchmark's options: GQA, RoPE,
SwiGLU, per-block remat, the chunked lm-head loss, and ``--mfu``;
``--num-experts`` swaps each block's MLP for switch-routed GELU experts
(the loss stays the cross-entropy: the load-balancing loss is exposed,
``TransformerLM(..., moe_aux=[])``, not added, as in the JAX benchmark).  ``--dist-optimizer gradient_allreduce`` averages the gradients
over the ranks instead of the parameters, which keeps every replica the
same.  ``--dist-optimizer hierarchical`` averages over machines of ``ranks
// 2`` ranks (``CommunicationType.hierarchical_neighbor_allreduce``, the
machine topology's one-peer walk with ``--dynamic``), and ``win_put``
trains with ``DistributedWinPutOptimizer`` through one-sided windows on
the card (``--atc`` and ``--dynamic`` do not apply).  ``--compression`` is
then the window codec, for this run only (a scoped override of the port's
config, ``os.environ`` untouched); it acts on edges across processes, so
in one process it changes nothing, as the JAX benchmark notes.  Under a
launcher, each process's ``flat`` holds its owned rows, the windows take
the owned layout, and the rows that cross processes travel over the
window transport; the result then carries ``window``: the seconds a step
of staging rows off the card, of sends until they were handed to TCP and
of the drain's commits, and the bytes sent.  ``--backend gloo`` runs the
processes' control group on gloo, for several processes on one card
(NCCL refuses two ranks on one device).  ``--host-data`` feeds every
batch from host memory through ``data.prefetch_to_device`` (depth 2), as
the JAX benchmark's flag does.

    python -m bluefog_tpu_torch.benchmark --model resnet50 --batch-size 64 \\
        --atc --dynamic --ranks 4
    python -m bluefog_tpu_torch.benchmark --model transformer \\
        --flash-attention --atc --dynamic --num-layers 24 --embed-dim 2048 \\
        --num-heads 16 --seq-len 2048 --batch-size 2 --momentum 0 --ranks 4
    python -m bluefog_tpu_torch.benchmark --model transformer \\
        --flash-attention --atc --dynamic --num-layers 24 --embed-dim 2048 \\
        --num-heads 16 --num-kv-heads 4 --rope --swiglu --remat \\
        --chunked-loss --seq-len 2048 --batch-size 2 --vocab-size 32000 \\
        --momentum 0 --ranks 4 --mfu
    python -m bluefog_tpu_torch.benchmark --model transformer \\
        --flash-attention --atc --dynamic --num-layers 6 --embed-dim 2048 \\
        --num-heads 16 --num-experts 8 --remat --seq-len 2048 \\
        --batch-size 2 --vocab-size 32000 --momentum 0 --ranks 4
    python -m bluefog_tpu_torch.benchmark --model resnet50 --batch-size 64 \\
        --dist-optimizer gradient_allreduce --ranks 4
    python -m bluefog_tpu_torch.benchmark --model transformer \\
        --flash-attention --atc --dynamic --num-layers 24 --embed-dim 2048 \\
        --num-heads 16 --seq-len 2048 --batch-size 2 --momentum 0 --ranks 4 \\
        --dist-optimizer hierarchical
    python -m bluefog_tpu_torch.benchmark --model resnet50 --batch-size 64 \\
        --dist-optimizer win_put --ranks 4
    BFTPU_COORDINATOR=127.0.0.1:29400 BFTPU_NUM_PROCESSES=2 \\
    BFTPU_PROCESS_ID=<0|1> BFTPU_LOCAL_DEVICES=2 \\
    python -m bluefog_tpu_torch.benchmark --model resnet50 --batch-size 64 \\
        --dist-optimizer win_put --backend gloo

``--efficiency`` also runs one rank alone and reports the scaling
efficiency, this process's ranks against one of them (one process only,
as ``examples/benchmark.py``); with every rank on one card it is not a
scaling figure.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch.ops.chunked_loss import chunked_softmax_cross_entropy

__all__ = ["build_parser", "Trainer", "measure", "consensus_spread",
           "efficiency",
           "transformer_train_flops_per_token", "main", "MODELS"]


MODELS = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "vgg11", "vgg16", "vgg19", "lenet", "vit", "transformer"]
# The JAX benchmark's words: 6N over every expert's weights would count
# E times the expert work a token does.
MOE_MFU_NOTE = ("--mfu accounting covers dense models only (top-1 MoE "
                "activates 1 of --num-experts expert MLPs per token); "
                "skipping the MFU report")
DIST_OPTIMIZERS = ["neighbor_allreduce", "allreduce", "gradient_allreduce",
                   "hierarchical", "win_put", "empty"]
# The JAX benchmark's words for --compression under win_put in one process.
WIN_COMPRESSION_NOTE = (
    "window compression applies to CROSS-PROCESS edges only; this "
    "single-process run sends nothing over the transport, so the flag does "
    "not change the measurement")


def _compression(value: str) -> str:
    if value in ("none", "bf16") or value.startswith("sparse:"):
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r}: expected none, bf16 or sparse:<frac>")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50", choices=MODELS)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--num-warmup-batches", type=int, default=10)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-batches-per-iter", type=int, default=10)
    ap.add_argument("--atc", action="store_true",
                    help="adapt-then-combine order (default AWC)")
    ap.add_argument("--dynamic", action="store_true",
                    help="dynamic one-peer topology (the phase table of "
                         "ExponentialGraph(ranks))")
    ap.add_argument("--dist-optimizer", default="neighbor_allreduce",
                    choices=DIST_OPTIMIZERS)
    ap.add_argument("--compression", default="none", type=_compression,
                    help="wire compression of the combine: none, bf16 or "
                         "sparse:<frac>")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--flash-attention", action="store_true",
                    help="use the hand-written flash-attention kernels "
                         "instead of dense attention")
    ap.add_argument("--remat", action="store_true",
                    help="transformer and vit: recompute each block's "
                         "activations in the backward "
                         "(torch.utils.checkpoint)")
    ap.add_argument("--remat-policy", default="full",
                    help="with --remat: 'full' recomputes everything; "
                         "'dots' saves matmul outputs and recomputes the "
                         "rest (attention included); 'dots:<K>' applies "
                         "dots to the first K blocks and full to the rest")
    ap.add_argument("--chunked-loss", action="store_true",
                    help="transformer model: chunked lm-head cross-entropy "
                         "(never materializes the S x vocab logits)")
    ap.add_argument("--num-kv-heads", type=int, default=0,
                    help="transformer model: grouped-query attention with "
                         "this many K/V heads (0 = MHA, 1 = MQA)")
    ap.add_argument("--rope", action="store_true",
                    help="transformer model: rotary position embeddings "
                         "instead of a learned table")
    ap.add_argument("--swiglu", action="store_true",
                    help="transformer model: SwiGLU MLP instead of GELU")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="transformer model: switch-MoE blocks with this "
                         "many experts (0 = dense MLP)")
    ap.add_argument("--num-layers", type=int, default=4,
                    help="transformer model: number of blocks")
    ap.add_argument("--embed-dim", type=int, default=512,
                    help="transformer model: model width")
    ap.add_argument("--num-heads", type=int, default=8,
                    help="transformer model: attention heads")
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="SGD momentum (0 drops the momentum buffer)")
    ap.add_argument("--mfu", action="store_true",
                    help="transformer model: also report model FLOPs "
                         "utilization of the card from the measured "
                         "tokens/s; every virtual rank runs on the one "
                         "card, so it counts the card's whole tokens/s, "
                         "not tokens/s divided by the ranks")
    ap.add_argument("--peak-tflops", type=float, default=989.0,
                    help="the card's peak (bf16) TFLOP/s for --mfu "
                         "(default: H100 SXM dense bf16)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="virtual ranks, all on the one device")
    ap.add_argument("--efficiency", action="store_true",
                    help="also measure one rank alone and report the "
                         "scaling efficiency (one process only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="under a launcher: the process group's backend "
                         "(default NCCL on CUDA, gloo on the CPU)")
    ap.add_argument("--metrics-file", default=None,
                    help="append per-iteration JSONL scalars to this path "
                         "(utils.metrics.MetricsWriter; one file a "
                         "process)")
    ap.add_argument("--host-data", action="store_true",
                    help="feed each batch from host memory through the "
                         "prefetching input pipeline (data.prefetch_to_"
                         "device, depth 2) instead of the device-resident "
                         "tensors: the step then includes the host-to-"
                         "device copy and its overlap")
    return ap


def host_feed(tr: "Trainer", size: int = 2):
    """The trainer's batch as it would come from host memory: one host
    copy of its inputs and targets, placed afresh on its device for every
    batch by ``data.prefetch_to_device`` (a pinned copy and an async
    transfer, ``size`` batches ahead).  bfloat16 images cross as their
    16-bit patterns (numpy has no bfloat16) and are viewed back on the
    device."""
    from bluefog_tpu_torch.data import prefetch_to_device
    bf16 = tr.inputs.dtype == torch.bfloat16
    x = tr.inputs.cpu()
    host = (x.view(torch.int16).numpy() if bf16 else x.numpy(),
            tr.targets.cpu().numpy())

    def gen():
        while True:
            yield host

    for x, y in prefetch_to_device(gen(), size=size, device=tr.device):
        yield (x.view(torch.bfloat16) if bf16 else x), y


def transformer_train_flops_per_token(args, params_total: int) -> float:
    """Training FLOPs per token: 6*N for the parameter matmuls (fwd 2N +
    bwd 4N) plus the attention scores/values term 12*L*S*d (*0.5 causal),
    the PaLM appendix's accounting, as ``examples/benchmark.py`` counts."""
    attn = 12 * args.num_layers * args.seq_len * args.embed_dim * 0.5
    return 6.0 * params_total + attn


@torch.no_grad()
def consensus_spread(flat: torch.Tensor, chunk: int = 1 << 24) -> dict:
    """The ranks' deviation from the rank mean: ``max``, the largest of any
    parameter, and ``rms``, its root mean square over every rank and
    parameter (a combine of a share of the columns, as ``sparse:<frac>``,
    shrinks the rms but may leave the largest deviation where it was).
    Under ``basics.init_distributed`` ``flat`` holds this process's ranks,
    and the mean, the largest deviation and the sum of squares are taken
    over every process's."""
    from bluefog_tpu_torch import basics
    procs = basics.process_ranks() if basics.initialized() else None
    n = flat.shape[0] if procs is None else procs.n

    # gloo moves CPU tensors: a card's tensor crosses through the host.
    host = procs is not None and flat.device.type == "cuda" and \
        torch.distributed.get_backend() == "gloo"

    def total(t, op=None):
        if procs is not None:
            h = t.cpu() if host else t
            torch.distributed.all_reduce(
                h, op=op or torch.distributed.ReduceOp.SUM)
            if host:
                t.copy_(h)
        return t
    worst = torch.zeros((), device=flat.device)
    sq = torch.zeros((), device=flat.device, dtype=torch.float64)
    for cols in flat.split(chunk, dim=1):
        dev = cols - total(cols.sum(0, keepdim=True)) / n
        worst = torch.maximum(worst, dev.abs().amax())
        sq += dev.square().sum().double()
    total(worst, torch.distributed.ReduceOp.MAX)
    total(sq)
    return {"max": float(worst), "rms": float((sq / (n * flat.shape[1])).sqrt())}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _image_model(args, attn):
    """``(make_module, (H, W, C), input dtype, classes)`` of an image
    model, as ``examples/benchmark.py`` builds it."""
    from bluefog_tpu_torch import models as M
    size = args.image_size
    if args.model.startswith(("resnet", "vgg")):
        cls = getattr(M, args.model.replace("resnet", "ResNet")
                      .replace("vgg", "VGG"))
        kw = {"image_size": size} if args.model.startswith("vgg") else {}
        return (lambda: cls(num_classes=1000, **kw)), (size, size, 3), \
            torch.bfloat16, 1000
    if args.model == "lenet":
        return M.LeNet5, (28, 28, 1), torch.float32, 10
    return (lambda: M.ViT(num_classes=1000, image_size=size, attn_impl=attn,
                          remat=args.remat,
                          remat_policy=args.remat_policy)), \
        (size, size, 3), torch.bfloat16, 1000


class Trainer:
    """The benchmark's training setup: ``ranks`` replicas of the model on
    one device, their per-rank data, and the distributed optimizer."""

    def __init__(self, args):
        import bluefog_tpu_torch as bf
        from bluefog_tpu_torch.models.convert import jax_ravel_order
        from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                          TransformerLM)
        from bluefog_tpu_torch.ops.flash_attention import \
            flash_attention_impl
        from bluefog_tpu_torch.optim import optimizers as O
        from bluefog_tpu_torch.optim import window_optimizers as WO
        from bluefog_tpu_torch.replicas import RankReplicas

        if not (bf.initialized() and bf.process_ranks() is not None):
            # As the JAX benchmark: machines of half the ranks.
            bf.init(args.ranks, device=args.device,
                    local_size=max(1, args.ranks // 2)
                    if args.dist_optimizer == "hierarchical" else None)
        # Every process draws the same initialization and every rank's data
        # from the seed, then keeps its own ranks' rows.
        world, own = bf.size(), bf.owned_ranks()
        rows = slice(own[0], own[-1] + 1)
        self.n, self.world, self.device = len(own), world, bf.device()
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True  # tuned in the warmup
        attn = flash_attention_impl() if args.flash_attention else None
        gen = torch.Generator(device=self.device).manual_seed(args.seed)
        self.image = args.model != "transformer"
        self.chunked_loss = args.chunked_loss
        if self.image:
            make, hwc, dtype, self.classes = _image_model(args, attn)
            self.inputs = torch.randn((world, args.batch_size) + hwc,
                                      generator=gen, device=self.device
                                      )[rows].to(dtype)
            self.targets = torch.randint(0, self.classes,
                                         (world, args.batch_size),
                                         generator=gen,
                                         device=self.device)[rows]
        else:
            # The LM's compute dtype: TransformerConfig's (bfloat16), or a
            # caller's ``args.lm_dtype`` (no flag: chip_smoke's f16_train
            # sets torch.float16, the JAX model's own dtype field).
            lm_dtype = getattr(args, "lm_dtype", None)
            self.cfg = TransformerConfig(
                **({"dtype": lm_dtype} if lm_dtype is not None else {}),
                vocab_size=args.vocab_size, num_layers=args.num_layers,
                num_heads=args.num_heads, embed_dim=args.embed_dim,
                max_seq_len=args.seq_len, remat=args.remat,
                remat_policy=args.remat_policy,
                num_kv_heads=args.num_kv_heads or None,
                pos_encoding="rope" if args.rope else "learned",
                mlp="swiglu" if args.swiglu else "gelu",
                num_experts=args.num_experts)
            self.classes = args.vocab_size
            make = lambda: TransformerLM(self.cfg, attn)  # noqa: E731
        with torch.device("meta"):
            order = jax_ravel_order(make())
        self.rep = RankReplicas(make, self.n, self.device,
                                init=lambda m: m.reset_parameters(gen),
                                order=order)
        if not self.image:
            self.inputs = torch.randint(0, args.vocab_size,
                                        (world, args.batch_size,
                                         args.seq_len),
                                        generator=gen,
                                        device=self.device)[rows]
            self.targets = torch.roll(self.inputs, -1, dims=2)
        base = torch.optim.SGD([self.rep.flat], lr=0.0125 * world,
                               momentum=args.momentum, dampening=0)
        self.note = None
        if args.dist_optimizer == "win_put":
            # In one process no window payload crosses the transport.
            if args.compression != "none" and world == self.n:
                self.note = WIN_COMPRESSION_NOTE
            with window_codec(args):
                self.opt = WO.DistributedWinPutOptimizer(base)
            return
        if args.dist_optimizer == "gradient_allreduce":
            # As the JAX benchmark: --atc and --dynamic do not apply.
            self.opt = O.DistributedGradientAllreduceOptimizer(
                base, compression=args.compression)
            return
        cls = (O.DistributedAdaptThenCombineOptimizer if args.atc
               else O.DistributedAdaptWithCombineOptimizer)
        comm = ("hierarchical_neighbor_allreduce"
                if args.dist_optimizer == "hierarchical"
                else args.dist_optimizer)
        self.opt = cls(base, O.CommunicationType[comm],
                       use_dynamic_topology=args.dynamic,
                       compression=args.compression)

    def forward_backward(self) -> torch.Tensor:
        """Every rank's forward and backward, one after another; returns
        the per-rank losses."""
        self.rep.zero_grad()
        losses = []
        for r in range(self.n):
            mod = self.rep.modules[r]
            if self.chunked_loss and not self.image:
                loss = chunked_softmax_cross_entropy(
                    mod(self.inputs[r], return_hidden=True),
                    mod.lm_head.weight, self.targets[r])
            else:
                logits = mod(self.inputs[r])
                loss = F.cross_entropy(logits.reshape(-1, self.classes),
                                       self.targets[r].reshape(-1))
            loss.backward()
            losses.append(loss.detach())
        return torch.stack(losses)


def window_codec(args):
    """``--compression`` as the window codec, for the enclosed block, under
    ``--dist-optimizer win_put`` (a scoped override of the port's config:
    ``os.environ`` is not touched)."""
    if args.dist_optimizer != "win_put":
        return contextlib.nullcontext()
    from bluefog_tpu_torch.utils import config
    return config.override(win_compression=args.compression)


def measure(args, tr: Trainer = None, quiet: bool = False,
            phase_series: str = None) -> dict:
    """Run the benchmark (on ``tr``, or a new ``Trainer(args)``); returns
    its numbers, rates over all ranks on the one device (img/s for the
    image models, tokens/s for the LM).  ``quiet`` prints no per-iteration
    line and writes no ``--metrics-file``.  ``phase_series`` names a
    histogram that gets each timed step's host time (phase
    ``optimizer-update``) and each iteration's device wait (``host-sync``),
    as the root ``bench.py``'s ``bf_bench_phase_seconds``."""
    tr = tr or Trainer(args)
    with window_codec(args):
        return _measure(args, tr, quiet, phase_series)


def _measure(args, tr: Trainer, quiet: bool, phase_series=None) -> dict:
    from bluefog_tpu_torch.utils import telemetry
    from bluefog_tpu_torch.ops import window as W
    n, dev, rep, opt = tr.n, tr.device, tr.rep, tr.opt
    forward_backward = tr.forward_backward
    host_data = getattr(args, "host_data", False)
    if host_data:
        # Each batch from host memory: the step waits for its copy.
        feed = host_feed(tr)

        def forward_backward():
            tr.inputs, tr.targets = next(feed)
            return tr.forward_backward()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # Gradient allreduce keeps the replicas equal: its spread is read after
    # every warmup step and every timed iteration (outside the clock).
    grad_ar = getattr(opt, "order", None) == "gradient_allreduce"
    # A step observed between its halves: ATC, and win_put (adapt, then
    # the puts and the window update).
    halves = args.atc or args.dist_optimizer == "win_put"
    spread = {"after_step": []} if grad_ar else None
    losses = None
    by_step = []  # every step's per-rank losses, read once at the end
    for i in range(args.num_warmup_batches):
        losses = forward_backward()
        by_step.append(losses)
        if grad_ar:
            opt.step()
            spread["after_step"].append(consensus_spread(rep.flat)["max"])
        elif i == 0 and halves:
            # One observed step: the ranks' spread after the local update
            # and after the combine.
            opt.adapt()
            before = consensus_spread(rep.flat)
            opt.combine()
            after = consensus_spread(rep.flat)
            spread = {"after_adapt": before["max"],
                      "after_combine": after["max"],
                      "rms_after_adapt": before["rms"],
                      "rms_after_combine": after["rms"]}
        else:
            opt.step()
    _sync(dev)

    rates, step_s = [], []
    win0 = W.stats.snapshot()
    unit = "imgs" if tr.image else "tokens"
    per_batch = n * args.batch_size * (1 if tr.image else args.seq_len)
    writer = None
    if getattr(args, "metrics_file", None) and not quiet:
        from bluefog_tpu_torch.utils.metrics import MetricsWriter
        writer = MetricsWriter(args.metrics_file)
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            t_step = time.perf_counter()
            losses = forward_backward()
            by_step.append(losses)
            opt.step()
            if phase_series:
                telemetry.observe(phase_series, time.perf_counter() - t_step,
                                  phase="optimizer-update")
        t_sync = time.perf_counter()
        _sync(dev)
        if phase_series:
            telemetry.observe(phase_series, time.perf_counter() - t_sync,
                              phase="host-sync")
        dt = time.perf_counter() - t0
        rates.append(per_batch * args.num_batches_per_iter / dt)
        step_s.append(dt / args.num_batches_per_iter)
        if grad_ar:
            spread["after_step"].append(consensus_spread(rep.flat)["max"])
        if writer is not None:
            writer.log(step=i, **{f"{unit}_per_sec": rates[-1]},
                       model=args.model, n_devices=n)
        if not quiet:
            print(f"iter {i}: {rates[-1]:.1f} {unit}/sec across {n} ranks "
                  f"on {dev}", flush=True)
    if writer is not None:
        writer.close()

    out = {
        "model": args.model,
        "device": str(dev),
        "ranks": n,
        "world_size": tr.world,
        "params_per_rank": rep.numel,
        "step_ms": 1e3 * float(np.mean(step_s)),
        f"{unit}_per_s": float(np.mean(rates)),
        f"{unit}_per_s_ci": 1.96 * float(np.std(rates)),
        "rates": rates,
        "losses": [float(x) for x in losses.cpu()],
        "losses_by_step": torch.stack(by_step).cpu().tolist(),
        "spread": spread,
        "steps": opt.step_count,
        "host_data": bool(host_data),
    }
    if host_data:
        feed.close()   # the prefetch thread exits
    if W._store.distrib is not None:
        # The timed steps' cross-process window path, a step.
        steps = args.num_iters * args.num_batches_per_iter
        win1 = W.stats.snapshot()
        out["window"] = {k: (win1[k] - win0[k]) / steps for k in win1}
        # fastcall or ctypes on the native path, python on the other
        out["window"]["send_path"] = W._store.distrib.transport.send_path
    if tr.note:
        out["compression_note"] = tr.note
    if args.mfu and not tr.image and args.num_experts:
        out["mfu_note"] = MOE_MFU_NOTE
    elif args.mfu and not tr.image:
        fpt = transformer_train_flops_per_token(args, rep.numel)
        out["train_flops_per_token"] = fpt
        out["peak_tflops"] = args.peak_tflops
        # All ranks share the one card: the card's whole rate counts.
        out["mfu"] = out["tokens_per_s"] * fpt / (args.peak_tflops * 1e12)
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if W._store.distrib is not None and args.dist_optimizer == "win_put":
        # The async mode leaves the last step's puts in flight: every
        # process lands them before any tears its transport down.
        W.win_fence()
    return out


def efficiency(args, res: dict) -> dict:
    """The scaling efficiency of ``res`` (a :func:`measure` of this
    process's ranks) against one rank alone, as ``examples/benchmark.py
    --efficiency``: the rate over ``ranks`` x the one rank's rate."""
    unit = "tokens" if args.model == "transformer" else "imgs"
    one = measure(argparse.Namespace(**{**vars(args), "ranks": 1}),
                  quiet=True)
    rate1 = one[f"{unit}_per_s"]
    return {"single_rank_per_s": rate1,
            "efficiency": res[f"{unit}_per_s"] / (res["ranks"] * rate1)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import bluefog_tpu_torch as bf
    launched = "BFTPU_COORDINATOR" in os.environ or "WORLD_SIZE" in os.environ
    if launched:
        bf.init_distributed(device=args.device, backend=args.backend)
    res = measure(args)
    unit = "tokens" if args.model == "transformer" else "imgs"
    if args.efficiency and not launched and res["ranks"] > 1:
        res.update(efficiency(args, res))
    print(f"total {unit}/sec: {res[unit + '_per_s']:.1f} +- "
          f"{res[unit + '_per_s_ci']:.1f} ({res['ranks']} ranks on "
          f"{res['device']}, model={args.model}, step "
          f"{res['step_ms']:.1f} ms)")
    for key in ("mfu_note", "compression_note"):
        if key in res:
            print(f"note: {res[key]}")
    if "mfu" in res:
        print(f"MFU: {100 * res['mfu']:.1f}% of {res['peak_tflops']:.0f} "
              f"TFLOP/s ({res['train_flops_per_token'] / 1e9:.2f} GFLOP "
              f"a token)")
    if "efficiency" in res:
        print(f"single-rank {unit}/sec: {res['single_rank_per_s']:.1f}")
        print(f"scaling efficiency at {res['ranks']} ranks: "
              f"{100 * res['efficiency']:.1f}% ({res[unit + '_per_s']:.1f} "
              f"vs {res['ranks']} x {res['single_rank_per_s']:.1f})")
    elif args.efficiency:
        print("scaling efficiency: nothing to compare (one rank, or several "
              "processes: run once per world size and divide the totals)")
    print(json.dumps(res))
    if launched:
        bf.shutdown()
    return res


if __name__ == "__main__":
    main()
