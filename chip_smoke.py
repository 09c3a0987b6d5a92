#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``bluefog_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``device``   — the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``    — builds the flash-attention kernels from ``csrc/`` with
   ``nvcc`` (``-Xptxas -v``: registers, shared memory, spills).
3. ``kernel``   — each of K1 (forward), K2 (dq) and K3 (dk/dv) against its
   plain PyTorch twin on the same inputs, at the training path's shape
   (B=2, S=2048, H=16, D=128, bf16, causal, q/k/v strided slices of a fused
   QKV tensor), at ragged S=1000 and non-causal, with kernel, twin and SDPA
   times and the least time the card could take (989 TFLOP/s bf16,
   3.35 TB/s); then head dim 64 (causal, and ragged non-causal), checked
   only.  Matmuls run with TF32 off.  Each output is held to its twin twice:
   by its relative error ``||kernel - twin|| / ||twin||`` (``REL_TOL``),
   which sees an error spread thinly over many rows, and element by element
   by ``max |kernel - twin| / (|twin| + rms(twin))`` (``ELEM_TOL``), which
   sees an error confined to a few rows; the lse by its largest absolute
   error (``LSE_TOL``).
4. ``reference`` — a small TransformerLM on the card: logits and gradients
   through the kernels against the same model with dense attention, by
   relative error (logits, and each parameter's gradient).
5. ``train``    — ``bluefog_tpu_torch.benchmark``: TransformerLM 24 layers,
   width 2048, 16 heads, seq 2048, batch 2, vocab 32000, SGD momentum 0,
   4 virtual ranks on the card, ATC over the dynamic one-peer topology,
   1 warmup + 3 timed steps.  Launch counts of K1-K3 must equal
   layers x ranks x steps.
6. ``{"kernels": [...]}``, then the ``nvidia-smi`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a GPU or outside the repository.
"""

import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# Limits, a few times the errors of sound bf16 kernels on the card (the
# readings stand in PERF.md).  Both output measures scale with the typical
# output, not with the largest one.
REL_TOL = 1e-2               # K1-K3 outputs vs twin: ||err|| / ||twin||
ELEM_TOL = 0.15              # and max |err| / (|twin| + rms(twin))
LSE_TOL = 1e-4               # K1 lse vs twin: max |err| (f32, |lse| ~ 8)
REF_LOGITS_TOL = 2e-2        # flash vs dense model, both bf16: logits
REF_GRAD_TOL = 5e-2          # and each parameter's gradient
LAYERS = 24
SEED = 0                     # inputs and weights are drawn from it
SOURCE = "bluefog_tpu_torch/csrc/flash_attention.cu"
KERNELS = {
    "K1": ("flash_fwd", "bluefog_tpu/ops/flash_attention.py:42"),
    "K2": ("flash_dq", "bluefog_tpu/ops/flash_attention.py:180"),
    "K3": ("flash_dkv", "bluefog_tpu/ops/flash_attention.py:211"),
}


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b):
    """``||a - b|| / ||b||`` in float32."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm())


def elem_err(a, b):
    """``max |a - b| / (|b| + rms(b))`` in float32."""
    b = b.float()
    rms = b.square().mean().sqrt()
    return float(((a.float() - b).abs() / (b.abs() + rms)).max())


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernels(B, S, H, D, causal, seed, timed):
    """K1-K3 against their twins at one shape; returns per-kernel dicts."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, S, H, 3, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    dlse = 0.1 * torch.randn(B, S, H, generator=g, device=dev)
    f32 = [t.float() for t in (q, k, v, do)]

    o_k, lse_k = FA.flash_fwd_cuda(q, k, v, causal)
    o_r, lse_r = FA.flash_fwd_ref(*f32[:3], causal)
    o = o_r.to(torch.bfloat16)
    lse_bhs = lse_r.transpose(1, 2).contiguous()
    delta = FA.flash_delta(o, do, dlse)
    dq_k = FA.flash_dq_cuda(q, k, v, do, lse_bhs, delta, causal)
    dk_k, dv_k = FA.flash_dkv_cuda(q, k, v, do, lse_bhs, delta, causal)
    dq_r, dk_r, dv_r = FA.flash_bwd_ref(*f32[:3], o.float(), lse_r, f32[3],
                                        dlse, causal)
    torch.cuda.synchronize()

    def err(pairs):
        """Largest relative error and largest absolute error over the
        outputs."""
        rel = max(rel_err(a, b) for a, b in pairs)
        elem = max(elem_err(a, b) for a, b in pairs)
        e = max(float((a.float() - b).abs().max()) for a, b in pairs)
        require(math.isfinite(e) and rel <= REL_TOL,
                f"||kernel - twin|| / ||twin|| {rel} over {REL_TOL}")
        require(elem <= ELEM_TOL,
                f"max |kernel - twin| / (|twin| + rms(twin)) {elem} over "
                f"{ELEM_TOL}")
        return {"rel_err": rel, "elem_err": elem, "max_abs_err": e}

    res = {"K1": err([(o_k, o_r)]), "K2": err([(dq_k, dq_r)]),
           "K3": err([(dk_k, dk_r), (dv_k, dv_r)])}
    lse_err = float((lse_k.transpose(1, 2) - lse_r).abs().max())
    require(lse_err <= LSE_TOL, f"max |lse - twin| {lse_err} over {LSE_TOL}")
    res["K1"]["lse_max_abs_err"] = lse_err
    pairs = S * (S + 1) // 2 if causal else S * S
    bsd, bhs = B * S * H * D * 2, B * H * S * 4
    work = {"K1": (4 * B * H * pairs * D, 4 * bsd + bhs),
            "K2": (6 * B * H * pairs * D, 5 * bsd + 2 * bhs),
            "K3": (8 * B * H * pairs * D, 6 * bsd + 2 * bhs)}
    for name, (flops, nbytes) in work.items():
        res[name]["bound_ms"], res[name]["bound_by"] = bound(flops, nbytes)
    if not timed:
        return res

    res["K1"]["ms"] = cuda_ms(lambda: FA.flash_fwd_cuda(q, k, v, causal))
    res["K2"]["ms"] = cuda_ms(
        lambda: FA.flash_dq_cuda(q, k, v, do, lse_bhs, delta, causal))
    res["K3"]["ms"] = cuda_ms(
        lambda: FA.flash_dkv_cuda(q, k, v, do, lse_bhs, delta, causal))
    res["K1"]["plain_ms"] = cuda_ms(
        lambda: FA.flash_fwd_ref(q, k, v, causal), iters=5, warmup=1)
    # The twin computes dq, dk and dv in one pass: its time stands for K2
    # and K3 together.
    bwd_plain = cuda_ms(lambda: FA.flash_bwd_ref(q, k, v, o, lse_r, do, dlse,
                                                 causal), iters=5, warmup=1)
    res["K2"]["plain_ms"] = res["K3"]["plain_ms"] = bwd_plain

    # Library yardstick (never called by the port): SDPA on (B, H, S, D).
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    res["K1"]["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    # SDPA's backward computes dq, dk and dv in one call: its time stands
    # for K2 and K3 together.
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                  retain_graph=True))
    res["K2"]["library_ms"] = res["K3"]["library_ms"] = bwd_lib
    return res


def check_reference(seed):
    """A small model through the kernels against dense attention."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                            embed_dim=256, max_seq_len=256)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = TransformerLM(cfg).to(dev)
    dense.reset_parameters(g)
    flash = TransformerLM(cfg, flash_attention_impl()).to(dev)
    flash.load_state_dict(dense.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device=dev)
    out = {}
    grads = {}
    for name, model in (("dense", dense), ("flash", flash)):
        logits = model(tokens)
        require(logits.shape == (2, 256, cfg.vocab_size),
                f"{name} logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), f"{name} logits finite")
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               torch.roll(tokens, -1, 1).reshape(-1))
        loss.backward()
        out[name] = logits.detach()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    logit_err = rel_err(out["flash"], out["dense"])
    grad_err = {k: rel_err(grads["flash"][k], g)
                for k, g in grads["dense"].items()}
    worst = max(grad_err, key=grad_err.get)
    require(logit_err <= REF_LOGITS_TOL,
            f"logits differ by {logit_err} (relative) over {REF_LOGITS_TOL}")
    require(grad_err[worst] <= REF_GRAD_TOL,
            f"gradient of {worst} differs by {grad_err[worst]} (relative) "
            f"over {REF_GRAD_TOL}")
    return {"logits_rel_err": logit_err, "grad_rel_err": grad_err[worst],
            "grad_rel_err_worst_param": worst,
            "logits_max_abs_err": float((out["flash"] - out["dense"]).abs().max()),
            "tol": {"logits": REF_LOGITS_TOL, "grad": REF_GRAD_TOL}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    _, log = FA.load_library(verbose=True)
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])

    main_res = None
    # (case, B, S, H, D, causal, timed): the training shape, ragged S,
    # non-causal, and the head dim 64 instantiation (checked, not timed).
    for case, B, S, H, D, causal, timed in (
            ("main", 2, 2048, 16, 128, True, True),
            ("ragged", 2, 1000, 16, 128, True, True),
            ("noncausal", 2, 2048, 16, 128, False, True),
            ("d64", 2, 512, 8, 64, True, False),
            ("d64-ragged-noncausal", 1, 777, 4, 64, False, False)):
        res = check_kernels(B, S, H, D, causal, SEED, timed=timed)
        for kname, r in res.items():
            emit("kernel", kernel=kname, case=case, B=B, S=S, H=H, D=D,
                 dtype="bfloat16", causal=causal, rel_tol=REL_TOL,
                 elem_tol=ELEM_TOL,
                 lse_tol=LSE_TOL if kname == "K1" else None, **r)
        if case == "main":
            main_res = res

    emit("reference", **check_reference(SEED))

    args = benchmark.build_parser().parse_args([
        "--num-layers", str(LAYERS), "--embed-dim", "2048",
        "--num-heads", "16", "--seq-len", "2048", "--batch-size", "2",
        "--vocab-size", "32000", "--momentum", "0", "--ranks", "4",
        "--atc", "--dynamic", "--flash-attention",
        "--num-warmup-batches", "1", "--num-iters", "3",
        "--num-batches-per-iter", "1", "--seed", str(SEED)])
    FA.reset_launch_counts()
    res = benchmark.measure(args)
    launches = {"K1": FA.flash_fwd_cuda.launches,
                "K2": FA.flash_dq_cuda.launches,
                "K3": FA.flash_dkv_cuda.launches}
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    expected = LAYERS * args.ranks * steps
    emit("train", config={"num_layers": LAYERS, "embed_dim": 2048,
                          "num_heads": 16, "seq_len": 2048, "batch_size": 2,
                          "vocab_size": 32000, "momentum": 0.0,
                          "ranks": args.ranks, "order": "atc",
                          "topology": "dynamic one-peer ExponentialGraph(4)"},
         launches=launches, expected_launches=expected, **res)
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(all(c == expected for c in launches.values()),
            f"launches {launches}, expected {expected} of each")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")

    kernels = []
    for kname, (fn, replaces) in KERNELS.items():
        r = main_res[kname]
        kernels.append({"name": f"{kname} {fn}", "route": "cuda",
                        "source": SOURCE, "replaces": replaces,
                        "launches": launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
