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
(batch 2, 64x64, 1 warmup and 2 x 2 timed batches), never a throughput.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from bluefog_tpu_torch import benchmark

__all__ = ["main", "BASELINE_PER_GPU"]

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


def main(argv=None):
    args = build_parser().parse_args(argv)
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
    res = benchmark.measure(bargs, quiet=True)
    total = res["imgs_per_s"]
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
        "step_ms": res["step_ms"],
        "peak_mem_gb": res.get("peak_mem_gb"),
    }
    if on_card:
        import torch
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
