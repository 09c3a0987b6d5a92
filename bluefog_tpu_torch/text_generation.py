"""Train a tiny character LM and generate text with the KV cache.

The port of ``examples/text_generation.py``: a Llama-style TransformerLM
(GQA + RoPE + SwiGLU, float32) memorizes a pangram with Adam, then
``models.transformer.generate`` continues a prompt through one prefill
forward and one-token decode steps; the KV cache stores the 2 shared kv
heads, a quarter of the 8-head cache.  It runs dense attention, as the JAX
example does.  A greedy continuation of a prefix of the training text must
match the text exactly.

    python -m bluefog_tpu_torch.text_generation             # on the GPU
    python -m bluefog_tpu_torch.text_generation --device cpu
    python -m bluefog_tpu_torch.text_generation --temperature 0.8

Prints the losses, the prompt and the continuation, and as its last line
one JSON object with the final loss and whether the greedy continuation
matched.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from bluefog_tpu_torch.basics import resolve_device
from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM, generate)

__all__ = ["TEXT", "build_parser", "main"]

TEXT = ("the quick brown fox jumps over the lazy dog. "
        "pack my box with five dozen liquor jugs. ")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--prompt", default="the quick brown ")
    ap.add_argument("--max-new-tokens", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    vocab = sorted(set(TEXT))
    stoi = {c: i for i, c in enumerate(vocab)}
    unknown = [c for c in args.prompt if c not in stoi]
    if unknown:  # fail before the training loop
        raise SystemExit(f"prompt contains unseen characters: {unknown}")
    dev = resolve_device(args.device)
    data = torch.tensor([[stoi[c] for c in TEXT * 4]], device=dev)

    cfg = TransformerConfig(
        vocab_size=len(vocab), num_layers=2, num_heads=8, num_kv_heads=2,
        embed_dim=128, max_seq_len=data.shape[1], pos_encoding="rope",
        mlp="swiglu", dtype=torch.float32)
    model = TransformerLM(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.reset_parameters(gen)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    loss = None
    for i in range(args.steps):
        opt.zero_grad()
        logits = model(data[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, len(vocab)),
                               data[0, 1:])
        loss.backward()
        opt.step()
        if (i + 1) % 100 == 0:
            print(f"step {i + 1}  loss {loss.item():.4f}", flush=True)

    prompt = torch.tensor([[stoi[c] for c in args.prompt]], device=dev)
    out = generate(model, prompt, args.max_new_tokens,
                   temperature=args.temperature,
                   generator=gen if args.temperature > 0 else None)
    text = "".join(vocab[int(t)] for t in out[0].cpu())
    print(f"prompt:    {args.prompt!r}")
    print(f"generated: {text!r}")
    res = {"device": str(dev), "steps": args.steps,
           "final_loss": None if loss is None else loss.item(),
           "generated": text, "matches_text": None}
    if args.temperature == 0.0 and TEXT.startswith(args.prompt):
        # Exact match holds only for prompts that start the training text:
        # a prompt from mid-text starts where the model never trained.
        need = len(args.prompt) + args.max_new_tokens
        want = (TEXT * (need // len(TEXT) + 2))[len(args.prompt):need]
        res["matches_text"] = text == want
        if text != want:
            raise SystemExit(f"greedy continuation {text!r} is not the "
                             f"training text {want!r}")
        print("greedy continuation matches the training text exactly")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
