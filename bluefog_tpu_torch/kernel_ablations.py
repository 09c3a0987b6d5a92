"""Where K1 (flash forward), K2 (flash dq) and K3 (flash dk/dv) spend their
time.

    python -m bluefog_tpu_torch.kernel_ablations [--iters 30]

Each variant is a copy of ``csrc/flash_attention.cu`` (and ``hopper.cuh``)
with one part of the kernels' work removed or changed by a text edit; all
copies build at once with ``nvcc`` (the shape's head-dim instance alone)
and are timed against the source as it is, on the training shape (B=2, S=2048, H=16, D=128, bf16, causal, fused
QKV), in turns.  A variant that still computes attention is also held to
the plain twin.  Needs a GPU; prints one JSON line per variant (``k1_ms``,
``k2_ms``, ``k3_ms``; the source's rows also ``flash_delta_ms``, the plain
op that K2's fused delta replaces) and the card's ``nvidia-smi`` name and
power limit last.

Variants (each edit replaces every occurrence of its text, so text that
K1 and K2 share is meant to change in both):

- ``as-is``: the committed source.
- ``no-exp``: the exponentials become the identity (K1's softmax, K2's and
  K3's P).
- ``no-second-product``: K1 skips O += P.V; K2 skips dQ += dS.K; K3 skips
  dV and dK.
- ``one-tile``: every streamed tile loads from the block's first tile, so
  the loads hit L2 instead of device memory (K1 and K2 share the K/V
  producer, ``stream_kv``).
- ``head-major``: grid (row tiles, B*H) instead of (B*H, row tiles): the
  blocks of one head run together, not the heaviest tiles of all heads
  (K1 and K2 share the lines edited).
- ``stages-3``: three ring stages instead of two, in K1 and K3; K2 keeps
  two (a third does not fit in shared memory beside its Q, dO and O tiles).
- ``k3-rows-32``: K3 streams 32-row q tiles (S^T and dP^T m64n32k16).
- ``k2-keys-64``: K2 streams 64-key K/V tiles (S and dP m64n64k16).
- ``k2-no-delta``: K2 reads delta from memory (here the plain op's) instead
  of computing it from O and dO; no O tile is loaded.
- ``k2-one-wait``: K2 commits S and dP as one group and waits for both
  before computing P (no overlap of the exponentials with dP).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from bluefog_tpu_torch.ops import _nvcc
from bluefog_tpu_torch.ops import flash_attention as FA

__all__ = ["VARIANTS", "variant_sources", "main"]

SHAPE = (2, 2048, 16, 128)

# name: (edits of the .cu, edits of hopper.cuh, launch-plan overrides)
VARIANTS = {
    "as-is": ([], [], {}),
    "no-exp": ([
        ("exp2f(fmaf(s[i], scale_log2, -m[r]))", "fmaf(s[i], scale_log2, -m[r])"),
        ("exp2f(fmaf(s[i + 1], scale_log2, -m[r]))",
         "fmaf(s[i + 1], scale_log2, -m[r])"),
        ("hopper::exp2_ftz(s[i] * scale_log2)", "(s[i] * scale_log2)"),
        ("hopper::exp2_ftz(s[i + 1] * scale_log2)", "(s[i + 1] * scale_log2)"),
        ("hopper::exp2_ftz(fmaf(s[i], scale_log2, -lse2[r]))",
         "fmaf(s[i], scale_log2, -lse2[r])"),
    ], [], {}),
    "no-second-product": ([
        ("hopper::wgmma_rs_tb(acc, &p[4 * kk]", "if (0) hopper::wgmma_rs_tb(acc, &p[4 * kk]"),
        ("hopper::wgmma_rs_tb(acc, &ds[4 * kk]", "if (0) hopper::wgmma_rs_tb(acc, &ds[4 * kk]"),
        ("hopper::wgmma_rs_tb(acc_v,", "if (0) hopper::wgmma_rs_tb(acc_v,"),
        ("hopper::wgmma_rs_tb(acc_k,", "if (0) hopper::wgmma_rs_tb(acc_k,"),
    ], [], {}),
    "one-tile": ([
        ("T::kKeys, kt * T::kKeys, h, b);", "T::kKeys, 0, h, b);"),
        ("&full[st], T::kRows, q0, h, b);", "&full[st], T::kRows, qt0 * T::kRows, h, b);"),
    ], [], {}),
    "head-major": ([
        ("const int bh = blockIdx.x, b = bh / H, h = bh % H;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;",
         "const int bh = blockIdx.y, b = bh / H, h = bh % H;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kRows;"),
        ("const int bh = blockIdx.x, b = bh / H, h = bh % H;\n"
         "  const int k0 = blockIdx.y * T::kKeys;",
         "const int bh = blockIdx.y, b = bh / H, h = bh % H;\n"
         "  const int k0 = blockIdx.x * T::kKeys;"),
    ], [], {"grid": "swap"}),
    "stages-3": ([(f"{tile}\n  static constexpr int kStages = 2;",
                   f"{tile}\n  static constexpr int kStages = 3;")
                  for tile in ("static constexpr int kKeys = D > 128 ? 64 : 128;  "
                               "// keys per pipeline stage",
                               "static constexpr int kRows = 64;   // query rows per pipeline stage")],
                 [], {"stages": 3}),
    "k3-rows-32": ([("static constexpr int kRows = 64;   // query rows",
                     "static constexpr int kRows = 32;   // query rows")],
                   [("}  // namespace hopper", "WGMMA_N32\n}  // namespace hopper")],
                   {"dkv_rows": 32}),
    "k2-keys-64": ([("static constexpr int kKeys = D > 128 ? 64 : 128;  // keys per stage of the ring",
                     "static constexpr int kKeys = 64;  // keys per stage of the ring")],
                   [], {"dq_keys": 64}),
    "k2-no-delta": ([
        ("hopper::mbar_arrive_expect_tx(&bar_q, 3 * T::kRowBytes);",
         "hopper::mbar_arrive_expect_tx(&bar_q, 2 * T::kRowBytes);"),
        ("load_rows<D>(sO, &to,", "if (0) load_rows<D>(sO, &to,"),
        ("row_dot<D>(sO, sdO, T::kRows, lr, t)", "0.f"),
        ("dot - dlse[((long long)b * S + row[r]) * H + h]",
         "dot + delta[(long long)bh * S + row[r]]"),
        ("if (t == 0 && in) delta[", "if (0) delta["),
    ], [], {}),
    "k2-one-wait": ([("hopper::wgmma_commit();  // S\n", ""),
                     ("hopper::wgmma_wait<1>();", "hopper::wgmma_wait<0>();")], [], {}),
}


def _wgmma_ss_n32() -> str:
    """The m64n32k16 shared-operand wgmma that 32-row q tiles need."""
    outs = ", ".join(f"%{i}" for i in range(16))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(16))
    return (
        "__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,\n"
        "                                         uint64_t b, int accumulate) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %18, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "\n'
        f'      "{{{outs}}}, %16, %17, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f'      : {regs}\n'
        '      : "l"(a), "l"(b), "r"(accumulate));\n'
        "}\n")


def _apply(text: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def variant_sources(name: str, csrc: Path = _nvcc.CSRC_DIR):
    """``(flash_attention.cu, hopper.cuh)`` texts of a variant; raises
    ``ValueError`` if an edit no longer matches the source."""
    cu_edits, h_edits, _ = VARIANTS[name]
    cu = _apply((csrc / "flash_attention.cu").read_text(), cu_edits, name)
    h = _apply((csrc / "hopper.cuh").read_text(), h_edits, name)
    return cu, h.replace("WGMMA_N32", _wgmma_ss_n32())


def _load(path: Path):
    """The variant's library, bound like ``FA.load_library``'s."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(I)]
    lib.bf_flash_fwd.argtypes = [P] * 5 + [I] * 3 + plan + [F, I, P]
    lib.bf_flash_dq.argtypes = [P] * 9 + [I] * 3 + plan + [F, I, P]
    lib.bf_flash_dkv.argtypes = [P] * 8 + [I] * 3 + plan + [F, I, P]
    return lib


def _plan(kernel, strides, over):
    """The launch plan under a variant's overrides, as C arrays."""
    saved = dict(FA._TILES)
    key = (kernel, SHAPE[-1])
    try:
        block, step, stages, threads = FA._TILES[key]
        if kernel == "dkv":
            step = over.get("dkv_rows", step)
        if kernel == "dq":
            step = over.get("dq_keys", step)
        else:
            stages = over.get("stages", stages)
        FA._TILES[key] = (block, step, stages, threads)
        plan = FA.launch_plan(kernel, SHAPE, strides, True)
    finally:
        FA._TILES.clear()
        FA._TILES.update(saved)
    flat = [x for m in plan.maps.values() for x in m.flat()]
    grid = plan.grid[::-1] if over.get("grid") == "swap" else plan.grid
    return ((ctypes.c_longlong * len(flat))(*flat),
            (ctypes.c_int * 4)(*grid, plan.threads, plan.smem))


def _ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablations needs a GPU")
    with tempfile.TemporaryDirectory(prefix="bf_ablate_") as tmp:
        _run(Path(tmp), args.iters)


def _run(tmp: Path, iters: int):
    procs = {}
    for name in VARIANTS:
        d = tmp / name
        d.mkdir()
        cu, h = variant_sources(name)
        (d / "flash_attention.cu").write_text(cu)
        (d / "hopper.cuh").write_text(h)
        for header in _nvcc.CSRC_DIR.glob("*.cuh"):
            if header.name != "hopper.cuh":
                shutil.copy(header, d)
        # SHAPE's head-dim instance alone.
        procs[name] = subprocess.Popen(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS,
             f"-DFLASH_D={FA.instance(torch.bfloat16, SHAPE[-1])}",
             "-o", str(d / "lib.so"), str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")

    dev = torch.device("cuda")
    B, S, H, D = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(B, S, H, 3, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    o_r, lse_r = FA.flash_fwd_ref(q.float(), k.float(), v.float(), True)
    lse = lse_r.transpose(1, 2).contiguous()
    o_bf = o_r.to(torch.bfloat16)
    dlse = torch.zeros_like(lse_r)                          # (B, S, H)
    delta = FA.flash_delta(o_bf, do, dlse)
    dq_r, dk_r, dv_r = FA.flash_bwd_ref(q.float(), k.float(), v.float(), o_r,
                                        lse_r, do.float(), dlse, True)
    st = {"q": q.stride(), "k": k.stride(), "v": v.stride(), "do": do.stride(),
          "o": o_bf.stride()}
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(D)
    rel = lambda a, b: float((a.float() - b).norm() / b.norm())  # noqa: E731

    libs = {n: _load(tmp / n / "lib.so") for n in VARIANTS}
    for name in [*VARIANTS, "as-is"]:          # the source again, last
        lib, over = libs[name], VARIANTS[name][2]
        fwd_plan = _plan("fwd", {n: st[n] for n in "qkv"}, over)
        dq_plan = _plan("dq", st, over)
        dkv_plan = _plan("dkv", {n: st[n] for n in ("q", "k", "v", "do")}, over)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse_k = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(o) for _ in range(3))
        delta_k = delta.clone()          # k2-no-delta reads it; K2 writes it

        def k1():
            rc = lib.bf_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), lse_k.data_ptr(), S, H, D,
                                  *fwd_plan, scale, 1, stream)
            if rc:
                raise RuntimeError(f"{name}: K1 launch failed, CUDA error {rc}")

        def k2():
            rc = lib.bf_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), o_bf.data_ptr(), lse.data_ptr(),
                                 dlse.data_ptr(), delta_k.data_ptr(),
                                 dq.data_ptr(), S, H, D, *dq_plan, scale, 1,
                                 stream)
            if rc:
                raise RuntimeError(f"{name}: K2 launch failed, CUDA error {rc}")

        def k3():
            rc = lib.bf_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                  dk.data_ptr(), dv.data_ptr(), S, H, D,
                                  *dkv_plan, scale, 1, stream)
            if rc:
                raise RuntimeError(f"{name}: K3 launch failed, CUDA error {rc}")

        k1()
        k2()
        k3()
        torch.cuda.synchronize()
        res = {"variant": name, "k1_ms": _ms(k1, iters), "k2_ms": _ms(k2, iters),
               "k3_ms": _ms(k3, iters)}
        if name in ("as-is", "head-major", "stages-3", "k3-rows-32",
                    "k2-keys-64", "k2-no-delta", "k2-one-wait"):
            res["k1_rel_err"] = rel(o, o_r)
            res["k2_rel_err"] = max(rel(dq, dq_r), rel(delta_k, delta))
            res["k3_rel_err"] = max(rel(dk, dk_r), rel(dv, dv_r))
        if name == "as-is":
            res["flash_delta_ms"] = _ms(lambda: FA.flash_delta(o_bf, do, dlse),
                                        iters)
        print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
