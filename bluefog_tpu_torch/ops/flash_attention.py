"""Flash attention: hand-written Hopper kernels with a plain PyTorch twin.

The port of ``bluefog_tpu/ops/flash_attention.py``.  Its three Pallas TPU
kernels become three CUDA kernels for ``sm_90a`` in
``bluefog_tpu_torch/csrc/flash_attention.cu``, each warp-specialised: TMA
loads through an mbarrier ring, every product a ``wgmma``:

- K1 ``flash_fwd_cuda`` (replaces ``_fwd_kernel``): O and the per-row
  logsumexp by the online-softmax recurrence, logits never in device memory;
- K2 ``flash_dq_cuda`` (replaces ``_dq_kernel``): ``dq = sum_k dS K``, and
  the backward's ``delta = rowsum(dO o) - dlse`` for K3 (in the JAX
  package a plain op before both kernels);
- K3 ``flash_dkv_cuda`` (replaces ``_dkv_kernel``): ``dk = sum_q dS^T Q`` and
  ``dv = sum_q P^T dO``.

``flash_fwd_ref``, ``flash_bwd_ref`` and ``flash_delta`` are their plain
twins: the same functions as dense float32 math.  :class:`FlashAttention`
takes the plain path only for tensors on the CPU; for CUDA tensors it
launches the kernels or raises.  Each CUDA wrapper counts its launches in a plain integer
attribute ``launches``.

Layout: ``(B, S, H, D)`` like ``models.transformer.local_attention``; the
kernels read q, k, v and dO through their strides, so the fused-QKV slices
need no copy.  The lse is ``(B, S, H)`` at the public functions.

:func:`launch_plan` holds the host-side arithmetic of K1-K3 (grid, tile
counts, shared memory, and the TMA tensor maps over the operands' strides)
as a pure function of shapes and strides; the wrappers pass its result to
the C interface.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from bluefog_tpu_torch.ops import _nvcc

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_impl",
           "FlashAttention", "flash_fwd_ref", "flash_bwd_ref", "flash_delta",
           "flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda",
           "load_library", "reset_launch_counts", "launch_plan",
           "LaunchPlan", "TensorMapPlan"]

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_LIB = None


# ---------------------------------------------------------------------------
# Plain twins (dense, float32 inside)
# ---------------------------------------------------------------------------

def _scores(q, k, causal):
    """(B, H, S, S) float32 logits, masked to -1e30 like the TPU kernels."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_ref(q, k, v, causal: bool = True):
    """Plain twin of K1: ``(o, lse)`` with o ``(B, S, H, D)`` in q's dtype
    and lse ``(B, S, H)`` float32."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float().permute(0, 2, 1, 3)) / l
    lse = (m + torch.log(l)).squeeze(-1)                   # (B, H, S)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse.transpose(1, 2)


def flash_bwd_ref(q, k, v, o, lse, do, dlse, causal: bool = True):
    """Plain twin of K2 and K3: ``(dq, dk, dv)`` from the saved ``o`` and
    ``lse`` ``(B, S, H)`` and the cotangents of both outputs; a non-zero
    ``dlse`` folds into the delta term (``delta = rowsum(dO o) - dlse``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    bhsd = lambda t: t.float().permute(0, 2, 1, 3)          # noqa: E731
    qf, kf, vf, of, dof = map(bhsd, (q, k, v, o, do))
    lse_c = lse.float().transpose(1, 2).unsqueeze(-1)      # (B, H, S, 1)
    p = torch.exp(_scores(q, k, causal) - lse_c)           # masked -> 0
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True) \
        - dlse.float().transpose(1, 2).unsqueeze(-1)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    back = lambda t, like: t.permute(0, 2, 1, 3).to(like.dtype)  # noqa: E731
    return back(dq, q), back(dk, k), back(dv, v)


# ---------------------------------------------------------------------------
# CUDA kernels (K1-K3)
# ---------------------------------------------------------------------------

def load_library(verbose: bool = False):
    """Build (at first use) and load the kernels' library; returns
    ``(ctypes library, compiler log)``."""
    global _LIB
    if _LIB is not None and not verbose:
        return _LIB, ""
    path, log = _nvcc.build("flash_attention", verbose=verbose)
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(I)]  # maps, launch
    lib.bf_flash_fwd.argtypes = [P] * 5 + [I] * 3 + plan + [F, I, P]
    lib.bf_flash_dq.argtypes = [P] * 9 + [I] * 3 + plan + [F, I, P]
    lib.bf_flash_dkv.argtypes = [P] * 8 + [I] * 3 + plan + [F, I, P]
    for fn in (lib.bf_flash_fwd, lib.bf_flash_dq, lib.bf_flash_dkv):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib, log


# ---------------------------------------------------------------------------
# Launch plan of K1-K3 (pure host arithmetic; tested on the CPU)
# ---------------------------------------------------------------------------

# Tiles of csrc/flash_attention.cu (FwdTile, DqTile, DkvTile): a block of 3
# warpgroups owns `block` rows; `stream` rows of the other operands pass
# through a ring of `stages` shared-memory stages.  K1's and K2's blocks are
# query rows and stream keys; K3's block is keys and streams query rows.
_WS_THREADS = 384
_ALIGN = 1024                 # swizzled tiles start 1024-byte aligned
_SMEM_LIMIT = 232448          # dynamic shared memory a Hopper block may use
_BOX_COLS = 64                # one TMA box row: 64 bf16 = the 128-byte swizzle
_KERNELS = {
    # name: (block rows, streamed rows, stages, resident operands, streamed)
    "fwd": (128, 128, 2, ("q",), ("k", "v")),
    "dq": (128, 128, 2, ("q", "do", "o"), ("k", "v")),
    "dkv": (128, 64, 2, ("k", "v"), ("q", "do")),
}


@dataclasses.dataclass(frozen=True)
class TensorMapPlan:
    """One operand's TMA tensor map: dims innermost first ``(D, S, H, B)``,
    the byte strides of dims 1-3, and the box one load copies."""
    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]

    def flat(self) -> Tuple[int, ...]:
        return self.dims + self.strides + self.box


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Grid ``(B*H, row tiles)``, threads and dynamic shared-memory bytes of
    one launch; ``inner_tiles`` counts the ring stages filled over one
    (b, h), and ``maps`` the operands' tensor maps in C-interface order."""
    grid: Tuple[int, int]
    threads: int
    smem: int
    inner_tiles: int
    maps: Dict[str, TensorMapPlan]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tensor_map(name, shape, strides, rows) -> TensorMapPlan:
    B, S, H, D = shape
    sb, ss, sh, sd = strides
    if sd != 1:
        raise ValueError(f"{name}: the head dim must have unit stride, got "
                         f"{sd}")
    if any((2 * x) % 16 for x in (sb, ss, sh)):
        raise ValueError(f"{name}: TMA needs byte strides that are multiples "
                         f"of 16; got element strides {(sb, ss, sh)}")
    return TensorMapPlan(dims=(D, S, H, B), strides=(2 * ss, 2 * sh, 2 * sb),
                         box=(_BOX_COLS, rows, 1, 1))


def launch_plan(kernel: str, shape, strides, causal: bool = True) -> LaunchPlan:
    """The launch of K1 (``kernel="fwd"``; operands q, k, v), K2 (``"dq"``;
    q, k, v, do, o) or K3 (``"dkv"``; q, k, v, do) for ``shape = (B, S, H,
    D)`` and each operand's element strides ``(sb, ss, sh, sd)``.  Raises
    ``ValueError`` for a head dim other than 64 or 128, or strides a TMA
    map cannot describe."""
    block, step, stages, resident, streamed = _KERNELS[kernel]
    B, S, H, D = shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim {_HEAD_DIMS}, "
                         f"got {D}")
    if min(B, S, H) < 1:
        raise ValueError(f"empty shape {tuple(shape)}")
    maps = {n: _tensor_map(n, shape, strides[n], block if n in resident else step)
            for n in ("q", "k", "v", "do", "o") if n in resident + streamed}

    row_tiles = _ceil(S, block)
    tile = lambda rows: rows * D * 2                        # noqa: E731
    if kernel in ("fwd", "dq"):
        ring = stages * 2 * tile(step)                      # K and V
        smem = _ALIGN + len(resident) * tile(block) + ring
        inner = sum(_ceil(min(S, (qt + 1) * block) if causal else S, step)
                    for qt in range(row_tiles))
    else:
        stage = _ceil(2 * tile(step) + 2 * step * 4, _ALIGN) * _ALIGN
        smem = _ALIGN + 2 * tile(block) + stages * stage
        inner = sum(_ceil(S, step) - (kt * block // step if causal else 0)
                    for kt in range(row_tiles))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{kernel}: {smem} bytes of shared memory, over "
                         f"{_SMEM_LIMIT}")
    return LaunchPlan(grid=(B * H, row_tiles), threads=_WS_THREADS,
                      smem=smem, inner_tiles=inner, maps=maps)


@functools.lru_cache(maxsize=256)
def _c_plan(kernel: str, shape, strides, causal: bool):
    """The plan as the C interface takes it (tensor maps, launch), cached
    per shape and strides: a launch then costs the host no Python
    arithmetic."""
    plan = launch_plan(kernel, shape, dict(strides), causal)
    flat = [x for m in plan.maps.values() for x in m.flat()]
    maps = (ctypes.c_longlong * len(flat))(*flat)
    launch = (ctypes.c_int * 4)(*plan.grid, plan.threads, plan.smem)
    return maps, launch


def _operand(t: torch.Tensor, name: str, like: torch.Tensor) -> torch.Tensor:
    """Check a (B, S, H, D) bf16 CUDA operand; returns it, or a contiguous
    copy when its strides do not allow 16-byte row loads."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernels take bfloat16; {name} is {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                         f"{tuple(like.shape)}")
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _stats(t: torch.Tensor, name: str, B: int, H: int, S: int) -> torch.Tensor:
    if t.dtype != torch.float32 or t.shape != (B, H, S) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 (B, H, S) = "
                         f"{(B, H, S)}; got {t.dtype} {tuple(t.shape)}")
    return t


def _dims(q: torch.Tensor):
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) inputs, got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim {_HEAD_DIMS}, "
                         f"got {D}")
    return B, S, H, D


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_cuda(q, k, v, causal: bool = True):
    """K1: ``(o, lse)`` with o ``(B, S, H, D)`` bf16 and lse ``(B, H, S)``
    float32."""
    B, S, H, D = _dims(q)
    q = _operand(q, "q", q)
    k, v = _operand(k, "k", q), _operand(v, "v", q)
    plan = _c_plan("fwd", (B, S, H, D), (("q", q.stride()), ("k", k.stride()),
                                         ("v", v.stride())), bool(causal))
    lib, _ = load_library()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = lib.bf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        S, H, D, *plan, 1.0 / math.sqrt(D), int(causal), _stream(q))
    _check(rc, "flash forward (K1)")
    flash_fwd_cuda.launches += 1
    return o, lse


def flash_dq_cuda(q, k, v, o, do, lse, dlse, causal: bool = True):
    """K2: ``(dq, delta)`` from the forward's saved ``o`` and lse (float32
    ``(B, H, S)``) and the cotangents ``do`` and ``dlse`` (``(B, S, H)``, any
    strides); dq is ``(B, S, H, D)``, ``delta = rowsum(dO o) - dlse`` float32
    ``(B, H, S)``, the input of K3."""
    B, S, H, D = _dims(q)
    q = _operand(q, "q", q)
    k, v, do, o = (_operand(t, n, q)
                   for t, n in ((k, "k"), (v, "v"), (do, "do"), (o, "o")))
    lse = _stats(lse, "lse", B, H, S)
    if dlse.shape != (B, S, H) or dlse.device != q.device:
        raise ValueError(f"dlse must be (B, S, H) = {(B, S, H)} on {q.device}; "
                         f"got {tuple(dlse.shape)} on {dlse.device}")
    dlse = dlse.float().contiguous()
    plan = _c_plan("dq", (B, S, H, D),
                   (("q", q.stride()), ("k", k.stride()), ("v", v.stride()),
                    ("do", do.stride()), ("o", o.stride())), bool(causal))
    lib, _ = load_library()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = lib.bf_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dlse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        S, H, D, *plan, 1.0 / math.sqrt(D), int(causal), _stream(q))
    _check(rc, "flash dq (K2)")
    flash_dq_cuda.launches += 1
    return dq, delta


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K3: ``(dk, dv)``, each ``(B, S, H, D)``, from the saved lse and the
    ``delta`` that K2 returns, both float32 ``(B, H, S)``."""
    B, S, H, D = _dims(q)
    q = _operand(q, "q", q)
    k, v, do = (_operand(t, n, q) for t, n in ((k, "k"), (v, "v"), (do, "do")))
    lse, delta = _stats(lse, "lse", B, H, S), _stats(delta, "delta", B, H, S)
    plan = _c_plan("dkv", (B, S, H, D),
                   (("q", q.stride()), ("k", k.stride()), ("v", v.stride()),
                    ("do", do.stride())), bool(causal))
    lib, _ = load_library()
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    rc = lib.bf_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        S, H, D, *plan, 1.0 / math.sqrt(D), int(causal), _stream(q))
    _check(rc, "flash dk/dv (K3)")
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_dq_cuda.launches = 0
flash_dkv_cuda.launches = 0


def reset_launch_counts() -> None:
    for fn in (flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda):
        fn.launches = 0


def flash_delta(o, do, dlse):
    """``rowsum(dO o) - dlse`` as float32 ``(B, H, S)``: the delta term of
    the backward, as the JAX package computes it before its K2 and K3; the
    plain twin of K2's second output."""
    delta = (do.float() * o.float()).sum(-1) - dlse.float()   # (B, S, H)
    return delta.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Autograd and the public API
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of exact attention, differentiable in both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            o, lse_bhs = flash_fwd_cuda(q, k, v, causal)
        elif not (k.is_cuda or v.is_cuda):
            o, lse = flash_fwd_ref(q, k, v, causal)
            lse_bhs = lse.transpose(1, 2).contiguous()
        else:
            raise ValueError("q, k and v must be on one device")
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse_bhs)
        return o, lse_bhs.transpose(1, 2)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse_bhs = ctx.saved_tensors
        if q.is_cuda:
            dq, delta = flash_dq_cuda(q, k, v, o, do, lse_bhs, dlse, ctx.causal)
            dk, dv = flash_dkv_cuda(q, k, v, do, lse_bhs, delta, ctx.causal)
        else:
            dq, dk, dv = flash_bwd_ref(q, k, v, o, lse_bhs.transpose(1, 2),
                                       do, dlse, ctx.causal)
        return dq, dk, dv, None


def flash_attention_lse(q, k, v, *, causal: bool = True):
    """Exact attention ``(B, S, H, D)`` and its per-row logsumexp
    ``(B, S, H)``, differentiable in both outputs (the lse cotangent folds
    into the backward's delta term)."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention(q, k, v, *, causal: bool = True):
    """Memory-O(S) exact attention; inputs/outputs ``(B, S, H, D)``."""
    return FlashAttention.apply(q, k, v, causal)[0]


def flash_attention_impl():
    """``attn_impl`` for ``models.transformer.TransformerLM``."""
    def impl(q, k, v, *, causal=True):
        return flash_attention(q, k, v, causal=causal)
    return impl
