"""Flash attention: hand-written Hopper kernels with a plain PyTorch twin.

The port of ``bluefog_tpu/ops/flash_attention.py``.  Its three Pallas TPU
kernels become three CUDA kernels for ``sm_90a`` in
``bluefog_tpu_torch/csrc/flash_attention.cu``:

- K1 ``flash_fwd_cuda`` (replaces ``_fwd_kernel``): O and the per-row
  logsumexp by the online-softmax recurrence, logits never in device memory;
- K2 ``flash_dq_cuda`` (replaces ``_dq_kernel``): ``dq = sum_k dS K``;
- K3 ``flash_dkv_cuda`` (replaces ``_dkv_kernel``): ``dk = sum_q dS^T Q`` and
  ``dv = sum_q P^T dO``.

``flash_fwd_ref`` and ``flash_bwd_ref`` are their plain twins: the same
function as dense float32 math.  :class:`FlashAttention` takes the plain
path only for tensors on the CPU; for CUDA tensors it launches the kernels
or raises.  Each CUDA wrapper counts its launches in a plain integer
attribute ``launches``.

Layout: ``(B, S, H, D)`` like ``models.transformer.local_attention``; the
kernels read q, k, v and dO through their strides, so the fused-QKV slices
need no copy.  The lse is ``(B, S, H)`` at the public functions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from bluefog_tpu_torch.ops import _nvcc

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_impl",
           "FlashAttention", "flash_fwd_ref", "flash_bwd_ref",
           "flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda",
           "load_library", "reset_launch_counts"]

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
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    strides = [L] * 3
    lib.bf_flash_fwd.argtypes = ([P] * 5 + [I] * 4 + strides * 3
                                 + [F, I, P])
    lib.bf_flash_dq.argtypes = ([P] * 7 + [I] * 4 + strides * 4 + [F, I, P])
    lib.bf_flash_dkv.argtypes = ([P] * 8 + [I] * 4 + strides * 4 + [F, I, P])
    for fn in (lib.bf_flash_fwd, lib.bf_flash_dq, lib.bf_flash_dkv):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib, log


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
    lib, _ = load_library()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = lib.bf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, S, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(D), int(causal), _stream(q))
    _check(rc, "flash forward (K1)")
    flash_fwd_cuda.launches += 1
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K2: dq ``(B, S, H, D)`` from the saved lse and the precomputed
    ``delta = rowsum(dO o) - dlse``, both float32 ``(B, H, S)``."""
    B, S, H, D = _dims(q)
    q = _operand(q, "q", q)
    k, v, do = (_operand(t, n, q) for t, n in ((k, "k"), (v, "v"), (do, "do")))
    lse, delta = _stats(lse, "lse", B, H, S), _stats(delta, "delta", B, H, S)
    lib, _ = load_library()
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    rc = lib.bf_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        1.0 / math.sqrt(D), int(causal), _stream(q))
    _check(rc, "flash dq (K2)")
    flash_dq_cuda.launches += 1
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K3: ``(dk, dv)``, each ``(B, S, H, D)``; inputs as :func:`flash_dq_cuda`."""
    B, S, H, D = _dims(q)
    q = _operand(q, "q", q)
    k, v, do = (_operand(t, n, q) for t, n in ((k, "k"), (v, "v"), (do, "do")))
    lse, delta = _stats(lse, "lse", B, H, S), _stats(delta, "delta", B, H, S)
    lib, _ = load_library()
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    rc = lib.bf_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], 1.0 / math.sqrt(D), int(causal), _stream(q))
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
    the backward, a plain torch op before K2 and K3 as in the JAX package."""
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
            delta = flash_delta(o, do, dlse)
            dq = flash_dq_cuda(q, k, v, do, lse_bhs, delta, ctx.causal)
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
