"""Flash attention: hand-written Hopper kernels with a plain PyTorch twin.

The port of ``bluefog_tpu/ops/flash_attention.py``.  Its three Pallas TPU
kernels become CUDA kernels for ``sm_90a``, over the JAX kernels' domain:
float16, bfloat16 or float32 operands (float64, and operands of mixed
dtypes, on float32 copies), any head dim D >= 1, causal or not, any S,
strided operands.

- K1 ``flash_fwd_cuda`` (replaces ``_fwd_kernel``): O and the per-row
  logsumexp by the online-softmax recurrence, logits never in device memory;
- K2 ``flash_dq_cuda`` (replaces ``_dq_kernel``): ``dq = sum_k dS K``, and
  the backward's ``delta = rowsum(dO o) - dlse`` for K3 (in the JAX
  package a plain op before both kernels);
- K3 ``flash_dkv_cuda`` (replaces ``_dkv_kernel``): ``dk = sum_q dS^T Q`` and
  ``dv = sum_q P^T dO``.

bfloat16 and float16 run in ``csrc/flash_attention.cu`` (its element type a
build parameter): warp-specialised kernels,
TMA loads through an mbarrier ring, every product a ``wgmma``, in three
instances D = 64, 128 and 256.  float32 runs in
``csrc/flash_attention_f32.cu``, instances D = 16, 64, 128 and 256: K1-K3
on the tensor cores in 3xTF32 (``mma.sync`` TF32 products of each operand
split into hi + lo, float32-accurate; whatever
``torch.backends.cuda.matmul.allow_tf32`` says), their streamed tiles
through a ring of ``cp.async`` copies, 16-byte where every operand allows
(:func:`f32_copy_bytes`).  Every head dim past 256 runs in the wide route
(``csrc/flash_wide.cuh``, instance :data:`WIDE`, each dtype): the output's
columns split over grid z in groups of 128, the score products over D in
64-column chunks, ``mma.sync`` on the tensor cores.  Each dtype's instance
builds into a library of its own, float32 one a copy route
(:func:`load_library`).  A head dim D <= 256 runs in the smallest instance
at least as wide (:func:`instance`); the columns past it are zeros the
kernels never store.  Operands of different float dtypes, or float64, run
in the float32 kernels on float32 copies, each output cast back to its
operand's dtype, as the JAX kernels compute every block in float32 and
store each output in its operand's dtype.

``flash_fwd_ref``, ``flash_bwd_ref`` and ``flash_delta`` are their plain
twins: the same functions as dense float32 math.  :class:`FlashAttention`
takes the plain path only for tensors on the CPU; for CUDA tensors it
launches the kernels or raises.  Each CUDA wrapper counts its launches in a
plain integer attribute ``launches``, and per instance (``"bf16/D128"``,
``"f16/D64"``, ``"f32/D16"``, ``"bf16/Dwide"``, ...) in ``by_instance``;
``copies`` counts the operands it copied: 16-bit operands into a padded
buffer because a TMA tensor map (or the wide route's 16-byte copies)
cannot describe their strides, and the float32 copies of mixed or float64
operands.

Layout: ``(B, S, H, D)`` like ``models.transformer.local_attention``; the
kernels read q, k, v and dO through their strides, so the fused-QKV slices
need no copy.  The lse is ``(B, S, H)`` at the public functions.

:func:`launch_plan` holds the host-side arithmetic of K1-K3 (grid, tile
counts, shared memory, and the 16-bit kernels' TMA tensor maps over the
operands' strides) as a pure function of dtype, shapes and strides; the
wrappers pass its result to the C interface.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from bluefog_tpu_torch.ops import _nvcc

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_impl",
           "FlashAttention", "flash_fwd_ref", "flash_bwd_ref", "flash_delta",
           "flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda", "instance",
           "kernel_dtype", "INSTANCES", "WIDE", "describable",
           "load_library", "reset_launch_counts", "launch_plan",
           "f32_copy_bytes",
           "LaunchPlan", "TensorMapPlan"]

_NEG_INF = -1e30
# Each kernel dtype's library tag (``_nvcc.FLASH_DTYPES``) and the suffix of
# its C functions' names.
_TAGS = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
_SUFFIX = {"bf16": "", "f16": "", "f32": "_f32"}
# The wide route: every head dim past the widest numbered instance.
WIDE = _nvcc.WIDE
# Head-dim instances of each dtype's kernels; a head dim D runs in the
# smallest instance >= D, past the last numbered one in WIDE.
INSTANCES = {dtype: _nvcc.FLASH_INSTANCES[tag] for dtype, tag in _TAGS.items()}
_LIBS = None


def kernel_dtype(dtype):
    """The dtype of the kernels that run operands of ``dtype``: float16,
    bfloat16 and float32 their own, float64 float32 (on float32 copies);
    raises ``ValueError`` for a dtype that is not a float."""
    if dtype in _TAGS:
        return dtype
    if dtype == torch.float64:
        return torch.float32
    raise ValueError(f"the flash kernels take float16, bfloat16, float32 and "
                     f"float64 operands (float64 on float32 copies), got "
                     f"{dtype}")


def instance(dtype, D: int):
    """The kernel instance that runs head dim ``D`` in ``dtype``: the
    smallest numbered instance at least ``D``, or :data:`WIDE` past 256;
    raises ``ValueError`` for a dtype that is not a float and for D < 1."""
    insts = INSTANCES[kernel_dtype(dtype)]
    if D < 1:
        raise ValueError(f"the flash kernels take head dims from 1, got {D}")
    return next(i for i in insts if i == WIDE or D <= i)


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

def load_library(verbose: bool = False, built=None):
    """Build (at first use) and load the kernels' libraries, one per dtype
    and head-dim instance (float32: and copy route), every ``nvcc`` at once
    (``_nvcc.build_flash``); a caller that started the build itself passes
    its result ``built``, every library or some (the rest loads with a
    later call).  Returns ``({(dtype, instance, route): (K1, K2, K3) C
    functions}, compiler log)``, route the float32 copy bytes (16 or 4;
    16-bit: 0).  Each library's part of the log starts with a line
    ``== flash library <tag>/D<instance> route <route>``."""
    global _LIBS
    complete = _LIBS is not None and len(_LIBS) == len(
        _nvcc.flash_libraries())
    if complete and not verbose and built is None:
        return _LIBS, ""
    built = built or _nvcc.build_flash(verbose)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan = [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(I)]  # maps or strides, launch
    libs = dict(_LIBS or {})
    dtypes = {tag: dtype for dtype, tag in _TAGS.items()}
    for tag, inst, route in built:
        lib = ctypes.CDLL(str(built[tag, inst, route][0]))
        fns = [getattr(lib, f"bf_flash_{k}{_SUFFIX[tag]}")
               for k in ("fwd", "dq", "dkv")]
        for fn, pointers in zip(fns, (5, 9, 8)):
            fn.argtypes = [P] * pointers + [I] * 3 + plan + [F, I, P]
            fn.restype = ctypes.c_int
        libs[dtypes[tag], inst, route] = fns
    _LIBS = libs
    return libs, "".join(f"== flash library {tag}/D{inst} route {route}\n"
                         + log for (tag, inst, route), (_, log)
                         in built.items())


# ---------------------------------------------------------------------------
# Launch plan of K1-K3 (pure host arithmetic; tested on the CPU)
# ---------------------------------------------------------------------------

# 16-bit tiles of csrc/flash_attention.cu (FwdTile, DqTile, DkvTile) by
# (kernel, instance): a block owns `block` rows; `stream` rows of the other
# operands pass through a ring of `stages` shared-memory stages; `threads`
# is 128 a consumer warpgroup plus a producer warpgroup.  K1's and K2's
# blocks are query rows and stream keys; K3's block is keys and streams
# query rows.
_TILES = {
    # (kernel, instance): (block rows, streamed rows, stages, threads)
    ("fwd", 64): (128, 128, 2, 384), ("fwd", 128): (128, 128, 2, 384),
    ("fwd", 256): (128, 64, 2, 384),
    ("dq", 64): (128, 128, 2, 384), ("dq", 128): (128, 128, 2, 384),
    ("dq", 256): (64, 64, 2, 256),
    ("dkv", 64): (128, 64, 2, 384), ("dkv", 128): (128, 64, 2, 384),
    ("dkv", 256): (64, 64, 2, 384),
}
# (resident operands, streamed operands) of each kernel
_OPERANDS = {"fwd": (("q",), ("k", "v")), "dq": (("q", "do", "o"), ("k", "v")),
             "dkv": (("k", "v"), ("q", "do"))}
_ALIGN = 1024                 # swizzled tiles start 1024-byte aligned
_SMEM_LIMIT = 232448          # dynamic shared memory a Hopper block may use
_BOX_COLS = 64                # one TMA box row: 64 x 2 bytes, the 128-byte swizzle
# float32 tiles of csrc/flash_attention_f32.cu by (kernel, instance), every
# block 64 rows, all three on the tensor cores (FwdTile, DqTile, DkvTile):
# one or two groups of 4 warps (128 threads a group) take turns over the
# streamed tiles, a ring of `stages` stages of a tile a group, a row
# stride of instance + 4 floats; K3 at 256 one block a role (dV, dK: grid
# y doubled).  K2 keeps q, dO and the 64 rows' delta beside the ring.
_F32_BLOCK = 64
_F32_TILES = {
    # (kernel, instance): (threads, streamed rows, stages, roles)
    ("fwd", 16): (128, 64, 4, 1), ("fwd", 64): (128, 64, 2, 1),
    ("fwd", 128): (256, 32, 2, 1), ("fwd", 256): (256, 16, 2, 1),
    ("dq", 16): (128, 64, 4, 1), ("dq", 64): (256, 64, 2, 1),
    ("dq", 128): (256, 32, 2, 1), ("dq", 256): (128, 16, 2, 1),
    ("dkv", 16): (128, 64, 4, 1), ("dkv", 64): (256, 64, 2, 1),
    ("dkv", 128): (256, 16, 2, 1), ("dkv", 256): (128, 16, 2, 2),
}
# The wide route of csrc/flash_wide.cuh (every dtype, every D > 256): a
# block of 4 warps owns 64 rows and one group of 128 output columns (grid
# z); the score products stream D in 64-column chunks.  A streamed tile is
# ceil(D / 64) chunk steps (K1: q and k chunks; K2: q, dO, k, v; K3: k, v,
# q, dO) and a group step (K1: v's group columns; K2: k's; K3: q's and dO's
# with their lse and delta), each through one ring of 3 stages, a stage
# the larger of the two, its rows padded by 16 bytes.  K2 keeps its rows'
# delta beside the ring; float32 K3 takes one block a role (dV, dK: grid y
# doubled).  Streamed rows by (kernel, element bytes).
_WIDE_BLOCK, _WIDE_CHUNK, _WIDE_GROUP, _WIDE_STAGES = 64, 64, 128, 3
_WIDE_THREADS = 128
_WIDE_STREAM = {("fwd", 2): 64, ("dq", 2): 64, ("dkv", 2): 16,
                ("fwd", 4): 16, ("dq", 4): 32, ("dkv", 4): 16}


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
    """Grid ``(B*H, row tiles)`` (the wide route: ``(B*H, row tiles,
    column groups)``), threads and dynamic shared-memory bytes of one
    launch of the head-dim ``instance``; ``inner_tiles`` counts the
    streamed tiles over one (b, h) (each role's, at a role-split tile; each
    column group's in the wide route), and ``maps`` the 16-bit operands'
    tensor maps in C-interface order (float32 and the wide route read
    through strides: none); ``copy_bytes`` is the copy of the kernels that
    read through strides (:func:`f32_copy_bytes`; the wide route's 16-bit:
    16; the TMA route: 0)."""
    grid: Tuple[int, ...]
    threads: int
    smem: int
    inner_tiles: int
    instance: object
    maps: Dict[str, TensorMapPlan]
    copy_bytes: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def describable(strides, data_ptr: int = 0) -> bool:
    """Whether a TMA tensor map (or the wide route's 16-byte copies) can
    describe a 16-bit ``(B, S, H, D)`` operand: unit stride along D,
    16-byte multiples for the other strides and a 16-byte aligned base."""
    sb, ss, sh, sd = strides
    return sd == 1 and all((2 * x) % 16 == 0 for x in (sb, ss, sh)) \
        and data_ptr % 16 == 0


def _tensor_map(name, shape, strides, rows) -> TensorMapPlan:
    B, S, H, D = shape
    sb, ss, sh, sd = strides
    if sd != 1:
        raise ValueError(f"{name}: the head dim must have unit stride, got "
                         f"{sd}")
    if not describable(strides):
        raise ValueError(f"{name}: TMA needs byte strides that are multiples "
                         f"of 16; got element strides {(sb, ss, sh)}")
    # The true D is the map's inner extent; the instance's 64-column boxes
    # reach past it, and the TMA fills those columns with zeros.
    return TensorMapPlan(dims=(D, S, H, B), strides=(2 * ss, 2 * sh, 2 * sb),
                         box=(_BOX_COLS, rows, 1, 1))


def _inner_tiles(kernel, S, block, step, causal) -> int:
    """Streamed tiles over one (b, h): K1 and K2 stream keys up to each
    query block's causal frontier, K3 query rows from each key block's."""
    tiles = range(_ceil(S, block))
    if kernel in ("fwd", "dq"):
        return sum(_ceil(min(S, (t + 1) * block) if causal else S, step)
                   for t in tiles)
    return sum(_ceil(S, step) - (t * block // step if causal else 0)
               for t in tiles)


def f32_copy_bytes(strides, data_ptrs=()) -> int:
    """The float32 kernels' copy of their tiles: 16-byte
    ``cp.async`` when every operand has unit stride along D, element strides
    that are multiples of 4 (16-byte rows) and a 16-byte aligned base, else
    4-byte copies.  Never a copy of an operand."""
    aligned = all(sd == 1 and sb % 4 == 0 and ss % 4 == 0 and sh % 4 == 0
                  for sb, ss, sh, sd in strides) \
        and all(p % 16 == 0 for p in data_ptrs)
    return 16 if aligned else 4


def _f32_plan(kernel, shape, strides, inst, causal) -> LaunchPlan:
    B, S, H, _ = shape
    threads, step, stages, roles = _F32_TILES[kernel, inst]
    ld = inst + 4
    # A stage's tile a group (K and V; K3: q and dO with lse and delta) and
    # the resident tiles (K1: q; K2: q, dO and delta; K3: k and v).
    tile = 2 * step * ld + (2 * step if kernel == "dkv" else 0)
    resident = {"fwd": _F32_BLOCK * ld, "dq": 2 * _F32_BLOCK * ld + _F32_BLOCK,
                "dkv": 2 * _F32_BLOCK * ld}[kernel]
    floats = resident + stages * (threads // 128) * tile
    return LaunchPlan(grid=(B * H, roles * _ceil(S, _F32_BLOCK)),
                      threads=threads, smem=4 * floats,
                      inner_tiles=roles * _inner_tiles(kernel, S, _F32_BLOCK,
                                                       step, causal),
                      instance=inst, maps={},
                      copy_bytes=f32_copy_bytes(strides.values()))


def _wide_plan(kernel, shape, strides, esize, causal) -> LaunchPlan:
    B, S, H, D = shape
    step = _WIDE_STREAM[kernel, esize]
    if esize == 2:
        for n, st in strides.items():
            if not describable(st):
                raise ValueError(f"{n}: the wide route's 16-byte copies need "
                                 f"unit stride along D and byte strides that "
                                 f"are multiples of 16; got element strides "
                                 f"{tuple(st)}")
    row_c = (_WIDE_CHUNK + 16 // esize) * esize       # a chunk tile's row
    row_g = (_WIDE_GROUP + 16 // esize) * esize       # a group tile's row
    # rows of a chunk step (K1: q and k; K2, K3: two of each) and bytes of
    # a group step (K3: q and dO, then lse and delta)
    chunk = (_WIDE_BLOCK + step) * (1 if kernel == "fwd" else 2)
    group = step * row_g if kernel != "dkv" else 2 * step * (row_g + 4)
    stage = _ceil(max(chunk * row_c, group), 16) * 16
    groups = _ceil(D, _WIDE_GROUP)
    roles = 2 if kernel == "dkv" and esize == 4 else 1
    return LaunchPlan(
        grid=(B * H, roles * _ceil(S, _WIDE_BLOCK), groups),
        threads=_WIDE_THREADS,
        smem=_WIDE_STAGES * stage + (4 * _WIDE_BLOCK if kernel == "dq" else 0),
        inner_tiles=roles * groups * _inner_tiles(kernel, S, _WIDE_BLOCK, step,
                                                  causal),
        instance=WIDE, maps={},
        copy_bytes=16 if esize == 2 else f32_copy_bytes(strides.values()))


def launch_plan(kernel: str, shape, strides, causal: bool = True,
                dtype=torch.bfloat16) -> LaunchPlan:
    """The launch of K1 (``kernel="fwd"``; operands q, k, v), K2 (``"dq"``;
    q, k, v, do, o) or K3 (``"dkv"``; q, k, v, do) for ``shape = (B, S, H,
    D)`` in ``dtype`` (float64: the float32 kernels') and each operand's
    element strides ``(sb, ss, sh, sd)``.  Raises ``ValueError`` for a dtype
    that is not a float, for D < 1, and for 16-bit strides a TMA map (or
    the wide route's 16-byte copies) cannot describe (the wrappers copy
    such an operand first)."""
    B, S, H, D = shape
    dtype = kernel_dtype(dtype)
    inst = instance(dtype, D)
    if min(B, S, H) < 1:
        raise ValueError(f"empty shape {tuple(shape)}")
    if inst == WIDE:
        return _wide_plan(kernel, shape, strides, dtype.itemsize, causal)
    if dtype == torch.float32:
        return _f32_plan(kernel, shape, strides, inst, causal)
    block, step, stages, threads = _TILES[kernel, inst]
    resident, streamed = _OPERANDS[kernel]
    maps = {n: _tensor_map(n, shape, strides[n], block if n in resident else step)
            for n in ("q", "k", "v", "do", "o") if n in resident + streamed}

    tile = lambda rows: rows * inst * 2                     # noqa: E731
    if kernel in ("fwd", "dq"):
        ring = stages * 2 * tile(step)                      # K and V
        smem = _ALIGN + len(resident) * tile(block) + ring
    else:
        stage = _ceil(2 * tile(step) + 2 * step * 4, _ALIGN) * _ALIGN
        smem = _ALIGN + 2 * tile(block) + stages * stage
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{kernel}: {smem} bytes of shared memory, over "
                         f"{_SMEM_LIMIT}")
    return LaunchPlan(grid=(B * H, _ceil(S, block)), threads=threads,
                      smem=smem,
                      inner_tiles=_inner_tiles(kernel, S, block, step, causal),
                      instance=inst, maps=maps)


@functools.lru_cache(maxsize=256)
def _c_plan(kernel: str, shape, strides, causal: bool, dtype,
            bases_aligned: bool):
    """The plan as the C interface takes it (the 16-bit instances: the
    tensor maps; float32 and the wide route: each operand's four element
    strides; then the launch, with the copy bytes where the kernels read
    through strides, float32's 4 where a base is not 16-byte aligned: the
    float32 library's copy route), cached per shape and strides: a launch
    then costs the host no Python arithmetic."""
    plan = launch_plan(kernel, shape, dict(strides), causal, dtype)
    launch = [*plan.grid, plan.threads, plan.smem]
    if plan.maps:
        flat = [x for m in plan.maps.values() for x in m.flat()]
    else:
        flat = [x for _, st in strides for x in st]
        launch.append(plan.copy_bytes if bases_aligned or dtype !=
                      torch.float32 else 4)
    maps = (ctypes.c_longlong * len(flat))(*flat)
    return maps, (ctypes.c_int * len(launch))(*launch)


def _padded(t: torch.Tensor, inst) -> torch.Tensor:
    """``t`` copied into a contiguous zero buffer ``(B, S, H, inst)`` (the
    wide route: D rounded up to 8 columns, 16 bytes), viewed as its first D
    columns: strides every tensor map, and the wide route's 16-byte copies,
    describe."""
    D = t.shape[-1]
    width = _ceil(D, 8) * 8 if inst == WIDE else inst
    buf = t.new_zeros(tuple(t.shape[:3]) + (width,))
    buf[..., :D] = t
    return buf[..., :D]


def _operands(fn, q: torch.Tensor, **ts):
    """Checked ``(B, S, H, D)`` CUDA operands of one launch of ``fn`` (q
    first), in the kernels' dtype, and their head-dim instance: operands of
    different float dtypes, or float64, are copied to float32 (the float32
    kernels run them); a 16-bit operand whose strides a tensor map cannot
    describe is copied into a padded buffer.  Both copies count in
    ``fn.copies``."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) inputs, got {tuple(q.shape)}")
    named = (("q", q), *ts.items())
    dtypes = {t.dtype for _, t in named}
    for dt in dtypes:
        kernel_dtype(dt)
    kd = q.dtype if len(dtypes) == 1 and q.dtype in _TAGS else torch.float32
    inst = instance(kd, q.shape[-1])
    out = {}
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
        if t.dtype != kd:
            t = t.to(kd)
            fn.copies += 1
        if kd != torch.float32 and not describable(t.stride(), t.data_ptr()):
            t = _padded(t, inst)
            fn.copies += 1
        out[name] = t
    return out, inst


def _stats(t: torch.Tensor, name: str, B: int, H: int, S: int) -> torch.Tensor:
    if t.dtype != torch.float32 or t.shape != (B, H, S) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 (B, H, S) = "
                         f"{(B, H, S)}; got {t.dtype} {tuple(t.shape)}")
    return t


def _launch(fn, kernel: str, ops: Dict[str, torch.Tensor], inst: int,
            causal: bool, *tail) -> None:
    """One launch of ``kernel`` on ``ops`` (q, k, v[, do[, o]]); ``tail``
    are the C function's other pointers, after the operands'.  Raises on a
    refused launch; counts it in ``fn``."""
    q = ops["q"]
    B, S, H, D = q.shape
    maps, launch = _c_plan(
        kernel, (B, S, H, D), tuple((n, t.stride()) for n, t in ops.items()),
        bool(causal), q.dtype,
        all(t.data_ptr() % 16 == 0 for t in ops.values()))
    route = launch[len(launch) - 1] if q.dtype == torch.float32 else 0
    key = (q.dtype, inst, route)
    libs = _LIBS if _LIBS is not None and key in _LIBS else load_library()[0]
    c_fn = libs[key][("fwd", "dq", "dkv").index(kernel)]
    rc = c_fn(*(t.data_ptr() for t in ops.values()), *tail, S, H, D, maps,
              launch, 1.0 / math.sqrt(D), int(causal),
              torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash {kernel} kernel launch failed: CUDA "
                           f"error {rc}")
    fn.launches += 1
    fn.by_instance[f"{_TAGS[q.dtype]}/D{inst}"] += 1


def flash_fwd_cuda(q, k, v, causal: bool = True):
    """K1: ``(o, lse)`` with o ``(B, S, H, D)`` in q's dtype and lse ``(B, H,
    S)`` float32."""
    ops, inst = _operands(flash_fwd_cuda, q, k=k, v=v)
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=ops["q"].dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(flash_fwd_cuda, "fwd", ops, inst, causal, o.data_ptr(),
            lse.data_ptr())
    return o.to(q.dtype), lse


def flash_dq_cuda(q, k, v, o, do, lse, dlse, causal: bool = True):
    """K2: ``(dq, delta)`` from the forward's saved ``o`` and lse (float32
    ``(B, H, S)``) and the cotangents ``do`` and ``dlse`` (``(B, S, H)``, any
    strides); dq is ``(B, S, H, D)``, ``delta = rowsum(dO o) - dlse`` float32
    ``(B, H, S)``, the input of K3."""
    ops, inst = _operands(flash_dq_cuda, q, k=k, v=v, do=do, o=o)
    B, S, H, D = q.shape
    lse = _stats(lse, "lse", B, H, S)
    if dlse.shape != (B, S, H) or dlse.device != q.device:
        raise ValueError(f"dlse must be (B, S, H) = {(B, S, H)} on {q.device}; "
                         f"got {tuple(dlse.shape)} on {dlse.device}")
    dlse = dlse.float().contiguous()
    dq = torch.empty((B, S, H, D), dtype=ops["q"].dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(flash_dq_cuda, "dq", ops, inst, causal, lse.data_ptr(),
            dlse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    return dq.to(q.dtype), delta


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool = True):
    """K3: ``(dk, dv)``, each ``(B, S, H, D)``, from the saved lse and the
    ``delta`` that K2 returns, both float32 ``(B, H, S)``."""
    ops, inst = _operands(flash_dkv_cuda, q, k=k, v=v, do=do)
    B, S, H, D = q.shape
    lse, delta = _stats(lse, "lse", B, H, S), _stats(delta, "delta", B, H, S)
    kd = ops["q"].dtype
    dk = torch.empty((B, S, H, D), dtype=kd, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=kd, device=q.device)
    _launch(flash_dkv_cuda, "dkv", ops, inst, causal, lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    return dk.to(k.dtype), dv.to(v.dtype)


def reset_launch_counts() -> None:
    for fn in (flash_fwd_cuda, flash_dq_cuda, flash_dkv_cuda):
        fn.launches = fn.copies = 0
        fn.by_instance = collections.Counter()


reset_launch_counts()


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
