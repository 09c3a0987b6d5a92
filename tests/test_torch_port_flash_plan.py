"""The launch plan of the Hopper kernels K1 (flash forward), K2 (dq) and K3
(dk/dv),
``ops.flash_attention.launch_plan``: grid, tile counts, shared memory and
the TMA tensor maps over the operands' strides.  Pure host arithmetic,
held here against PyTorch's own addressing and a brute-force count of the
tiles the causal mask leaves work in."""

import math

import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import flash_attention as FA

SMEM_LIMIT = 232448            # dynamic shared memory a Hopper block may use
OPERANDS = {"fwd": ("q", "k", "v"), "dq": ("q", "k", "v", "do", "o"),
            "dkv": ("q", "k", "v", "do")}
# Rows of one TMA box per operand: the block's own rows (128) and the rows
# of one pipeline stage (K1 and K2: 128 keys; K3: 64 queries).
BOX_ROWS = {"fwd": {"q": 128, "k": 128, "v": 128},
            "dq": {"q": 128, "k": 128, "v": 128, "do": 128, "o": 128},
            "dkv": {"q": 64, "k": 128, "v": 128, "do": 64}}
RESIDENT = {"fwd": ("q",), "dq": ("q", "do", "o"), "dkv": ("k", "v")}


def _operands(kernel, B, S, H, D, layout):
    """Views as the model hands them over: q, k, v slices of one fused
    (B, S, H, 3, D) projection, or separate contiguous tensors; dO is always
    a contiguous gradient, and O (K2) the forward's contiguous output."""
    if layout == "fused":
        qkv = torch.zeros(B, S, H, 3, D, dtype=torch.bfloat16)
        ts = {"q": qkv[..., 0, :], "k": qkv[..., 1, :], "v": qkv[..., 2, :]}
    else:
        ts = {n: torch.zeros(B, S, H, D, dtype=torch.bfloat16)
              for n in ("q", "k", "v")}
    for name in OPERANDS[kernel][3:]:
        ts[name] = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    return ts


def _plan(kernel, B, S, H, D, layout="fused", causal=True):
    ts = _operands(kernel, B, S, H, D, layout)
    return FA.launch_plan(kernel, (B, S, H, D),
                          {n: t.stride() for n, t in ts.items()}, causal), ts


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_maps_address_what_torch_addresses(kernel, D, layout):
    B, S, H = 2, 300, 3
    plan, ts = _plan(kernel, B, S, H, D, layout)
    assert tuple(plan.maps) == OPERANDS[kernel]            # C-interface order
    rng = np.random.RandomState(0)
    for name, m in plan.maps.items():
        t = ts[name]
        assert m.dims == (D, S, H, B)
        assert m.box == (64, BOX_ROWS[kernel][name], 1, 1)
        assert all(s % 16 == 0 for s in m.strides)
        assert len(m.flat()) == 11
        for b, s, h, d in zip(*(rng.randint(0, n, 8) for n in (B, S, H, D))):
            want = (t[b, s, h, d].data_ptr() - t.data_ptr())
            got = 2 * d + s * m.strides[0] + h * m.strides[1] + b * m.strides[2]
            assert got == want, (name, b, s, h, d)


def _tiles_with_work(S, rows, inner, causal, block_is_keys):
    """Brute force: (block tile, inner tile) pairs holding at least one
    query/key pair inside the sequence that the mask keeps."""
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    keep = (k <= q) if causal else np.ones((S, S), bool)
    if block_is_keys:
        keep = keep.T                   # rows: keys, columns: queries
    nb, ni = math.ceil(S / rows), math.ceil(S / inner)
    pad = np.zeros((nb * rows, ni * inner), bool)
    pad[:S, :S] = keep
    return int(pad.reshape(nb, rows, ni, inner).any(axis=(1, 3)).sum())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [2048, 1000, 777, 128, 100, 1])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_grid_and_tile_counts(kernel, S, causal):
    B, H, D = 2, 16, 128
    plan, _ = _plan(kernel, B, S, H, D, causal=causal)
    assert plan.grid == (B * H, math.ceil(S / 128)) and plan.threads == 384
    inner = 64 if kernel == "dkv" else 128
    assert plan.inner_tiles == _tiles_with_work(S, 128, inner, causal,
                                                block_is_keys=kernel == "dkv")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_shared_memory_fits_a_block(kernel, D):
    """Room for the resident tiles and two stages of the streamed ones."""
    plan, _ = _plan(kernel, 2, 2048, 16, D)
    resident = RESIDENT[kernel]
    rows_bytes = {n: m.box[1] * D * 2 for n, m in plan.maps.items()}
    need = sum(b if n in resident else 2 * b for n, b in rows_bytes.items())
    assert plan.smem % 1024 == 0
    assert need <= plan.smem <= SMEM_LIMIT


def test_main_shape_plan():
    """The training shape: fused QKV, B=2, S=2048, H=16, D=128."""
    fwd, _ = _plan("fwd", 2, 2048, 16, 128)
    dq, _ = _plan("dq", 2, 2048, 16, 128)
    dkv, _ = _plan("dkv", 2, 2048, 16, 128)
    assert fwd.grid == dq.grid == dkv.grid == (32, 16)
    assert fwd.maps["q"].strides == dq.maps["k"].strides == (
        2 * 16 * 384, 2 * 384, 2 * 2048 * 16 * 384)
    assert dkv.maps["do"].strides == dq.maps["o"].strides == (
        2 * 16 * 128, 2 * 128, 2 * 2048 * 16 * 128)
    assert (fwd.inner_tiles, dq.inner_tiles, dkv.inner_tiles) == (136, 136, 272)
    # K2: 1,024 alignment + Q, dO and O (3 x 32 KiB) + 2 stages of K and V.
    assert (fwd.smem, dq.smem, dkv.smem) == (164864, 230400, 134144)


@pytest.mark.parametrize("bad", ["row_stride", "head_stride", "batch_stride",
                                 "head_dim_stride", "head_dim"])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_refuses_what_a_tensor_map_cannot_describe(kernel, bad):
    B, S, H, D = 2, 64, 4, 64
    st = (S * H * D, H * D, D, 1)
    shape = (B, S, H, D)
    if bad == "row_stride":
        st = (S * H * D, H * D + 4, D, 1)          # 520 bytes: not a multiple of 16
    elif bad == "head_stride":
        st = (S * H * (D + 4), H * (D + 4), D + 4, 1)
    elif bad == "batch_stride":
        st = (S * H * D + 2, H * D, D, 1)
    elif bad == "head_dim_stride":
        st = (S * H * D * 2, H * D * 2, D * 2, 2)
    else:
        shape = (B, S, H, 96)
    with pytest.raises(ValueError):
        FA.launch_plan(kernel, shape, {n: st for n in OPERANDS[kernel]})
