"""The launch plan of the Hopper kernels K1 (flash forward), K2 (dq) and K3
(dk/dv),
``ops.flash_attention.launch_plan``: the head-dim instance, grid, tile
counts, shared memory and the TMA tensor maps over the operands' strides
(bf16), and the float32 kernels' plan.  Pure host arithmetic, held here
against PyTorch's own addressing and a brute-force count of the tiles the
causal mask leaves work in."""

import math

import numpy as np
import pytest
import torch

from bluefog_tpu_torch.ops import flash_attention as FA

SMEM_LIMIT = 232448            # dynamic shared memory a Hopper block may use
OPERANDS = {"fwd": ("q", "k", "v"), "dq": ("q", "k", "v", "do", "o"),
            "dkv": ("q", "k", "v", "do")}
# Rows of one TMA box per operand: the block's own rows (128) and the rows
# of one pipeline stage (K1 and K2: 128 keys; K3: 64 queries); at instance
# 256, K1 streams 64 keys, K2 owns 64 rows and streams 64 keys, K3 owns 64
# keys.
BOX_ROWS = {"fwd": {"q": 128, "k": 128, "v": 128},
            "dq": {"q": 128, "k": 128, "v": 128, "do": 128, "o": 128},
            "dkv": {"q": 64, "k": 128, "v": 128, "do": 64}}
BOX_ROWS_256 = {"fwd": {"q": 128, "k": 64, "v": 64},
                "dq": {n: 64 for n in ("q", "k", "v", "do", "o")},
                "dkv": {n: 64 for n in ("q", "k", "v", "do")}}
RESIDENT = {"fwd": ("q",), "dq": ("q", "do", "o"), "dkv": ("k", "v")}


def _operands(kernel, B, S, H, D, layout, dtype=torch.bfloat16):
    """Views as the model hands them over: q, k, v slices of one fused
    (B, S, H, 3, D) projection, or separate contiguous tensors; dO is always
    a contiguous gradient, and O (K2) the forward's contiguous output."""
    if layout == "fused":
        qkv = torch.zeros(B, S, H, 3, D, dtype=dtype)
        ts = {"q": qkv[..., 0, :], "k": qkv[..., 1, :], "v": qkv[..., 2, :]}
    else:
        ts = {n: torch.zeros(B, S, H, D, dtype=dtype) for n in ("q", "k", "v")}
    for name in OPERANDS[kernel][3:]:
        ts[name] = torch.zeros(B, S, H, D, dtype=dtype)
    return ts


def _plan(kernel, B, S, H, D, layout="fused", causal=True,
          dtype=torch.bfloat16):
    ts = _operands(kernel, B, S, H, D, layout, dtype)
    return FA.launch_plan(kernel, (B, S, H, D),
                          {n: t.stride() for n, t in ts.items()}, causal,
                          dtype), ts


@pytest.mark.parametrize("layout", ["fused", "contiguous"])
@pytest.mark.parametrize("D", [8, 16, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_maps_address_what_torch_addresses(kernel, D, layout):
    """Each map's inner extent is the true head dim, its box the
    instance's 64-column block of the tile's rows."""
    B, S, H = 2, 300, 3
    plan, ts = _plan(kernel, B, S, H, D, layout)
    assert tuple(plan.maps) == OPERANDS[kernel]            # C-interface order
    rows = (BOX_ROWS_256 if plan.instance == 256 else BOX_ROWS)[kernel]
    rng = np.random.RandomState(0)
    for name, m in plan.maps.items():
        t = ts[name]
        assert m.dims == (D, S, H, B)
        assert m.box == (64, rows[name], 1, 1)
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


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_shared_memory_fits_a_block(kernel, D):
    """Room for the resident tiles and two stages of the streamed ones,
    each instance's tiles within a Hopper block's shared memory; the
    float32 kernel's tiles at the same instance too (K2's q, dO and
    delta beside its K/V ring)."""
    plan, _ = _plan(kernel, 2, 2048, 16, D)
    assert plan.instance == D
    resident = RESIDENT[kernel]
    rows_bytes = {n: m.box[1] * D * 2 for n, m in plan.maps.items()}
    need = sum(b if n in resident else 2 * b for n, b in rows_bytes.items())
    assert plan.smem % 1024 == 0
    assert need <= plan.smem <= SMEM_LIMIT
    f32, _ = _plan(kernel, 2, 2048, 16, D, dtype=torch.float32)
    assert f32.instance == D and f32.smem <= SMEM_LIMIT


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
        shape = (B, S, H, 0)                       # no kernel takes D = 0
    with pytest.raises(ValueError):
        FA.launch_plan(kernel, shape, {n: st for n in OPERANDS[kernel]})


@pytest.mark.parametrize("dtype, instances", [
    (torch.bfloat16, (64, 128, 256)), (torch.float32, (16, 64, 128, 256))])
def test_every_head_dim_takes_the_smallest_instance_that_holds_it(dtype,
                                                                  instances):
    """Every D from 1 to 256 plans in the smallest instance at least D (the
    bf16 operands as the padded buffers the copy route gives odd widths);
    D > 256 takes the wide route; D = 0 is refused."""
    B, S, H = 1, 64, 2
    for D in range(1, 257):
        want = min(i for i in instances if i >= D)
        assert FA.instance(dtype, D) == want, D
        st = (S * H * want, H * want, want, 1)
        plan = FA.launch_plan("dq", (B, S, H, D), {n: st for n in OPERANDS["dq"]},
                              True, dtype)
        assert plan.instance == want, D
    for D in (257, 288):
        assert FA.instance(dtype, D) == FA.WIDE, D
    with pytest.raises(ValueError, match="head dims from 1"):
        FA.instance(dtype, 0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_refuses_dtypes_the_kernels_do_not_take(dtype):
    """float16 runs its own instances (the bf16 kernels' design), float64
    the float32 kernels on float32 copies: both plan as those kernels."""
    st = (64 * 2 * 64, 2 * 64, 64, 1)
    plan = FA.launch_plan("fwd", (1, 64, 2, 64), {n: st for n in "qkv"},
                          True, dtype)
    want = {torch.float16: torch.bfloat16, torch.float64: torch.float32}
    assert plan == FA.launch_plan("fwd", (1, 64, 2, 64),
                                  {n: st for n in "qkv"}, True, want[dtype])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.bool,
                                   torch.complex64])
def test_refuses_dtypes_that_are_not_floats(dtype):
    """A dtype that is not a float raises, naming what the kernels take."""
    with pytest.raises(ValueError, match="float16, bfloat16, float32 and "
                                         "float64"):
        FA.launch_plan("fwd", (1, 64, 2, 64), {}, True, dtype)
    with pytest.raises(ValueError, match="float16, bfloat16, float32"):
        FA.instance(dtype, 64)


@pytest.mark.parametrize("D, H", [(36, 1), (20, 3), (1, 4)])
def test_copy_route_for_strides_a_map_cannot_describe(D, H):
    """A fused-QKV slice whose strides or base are not 16-byte multiples
    (D = 36 at H = 1: 216-byte rows, k 72 bytes in) is copied into a zero
    buffer padded to the instance; the copy holds the same values and its
    strides plan."""
    B, S = 2, 100
    qkv = torch.randn(B, S, H, 3, D).to(torch.bfloat16)
    k = qkv[..., 1, :]
    assert not FA.describable(k.stride(), k.data_ptr())
    with pytest.raises(ValueError, match="multiples of 16"):
        FA.launch_plan("fwd", (B, S, H, D), {n: k.stride() for n in "qkv"})
    inst = FA.instance(torch.bfloat16, D)
    c = FA._padded(k, inst)
    assert c.shape == k.shape and torch.equal(c, k)
    assert c.stride() == (S * H * inst, H * inst, inst, 1)
    assert FA.describable(c.stride(), c.data_ptr())
    assert int(c._base[..., D:].abs().sum()) == 0          # zero past D
    plan = FA.launch_plan("fwd", (B, S, H, D), {n: c.stride() for n in "qkv"})
    assert plan.maps["k"].dims == (D, S, H, B)
    assert plan.maps["k"].strides == (2 * H * inst, 2 * inst, 2 * S * H * inst)


# The float32 tiles of csrc/flash_attention_f32.cu: K1 (FwdTile), K2
# (DqTile) and K3 (DkvTile) on the tensor cores, one or two groups of 4
# warps taking turns over the streamed tiles, K3 at instance 256 one block
# a role (dV, dK).  (threads, streamed rows, stages, roles) by (kernel,
# instance).
F32_TILES = {("fwd", 16): (128, 64, 4, 1), ("fwd", 64): (128, 64, 2, 1),
             ("fwd", 128): (256, 32, 2, 1), ("fwd", 256): (256, 16, 2, 1),
             ("dq", 16): (128, 64, 4, 1), ("dq", 64): (256, 64, 2, 1),
             ("dq", 128): (256, 32, 2, 1), ("dq", 256): (128, 16, 2, 1),
             ("dkv", 16): (128, 64, 4, 1), ("dkv", 64): (256, 64, 2, 1),
             ("dkv", 128): (256, 16, 2, 1), ("dkv", 256): (128, 16, 2, 2)}


@pytest.mark.parametrize("D", [8, 16, 64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_float32_plan(kernel, causal, D):
    """The float32 kernels over 64-row blocks: one or two groups of 4
    warps, a ring of 2-4 stages, each a streamed tile a group (K1 and K2: K
    and V; K3: q and dO with their lse and delta), beside the resident
    tiles (K1: q; K2: q, dO and the rows' delta; K3: k and v), every tile
    instance + 4 floats a row; K3 at instance 256 doubles grid y, a block a
    role, each streaming its own tiles.  All within a block's shared
    memory; no tensor maps (they read through the strides)."""
    S = 777
    plan, _ = _plan(kernel, 2, S, 3, D, causal=causal, dtype=torch.float32)
    inst = FA.instance(torch.float32, D)
    threads, step, stages, roles = F32_TILES[kernel, inst]
    assert plan.maps == {} and plan.instance == inst
    assert plan.grid == (6, roles * math.ceil(S / 64))
    assert plan.threads == threads
    row = 4 * (inst + 4)
    resident = {"fwd": 64 * row, "dq": 2 * 64 * row + 4 * 64,
                "dkv": 2 * 64 * row}[kernel]
    stage = 2 * step * row + (2 * 4 * step if kernel == "dkv" else 0)
    need = resident + stages * (threads // 128) * stage
    assert plan.smem == need <= SMEM_LIMIT
    assert plan.inner_tiles == roles * _tiles_with_work(
        S, 64, step, causal, block_is_keys=kernel == "dkv")
    assert plan.copy_bytes == 16          # fused slices at D = 8-256


@pytest.mark.parametrize("case", ["contiguous", "fused", "fused-d6",
                                  "odd-rows", "unaligned-base", "d-stride"])
def test_float32_copy_route(case):
    """The float32 K1-K3 copy their tiles with 16-byte
    cp.async when every operand has unit stride along D, element strides
    that are multiples of 4 and a 16-byte aligned base; else with 4-byte
    copies, never a copy of the operand.  The plan decides by the strides,
    the wrapper lowers it to 4 for a base off 16 bytes."""
    B, S, H, D = 2, 300, 1, 16
    if case == "contiguous":
        ts = [torch.zeros(B, S, H, D) for _ in range(3)]
    elif case in ("fused", "fused-d6"):
        D = 6 if case == "fused-d6" else D
        qkv = torch.zeros(B, S, H, 3, D)          # D = 6: 72-byte rows
        ts = [qkv[..., i, :] for i in range(3)]
    elif case == "odd-rows":
        ts = [torch.zeros(B, S, H, D + 2)[..., :D] for _ in range(3)]
    elif case == "unaligned-base":
        ts = [torch.zeros(B * S * H * D + 1)[1:].view(B, S, H, D)
              for _ in range(3)]
    else:
        ts = [torch.zeros(B, S, H, 2 * D)[..., ::2] for _ in range(3)]
    strides = [t.stride() for t in ts]
    by_strides = FA.f32_copy_bytes(strides)
    got = FA.f32_copy_bytes(strides, [t.data_ptr() for t in ts])
    want = {"contiguous": 16, "fused": 16, "fused-d6": 4, "odd-rows": 4,
            "unaligned-base": 4, "d-stride": 4}[case]
    assert got == want
    assert by_strides == (16 if case == "unaligned-base" else want)
    aligned = all(t.data_ptr() % 16 == 0 for t in ts)
    do = (S * H * D, H * D, D, 1)
    for kernel, names in (("fwd", "qkv"), ("dq", ("q", "k", "v", "do", "o")),
                          ("dkv", ("q", "k", "v", "do"))):
        st = tuple(zip(names, strides + [do, do]))
        plan = FA.launch_plan(kernel, (B, S, H, D), dict(st), True,
                              torch.float32)
        assert plan.copy_bytes == by_strides
        _, launch = FA._c_plan(kernel, (B, S, H, D), st, True, torch.float32,
                               aligned)
        assert list(launch) == [*plan.grid, plan.threads, plan.smem, want]


@pytest.mark.parametrize("route", [16, 4])
@pytest.mark.parametrize("inst", [16, 64, 128, 256])
def test_float32_dq_tiles(inst, route):
    """K2 (DqTile) at every instance, in both copy routes (contiguous
    operands: 16-byte copies; one head of a fused QKV at an odd width:
    4-byte): two groups of 4 warps at instances 64 and 128, one at 16 (its
    grids hold many blocks) and at 256 (q and dO take 133,120 bytes, and
    two groups' 16-key tiles in two stages would take as much again);
    64/64/32/16 streamed keys, 4 stages at 16 and 2 above; the same
    shared memory in both routes, within a block's, the ring room for O's
    tile before it starts and for the groups' dQ merge at the end; the
    route in the plan and in the C launch."""
    B, S, H = 2, 300, 1
    D = {16: 15, 64: 63, 128: 127, 256: 255}[inst] if route == 4 else inst
    if route == 4:
        qkv = torch.zeros(B, S, H, 3, D)
        ts = [qkv[..., i, :] for i in range(3)]
    else:
        ts = [torch.zeros(B, S, H, D) for _ in range(3)]
    ts += [torch.zeros(B, S, H, D) for _ in range(2)]          # dO, O
    st = tuple(zip(("q", "k", "v", "do", "o"), (t.stride() for t in ts)))
    plan = FA.launch_plan("dq", (B, S, H, D), dict(st), True, torch.float32)
    threads, step, stages, roles = F32_TILES["dq", inst]
    groups = threads // 128
    assert (groups, step, stages, roles) == {
        16: (1, 64, 4, 1), 64: (2, 64, 2, 1), 128: (2, 32, 2, 1),
        256: (1, 16, 2, 1)}[inst]
    row = 4 * (inst + 4)
    ring = stages * groups * 2 * step * row
    assert plan.smem == 2 * 64 * row + 4 * 64 + ring <= SMEM_LIMIT
    assert ring >= 64 * row                    # O's tile, before the ring
    assert ring >= 4 * (inst // 8) * 4 * 32 * 4        # the groups' merge
    assert plan.instance == inst and plan.threads == threads
    assert plan.grid == (B * H, math.ceil(S / 64))
    assert plan.inner_tiles == _tiles_with_work(S, 64, step, True,
                                                block_is_keys=False)
    assert plan.copy_bytes == route
    _, launch = FA._c_plan("dq", (B, S, H, D), st, True, torch.float32, True)
    assert list(launch) == [*plan.grid, threads, plan.smem, route]
