"""Head dims past 256 and operands of mixed dtypes through the port's flash
attention.  Its plain twins (the CPU path) against the JAX package's Pallas
kernels in interpret mode (block 16), forward, lse and the gradients of both
outputs, causal and not: D = 257, 320, 384 and 512 in float32, bfloat16 and
float16, and q bfloat16 with k, v float32, q float16 with k, v bfloat16
(every block in float32, each output in its operand's dtype, as JAX).  And
the wide route's launch plan (``csrc/flash_wide.cuh``): every D > 256 plans
in it, in 128-column groups over grid z, within a block's shared memory.

Tolerances: float32 as ``test_torch_port_flash_dims.py``'s (forward and lse
2e-5, gradients 1e-4: two summation orders); bfloat16 5e-2 on the output
and 2e-2 relative (plus 5e-2) on the gradients (one bf16 rounding of the
outputs: an ulp is 2^-7 of the value); float16 5e-3 and 5e-3 relative (plus
5e-3) (an ulp 2^-10); lse 2e-5 in every dtype (float32 in both).  A mixed
pair takes the tolerance of its narrowest output's dtype."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.ops import flash_attention as JF
from bluefog_tpu_torch.ops import flash_attention as TF

B, S, H = 1, 32, 2
SMEM_LIMIT = 232448
# dtype: (output atol, gradient rtol, gradient atol)
TOL = {"float32": (2e-5, 0, 1e-4), "bfloat16": (5e-2, 2e-2, 5e-2),
       "float16": (5e-3, 5e-3, 5e-3)}
LSE_TOL = 2e-5
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _check_against_jax(D, dtypes, causal, seed):
    """q, k, v in ``dtypes`` through both, o and lse and the gradients of
    sum(o^2) + sum(lse); each output held to its own dtype's tolerance."""
    rng = np.random.RandomState(seed)
    arrs = [np.asarray(jnp.asarray(rng.randn(B, S, H, D), JNP[d]))
            for d in dtypes]

    def loss(a, b, c):
        o, lse = JF.flash_attention_lse(a, b, c, causal=causal, block_q=16,
                                        block_k=16)
        return jnp.sum(o.astype(jnp.float32) ** 2) + jnp.sum(lse), (o, lse)
    (_, (oj, lj)), gj = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, arrs))
    ts = [torch.tensor(np.asarray(a, np.float32)).to(TORCH[d])
          .requires_grad_() for a, d in zip(arrs, dtypes)]
    ot, lt = TF.flash_attention_lse(*ts, causal=causal)
    (ot.float().pow(2).sum() + lt.sum()).backward()
    assert ot.dtype == TORCH[dtypes[0]] and lt.dtype == torch.float32
    np.testing.assert_allclose(ot.detach().float().numpy(),
                               np.asarray(oj, np.float32), rtol=0,
                               atol=TOL[dtypes[0]][0])
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=LSE_TOL)
    for a, t, d in zip(gj, ts, dtypes):
        assert t.grad.dtype == TORCH[d] and a.dtype == JNP[d]
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=TOL[d][1], atol=TOL[d][2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [257, 320, 384, 512])
def test_wide_head_dims_match_jax(D, dtype, causal):
    _check_against_jax(D, (dtype,) * 3, causal, seed=D)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32", "float32"),
                                    ("float16", "bfloat16", "bfloat16")],
                         ids=["q-bf16-kv-f32", "q-f16-kv-bf16"])
def test_mixed_operand_dtypes_match_jax(dtypes, causal):
    _check_against_jax(64, dtypes, causal, seed=7)


OPERANDS = {"fwd": ("q", "k", "v"), "dq": ("q", "k", "v", "do", "o"),
            "dkv": ("q", "k", "v", "do")}
# The wide route's streamed rows by (kernel, element bytes), its block of
# 64 rows, 128-column groups, 64-column chunks and 3 ring stages.
STREAM = {("fwd", 2): 64, ("dq", 2): 64, ("dkv", 2): 16,
          ("fwd", 4): 16, ("dq", 4): 32, ("dkv", 4): 16}


def _tiles_with_work(S_, rows, inner, causal, block_is_keys):
    """Brute force: (block tile, inner tile) pairs holding at least one
    query/key pair inside the sequence that the mask keeps."""
    q = np.arange(S_)[:, None]
    k = np.arange(S_)[None, :]
    keep = (k <= q) if causal else np.ones((S_, S_), bool)
    if block_is_keys:
        keep = keep.T
    nb, ni = math.ceil(S_ / rows), math.ceil(S_ / inner)
    pad = np.zeros((nb * rows, ni * inner), bool)
    pad[:S_, :S_] = keep
    return int(pad.reshape(nb, rows, ni, inner).any(axis=(1, 3)).sum())


@pytest.mark.parametrize("D", [257, 320, 512, 1024])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_wide_route_plan(kernel, D):
    """Grid (B*H, roles * ceil(S/64), ceil(D/128)) of 128-thread blocks
    (float32 K3: two roles, dV and dK, a block each); a ring of
    3 stages, each the larger of a chunk step (64-column rows of the block
    and the streamed tile) and a group step (the streamed tile's 128
    columns; K3 with its lse and delta), rows padded by 16 bytes; K2's
    rows' delta beside it.  Within a block's shared memory at every D; no
    tensor maps.  16-bit: 16-byte copies; float32 by the strides (one
    head of a fused QKV at D = 257: 4-byte)."""
    Bq, Sq, Hq = 2, 777, 3
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        es = dtype.itemsize
        width = -(-D // 8) * 8 if es == 2 else D
        st = (Sq * Hq * 3 * width, Hq * 3 * width, 3 * width, 1)
        plan = TF.launch_plan(kernel, (Bq, Sq, Hq, D),
                              {n: st for n in OPERANDS[kernel]}, True, dtype)
        step = STREAM[kernel, es]
        roles = 2 if kernel == "dkv" and es == 4 else 1
        assert plan.instance == TF.WIDE == TF.instance(dtype, D)
        assert plan.grid == (Bq * Hq, roles * math.ceil(Sq / 64),
                             math.ceil(D / 128))
        assert plan.threads == 128 and plan.maps == {}
        chunk = (64 + step) * (1 if kernel == "fwd" else 2) * (64 + 16 // es)
        group = step * (128 + 16 // es) * (2 if kernel == "dkv" else 1)
        stage = max(chunk * es, group * es + (8 * step if kernel == "dkv"
                                              else 0))
        stage = -(-stage // 16) * 16
        assert plan.smem == 3 * stage + (256 if kernel == "dq" else 0)
        assert plan.smem <= SMEM_LIMIT
        assert plan.inner_tiles == roles * math.ceil(D / 128) * \
            _tiles_with_work(Sq, 64, step, True, block_is_keys=kernel == "dkv")
        want = 16 if es == 2 or D % 4 == 0 else 4
        assert plan.copy_bytes == want
        flat = tuple((n, st) for n in OPERANDS[kernel])
        maps, launch = TF._c_plan(kernel, (Bq, Sq, Hq, D), flat, True, dtype,
                                  True)
        assert list(launch) == [*plan.grid, 128, plan.smem, want]
        assert list(maps) == [x for _, s in flat for x in s]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_every_head_dim_to_1024_plans(dtype):
    """Every D from 1 to 1024 has an instance and a plan in every float
    dtype (float64: the float32 kernels'), D > 256 the wide route."""
    for D in range(1, 1025):
        inst = TF.instance(dtype, D)
        assert (inst == TF.WIDE) == (D > 256), D
        width = -(-D // 8) * 8 if inst == TF.WIDE else inst
        st = (64 * 2 * width, 2 * width, width, 1)
        for kernel, names in OPERANDS.items():
            plan = TF.launch_plan(kernel, (1, 64, 2, D),
                                  {n: st for n in names}, True, dtype)
            assert plan.smem <= SMEM_LIMIT and plan.instance == inst


def test_wide_copy_route_for_strides_16_bytes_cannot_take():
    """D = 257 at one head of a fused QKV: 514-byte rows, which neither a
    tensor map nor the wide route's 16-byte copies describe; the wrapper's
    padded buffer (D rounded up to 264 columns) plans."""
    qkv = torch.randn(2, 100, 1, 3, 257).to(torch.bfloat16)
    k = qkv[..., 1, :]
    assert not TF.describable(k.stride(), k.data_ptr())
    with pytest.raises(ValueError, match="16-byte copies"):
        TF.launch_plan("fwd", (2, 100, 1, 257), {n: k.stride() for n in "qkv"})
    c = TF._padded(k, TF.WIDE)
    assert c.shape == k.shape and torch.equal(c, k)
    assert c.stride() == (100 * 264, 264, 264, 1)
    assert TF.describable(c.stride(), c.data_ptr())
    plan = TF.launch_plan("fwd", (2, 100, 1, 257),
                          {n: c.stride() for n in "qkv"})
    assert plan.grid == (2, 2, 3) and plan.copy_bytes == 16


@pytest.mark.parametrize("dtype, want", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.float64, torch.float32)])
def test_kernel_dtype(dtype, want):
    assert TF.kernel_dtype(dtype) == want
