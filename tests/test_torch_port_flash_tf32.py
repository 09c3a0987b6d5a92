"""The arithmetic of the float32 K1-K3 (``csrc/flash_attention_f32.cu``) on
the CPU, against the JAX package's Pallas kernels in interpret mode.

The kernels run every product on the tensor cores in 3xTF32: each float32
operand splits into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
with ties away from zero (``cvt.rna``'s rounding, ``mma_tf32.cuh``
``round_tf32``), and lo.hi + hi.lo + hi.hi sum in float32.  Here a numpy
emulation of that split computes K1's forward, K2's dq and delta and K3's
dk and dv blockwise in the kernels' order: 64-row blocks, the instance's
streamed tiles (K2's taken in turns by its warp groups), the online
softmax in log2 units, a tile's products added in float32.  It is held to
the JAX kernels at the tolerances the kernels are held to on the card (o
and lse 2e-5 max abs, dq, delta, dk and dv 1e-4 relative); one TF32
product alone misses them at D = 256.  The fragment order in which a
score accumulator feeds the next product without a shuffle is checked
lane by lane."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bluefog_tpu.ops import flash_attention as JF

B, S, H = 1, 80, 2            # S = 80: a ragged last 64-row block and tile
BLOCK = 64                    # rows a block (FwdTile, DkvTile kBlock)
INSTANCES = (16, 64, 128, 256)
# Streamed rows a tile by instance (FwdTile, DqTile, DkvTile kStream).
FWD_STREAM = {16: 64, 64: 64, 128: 32, 256: 16}
DQ_STREAM = {16: 64, 64: 64, 128: 32, 256: 16}
DKV_STREAM = {16: 64, 64: 64, 128: 16, 256: 16}
DQ_GROUPS = {16: 1, 64: 2, 128: 2, 256: 1}    # DqTile kGroups
LOG2E = 1.4426950408889634
FWD_TOL = 2e-5                # o and lse: max |err|
GRAD_TOL = 1e-4               # dq, delta, dk, dv: ||err|| / ||ref||


def round_tf32(x):
    """``round_tf32`` of mma_tf32.cuh on the int32 view: half a TF32 ulp
    (bit 12) added to the magnitude, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    hi = round_tf32(x)
    return hi, round_tf32(np.float32(x) - hi)


def mm3(a, b):
    """``a @ b`` in 3xTF32: lo.hi + hi.lo first, then hi.hi, in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    small = (al @ bh).astype(np.float32) + (ah @ bl).astype(np.float32)
    return (ah @ bh).astype(np.float32) + small


def mm1(a, b):
    """``a @ b`` as one TF32 product (one rounding of each operand)."""
    return (round_tf32(a) @ round_tf32(b)).astype(np.float32)


def instance(D):
    return next(i for i in INSTANCES if D <= i)


def fwd_emulated(q, k, v, causal, mm=mm3):
    """K1 on (S, D) slabs: o and lse, block by block and tile by tile."""
    D = q.shape[1]
    step = FWD_STREAM[instance(D)]
    scale_log2 = np.float32(LOG2E / math.sqrt(D))
    o = np.zeros_like(q)
    lse = np.zeros(S, np.float32)
    for q0 in range(0, S, BLOCK):
        rows = np.arange(q0, min(S, q0 + BLOCK))
        m = np.full(len(rows), -1e30, np.float32)
        l = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        kend = min(S, q0 + BLOCK) if causal else S
        for k0 in range(0, kend, step):
            cols = np.arange(k0, min(S, k0 + step))
            x = mm(q[rows], k[cols].T) * scale_log2
            if causal:
                x = np.where(cols[None] > rows[:, None], -np.inf, x)
            mn = np.maximum(m, x.max(1))
            corr = np.exp2(m - mn)
            p = np.exp2(x - mn[:, None]).astype(np.float32)
            l = l * corr + p.sum(1)
            acc = acc * corr[:, None] + mm(p, v[cols])
            m = mn
        li = np.maximum(l, np.float32(1e-30))
        o[rows] = acc / li[:, None]
        lse[rows] = (m + np.log2(li)) * np.float32(math.log(2.0))
    return o, lse


def dq_emulated(q, k, v, do, o, lse, dlse, causal, mm=mm3):
    """K2 on (S, D) slabs: dq and delta.  Per 64-row block: delta =
    rowsum(dO o) - dlse, each row summed in parts by the block's lanes;
    key tiles up to the causal frontier, tile i to warp group i mod G, each
    group's dQ += dS.K a tile at a time; the groups' dQ added at the end."""
    D = q.shape[1]
    inst = instance(D)
    step, G = DQ_STREAM[inst], DQ_GROUPS[inst]
    lanes = 128 * G // BLOCK                      # lanes summing a row
    scale = np.float32(1.0 / math.sqrt(D))
    scale_log2 = np.float32(LOG2E / math.sqrt(D))
    dq = np.zeros_like(q)
    delta = np.zeros(S, np.float32)
    for q0 in range(0, S, BLOCK):
        rows = np.arange(q0, min(S, q0 + BLOCK))
        prod = np.zeros((len(rows), inst), np.float32)
        prod[:, :D] = do[rows] * o[rows]
        dl = prod.reshape(len(rows), -1, lanes).sum(1, dtype=np.float32)
        dl = dl.sum(1, dtype=np.float32) - dlse[rows]
        delta[rows] = dl
        acc = np.zeros((G, len(rows), D), np.float32)
        kend = min(S, q0 + BLOCK) if causal else S
        for i, k0 in enumerate(range(0, kend, step)):
            cols = np.arange(k0, min(S, k0 + step))
            s = mm(q[rows], k[cols].T)
            p = np.exp2(s * scale_log2 - lse[rows][:, None] * np.float32(LOG2E))
            if causal:
                p = np.where(cols[None] > rows[:, None], 0, p)
            dp = mm(do[rows], v[cols].T)
            ds = (p * (dp - dl[:, None])).astype(np.float32)
            acc[i % G] = acc[i % G] + mm(ds, k[cols])
        dq[rows] = acc.sum(0, dtype=np.float32) * scale
    return dq, delta


def dkv_emulated(q, k, v, do, lse, delta, causal, mm=mm3):
    """K3 on (S, D) slabs: dk and dv, key block by key block, q tiles from
    the causal frontier."""
    D = q.shape[1]
    step = DKV_STREAM[instance(D)]
    scale = np.float32(1.0 / math.sqrt(D))
    scale_log2 = np.float32(LOG2E / math.sqrt(D))
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for k0 in range(0, S, BLOCK):
        keys = np.arange(k0, min(S, k0 + BLOCK))
        acc_k = np.zeros((len(keys), D), np.float32)
        acc_v = np.zeros_like(acc_k)
        for q0 in range(k0 if causal else 0, S, step):
            rows = np.arange(q0, min(S, q0 + step))
            st = mm(k[keys], q[rows].T)
            p = np.exp2(st * scale_log2 - lse[rows][None] * np.float32(LOG2E))
            if causal:
                p = np.where(keys[:, None] > rows[None], 0, p)
            p = p.astype(np.float32)
            dpt = mm(v[keys], do[rows].T)
            ds = p * (dpt - delta[rows][None])
            acc_v = acc_v + mm(p, do[rows])
            acc_k = acc_k + mm(ds, q[rows])
        dk[keys], dv[keys] = acc_k * scale, acc_v
    return dk, dv


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    dlse = (0.1 * rng.randn(B, S, H)).astype(np.float32)
    return q, k, v, do, dlse


@functools.lru_cache(maxsize=None)
def _jax(D, causal):
    """The JAX kernels' o, lse and (dq, dk, dv) for the cotangents (do,
    dlse)."""
    q, k, v, do, dlse = _inputs(D, seed=100 + D)

    def f(a, b, c):
        return JF.flash_attention_lse(a, b, c, causal=causal, block_q=16,
                                      block_k=16)
    (o, lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return tuple(np.asarray(x) for x in (o, lse, *grads))


def _slab(x, b, h):
    return np.ascontiguousarray(x[b, :, h])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [6, 8, 16, 64, 256])
def test_k1_3xtf32_matches_jax(D, causal):
    q, k, v, _, _ = _inputs(D, seed=100 + D)
    o_j, lse_j = _jax(D, causal)[:2]
    for b in range(B):
        for h in range(H):
            o, lse = fwd_emulated(_slab(q, b, h), _slab(k, b, h),
                                  _slab(v, b, h), causal)
            np.testing.assert_allclose(o, o_j[b, :, h], rtol=0, atol=FWD_TOL)
            np.testing.assert_allclose(lse, lse_j[b, :, h], rtol=0,
                                       atol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [6, 8, 16, 64, 256])
def test_k3_3xtf32_matches_jax(D, causal):
    """dk and dv from the forward's o and lse and delta = rowsum(dO o) -
    dlse, as K2 hands it to K3."""
    q, k, v, do, dlse = _inputs(D, seed=100 + D)
    o_j, lse_j, _, dk_j, dv_j = _jax(D, causal)
    delta = (do * o_j).sum(-1) - dlse                      # (B, S, H)
    for b in range(B):
        for h in range(H):
            dk, dv = dkv_emulated(*(_slab(x, b, h) for x in (q, k, v, do)),
                                  lse_j[b, :, h], delta[b, :, h], causal)
            for got, ref in ((dk, dk_j[b, :, h]), (dv, dv_j[b, :, h])):
                rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert rel <= GRAD_TOL, rel


def _rel(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_k2_3xtf32_matches_jax(D, causal):
    """dq from the forward's o and lse and the cotangents (dO, dlse), in
    each instance's tiles and warp groups; delta from the same o, against
    the JAX backward's own sum."""
    q, k, v, do, dlse = _inputs(D, seed=100 + D)
    o_j, lse_j, dq_j = _jax(D, causal)[:3]
    delta_j = np.asarray(jnp.sum(jnp.asarray(do) * jnp.asarray(o_j), -1)
                         - jnp.asarray(dlse))                  # (B, S, H)
    for b in range(B):
        for h in range(H):
            dq, delta = dq_emulated(*(_slab(x, b, h) for x in (q, k, v, do,
                                                               o_j)),
                                    lse_j[b, :, h], dlse[b, :, h], causal)
            assert _rel(dq, dq_j[b, :, h]) <= GRAD_TOL
            assert _rel(delta, delta_j[b, :, h]) <= GRAD_TOL


def test_one_tf32_product_misses_the_dq_tolerance_at_d256():
    """K2's three products each in one TF32 product: dq at D = 256 is off
    by more than the float32 tolerance."""
    D = 256
    q, k, v, do, dlse = _inputs(D, seed=100 + D)
    o_j, lse_j, dq_j = _jax(D, True)[:3]
    dq, _ = dq_emulated(*(_slab(x, 0, 0) for x in (q, k, v, do, o_j)),
                        lse_j[0, :, 0], dlse[0, :, 0], True, mm=mm1)
    assert _rel(dq, dq_j[0, :, 0]) > 3 * GRAD_TOL         # ~6e-4


def test_one_tf32_product_misses_the_tolerance_at_d256():
    """Why three products: with one TF32 rounding of each operand the
    forward at D = 256 is off by more than the float32 tolerance."""
    D = 256
    q, k, v, _, _ = _inputs(D, seed=100 + D)
    o_j, lse_j = _jax(D, True)[:2]
    o, lse = fwd_emulated(_slab(q, 0, 0), _slab(k, 0, 0), _slab(v, 0, 0),
                          True, mm=mm1)
    err = max(np.abs(o - o_j[0, :, 0]).max(), np.abs(lse - lse_j[0, :, 0]).max())
    assert err > 10 * FWD_TOL, err


def test_round_tf32_is_to_nearest_ties_away():
    x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                  -(1 + 2.0 ** -11), 1 + 2.0 ** -12], np.float32)
    # ties (exactly half a TF32 ulp) go away from zero; below half, down
    np.testing.assert_array_equal(
        round_tf32(x), np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                                 -(1 + 2.0 ** -10), 1.0], np.float32))
    y = np.random.RandomState(0).randn(4096).astype(np.float32)
    hi, lo = split(y)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi + lo keeps y to ~2^-22 relative; hi alone to 2^-11
    assert np.abs(hi.astype(np.float64) + lo - y).max() <= 2.0 ** -21 * np.abs(y).max()
    assert np.abs((hi - y) / y).max() <= 2.0 ** -11


def _mma(a_frag, b_frag):
    """m16n8k8 from per-lane fragments (lane = 4g + t): A a0 (g, t), a1
    (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k = t, n = g), b1
    (k = t + 4, n = g); returns the 16 x 8 product."""
    A, Bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        Bm[t, g], Bm[t + 4, g] = b_frag[lane]
    return A @ Bm


@pytest.mark.parametrize("n0", [0, 8, 16, 24])
def test_scores_feed_the_next_product_without_a_shuffle(n0):
    """acc_as_a and load_b_cols: a lane's score accumulator (columns 2t and
    2t + 1 of rows g and g + 8) is A at k = t and t + 4, and B's rows are
    read as 2t and 2t + 1; the product is P . V (K2: dS . K, the K tile
    of the scores read by columns; K3: dS^T . Q), at head-dim columns n0
    to n0 + 8."""
    rng = np.random.RandomState(n0)
    P = rng.randn(16, 8)                  # one 16 x 8 score tile
    V = rng.randn(8, 32)                  # its 8 rows of the other operand
    a_frag, b_frag = [], []
    for lane in range(32):
        g, t = divmod(lane, 4)
        c = (P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t], P[g + 8, 2 * t + 1])
        a_frag.append((c[0], c[2], c[1], c[3]))            # acc_as_a
        b_frag.append((V[2 * t, n0 + g], V[2 * t + 1, n0 + g]))  # load_b_cols
    np.testing.assert_allclose(_mma(a_frag, b_frag), P @ V[:, n0:n0 + 8],
                               rtol=1e-12, atol=1e-12)


def test_key_major_fragments_give_q_kt():
    """load_a and load_b_rows: Q's rows g, g + 8 at columns t, t + 4 and
    K's row g at columns t, t + 4 give Q . K^T."""
    rng = np.random.RandomState(1)
    Q, K = rng.randn(16, 8), rng.randn(8, 8)
    a_frag = [(Q[g, t], Q[g + 8, t], Q[g, t + 4], Q[g + 8, t + 4])
              for g, t in map(lambda lane: divmod(lane, 4), range(32))]
    b_frag = [(K[g, t], K[g, t + 4])
              for g, t in map(lambda lane: divmod(lane, 4), range(32))]
    np.testing.assert_allclose(_mma(a_frag, b_frag), Q @ K.T, rtol=1e-12,
                               atol=1e-12)
