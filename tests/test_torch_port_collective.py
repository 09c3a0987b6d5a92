"""The port's rank-major collectives against the JAX package's eager ops
(and, where the JAX package has no eager wrapper, its ``ops.collective``
functions under ``shard_map``) on the virtual CPU mesh.  float32 results
are equal bit for bit: the port sums in the JAX package's order, and its
static schedules are the JAX package's round for round (both repack)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import collective as JC
from bluefog_tpu.ops import schedule as jsched
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import collective as TC
from bluefog_tpu_torch.ops import schedule as tsched


@pytest.fixture
def port():
    yield tbf
    tbf.shutdown()


@pytest.mark.parametrize("n", [4, 8])
def test_dynamic_neighbor_allreduce_matches_jax(devices, port, n):
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    period = len(ttopo.dynamic_phase_table(ttopo.ExponentialGraph(n)))
    rng = np.random.RandomState(n)
    x = rng.randn(n, 5, 7).astype(np.float32)
    xj, xt = x, torch.from_numpy(x)
    for step in range(period + 2):
        xj = np.asarray(jbf.dynamic_neighbor_allreduce(xj, step))
        xt = port.dynamic_neighbor_allreduce(xt, step)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
def test_exp2_phases_reach_consensus_as_jax(devices, port, n):
    """One-peer Exp-2 phases: a full period averages exactly, in both."""
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(n, 16).astype(np.float32)
    jph, tph = jtopo.one_peer_exp2_phases(n), ttopo.one_peer_exp2_phases(n)
    xj, xt = x, torch.from_numpy(x)
    for step in range(len(tph)):
        xj = np.asarray(jbf.dynamic_neighbor_allreduce(xj, step, phases=jph))
        xt = port.dynamic_neighbor_allreduce(xt, step, phases=tph)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.broadcast_to(x.mean(0), x.shape),
                               atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_static_neighbor_allreduce_matches_jax(devices, port, weighted):
    n = 8
    jbf.init(devices=devices[:n], is_weighted=weighted)
    port.init(n, device="cpu", is_weighted=weighted)
    x = np.random.RandomState(1).randn(n, 33).astype(np.float32)
    out_j = np.asarray(jbf.neighbor_allreduce(x))
    out_t = port.neighbor_allreduce(torch.from_numpy(x)).numpy()
    # Both repack the rounds alike, so the sums run in the same order.
    np.testing.assert_array_equal(out_t, out_j)


def test_rank_major_shape_checked(port):
    port.init(4, device="cpu")
    with pytest.raises(ValueError, match="leading dim 4"):
        port.dynamic_neighbor_allreduce(torch.zeros(3, 2), 0)


def _jax_ranks(devices, fn, x, *extra):
    """``fn(rank's block, *extra)`` under ``shard_map`` over the leading
    dim of the rank-major ``x``."""
    mesh = Mesh(np.asarray(devices[:x.shape[0]]), ("r",))
    return np.asarray(jax.jit(jax.shard_map(
        lambda b, *e: fn(b[0], *e)[None], mesh=mesh,
        in_specs=(P("r"),) + (P(),) * len(extra), out_specs=P("r"),
        check_vma=False))(x, *extra))


@pytest.mark.parametrize("op", ["allreduce", "sum", "broadcast", "allgather",
                                "local_allreduce", "neighbor_allgather",
                                "pair_gossip"])
def test_eager_collectives_match_jax(devices, port, op):
    """Each eager collective on the same rank-major f32 input: bitwise."""
    n = 8
    local = 4 if op == "local_allreduce" else None
    topo = (lambda: jtopo.StarGraph(n), lambda: ttopo.StarGraph(n))
    jbf.init(devices=devices[:n], local_size=local, topology_fn=topo[0])
    port.init(n, device="cpu", local_size=local, topology_fn=topo[1])
    x = np.random.RandomState(3).randn(n, 3, 5).astype(np.float32)
    xt = torch.from_numpy(x)
    pairs = [1, 0, 3, 2, -1, 6, 5, -1]
    # Under jit XLA contracts pair_gossip's ``x * w + recv`` into one fused
    # multiply-add; op by op it rounds the product as the port does.
    with jax.disable_jit():
        want, got = _eager_pair(op, x, xt, pairs, port)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if op == "local_allreduce":   # two machines of four
        assert not np.allclose(want[0], want[4])


def _eager_pair(op, x, xt, pairs, port):
    return {
        "allreduce": lambda: (jbf.allreduce(x), port.allreduce(xt)),
        "sum": lambda: (jbf.allreduce(x, average=False),
                        port.allreduce(xt, average=False)),
        "broadcast": lambda: (jbf.broadcast(x, 5), port.broadcast(xt, 5)),
        "allgather": lambda: (jbf.allgather(x), port.allgather(xt)),
        "local_allreduce": lambda: (jbf.local_allreduce(x),
                                    port.local_allreduce(xt)),
        "neighbor_allgather": lambda: (jbf.neighbor_allgather(x),
                                       port.neighbor_allgather(xt)),
        "pair_gossip": lambda: (jbf.pair_gossip(x, pairs, self_weight=0.3,
                                                target_weight=0.7),
                                port.pair_gossip(xt, pairs, self_weight=0.3,
                                                 target_weight=0.7)),
    }[op]()


def test_ragged_allgathers_match_jax(devices, port):
    n = 8
    jbf.init(devices=devices[:n], topology_fn=lambda: jtopo.StarGraph(n))
    port.init(n, device="cpu", topology_fn=lambda: ttopo.StarGraph(n))
    rng = np.random.RandomState(4)
    parts = [rng.randn(i % 3 + 1, 2).astype(np.float32) for i in range(n)]
    tparts = [torch.from_numpy(p) for p in parts]
    np.testing.assert_array_equal(port.allgather_v(tparts).numpy(),
                                  np.asarray(jbf.allgather_v(parts)))
    want = jbf.neighbor_allgather_v(parts)
    got = port.neighbor_allgather_v(tparts)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="FIRST dim"):
        port.allgather_v([torch.zeros(1, 2)] * (n - 1) + [torch.zeros(1, 3)])


def test_broadcast_parameters_matches_jax(devices, port):
    n = 4
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    rng = np.random.RandomState(5)
    tree = {"w": rng.randn(n, 3, 2).astype(np.float32),
            "b": [rng.randn(n, 4).astype(np.float32)]}
    want = jbf.broadcast_parameters(tree, root_rank=2)
    got = port.broadcast_parameters(
        {"w": torch.from_numpy(tree["w"]), "b": [torch.from_numpy(tree["b"][0])]},
        root_rank=2)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))


@pytest.mark.parametrize("weights", ["matrix", "src-dict", "dst-dict"])
def test_neighbor_allreduce_weight_override_matches_jax(devices, port,
                                                        weights):
    n = 8
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    rng = np.random.RandomState(6)
    x = rng.randn(n, 9).astype(np.float32)
    w = jtopo.weight_matrix(jtopo.ExponentialGraph(n)) * rng.rand(n, n)
    kw = {"matrix": dict(src_weights=w),
          "src-dict": dict(self_weight=0.4,
                           src_weights={r: 0.1 * (r + 1) for r in range(n)}),
          "dst-dict": dict(self_weight=0.2, dst_weights={1: 0.3, 4: 0.15})
          }[weights]
    with jax.disable_jit():   # op by op: no fused multiply-add
        want = np.asarray(jbf.neighbor_allreduce(x, **kw))
    got = port.neighbor_allreduce(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="same time"):
        port.neighbor_allreduce(torch.from_numpy(x), self_weight=0.5)


@pytest.mark.parametrize("topo", ["MeshGrid2DGraph", "StarGraph"])
def test_neighbor_allreduce_matrix_matches_jax(devices, topo):
    """A runtime weight matrix over a static schedule's edges, in f32 and
    in bf16 (the weights rounded to f32 first, then to the payload's
    dtype, in both); the JAX side op by op, as XLA's jit would fuse the
    weighted terms into multiply-adds."""
    n = 8
    rng = np.random.RandomState(7)
    js = jsched.compile_static(getattr(jtopo, topo)(n))
    ts = tsched.compile_static(getattr(ttopo, topo)(n))
    w = (rng.rand(n, n) + 0.1).astype(np.float64)
    x = rng.randn(n, 6).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        with jax.disable_jit():
            want = _jax_ranks(
                devices, lambda b, ww: JC.neighbor_allreduce_matrix(
                    b, ww, js, "r"),
                jnp.asarray(x, jdt), jnp.asarray(w, jnp.float32))
        got = TC.neighbor_allreduce_matrix(torch.from_numpy(x).to(tdt), w, ts)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["topk", "topk-valid", "indices-per-rank",
                                  "duplicates"])
def test_sparse_neighbor_allreduce_unaligned_matches_jax(devices, mode):
    """The per-rank (not aligned) sparse exchange: magnitude top-k (inputs
    with distinct magnitudes, so both pick the same entries), a ``valid``
    mask, per-rank index sets, and an index picked twice (it adds twice,
    in the sent ``q`` as at the receivers)."""
    n, m, k = 8, 40, 6
    rng = np.random.RandomState(8)
    x = (rng.permutation(n * m).reshape(n, m) + 1.0).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32)
    x /= n * m
    js = jsched.compile_static(jtopo.ExponentialGraph(n))
    ts = tsched.compile_static(ttopo.ExponentialGraph(n))
    idx = np.stack([rng.choice(m, k, replace=False) for _ in range(n)]
                   ).astype(np.int32)
    if mode == "duplicates":
        idx[:, 1] = idx[:, 0]
    valid = (rng.rand(k) > 0.3) if mode == "topk-valid" else None
    mesh = Mesh(np.asarray(devices[:n]), ("r",))

    def j_rank(b, ib):
        kw = dict(k=k) if mode.startswith("topk") else dict(indices=ib[0])
        if valid is not None:
            kw["valid"] = jnp.asarray(valid)
        out, q = JC.sparse_neighbor_allreduce(b[0], js, "r",
                                              return_sent=True, **kw)
        return out[None], q[None]
    want, want_q = jax.jit(jax.shard_map(
        j_rank, mesh=mesh, in_specs=(P("r"), P("r")),
        out_specs=(P("r"), P("r")), check_vma=False))(x, idx)
    kw = (dict(k=k) if mode.startswith("topk")
          else dict(indices=torch.from_numpy(idx)))
    if valid is not None:
        kw["valid"] = torch.from_numpy(valid)
    got, got_q = TC.sparse_neighbor_allreduce(torch.from_numpy(x), ts,
                                              return_sent=True, **kw)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
