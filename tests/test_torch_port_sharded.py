"""The port's sharded gossip (``ops/sharded.py``, the optimizers'
``shard_specs``) against the JAX package's, on the same seeded trees.

- The planner (mask, dims, groups, coordinates, bytes, decisions,
  signature), the merged group schedules, the edge counts, the window
  weights and the slice helpers: equal.
- The collective optimizer on ``test_sharded_gossip.py``'s tree: at lr 0
  (the combine alone) bit for bit the JAX package's run (op by op,
  ``jax.disable_jit()``, where ``jit`` contracts or widens the sums), under
  ``none``, ``bf16`` and ``sparse:0.5`` on the group combiner, static and
  dynamic, AWC and ATC; with a learning rate, jitted, within 1e-6 (a fused
  multiply-add and ``p - lr * g`` against ``p + (-lr * g)`` round
  differently).  The ghost slices are their input bit for bit;
  ``BLUEFOG_TPU_SHARDED_GOSSIP=0`` and fully replicated specs give the
  replicated path bit for bit.
- The sharded WinPut against ``test_window_sharded_in_group_oracle``: bit
  for bit.
- A 2-block MoE LM (32 wide, 4 experts sharded on their expert axis, 2
  groups of 2 ranks) for 3 ATC steps over the dynamic topology: losses and
  parameters within 1e-4, the MoE trajectories' tolerance
  (``test_torch_port_train.py``).
- The JAX package's 8-rank multi-process MoE script as 2 gloo processes of
  4 ranks: its consensus checks, and the owned rows bit for bit the
  single-process run.  Run as a script, this file is that worker.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N = 8
JOIN_TIMEOUT = 120


def _tree(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(n, 5).astype(np.float32),
            "b": rng.randn(n, 4, 8).astype(np.float32)}


def _specs():
    from jax.sharding import PartitionSpec as P
    return {"a": P(), "b": P(None, "tp")}


def _plans(tree, specs, **kw):
    from bluefog_tpu.ops import sharded as JSH
    from bluefog_tpu_torch.ops import sharded as TSH
    return (JSH.build_plan(tree, specs, **kw),
            TSH.build_plan({k: torch.from_numpy(v) for k, v in tree.items()},
                           specs, **kw))


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _moe_tree(n, n_shards):
    return ({"router": np.zeros((n, 256), np.float32),
             "experts": np.zeros((n, n_shards, 512), np.float32),
             "head": np.zeros((n, 7, 16), np.float32)},
            {"router": None, "experts": ("ep", None), "head": ("ep", None)})


@pytest.mark.parametrize("case", ["tp", "all-replicated", "indivisible",
                                  "groups", "moe-4", "moe-2"])
def test_plan_equals_jax(case):
    from jax.sharding import PartitionSpec as P
    tree, specs, kw = _tree(), _specs(), {"n": N, "n_shards": 2}
    if case == "all-replicated":
        specs = {"a": P(), "b": P()}
    elif case == "indivisible":
        tree = {"w": np.zeros((N, 7, 3), np.float32)}
        specs = {"w": P("ep", None)}
    elif case == "groups":
        kw = {"n": N, "groups": ((0, 2, 4, 6), (1, 3, 5, 7))}
    elif case.startswith("moe"):
        ns = int(case[-1])
        tree, specs = _moe_tree(N, ns)
        kw = {"n": N, "n_shards": ns}
    want, got = _plans(tree, specs, **kw)
    for f in ("n", "n_shards", "groups", "coords", "mask", "dims",
              "rep_bytes", "sh_bytes", "decisions", "signature",
              "replicated_fraction", "any_sharded"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()


def test_plan_refusals_match_jax():
    from bluefog_tpu.ops import sharded as JSH
    from bluefog_tpu_torch.ops import sharded as TSH
    for mod in (JSH, TSH):
        with pytest.raises(ValueError, match="n_shards"):
            mod.build_plan(_tree(), _specs(), n=N)
        with pytest.raises(ValueError):
            mod.default_groups(8, 3)
        with pytest.raises(ValueError):
            mod.build_plan(_tree(), _specs(), n=N, groups=((0, 1), (1, 2)))
        assert mod.default_groups(8, 4) == ((0, 1), (2, 3), (4, 5), (6, 7))


@pytest.mark.parametrize("n,groups", [
    (8, 2), (8, 4), (16, 2), (8, ((0, 2, 4, 6), (1, 3, 5, 7))),
    (8, ((0,), (1, 2, 3, 4, 5, 6, 7)))])
def test_group_schedules_and_counts_equal_jax(n, groups):
    from bluefog_tpu import topology as jtopo
    from bluefog_tpu.ops import schedule as JS
    from bluefog_tpu.ops import sharded as JSH
    from bluefog_tpu_torch import topology as ttopo
    from bluefog_tpu_torch.ops import schedule as TS
    from bluefog_tpu_torch.ops import sharded as TSH
    from test_torch_port_placement import assert_same_rounds
    if isinstance(groups, int):
        groups = JSH.default_groups(n, groups)
    want, want_per = JSH.compile_group_schedules(n, groups)
    got, got_per = TSH.compile_group_schedules(n, groups)
    assert_same_rounds(want, got)
    assert got.provenance == "sharded"
    np.testing.assert_array_equal(got.indegree, want.indegree)
    np.testing.assert_array_equal(got.outdegree, want.outdegree)
    for (gw, sw), (gg, sg) in zip(want_per, got_per):
        assert gw == gg
        assert_same_rounds(sw, sg)
    coords = [next(i for i, g in enumerate(groups) if r in g)
              for r in range(n)]
    assert TSH.edge_level_counts(coords, got) == \
        JSH.edge_level_counts(coords, want)
    for jmake, tmake in ((jtopo.ExponentialTwoGraph, ttopo.ExponentialTwoGraph),
                         (jtopo.RingGraph, ttopo.RingGraph)):
        assert TSH.edge_level_counts(coords, TS.compile_static(tmake(n))) \
            == JSH.edge_level_counts(coords, JS.compile_static(jmake(n)))
        dyn_t = TS.compile_dynamic(ttopo.dynamic_phase_table(tmake(n)), n)
        dyn_j = JS.compile_dynamic(jtopo.dynamic_phase_table(jmake(n)), n)
        assert TSH.edge_level_counts(coords, dyn_t) == \
            JSH.edge_level_counts(coords, dyn_j)
    gt_j = JSH.group_topology(n, groups)
    gt_t = TSH.group_topology(n, groups)
    assert sorted(gt_t.edges(data="weight")) == sorted(
        gt_j.edges(data="weight"))


def test_window_weights_slices_and_bytes_equal_jax():
    from bluefog_tpu import topology as jtopo
    from bluefog_tpu.ops import sharded as JSH
    from bluefog_tpu_torch import topology as ttopo
    from bluefog_tpu_torch.ops import sharded as TSH
    jp, tp = _plans(_tree(), _specs(), n=N, n_shards=2)
    we, ws, wn = JSH.induced_window_weights(jp, jtopo.ExponentialTwoGraph(N))
    ge, gs, gn = TSH.induced_window_weights(tp, ttopo.ExponentialTwoGraph(N))
    assert ge == we and gn == wn
    np.testing.assert_array_equal(gs, ws)
    leaf = np.random.RandomState(3).randn(N, 4, 8).astype(np.float32)
    rows_j = JSH.own_shard_rows(leaf, 1, jp.coords, 2)
    rows_t = TSH.own_shard_rows(leaf, 1, tp.coords, 2)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(
        TSH.scatter_shard_rows(leaf, rows_t * 2, 1, tp.coords, 2),
        JSH.scatter_shard_rows(leaf, rows_j * 2, 1, jp.coords, 2))
    # test_shard_telemetry_labels' bytes a step: rep rows of 5 f32 over 14
    # cross-group and 10 in-group Exp2(8) edges, own slices over 16.
    got = TSH.record_level_bytes(tp, rep_ici_edges=10.0, rep_dcn_edges=14.0,
                                 grp_edges=16.0)
    assert got == {("ici", "replicated"): 20 * 10, ("dcn", "replicated"):
                   20 * 14, ("ici", "sharded"): 64 * 16}
    assert TSH.record_level_bytes(tp, rep_ici_edges=10.0, rep_dcn_edges=0.0,
                                  grp_edges=16.0, compression="bf16") == {
        ("ici", "replicated"): 100.0, ("ici", "sharded"): 512.0}


def test_jax_leaf_specs_follow_the_ravel_order():
    """``tp_param_specs``' tree for a MoE LM, taken onto the port's
    ``RankReplicas`` order: the JAX leaves' specs in ravel order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from bluefog_tpu import models as jmodels
    from bluefog_tpu.parallel.tensor_parallel import tp_param_specs
    from bluefog_tpu_torch.models import transformer as TT
    from bluefog_tpu_torch.models.convert import (jax_leaf_specs,
                                                  jax_ravel_order)
    kw = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
              max_seq_len=16, num_experts=4)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 8), jnp.int32))["params"]
    specs = tp_param_specs(shapes, ep_axis="ep")
    want = jax.tree_util.tree_leaves(specs,
                                     is_leaf=lambda x: isinstance(x, P))
    with torch.device("meta"):
        tm = TT.TransformerLM(TT.TransformerConfig(**kw))
    got = jax_leaf_specs(tm, specs)
    assert got == want
    names = [name for name, _ in jax_ravel_order(tm)]
    assert jax_leaf_specs(tm, {"params": specs}, names) == want
    assert sum(s == P("ep", None, None) for s in got) == 4
    # A subtree left None is replicated.
    part = dict(specs, block_0=None)
    got = jax_leaf_specs(tm, part, names)
    assert [s for s, nm in zip(got, names) if not nm.startswith("blocks.0.")
            ] == [s for s, nm in zip(want, names)
                  if not nm.startswith("blocks.0.")]
    assert all(s is None for s, nm in zip(got, names)
               if nm.startswith("blocks.0."))


# ---------------------------------------------------------------------------
# The collective optimizer
# ---------------------------------------------------------------------------

def _jax_steps(devices, specs, *, order, dynamic, compression, lr, steps,
               seed=0, num_shards=2, op_by_op=False):
    import jax
    import jax.numpy as jnp
    import optax

    import bluefog_tpu as jbf
    from bluefog_tpu import topology as jtopo
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices)
    params = {k: jnp.asarray(v) for k, v in _tree(seed=seed).items()}
    grads = {k: jnp.asarray(v) for k, v in _tree(seed=seed + 7).items()}
    cls = (jbf.optim.DistributedAdaptThenCombineOptimizer if order == "atc"
           else jbf.optim.DistributedAdaptWithCombineOptimizer)
    opt = cls(optax.sgd(lr), use_dynamic_topology=dynamic,
              compression=compression, shard_specs=specs,
              num_shards=num_shards if specs is not None else None)
    state = opt.init(params)
    with jax.disable_jit(op_by_op):
        for _ in range(steps):
            params, state = opt.step(params, grads, state)
    return {k: np.asarray(v) for k, v in params.items()}, opt


def _port_steps(specs, *, order, dynamic, compression, lr, steps, seed=0,
                num_shards=2, flat=False):
    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch import topology as ttopo
    from bluefog_tpu_torch.optim import optimizers as TO
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    try:
        tree, grads = _tree(seed=seed), _tree(seed=seed + 7)
        keys = sorted(tree)
        if flat:
            ps = [torch.from_numpy(np.concatenate(
                [tree[k].reshape(N, -1) for k in keys], axis=1))]
            ps[0].grad = torch.from_numpy(np.concatenate(
                [grads[k].reshape(N, -1) for k in keys], axis=1))
            extra = {"leaf_shapes": [tree[k].shape[1:] for k in keys]}
        else:
            ps = [torch.from_numpy(tree[k].copy()) for k in keys]
            for p, k in zip(ps, keys):
                p.grad = torch.from_numpy(grads[k])
            extra = {}
        cls = (TO.DistributedAdaptThenCombineOptimizer if order == "atc"
               else TO.DistributedAdaptWithCombineOptimizer)
        opt = cls(torch.optim.SGD(ps, lr=lr), use_dynamic_topology=dynamic,
                  compression=compression,
                  shard_specs=(None if specs is None
                               else [specs[k] for k in keys]),
                  num_shards=num_shards if specs is not None else None,
                  **extra)
        for _ in range(steps):
            opt.step()
        if flat:
            cols = np.cumsum([0] + [tree[k][0].size for k in keys])
            return {k: ps[0][:, cols[i]:cols[i + 1]].numpy().reshape(
                tree[k].shape) for i, k in enumerate(keys)}
        return {k: p.detach().numpy() for k, p in zip(keys, ps)}
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("compression,order,dynamic,op_by_op", [
    ("none", "awc", False, True), ("bf16", "atc", True, True),
    ("sparse:0.5", "awc", False, False), ("sparse:0.5", "atc", True, False)])
def test_collective_combine_bitwise_jax(devices, order, dynamic,
                                        compression, op_by_op):
    """Under ``jit`` XLA contracts ``x * w + recv`` (weights of 1/3 in the
    groups of 4) and keeps the bf16 sums in f32, so those cases run the
    JAX side op by op (one step: ~10 s); the sparse exchange agrees under
    ``jit`` too (two steps, the block rotating)."""
    steps = 1 if op_by_op else 2
    want, opt = _jax_steps(devices, _specs(), order=order, dynamic=dynamic,
                           compression=compression, lr=0.0, steps=steps,
                           op_by_op=op_by_op)
    got = _port_steps(_specs(), order=order, dynamic=dynamic,
                      compression=compression, lr=0.0, steps=steps)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # Ghosts: each rank's other coordinate of b is its input.
    b0, plan = _tree()["b"], opt._shard_plan({k: v for k, v in _tree()
                                              .items()})
    for r in range(N):
        o = 1 - plan.coords[r]
        np.testing.assert_array_equal(got["b"][r, :, o * 4:(o + 1) * 4],
                                      b0[r, :, o * 4:(o + 1) * 4])


@pytest.mark.parametrize("flat", [False, True])
def test_collective_trajectory_within_1e6_of_jax(devices, flat):
    """Three ATC steps with a learning rate over the dynamic topology; the
    single flat buffer with ``leaf_shapes`` takes the same path."""
    want, _ = _jax_steps(devices, _specs(), order="atc", dynamic=True,
                         compression="none", lr=0.1, steps=3)
    got = _port_steps(_specs(), order="atc", dynamic=True,
                      compression="none", lr=0.1, steps=3, flat=flat)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_knob_off_and_all_replicated_are_the_replicated_path(monkeypatch):
    from jax.sharding import PartitionSpec as P

    from bluefog_tpu_torch.utils import config as tconfig
    kw = dict(order="atc", dynamic=True, compression="none", lr=0.1,
              steps=2)
    base = _port_steps(None, **kw)
    allrep = _port_steps({"a": P(), "b": P()}, **kw)
    monkeypatch.setenv("BLUEFOG_TPU_SHARDED_GOSSIP", "0")
    tconfig.reload()
    try:
        off = _port_steps(_specs(), **kw)
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_SHARDED_GOSSIP")
        tconfig.reload()
    for k in base:
        np.testing.assert_array_equal(allrep[k], base[k], err_msg=k)
        np.testing.assert_array_equal(off[k], base[k], err_msg=k)


def test_shard_specs_refusals_match_jax():
    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch.optim import optimizers as TO
    tbf.init(N, device="cpu")
    try:
        sgd = torch.optim.SGD([torch.zeros(N, 4)], lr=0.1)
        with pytest.raises(ValueError, match="shard"):
            TO.DistributedGradientAllreduceOptimizer(
                sgd, shard_specs=[("ep",)], num_shards=2)
        with pytest.raises(ValueError, match="neighbor_allreduce"):
            TO.DistributedAllreduceOptimizer(sgd, shard_specs=[("ep",)],
                                             num_shards=2)
        with pytest.raises(ValueError, match="awc/atc"):
            TO.DistributedOptimizer(sgd, order="gradient_allreduce",
                                    shard_specs=[("ep",)], num_shards=2)
    finally:
        tbf.shutdown()


# ---------------------------------------------------------------------------
# The window optimizer
# ---------------------------------------------------------------------------

def test_window_sharded_bitwise_jax(devices):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import bluefog_tpu as jbf
    import bluefog_tpu_torch as tbf
    from bluefog_tpu import topology as jtopo
    from bluefog_tpu_torch import topology as ttopo
    from bluefog_tpu_torch.optim import window_optimizers as TWO
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices)
    tree = _tree(seed=1)
    params = {k: jnp.asarray(v) for k, v in tree.items()}
    grads = jax.tree.map(jnp.zeros_like, params)
    opt = jbf.optim.DistributedWinPutOptimizer(
        optax.sgd(0.0), shard_specs=_specs(), num_shards=2)
    want, _ = opt.step(params, grads, opt.init(params))
    opt.free()
    keys = sorted(tree)
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    try:
        outs = []
        for specs in ([_specs()[k] for k in keys], [P(), P()], None):
            ps = [torch.from_numpy(tree[k].copy()) for k in keys]
            topt = TWO.DistributedWinPutOptimizer(
                torch.optim.SGD(ps, lr=0.0), shard_specs=specs,
                num_shards=2 if specs else None)
            assert topt._names == (["winput.fused", "winput.sharded"]
                                   if specs and specs[1] else
                                   ["winput.fused"])
            topt.step()
            topt.free()
            outs.append({k: p.numpy() for k, p in zip(keys, ps)})
    finally:
        tbf.shutdown()
    for k in keys:
        np.testing.assert_array_equal(outs[0][k], np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(outs[1][k], outs[2][k], err_msg=k)
    b0 = tree["b"]
    for r in range(N):
        o = 1 - (r >= N // 2)
        np.testing.assert_array_equal(outs[0]["b"][r, :, o * 4:(o + 1) * 4],
                                      b0[r, :, o * 4:(o + 1) * 4])


# ---------------------------------------------------------------------------
# The MoE LM
# ---------------------------------------------------------------------------

R, V, SEQ, BATCH, STEPS = 4, 64, 16, 2, 3
LR = 0.0125 * R


def _moe_kw():
    return dict(vocab_size=V, num_layers=2, num_heads=2, embed_dim=32,
                max_seq_len=SEQ, num_experts=4, router_group_size=16)


def _jax_moe(devices, tokens):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import bluefog_tpu as jbf
    from bluefog_tpu import models as jmodels
    jbf.init(devices=devices[:R])
    model = jmodels.TransformerLM(jmodels.TransformerConfig(
        dtype=jnp.float32, **_moe_kw()))
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[0]))["params"]
    specs = jax.tree_util.tree_map_with_path(
        lambda path, x: P("ep", None, None) if str(path[-1].key) in (
            "experts_up", "experts_down") else P(), init)
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (R,) + x.shape),
                          init)
    opt = jbf.optim.DistributedAdaptThenCombineOptimizer(
        optax.sgd(LR), use_dynamic_topology=True, shard_specs=specs,
        num_shards=2)
    state = opt.init(params)

    def loss_fn(p, x):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, x), jnp.roll(x, -1, axis=1)).mean()

    vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn)))
    losses = []
    for _ in range(STEPS):
        loss, grads = vgrad(params, jnp.asarray(tokens))
        params, state = opt.step(params, jax.device_get(grads), state)
        params = jax.device_get(params)
        losses.append(np.asarray(loss))
    return (jax.tree.map(np.asarray, init), specs, np.stack(losses),
            jax.tree.map(np.asarray, params))


def test_moe_lm_sharded_trajectory_matches_jax(devices):
    import jax
    import torch.nn.functional as F

    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch.models.convert import (jax_leaf_specs,
                                                  jax_ravel_order,
                                                  transformer_params_from_jax)
    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl
    from bluefog_tpu_torch.optim import optimizers as TO
    from bluefog_tpu_torch.replicas import RankReplicas
    tokens = np.random.RandomState(5).randint(
        0, V, (R, BATCH, SEQ)).astype(np.int32)
    init, specs, j_losses, j_params = _jax_moe(devices, tokens)
    tbf.init(R, device="cpu")
    try:
        cfg = TransformerConfig(dtype=torch.float32, remat=True,
                                **_moe_kw())
        make = lambda: TransformerLM(cfg, flash_attention_impl())  # noqa
        rep = RankReplicas(make, R, "cpu", order=jax_ravel_order(make()))
        rep.load_state_dict(transformer_params_from_jax(init))
        opt = TO.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([rep.flat], lr=LR), use_dynamic_topology=True,
            shard_specs=jax_leaf_specs(rep.modules[0], specs, rep.names),
            num_shards=2, leaf_shapes=rep.leaf_shapes)
        assert opt._shard_plan().decisions.count("sharded(dim=0)") == 4
        x = torch.from_numpy(tokens).long()
        losses = []
        for _ in range(STEPS):
            rep.zero_grad()
            step = []
            for r in range(R):
                loss = F.cross_entropy(rep.modules[r](x[r]).reshape(-1, V),
                                       torch.roll(x[r], -1, 1).reshape(-1))
                loss.backward()
                step.append(loss.item())
            opt.step()
            losses.append(step)
        np.testing.assert_allclose(np.asarray(losses), j_losses, rtol=0,
                                   atol=1e-4)
        assert np.ptp(losses[-1]) > 1e-3
        for r in range(R):
            want = transformer_params_from_jax(
                jax.tree.map(lambda a: a[r], j_params))
            got = rep.rank_params(r)
            for name, w in want.items():
                np.testing.assert_allclose(
                    got[name].detach().numpy(), w.numpy(), rtol=0, atol=1e-4,
                    err_msg=f"rank {r} {name}")
    finally:
        tbf.shutdown()


# ---------------------------------------------------------------------------
# Two gloo processes of four ranks
# ---------------------------------------------------------------------------

def _moe_scenario(bf):
    """The JAX package's multi-process MoE script (``test_sharded_gossip.
    py``'s ``_MOE_SCRIPT``) on this process's rows: 24 AWC steps at lr 0;
    returns the owned rows and the initial world values."""
    from bluefog_tpu_torch.optim import optimizers as TO
    n, own = bf.size(), bf.owned_ranks()
    rows = slice(own[0], own[-1] + 1)
    rng = np.random.RandomState(11)
    attn0 = rng.randn(n, 16).astype(np.float32)
    exp0 = rng.randn(n, 4, 8).astype(np.float32)
    ps = [torch.from_numpy(attn0[rows].copy()),
          torch.from_numpy(exp0[rows].copy())]
    for p in ps:
        p.grad = torch.zeros_like(p)
    opt = TO.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(ps, lr=0.0), shard_specs=[(), (None, "ep")],
        num_shards=2)
    for _ in range(24):
        opt.step()
    return {"attn": ps[0].numpy(), "experts": ps[1].numpy(),
            "attn0": attn0, "exp0": exp0, "own": own}


def _worker():
    import bluefog_tpu_torch as bf
    bf.init_distributed(device="cpu")
    try:
        torch.save(_moe_scenario(bf), sys.argv[1])
        bf.barrier()
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_moe_sharded_gossip(tmp_path):
    port, children = _free_port(), []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "MASTER_", "WORLD_SIZE",
                                    "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES="4",
                   OMP_NUM_THREADS="1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_ID=str(p))
        children.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / f"proc{p}.pt")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for c in children:
            logs.append(c.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the 2-process group hung past {JOIN_TIMEOUT} s")
    for p, c in enumerate(children):
        assert c.returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    parts = [torch.load(tmp_path / f"proc{p}.pt", weights_only=False)
             for p in range(2)]
    attn = np.concatenate([q["attn"] for q in parts])
    experts = np.concatenate([q["experts"] for q in parts])
    a0, e0 = parts[0]["attn0"], parts[0]["exp0"]
    # The JAX script's checks: replicated consensus, each group's own slice
    # at its group's mean, the ghosts untouched, the groups apart.
    assert np.abs(attn - a0.mean(axis=0)).max() < 1e-3
    for gi, g in enumerate((range(0, 4), range(4, 8))):
        sl = slice(gi * 4, gi * 4 + 4)
        other = slice((1 - gi) * 4, (1 - gi) * 4 + 4)
        tgt = e0[list(g)][:, :, sl].mean(axis=0)
        for r in g:
            assert np.abs(experts[r, :, sl] - tgt).max() < 1e-3
            np.testing.assert_array_equal(experts[r, :, other],
                                          e0[r, :, other])
    assert np.abs(e0[0:4][:, :, 0:4].mean(axis=0)
                  - e0[4:8][:, :, 4:8].mean(axis=0)).max() > 1e-3
    # Bit for bit the single-process run.
    import bluefog_tpu_torch as bf
    bf.init(N, device="cpu")
    try:
        want = _moe_scenario(bf)
    finally:
        bf.shutdown()
    np.testing.assert_array_equal(attn, want["attn"])
    np.testing.assert_array_equal(experts, want["experts"])


if __name__ == "__main__":
    _worker()
