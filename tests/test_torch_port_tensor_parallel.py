"""The port's tensor and expert parallelism (``parallel/tensor_parallel.py``,
``parallel/moe.py``) against the JAX package's, on seeded inputs.

The JAX side runs as its own tests run it on the 8-device CPU mesh: GSPMD
over a ``(dp, tp)`` mesh for the LM, ``shard_map`` for ``moe_apply``.  The
weights are flax's, carried across by ``models.convert``; the port runs its
tp shards rank-major through the plain attention twin on the CPU.

Tolerances: the forward within 2e-5 (``test_tensor_parallel_sharded_
forward_matches``'s limit), the loss within 1e-5 relative and every gradient,
the replicated parameters' too, within rtol 5e-4 / atol 1e-5
(``test_tensor_parallel_grad_step_matches``'s); ``moe_apply`` within
1e-5 / 1e-6 (``test_moe_expert_parallel_matches_dense``'s); the dp combine
over tp shards within 1e-5 / 1e-6 of the dense oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from bluefog_tpu import models as jmodels
from bluefog_tpu.parallel import moe as JM
from bluefog_tpu.parallel import tensor_parallel as JTP
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import (flax_leaf,
                                              transformer_params_from_jax)
from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops import schedule as S
from bluefog_tpu_torch.parallel import moe as TM
from bluefog_tpu_torch.parallel import tensor_parallel as TP

FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5

CASES = {
    # (TransformerConfig options, tp, token seed): the JAX tests' models
    "mha": (dict(), 4, 0),
    "gqa": (dict(num_kv_heads=2), 4, 1),          # tp > kv heads: gathered
    "llama": (dict(num_kv_heads=4, pos_encoding="rope", mlp="swiglu"), 2, 2),
}


def _models(opts, vocab=128, seed=0):
    """The JAX LM, its flax params, and the port's unsharded LM on them."""
    kw = dict(vocab_size=vocab, num_layers=2, num_heads=4, embed_dim=32,
              max_seq_len=16, **opts)
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(
        dtype=jnp.float32, **kw))
    tokens = np.random.RandomState(seed).randint(0, vocab, (4, 16))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tm = TT.TransformerLM(TT.TransformerConfig(dtype=torch.float32, **kw))
    tm.load_state_dict(transformer_params_from_jax(jax.device_get(params)))
    return jm, params, tm, tokens


def _tp_model(tm, tp):
    model = TP.TensorParallelLM(tm.cfg, tp)
    model.load_state_dict(TP.tp_shard_params(tm, tm.state_dict(), tp))
    return model


def _jax_sharded(params, tokens, devices, tp):
    mesh = Mesh(np.asarray(devices).reshape(8 // tp, tp), ("dp", "tp"))
    return (JTP.tp_shard_params(params, mesh, axis="tp"),
            jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp"))))


def _flax_layout(model, name, t):
    _, _, dims = flax_leaf(model, name)
    return t.permute(*dims) if dims else t


@pytest.mark.parametrize("case", ["mha", "gqa", "moe"])
def test_tp_param_specs_match_jax(case):
    """Each parameter is cut where the JAX package's spec cuts its flax
    leaf: torch dim 0 for a column-parallel kernel (flax ``P(None, tp)``),
    dim 1 for a row-parallel one (``P(tp, None)``), the expert dim under
    ``ep_axis``; the rest replicate."""
    opts = {"mha": {}, "gqa": dict(num_kv_heads=2),
            "moe": dict(num_experts=4)}[case]
    _, params, tm, _ = _models(opts)
    ep = 2 if case == "moe" else None
    j_specs = {"/".join(str(getattr(k, "key", k)) for k in path): s
               for path, s in jax.tree_util.tree_flatten_with_path(
                   JTP.tp_param_specs(params, axis="tp",
                                      ep_axis="ep" if ep else None))[0]}
    specs = TP.tp_param_specs(tm, 4, ep_axis=ep)
    assert set(specs) == {n for n, _ in tm.named_parameters()}
    cut = 0
    for name, spec in specs.items():
        _, path, dims = flax_leaf(tm, name)
        j = tuple(j_specs["params/" + "/".join(path)])
        if not any(j):
            assert spec is None, name
            continue
        k = next(i for i, ax in enumerate(j) if ax is not None)
        assert spec == ({"tp": 4, "ep": ep}[j[k]],
                        dims[k] if dims else k), name
        cut += 1
    # every block kernel is cut, and the lm_head (MoE: the two expert stacks)
    assert cut == 2 * {"mha": 4, "gqa": 5, "moe": 4}[case] + 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_sharded_forward_matches_jax(devices, case):
    """The rank-major tp forward equals JAX's GSPMD forward of the same
    weights (itself the unsharded forward); under GQA at tp 4 with 2 kv
    heads the kv shards are half groups, gathered back."""
    opts, tp, seed = CASES[case]
    jm, params, tm, tokens = _models(opts, seed=seed)
    p_sh, t_sh = _jax_sharded(params, tokens, devices, tp)
    ref = np.asarray(jax.jit(jm.apply)(p_sh, t_sh))
    with torch.no_grad():
        out = _tp_model(tm, tp)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_qkv_cut_hands_each_shard_whole_heads():
    """The fused QKV is head-interleaved, so a contiguous cut of its rows
    gives shard ``i`` the q, k and v of heads ``i * H/tp ..``; read as
    thirds (``[Q | K | V]`` cut per third), the same weights give another
    model, which the forward test would catch."""
    _, _, tm, tokens = _models({})
    tp, E, d = 4, 32, 8
    w = tm.blocks[0].qkv.weight.detach()             # (3E, E) interleaved
    shards = TP.tp_shard_params(tm, tm.state_dict(), tp)[
        "blocks.0.qkv.weight"]
    heads = w.view(4, 3, d, E)                        # (h, q/k/v, d, E)
    for i in range(tp):
        np.testing.assert_array_equal(shards[i].numpy(),
                                      heads[i].reshape(-1, E).numpy())
    thirds = tm.state_dict()
    thirds["blocks.0.qkv.weight"] = heads.transpose(0, 1).reshape(3 * E, E)
    other = TT.TransformerLM(tm.cfg)
    other.load_state_dict(thirds)
    with torch.no_grad():
        t = torch.from_numpy(tokens)
        assert (_tp_model(other, tp)(t) - tm(t)).abs().max() > 1e-2


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_grad_step_matches_jax(devices, case):
    """Loss and gradients of the tp step against JAX's ``value_and_grad``
    under GSPMD, every parameter: the cut ones put back together, and the
    replicated ones (``wte``, ``wpe``, the RMSNorm scales), whose gradient
    is the sum over the shards."""
    opts, tp, seed = CASES[case]
    jm, params, tm, tokens = _models(opts, vocab=64, seed=seed)

    def loss(p, t):
        logits = jm.apply(p, t)
        tgt = jnp.roll(t, -1, axis=1)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, tgt[..., None], -1).mean()

    p_sh, t_sh = _jax_sharded(params, tokens, devices, tp)
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(p_sh, t_sh)
    j_flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
              for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}

    model = _tp_model(tm, tp)
    t = torch.from_numpy(tokens)
    logits = model(t)
    out = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.roll(t, -1, 1).reshape(-1))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(j_loss), rtol=1e-5)
    specs = TP.tp_param_specs(tm, tp)
    grads = dict(model.named_parameters())
    for name, spec in specs.items():
        g = grads[name].grad
        if spec is not None:
            g = torch.cat(list(g), spec[1])
        _, path, _ = flax_leaf(tm, name)
        np.testing.assert_allclose(
            _flax_layout(tm, name, g).numpy(),
            j_flat["params/" + "/".join(path)], rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=name)


def test_decentralized_combine_over_tp_sharded_params():
    """A column-parallel weight's replicas ``(dp, d, 4d)`` held as dp rows
    of their tp shards (one ``RankReplicas`` row a dp rank, the shards
    side by side in it) and combined over dp: each shard is averaged over
    dp only, equal to the dense oracle ``einsum("sd,s...->d...", W, x)``;
    each round's source shares the receiver's tp index, so changing one tp
    shard of the input moves that shard of the output alone."""
    dp, tp, d = 4, 2, 8
    rng = np.random.RandomState(0)
    W = rng.randn(dp, d, 4 * d).astype(np.float32)
    G = topo.ExponentialTwoGraph(dp)
    sched = S.compile_static(G, use_topo_weights=False)

    def combine(w):
        # (dp, d, 4d) -> (dp, tp, d, 4d / tp) shards -> one row a dp rank
        rows = torch.from_numpy(w).reshape(dp, d, tp, -1).transpose(1, 2)
        out = C.neighbor_allreduce(rows.reshape(dp, -1), sched)
        return out.reshape(dp, tp, d, -1).transpose(1, 2).reshape(dp, d, -1)

    out = combine(W).numpy()
    w_uni = S.uniform_weights(topo.weight_matrix(G))
    np.testing.assert_allclose(out, np.einsum("sd,s...->d...", w_uni, W),
                               rtol=1e-5, atol=1e-6)
    moved = W.copy()
    moved[:, :, 2 * d:] += 1.0                     # tp shard 1 only
    diff = np.abs(combine(moved).numpy() - out)
    assert diff[:, :, :2 * d].max() == 0.0 and diff[:, :, 2 * d:].min() > 0


def test_moe_expert_parallel_matches_dense(devices):
    """Switch-routed MoE over a 4-rank ep axis equals the dense evaluation
    of the same routing plan (capacity drops included), and the JAX
    package's ``moe_apply`` under ``shard_map``."""
    E, T, d, cap = 4, 12, 8, 4
    rng = np.random.RandomState(0)
    Ws = (rng.randn(E, d, d) * 0.5).astype(np.float32)
    x = rng.randn(T, d).astype(np.float32)
    logits = rng.randn(T, E).astype(np.float32)
    combine, dispatch = JM.switch_dispatch(jnp.asarray(logits), E, cap)
    ref = np.zeros_like(x)
    for e in range(E):
        ye = np.tanh((np.asarray(dispatch[e]) @ x) @ Ws[e])
        ref = ref + np.moveaxis(np.asarray(combine), 1, 0)[e] @ ye
    mesh = Mesh(np.asarray(devices[:E]), ("ep",))
    j_out = jax.jit(jax.shard_map(
        lambda W, xx, lg: JM.moe_apply(lambda w, z: jnp.tanh(z @ w[0]), W,
                                       xx, lg, axis_name="ep", capacity=cap),
        mesh=mesh, in_specs=(P("ep"), P(), P()), out_specs=P(),
        check_vma=False))(Ws, x, logits)
    rows = lambda a: torch.from_numpy(  # noqa: E731
        np.broadcast_to(a, (E,) + a.shape).copy())
    out = TM.moe_apply(lambda w, z: torch.tanh(z @ w[0]),
                       (torch.from_numpy(Ws),), rows(x), rows(logits),
                       axis=E, capacity=cap)
    for row in out:
        np.testing.assert_allclose(row.numpy(), ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(row.numpy(), np.asarray(j_out),
                                   rtol=1e-5, atol=1e-6)


def test_tensor_parallel_training_main_loss_falls():
    from bluefog_tpu_torch import tensor_parallel_training as TPT
    res = TPT.main(["--device", "cpu", "--steps", "12"])
    assert res["losses"][-1] < res["losses"][0]
    assert res["dp"] == 2 and res["tp"] == 4
    assert res["qkv_shards"] == [4, 96, 128]
