"""The port's ResNet family against the JAX package's flax ResNet, with the
weights carried by ``models.convert``.

Float32 throughout.  Forward logits agree at 1e-4 relative to their largest
value (XLA-CPU and torch-CPU order their convolution sums differently),
parameter gradients at 1e-4, BN ``batch_stats`` after a train-mode forward
at 1e-5.  The stride-2 3x3 convs pad flax's ``SAME`` way, ``(0, 1)``, and
the BN running variance moves by the biased batch variance; either undone
fails these tests.  The training trajectories of the small ResNet stand in
``test_torch_port_compression.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu import models as jmodels
from bluefog_tpu.models import resnet as jresnet
from bluefog_tpu_torch import models as tmodels
from bluefog_tpu_torch.models import resnet as tresnet
from bluefog_tpu_torch.models.convert import (flax_leaf, jax_ravel_order,
                                              params_from_jax)
from bluefog_tpu_torch.replicas import RankReplicas

CLASSES = 10


def _small(block, dtype):
    """``ResNet(stage_sizes=(1, 1), num_filters=8)`` in both packages."""
    if dtype == "jax":
        return jmodels.ResNet(stage_sizes=(1, 1),
                              block_cls=getattr(jresnet, block),
                              num_filters=8, num_classes=CLASSES,
                              dtype=jnp.float32)
    return tmodels.ResNet((1, 1), getattr(tresnet, block), num_filters=8,
                          num_classes=CLASSES, dtype=torch.float32)


MODELS = {
    "small-bottleneck": (lambda: _small("BottleneckBlock", "jax"),
                         lambda: _small("BottleneckBlock", "torch")),
    "small-basic": (lambda: _small("BasicBlock", "jax"),
                    lambda: _small("BasicBlock", "torch")),
    "resnet18": (lambda: jmodels.ResNet18(num_classes=CLASSES,
                                          dtype=jnp.float32),
                 lambda: tmodels.ResNet18(num_classes=CLASSES,
                                          dtype=torch.float32)),
}


def _images(seed, batch=8, size=32):
    """A batch of 8: ResNet-18's last stage is 1x1 at 32x32, and BN over 2
    values a channel would amplify rounding beyond any float32 tolerance."""
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(
        np.float32)


def _variables(jm, x, seed=0):
    """flax init with every BN scale and bias drawn at random, so that no
    branch is zeroed by the zero-initialised last BN of a block."""
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x))
    rng = np.random.RandomState(seed + 100)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if key.endswith("['bias']") and "Dense" not in key:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    params = jax.tree_util.tree_map_with_path(draw, var["params"])
    stats = {"mean": lambda a: (0.1 * rng.randn(*a.shape)),
             "var": lambda a: rng.uniform(0.5, 2.0, a.shape)}
    bstats = jax.tree_util.tree_map_with_path(
        lambda p, a: stats[p[-1].key](a).astype(np.float32),
        var["batch_stats"])
    return {"params": params, "batch_stats": bstats}


def _port(make, variables, train):
    tm = make()
    tm.load_state_dict(params_from_jax(tm, variables))
    return tm.train(train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name, train):
    jmake, tmake = MODELS[name]
    x = _images(0)
    jm = jmake()
    var = _variables(jm, x)
    if train:
        ref, _ = jm.apply(var, x, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(var, x, train=False)
    ref = np.asarray(ref)
    out = _port(tmake, var, train)(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (8, CLASSES)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_grads_match_jax(name):
    jmake, tmake = MODELS[name]
    x = _images(1)
    y = np.random.RandomState(2).randint(0, CLASSES, 8)
    jm = jmake()
    var = _variables(jm, x, seed=1)

    def loss_fn(p):
        logits, _ = jm.apply({"params": p, "batch_stats": var["batch_stats"]},
                             x, train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
    jgrads = jax.tree.map(np.asarray, jax.grad(loss_fn)(var["params"]))
    tm = _port(tmake, var, True)
    F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    want = params_from_jax(tm, {"params": jgrads,
                                "batch_stats": var["batch_stats"]})
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   rtol=0, atol=1e-4, err_msg=pname)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_batch_stats_after_train_step_match_jax(name):
    """flax moves the running variance by the biased batch variance; at
    32x32 the last BN normalizes over few values per channel, where the
    unbiased one is far off (checked below)."""
    jmake, tmake = MODELS[name]
    x = _images(3)
    jm = jmake()
    var = _variables(jm, x, seed=3)
    _, new = jm.apply(var, x, train=True, mutable=["batch_stats"])
    tm = _port(tmake, var, True)
    want = params_from_jax(tm, {
        "params": var["params"],
        "batch_stats": jax.tree.map(np.asarray, new["batch_stats"])})
    last = [k for k, _ in tm.named_buffers() if k.endswith("running_var")][-1]
    seen = []
    tm.get_submodule(last.rsplit(".", 1)[0]).register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape))
    tm(torch.from_numpy(x))
    got = dict(tm.named_buffers())
    assert set(got) == {k for k in want if ".running_" in k}
    for k, buf in got.items():
        np.testing.assert_allclose(buf.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    # The unbiased update would have missed by ten times the tolerance.
    start = params_from_jax(tm, var)[last].numpy()
    biased = (want[last].numpy() - 0.9 * start) / 0.1
    b, _, h, w = seen[0]
    unbiased = 0.9 * start + 0.1 * biased * (b * h * w) / (b * h * w - 1)
    assert np.abs(unbiased - want[last].numpy()).max() > 1e-4


@pytest.mark.parametrize("depth,params", [(18, 11689512), (34, 21797672),
                                          (50, 25557032), (101, 44549160),
                                          (152, 60192808)])
def test_counts_and_shapes_match_flax(depth, params):
    jm = getattr(jmodels, f"ResNet{depth}")()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    with torch.device("meta"):
        tm = getattr(tmodels, f"ResNet{depth}")()
    assert sum(p.numel() for p in tm.parameters()) == params
    n_stats = sum(int(np.prod(a.shape)) for a in
                  jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(b.numel() for b in tm.buffers()) == n_stats
    if depth == 50:
        assert n_stats == 53120
    for name, t in tm.state_dict().items():
        coll, path, dims = flax_leaf(tm, name)
        node = shapes[coll]
        for key in path:
            node = node[key]
        shape = tuple(t.shape) if dims is None else \
            tuple(t.shape[d] for d in dims)
        assert shape == tuple(node.shape), name


def test_ravel_order_is_jax_tree_order():
    """``jax_ravel_order`` lists the parameters in ``jax.tree_util``'s
    order (dict keys sorted: ``BottleneckBlock_10`` before
    ``BottleneckBlock_2``), and a flat row laid out by it equals the JAX
    package's ravel of the same weights."""
    from jax.flatten_util import ravel_pytree
    jm, tmake = MODELS["small-bottleneck"]
    x = _images(4)
    var = _variables(jm(), x, seed=4)
    want, _ = ravel_pytree(var["params"])
    rep = RankReplicas(tmake, 2, "cpu", order=jax_ravel_order(tmake()))
    rep.load_state_dict(params_from_jax(tmake(), var))
    np.testing.assert_array_equal(rep.flat[1].numpy(), np.asarray(want))
    with torch.device("meta"):
        names = [n for n, _ in jax_ravel_order(tmodels.ResNet50())]
    blocks = [n.split(".")[0] for n in names if n.startswith("Bottleneck")]
    assert blocks.index("BottleneckBlock_10") < blocks.index(
        "BottleneckBlock_2")
    assert names[-1] == "conv_init.weight"


def test_replicas_keep_buffers_rank_local():
    tm = MODELS["small-basic"][1]
    rep = RankReplicas(tm, 3, "cpu", order=jax_ravel_order(tm()),
                       init=lambda m: m.reset_parameters(
                           torch.Generator().manual_seed(0)))
    flat_ptr = rep.flat.untyped_storage().data_ptr()
    for r in range(3):
        for name, buf in rep.rank_buffers(r).items():
            assert buf.untyped_storage().data_ptr() != flat_ptr, name
    x = torch.from_numpy(_images(5, batch=3))
    for r in range(3):
        rep.modules[r](x[r:r + 1].expand(2, -1, -1, -1) + r)
    a, b = rep.rank_buffers(0), rep.rank_buffers(1)
    assert all(not torch.equal(a[k], b[k]) for k in a)
    # Conv kernels are stored HWIO in flat and seen OIHW by the module.
    w = rep.rank_params(0)["conv_init.weight"]
    assert w.shape == (8, 3, 7, 7) and w.permute(2, 3, 1, 0).is_contiguous()
    assert w.grad.shape == w.shape
