"""The port's VGG, LeNet, MLP, linear models and ViT against the JAX
package's flax models, with the weights carried by ``models.convert``; the
vision entry points (``benchmark --model``, ``bench``) on the CPU.

Float32.  VGG, LeNet, MLP and the linear models agree at 1e-5 (relative to
the largest logit); a 2-layer ViT at 1e-4 with dense attention, and with
the port's flash path (its plain twin on the CPU) against the JAX package's
flash kernels in interpret mode at 2e-5 in the logits and 1e-4 in the
gradients, as ``test_torch_port_flash.py`` holds the attention itself.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import bluefog_tpu_torch as tbf
from bluefog_tpu import models as jmodels
from bluefog_tpu.ops.flash_attention import flash_attention_impl as j_flash
from bluefog_tpu_torch import bench, benchmark
from bluefog_tpu_torch import models as tmodels
from bluefog_tpu_torch.models.convert import flax_leaf, params_from_jax
from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

CLASSES = 10
VGG_CFG = (8, "M", 16, 16, "M")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _vit(pkg, attn=None):
    kw = dict(num_classes=CLASSES, image_size=32, patch_size=8, embed_dim=32,
              num_layers=2, num_heads=2)
    if pkg == "jax":
        return jmodels.ViT(dtype=jnp.float32, attn_impl=attn, **kw)
    return tmodels.ViT(dtype=torch.float32, attn_impl=attn, **kw)


# name: (flax model, port model, input shape)
MODELS = {
    "vgg": (lambda: jmodels.VGG(VGG_CFG, num_classes=CLASSES, hidden=32,
                                dtype=jnp.float32),
            lambda: tmodels.VGG(VGG_CFG, num_classes=CLASSES, hidden=32,
                                dtype=torch.float32, image_size=16),
            (2, 16, 16, 3)),
    "lenet": (lambda: jmodels.LeNet5(), lambda: tmodels.LeNet5(),
              (2, 28, 28, 1)),
    "mlp": (lambda: jmodels.MLP(features=(32, 16), num_classes=CLASSES),
            lambda: tmodels.MLP(64, features=(32, 16), num_classes=CLASSES),
            (2, 8, 8, 1)),
    "logistic": (lambda: jmodels.LogisticRegression(num_classes=3),
                 lambda: tmodels.LogisticRegression(12, num_classes=3),
                 (4, 3, 4)),
    "linear": (lambda: jmodels.LinearModel(out_features=2),
               lambda: tmodels.LinearModel(5, out_features=2), (4, 5)),
}


def _carry(jm, tm, x, seed=0):
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x))
    # Nonzero biases, so that their layout is tested too.
    rng = np.random.RandomState(seed + 1)
    var = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['bias']") else a, var)
    tm.load_state_dict(params_from_jax(tm, var))
    return var


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_jax(name):
    jmake, tmake, shape = MODELS[name]
    x = _x(shape)
    jm, tm = jmake(), tmake()
    var = _carry(jm, tm, x)
    ref = np.asarray(jm.apply(var, x))
    out = tm(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_lenet_flattens_nhwc():
    """The first Dense's rows are flax's (H, W, C) order: a kernel that reads
    a single (h, w, c) position sees the same activation in both."""
    x = _x((2, 28, 28, 1), seed=1)
    jm, tm = jmodels.LeNet5(), tmodels.LeNet5()
    var = _carry(jm, tm, x)
    kernel = np.zeros_like(var["params"]["Dense_0"]["kernel"])
    kernel[(2 * 5 + 3) * 16 + 7, 0] = 1.0      # h=2, w=3, c=7
    var["params"]["Dense_0"]["kernel"] = kernel
    tm.load_state_dict(params_from_jax(tm, var))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(var, x)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_vit_logits_and_grads_match_jax(attn):
    x = _x((2, 32, 32, 3), seed=2)
    y = np.random.RandomState(3).randint(0, CLASSES, 2)
    jm = _vit("jax", j_flash() if attn == "flash" else None)
    tm = _vit("torch", flash_attention_impl() if attn == "flash" else None)
    var = _carry(jm, tm, x)
    var["params"]["cls_token"] = _x((1, 1, 32), seed=4)  # not zeros
    tm.load_state_dict(params_from_jax(tm, var))
    ref = np.asarray(jm.apply(var, x))
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=(2e-5 if attn == "flash" else 1e-4))

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jm.apply({"params": p}, x), y).mean()
    want = params_from_jax(tm, jax.tree.map(
        np.asarray, jax.grad(loss_fn)(var["params"])))
    F.cross_entropy(out, torch.from_numpy(y)).backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_vit_refuses_images_not_divisible_by_the_patch():
    tm = _vit("torch")
    with pytest.raises(ValueError, match="not divisible by patch size 8"):
        tm(torch.zeros(1, 30, 32, 3))


@pytest.mark.parametrize("name,params,shape", [
    ("VGG16", 138357544, (1, 224, 224, 3)),
    ("ViT", 21999592, (1, 224, 224, 3)),
    ("LeNet5", 61706, (1, 28, 28, 1))])
def test_counts_and_shapes_match_flax(name, params, shape):
    """Full-size models (VGG-16, ViT-S/16, LeNet-5): parameter counts, and
    every leaf's shape equal to the flax tree's (``jax.eval_shape``)."""
    jm = getattr(jmodels, name)()
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    with torch.device("meta"):
        tm = getattr(tmodels, name)()
    assert sum(p.numel() for p in tm.parameters()) == params
    assert sum(int(np.prod(a.shape)) for a in
               jax.tree_util.tree_leaves(tree)) == params
    for pname, t in tm.state_dict().items():
        coll, path, dims = flax_leaf(tm, pname)
        node = tree[coll]
        for key in path:
            node = node[key]
        got = tuple(t.shape) if dims is None else \
            tuple(t.shape[d] for d in dims)
        assert got == tuple(node.shape), pname


@pytest.mark.parametrize("model,extra", [
    ("resnet18", ["--image-size", "32", "--compression", "sparse:0.25"]),
    ("vgg11", ["--image-size", "32", "--compression", "bf16"]),
    ("lenet", ["--dist-optimizer", "allreduce"]),
    ("vit", ["--image-size", "32", "--flash-attention",
             "--dist-optimizer", "empty"])])
def test_benchmark_main_runs_image_models_on_cpu(capsys, model, extra):
    try:
        benchmark.main(["--device", "cpu", "--model", model, "--atc",
                        "--dynamic", "--batch-size", "2", "--ranks", "2",
                        "--num-warmup-batches", "1", "--num-iters", "1",
                        "--num-batches-per-iter", "1"] + extra)
    finally:
        tbf.shutdown()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["model"] == model and res["steps"] == 2
    assert res["imgs_per_s"] > 0 and all(np.isfinite(res["losses"]))
    spread = res["spread"]
    if "empty" in extra:
        assert spread["rms_after_combine"] == spread["rms_after_adapt"]
    else:
        assert spread["rms_after_combine"] < spread["rms_after_adapt"]


def test_bench_main_prints_bench_keys_on_cpu(capsys):
    try:
        bench.main(["--device", "cpu", "--ranks", "2"])
    finally:
        tbf.shutdown()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["metric"] == "resnet50_train_imgs_per_sec_per_chip"
    assert res["unit"] == "img/s/chip" and res["value"] > 0
    assert res["vs_baseline"] == pytest.approx(
        res["value"] / (4310.6 / 16), abs=1e-3)
    assert {"total_imgs_per_sec", "n_devices", "ranks", "per_device_batch",
            "image_size", "backend", "stddev_pct", "optimizer",
            "compression"} <= set(res["detail"])
    assert res["detail"]["backend"] == "cpu"
    assert res["detail"]["n_devices"] == 1 and res["detail"]["ranks"] == 2
    # Asked for the CPU: a labeled smoke run, with the registry's snapshot
    # and the bench's own phase histogram.
    assert res["detail"]["cpu_fallback"] is True
    assert res["detail"]["telemetry"][
        'bf_comm_calls_total{op="dynamic_neighbor_allreduce"}'] > 0
    assert set(res["detail"]["phase_latency"]) == {"optimizer-update",
                                                   "host-sync"}


@pytest.mark.parametrize("entry", ["benchmark", "bench"])
def test_entry_points_default_to_cuda(entry, capsys, monkeypatch):
    """Without a GPU the default device raises in the benchmark; the bench
    prints the root ``bench.py``'s ``no_backend`` line and exits 3 (unless
    ``BLUEFOG_TPU_BENCH_ALLOW_CPU=1`` asks for a CPU smoke run)."""
    main = {"benchmark": benchmark.main, "bench": bench.main}[entry]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.delenv("BLUEFOG_TPU_BENCH_ALLOW_CPU", raising=False)
    try:
        if entry == "benchmark":
            with pytest.raises(RuntimeError, match="no GPU"):
                main(["--ranks", "2"])
            return
        with pytest.raises(SystemExit) as exc:
            main(["--ranks", "2"])
        assert exc.value.code == 3
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["status"] == "no_backend" and line["value"] is None
    finally:
        tbf.shutdown()
