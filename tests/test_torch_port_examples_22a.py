"""The port's examples against the JAX package's, on the CPU.

Each port entry point (``bluefog_tpu_torch/<name>.py``) runs the JAX case
of ``tests/test_examples.py`` with the same arguments, and its output is
held to the JAX example's on the same inputs (numpy's generators, the same
seeds; the JAX examples run on the conftest's 8-device CPU mesh, the port
with ``--ranks 8`` on the CPU):

- average consensus, static and dynamic: every iteration's max consensus
  error and the final rows within 1e-6 (float32), the same iteration
  count, and lines printed at the same iterations;
- the decentralized optimization library and the resource allocation
  methods: the final iterates (or every sampled error) within 1e-6 of the
  JAX example's own functions run on the JAX package (EXTRA and exact
  diffusion on the dual: within 1e-6 to step 300, 5e-5 to the end, see
  the test); each below the JAX case's threshold;
- MoE training: every printed task and aux loss within 1e-4 (they print
  at 4 decimals: a printed pair differs by at most 1e-4 when the losses
  agree well within it), and the run's own progress check;
- ResNet training (lenet and vit) and MNIST LeNet: from the JAX example's
  initial weights (``models.convert``), the first 3 steps' per-rank
  losses within 1e-4 of the JAX example's protocol re-run on host arrays
  (the JAX CPU mesh gives other conv results on rank-sharded arrays, a
  Known difference), then the whole JAX case on the port with the JAX
  threshold; the checkpoint resume announces its epoch, skips the
  finished one, and the checkpoint holds the parameters bit for bit;
- ``benchmark --host-data``: the JAX case's arguments; the host-fed
  losses bit for bit those of the device-resident feed.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu import topology as jtopo

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--ranks", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are many small ops: with torch's default
    of a thread a core they spin against the other test workers' threads
    (a LeNet run took 80 times its time alone under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    """The JAX example module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(name, argv):
    """Run the JAX example as a script; its standard output."""
    mod = _jax_example(name)
    old = sys.argv
    sys.argv = [name] + list(argv)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
        jbf.shutdown()
    return buf.getvalue()


def _run_port(module, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = module.main(list(argv), **kw)
    return res, buf.getvalue()


def _lines(out):
    """The printed lines, less the port's trailing JSON line."""
    return [ln for ln in out.strip().splitlines() if not ln.startswith("{")]


# -- average consensus ----------------------------------------------------

@pytest.mark.parametrize("argv", [["--dim", "64", "--max-iters", "200"],
                                  ["--dim", "64", "--max-iters", "20",
                                   "--dynamic"]],
                         ids=["static", "dynamic"])
def test_average_consensus_equals_jax(monkeypatch, argv):
    """``test_average_consensus_static`` / ``_dynamic``: the same random
    rows (numpy's global generator, seeded), every iteration's error and
    the final rows within 1e-6, the same iteration count and output."""
    from bluefog_tpu_torch import average_consensus as ex
    traj = []
    for name in ("neighbor_allreduce", "dynamic_neighbor_allreduce"):
        fn = getattr(jbf, name)
        monkeypatch.setattr(jbf, name, lambda *a, _fn=fn, **k:
                            traj.append(np.asarray(_fn(*a, **k))) or
                            traj[-1])
    np.random.seed(5)
    want_out = _run_jax_main("average_consensus", argv)
    np.random.seed(5)
    res, got_out = _run_port(ex, argv + CPU)
    assert res["iterations"] == len(traj)
    np.random.seed(5)
    x0 = np.random.randn(8, 64).astype(np.float32)
    target = x0.mean(axis=0)
    want_err = [float(np.abs(x - target).max()) for x in traj]
    np.testing.assert_allclose(res["errors"], want_err, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["x"], traj[-1], rtol=0, atol=1e-6)
    # The same lines at the same iterations (the errors, near 1e-6 at the
    # end, print to 3 digits: held above at 1e-6 instead), and the same
    # closing line.
    got, want = _lines(got_out), _lines(want_out)
    assert [ln.split()[:2] for ln in got] == [ln.split()[:2] for ln in want]
    assert got[-1] == want[-1] and got[-1].startswith("consensus reached")


# -- decentralized optimization -------------------------------------------

@pytest.mark.parametrize("method,maxerr", [
    ("diffusion", 0.1),
    ("exact_diffusion", 1e-3),
    ("gradient_tracking", 1e-3),
    ("push_diging", 1e-3),
])
def test_decentralized_algorithms_equal_jax(devices, method, maxerr):
    """``test_decentralized_algorithms_reach_minimizer``: the final iterate
    within 1e-6 of the JAX example's own algorithm on the JAX package, at
    its default iteration count; the error below the JAX threshold."""
    from bluefog_tpu_torch import decentralized_optimization as ex
    jex = _jax_example("decentralized_optimization")
    jbf.init(devices=devices)
    try:
        n = jbf.size()
        A, y, _ = jex.make_problem(n)
        w_opt = jex.global_minimizer(A, y)
        jbf.set_topology(jtopo.RingGraph(n, connect_style=2)
                         if method == "push_diging"
                         else jtopo.ExponentialTwoGraph(n))
        want = jex.ALGORITHMS[method](jbf, A, y)
    finally:
        jbf.shutdown()
    want_err = np.linalg.norm(want - w_opt[None]) / np.linalg.norm(w_opt)
    res, out = _run_port(ex, ["--method", method] + CPU)
    np.testing.assert_allclose(res["x"][method], want, rtol=0, atol=1e-6)
    assert abs(res["errors"][method] - want_err) < 1e-6
    assert res["errors"][method] < maxerr, out


# -- resource allocation ---------------------------------------------------

@pytest.mark.parametrize("method,maxerr,iters", [
    ("admm", 1e-6, 300),
    ("extra", 5e-3, 2500),
    ("exact_diffusion", 5e-3, 2500),
    ("gradient_tracking", 5e-3, 2500),
])
def test_resource_allocation_methods_equal_jax(devices, method, maxerr,
                                               iters):
    """``test_resource_allocation_methods``: every sampled relative
    allocation error within 1e-6 of the JAX example's method on the JAX
    package over the same half-weight topology; the last below the JAX
    threshold."""
    from bluefog_tpu_torch import resource_allocation as ex
    jex = _jax_example("resource_allocation")
    jbf.init(devices=devices)
    try:
        n = jbf.size()
        G = jtopo.SymmetricExponentialGraph(n)
        W_half = (np.eye(n) + jtopo.weight_matrix(G)) / 2
        jbf.set_topology(jtopo.from_weight_matrix(W_half), is_weighted=True)
        A, b, Hinv, ATb = jex.make_problem(n)
        x_star, _ = jex.kkt_solution(Hinv, ATb)
        fn = jex.METHODS[method]
        want = (fn(jbf, A, b, Hinv, ATb, x_star, iters=iters)
                if method == "admm" else fn(jbf, Hinv, ATb, x_star,
                                            iters=iters))
    finally:
        jbf.shutdown()
    res, out = _run_port(ex, ["--method", method, "--iters", str(iters)]
                         + CPU)
    # EXTRA and exact diffusion carry ``2 y - y_prev`` (``psi + y -
    # psi_prev``) forward, which grows a last-bit difference in the
    # float32 combine: the JAX side's jitted combine contracts ``x * w +
    # recv`` into a fused multiply-add with the (I + W) / 2 weights, which
    # are not powers of two (a Known difference).  Within 1e-6 through
    # the sample at step 300, within 5e-5 to the end (2.94e-5 seen).
    tol = 5e-5 if method in ("extra", "exact_diffusion") else 1e-6
    np.testing.assert_allclose(res["errors"][:4], want[:4], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res["errors"], want, rtol=0, atol=tol)
    assert res["errors"][-1] < maxerr, out
    assert out.splitlines()[0] == (
        f"{method}: relative allocation error after {iters} iters = "
        f"{res['errors'][-1]:.3e}")


# -- MoE training ------------------------------------------------------------

_STEP = re.compile(r"step +(\d+)  task ([0-9.]+)  aux ([0-9.]+)")


@pytest.mark.parametrize("combine", ["neighbor", "allreduce"])
def test_moe_training_equals_jax(combine):
    """``test_moe_training_example``: 60 steps of ep 4 x dp 2; every printed
    task and aux loss within 1e-4 of the JAX example's, the router replica
    spread within 1e-4, and the run's progress check passed."""
    from bluefog_tpu_torch import moe_training as ex
    argv = ["--steps", "60", "--combine", combine]
    want_out = _run_jax_main("moe_training", argv)
    res, got_out = _run_port(ex, argv + CPU)
    want = [tuple(map(float, m.groups())) for m in _STEP.finditer(want_out)]
    got = [tuple(map(float, m.groups())) for m in _STEP.finditer(got_out)]
    assert [w[0] for w in want] == [g[0] for g in got] == [0, 25, 50, 59]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-4 + 1e-9)
    spread = [float(re.search(r"spread ([0-9.]+)", o).group(1))
              for o in (want_out, got_out)]
    assert abs(spread[0] - spread[1]) <= 1e-4 + 1e-9
    assert "MOE-TRAINING-OK" in got_out and "MOE-TRAINING-OK" in want_out
    assert res["last"] < res["first"]


# -- ResNet training ----------------------------------------------------------

RESNET_ARGV = {
    "lenet": ["--model", "lenet", "--image-size", "28",
              "--samples-per-rank", "256", "--batch-size", "16",
              "--epochs", "5", "--base-lr", "0.005"],
    "vit": ["--model", "vit", "--image-size", "32",
            "--samples-per-rank", "256", "--batch-size", "16",
            "--epochs", "5", "--base-lr", "0.01"],
}


def _jax_resnet_reference(argv, steps=3):
    """The JAX example's protocol for ``steps`` updates on host arrays:
    its model, data, schedule and optimizer; returns the flax variables it
    started from and each step's per-rank losses."""
    jex = _jax_example("resnet_training")
    from bluefog_tpu import models
    from bluefog_tpu.optim import CommunicationType
    args = jex.build_parser().parse_args(argv)
    jbf.init()
    try:
        n = jbf.size()
        if args.model == "lenet":
            model = models.LeNet5(num_classes=args.num_classes)
        else:
            patch = next(p for p in range(max(2, args.image_size // 4), 0,
                                          -1) if args.image_size % p == 0)
            model = models.ViT(num_classes=args.num_classes,
                               image_size=args.image_size, patch_size=patch,
                               embed_dim=64, num_layers=4, num_heads=4,
                               dtype=jnp.float32)
        x_train, y_train = jex.make_dataset(n, args.samples_per_rank,
                                            args.image_size,
                                            args.num_classes, args.seed)
        variables = model.init(jax.random.PRNGKey(args.seed),
                               jnp.asarray(x_train[0][:2]))
        params = jax.tree.map(
            lambda a: np.broadcast_to(np.asarray(a)[None],
                                      (n,) + a.shape).copy(),
            variables["params"])
        bpe = args.samples_per_rank // args.batch_size
        opt = jbf.optim.DistributedAdaptWithCombineOptimizer(
            optax.sgd(jex.lr_schedule(args, n, bpe), momentum=args.momentum),
            CommunicationType.neighbor_allreduce, use_dynamic_topology=True)
        state = opt.init(params)

        def loss_fn(p, xb, yb):
            logits = model.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, yb).mean()
        vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn)))
        order = np.random.RandomState(args.seed).permutation(
            args.samples_per_rank)
        losses = []
        for b in range(steps):
            idx = order[b * args.batch_size:(b + 1) * args.batch_size]
            loss, grads = vgrad(params, x_train[:, idx], y_train[:, idx])
            params, state = opt.step(params, jax.device_get(grads), state)
            params = jax.device_get(params)
            losses.append(np.asarray(loss))
        return jax.device_get(variables), np.stack(losses)
    finally:
        jbf.shutdown()


@pytest.mark.parametrize("model", ["lenet", "vit"])
def test_resnet_training_converges_and_equals_jax(model):
    """``test_resnet_training_example_converges``: from the JAX example's
    initial weights the first 3 steps' per-rank losses within 1e-4 of the
    JAX protocol; the whole case ends above the JAX threshold (0.9)."""
    from bluefog_tpu_torch import resnet_training as ex
    argv = RESNET_ARGV[model]
    variables, want = _jax_resnet_reference(argv)
    res, out = _run_port(ex, argv + CPU, variables=variables)
    np.testing.assert_allclose(res["step_losses"][:3], want, rtol=0,
                               atol=1e-4)
    assert len(res["epoch_losses"]) == 5
    assert res["epoch_losses"][-1] < res["epoch_losses"][0]
    acc = float(_lines(out)[-1].split()[-1])
    assert acc == pytest.approx(res["val_acc"], abs=5e-4)
    assert acc > 0.9, out


def test_resnet_training_checkpoint_resume(tmp_path):
    """``test_resnet_training_checkpoint_resume``: one epoch, then a run
    to 3 epochs from the same checkpoint directory announces the resume,
    does not retrain epoch 0 and does not end worse; the checkpoint (DCP)
    holds the first run's final parameters bit for bit."""
    from bluefog_tpu_torch import resnet_training as ex
    from bluefog_tpu_torch.utils import checkpoint
    argv = ["--model", "lenet", "--image-size", "28",
            "--samples-per-rank", "128", "--batch-size", "16",
            "--base-lr", "0.005"] + CPU
    ck = str(tmp_path / "ck")
    first, out1 = _run_port(ex, argv + ["--checkpoint-dir", ck,
                                        "--epochs", "1"])
    saved = checkpoint.restore_host(ck, step=0, as_tensors=True)
    assert torch.equal(saved["params"], first["params"])
    assert int(saved["count"]) == 8 and int(saved["epoch"]) == 0
    back, out = _run_port(ex, argv + ["--checkpoint-dir", ck,
                                      "--epochs", "3"])
    assert "resumed from epoch 0" in out, out
    assert "epoch 0:" not in out
    assert back["start_epoch"] == 1 and len(back["epoch_losses"]) == 2
    assert back["val_acc"] >= first["val_acc"], (out1, out)


# -- MNIST LeNet -------------------------------------------------------------

def _jax_mnist_reference(argv, steps=3):
    """The JAX example's loop for ``steps`` updates on host arrays: its
    synthetic MNIST through the JAX ``ShardedLoader``, LeNet-5 from
    ``PRNGKey(0)``, Adam under neighbor averaging; returns the initial
    flax variables and each step's per-rank losses."""
    jex = _jax_example("mnist_lenet")
    from bluefog_tpu.models import LeNet5
    from bluefog_tpu.optim import CommunicationType
    args = dict(zip(argv[::2], argv[1::2]))
    per_rank, batch = int(args["--per-rank-samples"]), int(
        args["--batch-size"])
    jbf.init()
    try:
        n = jbf.size()
        xs, ys = jex.synthetic_mnist(n, per_rank)
        model = LeNet5()
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 28, 28, 1)))
        params = jax.tree.map(
            lambda a: np.broadcast_to(np.asarray(a)[None],
                                      (n,) + a.shape).copy(), variables)
        opt = jbf.optim.DistributedAdaptWithCombineOptimizer(
            optax.adam(1e-3), CommunicationType("neighbor.allreduce"))
        state = opt.init(params)

        def loss_fn(p, x, y):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(p, x), y).mean()
        vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn)))
        loader = jbf.data.ShardedLoader(
            {"x": xs.reshape(-1, 28, 28, 1), "y": ys.reshape(-1)},
            batch_size=batch, seed=1, static_shards=True)
        loader.set_epoch(0)
        losses = []
        for i, b in enumerate(loader):
            if i == steps:
                break
            loss, grads = vgrad(params, np.asarray(b["x"]),
                                np.asarray(b["y"]))
            params, state = opt.step(params, jax.device_get(grads), state)
            params = jax.device_get(params)
            losses.append(np.asarray(loss))
        return jax.device_get(variables), np.stack(losses)
    finally:
        jbf.shutdown()


def test_mnist_lenet_short_equals_jax():
    """``test_mnist_lenet_short``: from the JAX example's initial weights
    the first 3 steps' per-rank losses within 1e-4 of the JAX loop; the
    whole case (6 epochs) ends above the JAX threshold (0.9), each epoch's
    held-out accuracy printed as the JAX example prints it."""
    from bluefog_tpu_torch import mnist_lenet as ex
    argv = ["--epochs", "6", "--per-rank-samples", "256",
            "--batch-size", "64"]
    variables, want = _jax_mnist_reference(argv)
    res, out = _run_port(ex, argv + CPU, variables=variables["params"])
    np.testing.assert_allclose(res["losses"][:3], want, rtol=0, atol=1e-4)
    lines = _lines(out)
    assert [ln.split()[:2] for ln in lines[:6]] == [
        ["epoch", str(e)] for e in range(6)]
    assert res["accuracy"][-1] > 0.9, out
    assert lines[-1].startswith("final accuracy")


# -- benchmark --host-data ------------------------------------------------------

def test_benchmark_host_data_feed():
    """``test_benchmark_host_data_feed``: the JAX case's arguments; the
    batches come from host memory through ``data.prefetch_to_device``
    (depth 2), and every step's losses are bit for bit the device-resident
    feed's (the same batch either way)."""
    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch import benchmark as ex
    argv = ["--model", "lenet", "--batch-size", "4",
            "--num-warmup-batches", "1", "--num-iters", "2",
            "--num-batches-per-iter", "1"] + CPU
    try:
        host, _ = _run_port(ex, argv + ["--host-data"])
        tbf.shutdown()      # the benchmark leaves its context up
        dev, _ = _run_port(ex, argv)
    finally:
        tbf.shutdown()
    assert host["host_data"] and not dev["host_data"]
    assert host["steps"] == dev["steps"] == 3
    assert np.isfinite(host["losses_by_step"]).all()
    assert host["losses_by_step"] == dev["losses_by_step"]
