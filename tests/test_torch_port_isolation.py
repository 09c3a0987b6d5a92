"""The port imports neither JAX nor the JAX package, and its entry points
default to CUDA: without a GPU they raise unless the CPU is asked for."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "bluefog_tpu_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, bluefog_tpu_torch, bluefog_tpu_torch.benchmark, "
            "bluefog_tpu_torch.bench, bluefog_tpu_torch.profile_step, "
            "bluefog_tpu_torch.optim, bluefog_tpu_torch.models, "
            "bluefog_tpu_torch.models.convert, bluefog_tpu_torch.replicas, "
            "bluefog_tpu_torch.parallel.moe, bluefog_tpu_torch.ops.collective, "
            "bluefog_tpu_torch.ops.schedule_opt, bluefog_tpu_torch.ops.p2p, "
            "bluefog_tpu_torch.parallel.ring_attention, "
            "bluefog_tpu_torch.parallel.ulysses, "
            "bluefog_tpu_torch.long_context_training, "
            "bluefog_tpu_torch.parallel.tensor_parallel, "
            "bluefog_tpu_torch.parallel.pipeline, "
            "bluefog_tpu_torch.parallel.composed, "
            "bluefog_tpu_torch.tensor_parallel_training, "
            "bluefog_tpu_torch.pipeline_training, "
            "bluefog_tpu_torch.ops.window, bluefog_tpu_torch.utils.config, "
            "bluefog_tpu_torch.optim.window_optimizers, "
            "bluefog_tpu_torch.ops.transport, bluefog_tpu_torch.native, "
            "bluefog_tpu_torch.average_consensus, "
            "bluefog_tpu_torch.decentralized_optimization, "
            "bluefog_tpu_torch.resource_allocation, "
            "bluefog_tpu_torch.moe_training, "
            "bluefog_tpu_torch.resnet_training, "
            "bluefog_tpu_torch.mnist_lenet, bluefog_tpu_torch.tools, "
            "bluefog_tpu_torch.tools.tracegossip, "
            "bluefog_tpu_torch.tools.metrics_lint, "
            "bluefog_tpu_torch.tools.chaos, bluefog_tpu_torch.tools.top, "
            "bluefog_tpu_torch.run.run, bluefog_tpu_torch.bench_comm, "
            "bluefog_tpu_torch.window_benchmark, "
            "bluefog_tpu_torch.run.interactive, "
            "bluefog_tpu_torch.run.cluster_repl, bluefog_tpu_torch.version;"
            "from bluefog_tpu_torch.run import cluster_repl;"
            "cluster_repl.bfstat_text();"
            "bf = bluefog_tpu_torch; bf.pipeline_train_step, bf.moe_apply, "
            "bf.tp_shard_params, bf.parallel.pipeline_apply;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'bluefog_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    mods = _IMPORT.findall(path.read_text())
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                  "optax", "bluefog_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_init_defaults_to_cuda():
    from bluefog_tpu_torch import basics
    try:
        if torch.cuda.is_available():
            basics.init(4)
            assert basics.device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no GPU"):
                basics.init(4)
            assert not basics.initialized()
        basics.init(4, device="cpu")
        assert basics.device() == torch.device("cpu") and basics.size() == 4
    finally:
        basics.shutdown()


def test_init_distributed_nccl_needs_a_gpu(monkeypatch):
    """The multi-process entry point defaults to CUDA and NCCL too: without
    a GPU it raises, whatever the launcher set, and never falls back to
    gloo on the CPU."""
    from bluefog_tpu_torch import basics
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setenv("BFTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("BFTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("BFTPU_PROCESS_ID", "0")
    for kw in ({}, {"backend": "nccl"}, {"backend": "nccl", "device": "cpu"}):
        with pytest.raises(RuntimeError, match="GPU"):
            basics.init_distributed(**kw)
        assert not basics.initialized()


def test_cuda_wrappers_refuse_cpu_tensors():
    from bluefog_tpu_torch.ops import flash_attention as FA
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd_cuda(q, q, q)
    assert FA.flash_fwd_cuda.launches == 0


def test_window_and_hierarchical_entry_points_default_to_cuda():
    """The windows follow ``bf.device()``, CUDA unless the CPU was asked
    for; a CPU tensor is refused when the windows live on the card."""
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch.ops import window
    if torch.cuda.is_available():
        basics.init(4, local_size=2)
        try:
            assert basics.device().type == "cuda"
            with pytest.raises(ValueError, match="windows live on cuda"):
                window.win_create(torch.zeros(4, 2), "w")
        finally:
            basics.shutdown()
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            basics.init(4, local_size=2)
    assert not basics.initialized()


@pytest.mark.parametrize("module", ["long_context_training",
                                    "tensor_parallel_training",
                                    "pipeline_training"])
def test_entry_points_default_to_cuda(module):
    """Without ``--device cpu`` an entry point runs on CUDA: without a GPU
    it raises before any work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    main = importlib.import_module(f"bluefog_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--steps", "2"])


@pytest.mark.parametrize("module", ["average_consensus",
                                    "decentralized_optimization",
                                    "resource_allocation", "moe_training",
                                    "resnet_training", "mnist_lenet"])
def test_example_entry_points_default_to_cuda(module):
    """The examples of item 22a run on CUDA unless ``--device cpu`` is
    given: without a GPU they raise before any work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    main = importlib.import_module(f"bluefog_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="no GPU"):
        main([])


@pytest.mark.parametrize("module,argv", [
    ("bench_comm", ["--smoke"]),
    ("window_benchmark", ["--elements", "16", "--rounds", "1"])])
def test_bench_rigs_default_to_cuda(module, argv):
    """The bench rigs (item 22d) run on CUDA unless ``--device cpu`` is
    given: without a GPU they raise before any work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    main = importlib.import_module(f"bluefog_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="no GPU"):
        main(argv)


def test_interactive_modules_are_in_the_source_scan():
    """The interactive cluster's modules and the notebooks' sources are
    held to the no-jax rule too."""
    paths = set(_port_sources())
    for rel in ("run/interactive.py", "run/cluster_repl.py", "version.py"):
        assert PORT / rel in paths
    for nb in sorted((PORT / "notebooks").glob("*.ipynb")):
        import json
        src = "\n".join("".join(c["source"]) for c in
                        json.loads(nb.read_text())["cells"]
                        if c["cell_type"] == "code")
        bad = [m for m in _IMPORT.findall(src) if m.split(".")[0] in
               ("jax", "jaxlib", "flax", "optax", "bluefog_tpu")]
        assert not bad, f"{nb.name} imports {bad}"


def test_interactive_launcher_starts_without_torch():
    """``ibfrun``'s launcher imports no torch (its children do), as bfrun."""
    code = ("import sys, bluefog_tpu_torch.run.interactive;"
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
