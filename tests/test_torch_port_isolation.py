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
            "bluefog_tpu_torch.optim, bluefog_tpu_torch.models.convert, "
            "bluefog_tpu_torch.replicas;"
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


def test_cuda_wrappers_refuse_cpu_tensors():
    from bluefog_tpu_torch.ops import flash_attention as FA
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd_cuda(q, q, q)
    assert FA.flash_fwd_cuda.launches == 0
