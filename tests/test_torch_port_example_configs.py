"""``long_context_training`` and ``tensor_parallel_training`` build the JAX
examples' own models whatever the device: the configuration for ``cuda``
is the one for ``cpu``, field for field the ``TransformerConfig`` that
``examples/long_context_training.py`` and
``examples/tensor_parallel_training.py`` build (width 128, 8 heads of 16,
float32).  No GPU is needed: only the configuration is built."""

import jax.numpy as jnp
import pytest
import torch

from bluefog_tpu import models as JM
from bluefog_tpu_torch import long_context_training as LC
from bluefog_tpu_torch import tensor_parallel_training as TPT
from bluefog_tpu_torch.ops import flash_attention as FA

FIELDS = ("vocab_size", "num_layers", "num_heads", "embed_dim", "mlp_ratio",
          "max_seq_len", "remat", "causal", "num_experts", "num_kv_heads",
          "pos_encoding", "mlp")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same(port, jax_cfg):
    for f in FIELDS:
        assert getattr(port, f) == getattr(jax_cfg, f), f
    assert port.dtype == DTYPES[jax_cfg.dtype]


@pytest.mark.parametrize("rope", [False, True])
def test_long_context_config_is_the_jax_examples_on_every_device(rope):
    extra = ["--rope"] if rope else []
    cfgs = [LC.model_config(LC.build_parser().parse_args(
        ["--device", dev, *extra])) for dev in ("cpu", "cuda")]
    # examples/long_context_training.py at its defaults (--seq-len 4096,
    # --vocab 256).
    want = JM.TransformerConfig(
        vocab_size=256, num_layers=2, num_heads=8, embed_dim=128,
        max_seq_len=4096, dtype=jnp.float32,
        pos_encoding="rope" if rope else "learned")
    for cfg in cfgs:
        _same(cfg, want)
    D = cfgs[0].embed_dim // cfgs[0].num_heads
    assert D == 16 and FA.instance(cfgs[0].dtype, D) == 16


def test_tensor_parallel_config_is_the_jax_examples_on_every_device():
    cfgs = [TPT.model_config(TPT.build_parser().parse_args(["--device", dev]))
            for dev in ("cpu", "cuda")]
    # examples/tensor_parallel_training.py at its default --seq-len 64.
    want = JM.TransformerConfig(
        vocab_size=256, num_layers=2, num_heads=8, embed_dim=128,
        max_seq_len=64, dtype=jnp.float32, mlp="swiglu")
    for cfg in cfgs:
        _same(cfg, want)
