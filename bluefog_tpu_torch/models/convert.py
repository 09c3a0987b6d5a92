"""Carry TransformerLM weights from the JAX package's flax tree to the port.

The input is the flax ``params`` tree with numpy leaves (no JAX import
here); the output is a ``state_dict`` for
``bluefog_tpu_torch.models.transformer.TransformerLM``.  A flax ``Dense``
kernel is ``(in, out)``, so ``Linear.weight`` is its transpose; ``Embed``
tables and ``RMSNorm`` scales copy as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["transformer_params_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def transformer_params_from_jax(params: Mapping) -> dict:
    """``state_dict`` of the port's ``TransformerLM`` from a flax params
    tree (``variables["params"]``) of numpy arrays."""
    if "params" in params:
        params = params["params"]
    sd = {"wte.weight": _t(params["wte"]["embedding"]),
          "wpe.weight": _t(params["wpe"]["embedding"]),
          "RMSNorm_0.scale": _t(params["RMSNorm_0"]["scale"]),
          "lm_head.weight": _t(params["lm_head"]["kernel"]).T.contiguous()}
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        extra = set(blk) - {"RMSNorm_0", "RMSNorm_1", "qkv", "proj", "up",
                            "down"}
        if extra:
            raise NotImplementedError(
                f"block_{i} holds {sorted(extra)}: only the MHA + GELU block "
                "is ported")
        pre = f"blocks.{i}."
        sd[pre + "RMSNorm_0.scale"] = _t(blk["RMSNorm_0"]["scale"])
        sd[pre + "RMSNorm_1.scale"] = _t(blk["RMSNorm_1"]["scale"])
        for name in ("qkv", "proj", "up", "down"):
            sd[pre + name + ".weight"] = _t(blk[name]["kernel"]).T.contiguous()
        i += 1
    return sd
