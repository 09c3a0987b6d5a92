"""Parallelism of the port beyond the decentralized data-parallel axis.

* ``ring_attention`` and ``ulysses``: sequence parallelism, exact attention
  over sequence shards (K/V rotating on a ring, or all-to-all to head
  shards).
* ``tensor_parallel``: Megatron tensor parallelism of the LM
  (``tp_param_specs``, ``tp_shard_params``, ``TensorParallelLM``).
* ``pipeline``: GPipe (``pipeline_apply``), 1F1B (``pipeline_train_step``),
  interleaved 1F1B and ZB-H1 (``pipeline_train_step_interleaved``).
* ``moe``: the switch-routed mixture of experts and expert parallelism
  (``switch_dispatch``, ``load_balance_loss``, ``moe_apply``).
* ``composed``: dp x tp x pp (x ep) in one step.

Each axis is an ``int`` (rank-major: every shard in this process) or an
``ops.p2p.ProcessRanks`` (the shards on the world's ranks).  The names of
the JAX package's ``parallel/__init__.py`` L23-28 are exported here,
imported when first read: ``models.transformer`` imports ``parallel.moe``,
and ``tensor_parallel`` imports ``models.transformer``.
"""

import importlib

_EXPORTS = {
    "tp_param_specs": "tensor_parallel", "tp_shard_params": "tensor_parallel",
    "pipeline_apply": "pipeline", "pipeline_train_step": "pipeline",
    "pipeline_train_step_interleaved": "pipeline",
    "load_balance_loss": "moe", "moe_apply": "moe", "switch_dispatch": "moe",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
