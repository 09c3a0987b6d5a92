"""Carry weights from the JAX package's flax trees to the port's models.

The input is a flax variables tree with numpy leaves (no JAX import here);
the output is a ``state_dict``.  A flax conv kernel is ``(kh, kw, in, out)``
(HWIO), the port's ``(out, in, kh, kw)``; a flax ``Dense`` kernel is
``(in, out)``, ``nn.Linear.weight`` its transpose; BN ``scale``/``bias`` are
``weight``/``bias`` and its ``batch_stats`` ``mean``/``var`` the buffers
``running_mean``/``running_var``.  Module names are the flax tree's.

``jax_ravel_order`` gives the order, and the layout, in which the JAX
package ravels a model's parameters into one buffer: ``jax.tree_util``
flattens dicts by sorted key (``BottleneckBlock_10`` before
``BottleneckBlock_2``) and each leaf in its own layout.  ``RankReplicas``
takes it as ``order``, so that a column of the port's flat buffer is the same
coordinate as in the JAX package's (the rotating block of
``compression="sparse:<frac>"`` depends on it).  ``jax_leaf_specs`` takes a
JAX spec tree (``tp_param_specs``' form, keyed by the flax paths) onto the
same order, for sharded gossip's ``shard_specs``.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bluefog_tpu_torch.models.layers import BatchNorm, Conv
from bluefog_tpu_torch.models.transformer import RMSNorm, SwitchMlp

__all__ = ["transformer_params_from_jax", "params_from_jax",
           "jax_ravel_order", "jax_leaf_specs", "flax_leaf",
           "stacked_block_params_from_jax",
           "tensor_parallel_params_from_jax", "window_state_from_jax",
           "window_state_to_jax"]

# A torch tensor's dims permuted by these is the flax leaf's layout.
_HWIO = (2, 3, 1, 0)
_IN_OUT = (1, 0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_leaf(model: nn.Module, name: str
              ) -> Tuple[str, Tuple[str, ...], Optional[Tuple[int, ...]]]:
    """``(collection, path, dims)`` of the flax leaf behind the port's
    parameter or buffer ``name``: ``collection`` is ``"params"`` or
    ``"batch_stats"``, ``path`` the keys in that tree, and ``dims`` the
    permutation that takes the torch tensor to the flax layout (None: the
    same layout)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    parts = owner_name.split(".") if owner_name else []
    path: List[str] = []
    for i, p in enumerate(parts):   # TransformerLM's blocks.{i} is block_{i}
        if p.isdigit() and i and parts[i - 1] == "blocks":
            path[-1] = f"block_{p}"
        else:
            path.append(p)
    coll, dims = "params", None
    if isinstance(owner, Conv) and leaf == "weight":
        leaf, dims = "kernel", _HWIO
    elif isinstance(owner, nn.Linear) and leaf == "weight":
        leaf, dims = "kernel", _IN_OUT
    elif isinstance(owner, BatchNorm):
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}[leaf]
    elif isinstance(owner, nn.Embedding):
        leaf = "embedding"
    elif not isinstance(owner, (Conv, nn.Linear, RMSNorm, SwitchMlp)) \
            and owner_name:
        raise ValueError(f"no flax counterpart for {name} "
                         f"({type(owner).__name__})")
    return coll, tuple(path) + (leaf,), dims


def jax_ravel_order(model: nn.Module) -> list:
    """``[(name, dims), ...]``: the model's parameters in the order the JAX
    package ravels them, each with the permutation of its dims that gives
    the flax layout.  Works on a model on the meta device."""
    leaves = []
    for name, _ in model.named_parameters():
        _, path, dims = flax_leaf(model, name)
        leaves.append((path, name, dims))
    return [(name, dims) for _, name, dims in sorted(leaves)]


def jax_leaf_specs(model: nn.Module, specs: Mapping,
                   names: Optional[List[str]] = None) -> list:
    """The JAX package's spec tree ``specs`` (nested dicts keyed by the
    flax paths; a leaf is ``None``, ``P()`` or a tuple of axis names, one a
    model dim of the flax layout) as a list, one spec a parameter of
    ``model`` in the order ``names`` (``RankReplicas.names``; default
    :func:`jax_ravel_order`'s).  A path the tree stops short of (a
    ``None`` subtree) is replicated.  Works on a model on the meta
    device."""
    if names is None:
        names = [name for name, _ in jax_ravel_order(model)]
    if "params" in specs:
        specs = specs["params"]
    out = []
    for name in names:
        _, path, _ = flax_leaf(model, name)
        node = specs
        for key in path:
            if not isinstance(node, Mapping):
                break
            node = node[key]
        out.append(None if isinstance(node, Mapping) else node)
    return out


def params_from_jax(model: nn.Module, variables: Mapping) -> dict:
    """``state_dict`` of ``model`` (parameters and buffers) from flax
    ``variables`` (``{"params": ..., "batch_stats": ...}``, or the params
    tree alone for a model without BN) of numpy arrays."""
    if "params" not in variables:
        variables = {"params": variables}
    sd = {}
    for name in model.state_dict():
        coll, path, dims = flax_leaf(model, name)
        node = variables[coll]
        for key in path:
            node = node[key]
        a = _t(node)
        if dims is not None:
            a = a.permute(*np.argsort(dims).tolist()).contiguous()
        sd[name] = a
    return sd


# The Dense layers of a TransformerLM block, under MHA (``qkv``) or GQA
# (``q``, ``kv``), with a GELU (``up``, ``down``) or SwiGLU (``gate`` too) MLP.
_LM_DENSE = ("qkv", "q", "kv", "proj", "gate", "up", "down")


def transformer_params_from_jax(params: Mapping) -> dict:
    """``state_dict`` of the port's ``TransformerLM`` from a flax params
    tree (``variables["params"]``) of numpy arrays: MHA or GQA, learned or
    rotary positions (no ``wpe``), GELU or SwiGLU, or MoE blocks
    (``moe/router/kernel`` and the stacked ``moe/experts_up``,
    ``moe/experts_down``, whose layout is the port's)."""
    if "params" in params:
        params = params["params"]
    sd = {"wte.weight": _t(params["wte"]["embedding"]),
          "RMSNorm_0.scale": _t(params["RMSNorm_0"]["scale"]),
          "lm_head.weight": _t(params["lm_head"]["kernel"]).T.contiguous()}
    if "wpe" in params:
        sd["wpe.weight"] = _t(params["wpe"]["embedding"])
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        extra = set(blk) - {"RMSNorm_0", "RMSNorm_1", "moe", *_LM_DENSE}
        if extra:
            raise ValueError(f"block_{i} holds {sorted(extra)}, which no "
                             "TransformerLM block has")
        pre = f"blocks.{i}."
        sd[pre + "RMSNorm_0.scale"] = _t(blk["RMSNorm_0"]["scale"])
        sd[pre + "RMSNorm_1.scale"] = _t(blk["RMSNorm_1"]["scale"])
        for name in _LM_DENSE:
            if name in blk:
                sd[pre + name + ".weight"] = \
                    _t(blk[name]["kernel"]).T.contiguous()
        if "moe" in blk:
            moe = blk["moe"]
            sd[pre + "moe.router.weight"] = \
                _t(moe["router"]["kernel"]).T.contiguous()
            sd[pre + "moe.experts_up"] = _t(moe["experts_up"])
            sd[pre + "moe.experts_down"] = _t(moe["experts_down"])
        i += 1
    return sd


def stacked_block_params_from_jax(params: Mapping, lead: int = 1) -> dict:
    """The parameters of ``models.transformer.Block`` (its names:
    ``qkv.weight``, ``RMSNorm_0.scale``, ``moe.experts_up``, ...) from a flax
    ``Block`` params tree whose leaves lead with ``lead`` stacked dims, as
    ``__graft_entry__.dryrun_multichip`` stacks them for a pipeline:
    ``(pp, ...)`` a stage, ``(pp, v, ...)`` a stage chunk.  Each Dense
    kernel's last two dims are transposed to ``nn.Linear``'s ``(out, in)``;
    the stacked dims and every other leaf keep their layout (the stacked MoE
    experts' is the port's)."""
    if "params" in params:
        params = params["params"]
    out = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
            elif key == "kernel" and np.ndim(val) == lead + 2:
                out[".".join(path + ("weight",))] = \
                    _t(val).transpose(-1, -2).contiguous()
            else:
                out[".".join(path + (key,))] = _t(val)
    walk(params, ())
    return out


def tensor_parallel_params_from_jax(params: Mapping, cfg, axis, *,
                                    ep_axis=None) -> dict:
    """``state_dict`` of the port's ``parallel.tensor_parallel.
    TensorParallelLM(cfg, axis, ep_axis=ep_axis)`` from the flax params
    tree of the JAX package's unsharded ``TransformerLM`` of the same
    config: :func:`transformer_params_from_jax`, then ``tp_shard_params``'s
    cut (the JAX package's ``tp_param_specs``; a MoE block's experts whole,
    or over ``ep_axis``)."""
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.parallel.tensor_parallel import tp_shard_params
    with torch.device("meta"):
        model = TransformerLM(cfg)
    return tp_shard_params(model, transformer_params_from_jax(params), axis,
                           ep_axis=ep_axis)


# The per-row and per-edge entries of a window snapshot, and the scalar
# kind of the counter and associated-P entries.
_WIN_ARRAYS = ("main", "staging", "stale_residual")
_WIN_INTS = ("versions", "main_versions")
_WIN_FLOATS = ("p_main", "p_staging", "p_stale_residual")


def window_state_from_jax(state: Mapping) -> dict:
    """The port's ``win_state_dict`` form (CPU tensors, Python ints and
    floats) of the JAX package's ``win_state_dict`` snapshot (numpy, the
    same ``"rank"`` and ``"dst:src"`` keys), the async mode's stale-residual
    store included; ``win_load_state_dict`` restores either."""
    out = {}
    for key, entries in state.items():
        if key in _WIN_ARRAYS:
            out[key] = {k: torch.from_numpy(np.array(v))
                        for k, v in dict(entries).items()}
        elif key in _WIN_INTS:
            out[key] = {k: int(v) for k, v in dict(entries).items()}
        elif key in _WIN_FLOATS:
            out[key] = {k: float(v) for k, v in dict(entries).items()}
        else:
            raise ValueError(f"window snapshot entry {key!r} is not one "
                             "of win_state_dict's")
    return out


def window_state_to_jax(state: Mapping) -> dict:
    """The JAX package's ``win_state_dict`` form (numpy arrays,
    ``np.int64`` counters, ``np.float64`` P scalars) of the port's
    snapshot: the inverse of :func:`window_state_from_jax`."""
    out = {}
    for key, entries in state.items():
        if key in _WIN_ARRAYS:
            out[key] = {k: torch.as_tensor(v).numpy().copy()
                        for k, v in dict(entries).items()}
        elif key in _WIN_INTS:
            out[key] = {k: np.int64(v) for k, v in dict(entries).items()}
        elif key in _WIN_FLOATS:
            out[key] = {k: np.float64(v) for k, v in dict(entries).items()}
        else:
            raise ValueError(f"window snapshot entry {key!r} is not one "
                             "of win_state_dict's")
    return out
