"""The environment knobs the port reads so far.

A subset of ``bluefog_tpu/utils/config.py``: the same variable names,
defaults and validation, for the knobs of the ported paths.  Values are
read on first access and cached; call :func:`reload` after changing
``os.environ``.  The rest of the JAX package's inventory (telemetry,
transport, placement, tuner, ...) comes with ROADMAP item 21, which folds
this module into the ported config; until then the tuner's overrides are
the identity they are with ``BLUEFOG_TPU_TUNE=0``, the JAX package's
default.

| Variable | Default | Meaning |
|---|---|---|
| BLUEFOG_TPU_FUSED_STEP        | 0     | whole-step compilation of the window optimizers (not ported: item 19b) |
| BLUEFOG_TPU_ASYNC             | 0     | barrier-free async window mode (not ported: item 17c) |
| BLUEFOG_TPU_CHURN             | 0     | churn supervisor hooks of the window optimizers (not ported: item 20) |
| BLUEFOG_TPU_HIER              | 0     | 1: enable two-level hierarchical gossip |
| BLUEFOG_TPU_HIER_OUTER_EVERY  | 1     | outer (inter-machine) cadence: every k steps |
| BLUEFOG_TPU_HIER_INNER        | exp2  | intra-machine dense topology: exp2 / ring |
| BLUEFOG_TPU_HIER_OUTER        | exp2  | inter-machine one-peer walk: exp2 / ring |
| BLUEFOG_TPU_HIER_OUTER_COMPRESSION | none | outer-level codec: none / bf16 / sparse:<frac> |
| BLUEFOG_TPU_HIER_OUTER_SELF_WEIGHT | 0.5 | cadence-1 outer self weight (cadence-corrected to theta**k) |
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Config", "get", "reload", "parse_sparse_frac",
           "COMPRESSION_VOCAB"]

COMPRESSION_VOCAB = ("none", "bf16", "sparse:<frac>")


def parse_sparse_frac(value: str) -> float:
    """Fraction of a ``sparse:<frac>`` codec spec, validated in (0, 1]."""
    if ":" not in value:
        raise ValueError(
            f"malformed {value!r}: use 'sparse:<frac>' (e.g. 'sparse:0.25')")
    try:
        frac = float(value.split(":", 1)[1])
    except ValueError:
        raise ValueError(
            f"malformed {value!r}: the fraction must be a float in (0, 1], "
            "e.g. 'sparse:0.25'") from None
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"sparse fraction must be in (0, 1], got {frac}")
    return frac


def _validated_compression(value: str, var: str) -> str:
    if value in ("none", "bf16"):
        return value
    if value.startswith("sparse"):
        parse_sparse_frac(value)  # raises on a malformed fraction
        return value
    raise ValueError(
        f"{var}={value!r} is not supported; expected one of "
        f"{', '.join(COMPRESSION_VOCAB)} (a typo here would otherwise "
        "silently disable compression)")


def _flag(name: str, default: bool = False) -> bool:
    return os.environ.get(name, "1" if default else "0") in ("1", "true",
                                                             "True", "yes")


@dataclass(frozen=True)
class Config:
    fused_step: bool
    async_mode: bool
    churn: bool
    hier: bool
    hier_outer_every: int
    hier_inner: str
    hier_outer: str
    hier_outer_compression: str
    hier_outer_self_weight: float

    @classmethod
    def from_env(cls) -> "Config":
        env = os.environ
        return cls(
            fused_step=_flag("BLUEFOG_TPU_FUSED_STEP"),
            async_mode=_flag("BLUEFOG_TPU_ASYNC"),
            churn=_flag("BLUEFOG_TPU_CHURN"),
            hier=_flag("BLUEFOG_TPU_HIER"),
            hier_outer_every=int(env.get("BLUEFOG_TPU_HIER_OUTER_EVERY",
                                         "1")),
            hier_inner=env.get("BLUEFOG_TPU_HIER_INNER", "exp2").lower(),
            hier_outer=env.get("BLUEFOG_TPU_HIER_OUTER", "exp2").lower(),
            hier_outer_compression=_validated_compression(
                env.get("BLUEFOG_TPU_HIER_OUTER_COMPRESSION",
                        "none").lower(),
                "BLUEFOG_TPU_HIER_OUTER_COMPRESSION"),
            hier_outer_self_weight=float(env.get(
                "BLUEFOG_TPU_HIER_OUTER_SELF_WEIGHT", "0.5")))


_cfg: Optional[Config] = None


def get() -> Config:
    global _cfg
    if _cfg is None:
        _cfg = Config.from_env()
    return _cfg


def reload() -> Config:
    global _cfg
    _cfg = None
    return get()
