"""Metrics: cross-rank averaging meters and JSONL scalar series.

The port of ``bluefog_tpu/utils/metrics.py``: the reference's examples'
allreduce-averaging ``Metric`` (``examples/pytorch_resnet.py:395-407``) and
``metric_average`` (``examples/pytorch_mnist.py:268-271``) as API, and a
series writer so training curves survive the run:

  * :func:`metric_average` / :class:`Metric`: the mean of per-rank scalars
    over the port's ``allreduce``, so it is the global mean across
    processes too (each process holds its owned ranks' rows).
  * :class:`MetricsWriter`: append-only JSONL (``{"ts", "step", ...}``),
    one file a process (the timeline's convention).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["metric_average", "Metric", "MetricsWriter"]


def metric_average(values, name: Optional[str] = None) -> float:
    """The mean of per-rank scalars, as one float.

    ``values`` is rank-major: ``(m,)``, row ``i`` the value of owned rank
    ``i`` (all ``size()`` ranks in one process), a tensor on any device or
    anything ``torch.as_tensor`` takes; a 0-d value is already global.
    The mean rides ``allreduce``.  ``name`` is accepted for the reference's
    API (it keyed negotiation there)."""
    del name
    from bluefog_tpu_torch import basics
    arr = torch.as_tensor(values, dtype=torch.float32)
    if arr.dim() == 0:
        return float(arr)
    out = basics.allreduce(arr.to(basics.device()), average=True)
    return float(out.reshape(-1)[0])


class Metric:
    """Running cross-rank average (the reference's
    ``pytorch_resnet.py:395-407``): each ``update`` averages the per-rank
    values over the ranks and accumulates; ``avg`` is the mean over
    updates."""

    def __init__(self, name: str):
        self.name = name
        self.sum = 0.0
        self.n = 0

    def update(self, values) -> None:
        self.sum += metric_average(values, self.name)
        self.n += 1

    @property
    def avg(self) -> float:
        return self.sum / max(1, self.n)


def _process_count() -> int:
    for var in ("BFTPU_NUM_PROCESSES", "WORLD_SIZE"):
        env = os.environ.get(var)
        if env is not None:
            try:
                return int(env)
            except ValueError:
                pass
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class MetricsWriter:
    """Append scalar series as JSON lines: ``{"ts": ..., "step": ...,
    **kv}``.

    One file a process: ``path`` gets the process index as a suffix in
    runs of several processes (``m.0.jsonl`` .. ``m.N.jsonl``, rank 0
    included), as the timeline's files do."""

    def __init__(self, path: str):
        from bluefog_tpu_torch.utils.timeline import _process_index
        proc = _process_index()
        if _process_count() > 1 or proc != 0:
            root, ext = os.path.splitext(path)
            path = f"{root}.{proc}{ext or '.jsonl'}"
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered

    def log(self, step: Optional[int] = None, **scalars) -> None:
        rec = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in scalars.items():
            rec[k] = float(v) if isinstance(v, (np.generic, np.ndarray,
                                                torch.Tensor)) else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
