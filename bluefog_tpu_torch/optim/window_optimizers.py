"""Asynchronous one-sided optimizers: win_put, pull-get and push-sum.

The port of ``bluefog_tpu/optim/window_optimizers.py`` (reference
``torch/optimizers.py:844-1178``), in one process:

- :class:`DistributedWinPutOptimizer`: adapt, ``win_put`` the new
  parameters to the out-neighbors, combine what arrived by ``win_update``;
- :class:`DistributedPullGetOptimizer`: adapt, publish the parameters as
  the window's memory, ``win_get`` the in-neighbors' and combine;
- :class:`DistributedPushSumOptimizer`: adapt, a column-stochastic
  ``win_accumulate`` of the parameters with the push-sum weight (the
  associated P), ``win_update_then_collect``; :meth:`debias` divides by P.

As ``optim/optimizers.py``: ``base`` is a ``torch.optim.Optimizer`` over
rank-major parameters (leading dim ``size()``); its ``step()`` is every
rank's local adapt, and ``step()`` here updates the parameters in place.
The combine goes through the windows of ``ops/window.py``, on the
parameters' device.

Fusion: with ``fuse=True`` (the default) each rank's whole parameter row
travels through ONE window: a single contiguous rank-major parameter (the
``flat`` of ``RankReplicas``, in the JAX ravel order) is its own row;
several are concatenated in ``base``'s order, which must be the JAX tree's
leaf order.  ``fuse=False`` keeps a window a parameter (the reference's
per-parameter layout).

``layout`` is ``"auto"`` or ``"rank"``: in one process both are the
rank-major layout, the only one here.

Left out, each raising an error that names its ROADMAP item: the fused
step (``fused=True``, or ``fused=None`` under ``BLUEFOG_TPU_FUSED_STEP=1``,
item 19b; the variable defaults to 0 in the JAX package, whose eager step,
ported here, is the bitwise oracle) and its fusion buckets, sharded gossip (``shard_specs``, item 16), the
churn hooks (item 20), windows across processes with the owned layout
(item 17b) and the async mode (``BLUEFOG_TPU_ASYNC``, item 17c).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.utils import config

__all__ = ["DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
           "DistributedPushSumOptimizer"]


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, "
                              f"{item})")


class _WindowOptimizerBase:
    """The windows (one fused, or one a parameter) and the local adapt."""

    _zero_init = False

    def __init__(self, base: torch.optim.Optimizer, *, window_prefix: str,
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 layout: str = "auto", fused=None, fusion_buckets=None,
                 shard_specs=None):
        if layout not in ("auto", "rank", "owned"):
            raise ValueError(
                f"layout must be 'auto', 'rank' or 'owned', got {layout!r}")
        if layout == "owned":
            _refuse("the owned layout (owned-rows windows across processes)",
                    "item 17b")
        if fused or (fused is None and config.get().fused_step):
            _refuse("the fused window step (fused=True or "
                    "BLUEFOG_TPU_FUSED_STEP=1)", "item 19b")
        if fusion_buckets is not None:
            _refuse("window fusion buckets (the fused step's per-bucket "
                    "puts)", "item 19b")
        if shard_specs is not None:
            _refuse("sharded gossip (shard_specs)", "item 16")
        if config.get().churn:
            _refuse("the churn supervisor hooks (BLUEFOG_TPU_CHURN=1)",
                    "item 20")
        if int(num_steps_per_communication) < 1:
            raise ValueError("num_steps_per_communication must be >= 1")
        self.base = base
        self.window_prefix = window_prefix
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.fuse = bool(fuse)
        self.step_count = 0
        self._names: Optional[List[str]] = None
        self.init()

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.base.param_groups for p in group["params"]]

    # -- payload layout ----------------------------------------------------
    def _payloads(self) -> List[torch.Tensor]:
        """The rank-major rows to ship, one a window: every parameter's
        row, raveled and concatenated (fused; a single contiguous
        parameter is its own row, no copy), or the parameters as they are."""
        ps = self.params
        if not self.fuse:
            return list(ps)
        n = ps[0].shape[0]
        if len(ps) == 1 and ps[0].is_contiguous():
            return [ps[0].detach().view(n, -1)]
        return [torch.cat([p.detach().reshape(n, -1) for p in ps], dim=1)]

    @torch.no_grad()
    def _rebuild(self, combined: List[List[torch.Tensor]]) -> None:
        """Write the combined rows (a window's, one a rank: the window's
        memory, read here only) back into the parameters, the inverse of
        :meth:`_payloads`, in place, a rank at a time."""
        ps = self.params
        if not self.fuse:
            for p, rows in zip(ps, combined):
                for r, row in enumerate(rows):
                    p[r].copy_(row)
            return
        (rows,) = combined
        for r, row in enumerate(rows):
            off = 0
            for p in ps:
                size = p[r].numel()
                p[r].copy_(row[off:off + size].view(p.shape[1:]))
                off += size

    # -- lifecycle ---------------------------------------------------------
    def init(self) -> None:
        """Create the windows from the parameters' current values (the
        constructor does; again after :meth:`free`)."""
        n = basics.size()
        for p in self.params:
            if p.dim() == 0 or p.shape[0] != n:
                raise ValueError(
                    f"{type(self).__name__}: parameters must be rank-major "
                    f"with leading dim {n} (the owned layout comes with item "
                    f"17b); got shape {tuple(p.shape)}")
        payloads = self._payloads()
        if self.fuse:
            self._names = [f"{self.window_prefix}.fused"]
        else:
            self._names = [f"{self.window_prefix}.{i}"
                           for i in range(len(payloads))]
        for name, payload in zip(self._names, payloads):
            W.win_create(payload, name, zero_init=self._zero_init)

    def adapt(self) -> None:
        """The local base update alone (every rank at once): the first
        half of :meth:`step`."""
        self.base.step()

    def gather(self):
        """Every rank's parameters, rank-major: in one process, the
        parameters themselves."""
        return self.params

    def free(self) -> None:
        W.win_flush()
        for name in self._names or []:
            W.win_free(name)
        self._names = None

    def _quiesce(self) -> None:
        """Complete every window op in flight, so that a snapshot misses
        no gossip mass."""
        W.win_flush()

    def _require_windows(self, what: str) -> List[str]:
        if not self._names:
            raise RuntimeError(
                f"{type(self).__name__}.{what}: no windows exist — call "
                "init() first (and not after free()); a silent empty "
                "snapshot would lose all gossip state")
        return self._names

    def window_state_dict(self) -> Dict[str, dict]:
        """Every window's state (``win_state_dict``, on the CPU) keyed by
        window name, after in-flight ops land; restore with
        :meth:`load_window_state_dict` after a restart."""
        names = self._require_windows("window_state_dict")
        self._quiesce()
        return {name: W.win_state_dict(name) for name in names}

    def load_window_state_dict(self, state) -> None:
        names = set(self._require_windows("load_window_state_dict"))
        self._quiesce()
        snap = dict(state)
        if set(snap) != names:
            raise ValueError(
                f"{type(self).__name__}.load_window_state_dict: snapshot "
                f"windows {sorted(snap)} do not match this optimizer's "
                f"{sorted(names)} — was the snapshot taken with a "
                "different fuse= setting or window_prefix?")
        for name, s in snap.items():
            W.win_load_state_dict(name, s)

    def _communicates(self) -> bool:
        return (self.step_count + 1) % self.num_steps_per_communication == 0


class DistributedWinPutOptimizer(_WindowOptimizerBase):
    """Push-style async optimizer: adapt locally, ``win_put`` the new
    parameters to the out-neighbors, combine the received ones with
    ``win_update`` (reference factory ``torch/optimizers.py:1271``).

    ``step(dst_weights=...)`` takes ``win_put``'s weight forms, anew each
    call.  ``overlap=True`` issues the put and does not wait for it: the
    put runs on the window pool while the caller computes the next
    forward and backward, and the next step's ``win_update`` combines
    what has arrived (one step of staleness, the reference's async
    operating mode).  The put reads a copy of the adapted parameters,
    taken when it is issued, because the step goes on to write the
    combine into them; the previous put is waited for before the next.

    The put sends to the out-neighbors only (no ``self_weight``), as the
    JAX package's step does: the self term of ``win_update`` is the
    window's memory, the previous combine, and a rank's own adapted
    parameters reach it through its neighbors' next puts."""

    def __init__(self, base, *, window_prefix: str = "winput",
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 overlap: bool = False, layout: str = "auto", fused=None,
                 fusion_buckets=None, shard_specs=None):
        self.overlap = bool(overlap)
        self._pending: List[int] = []
        super().__init__(base, window_prefix=window_prefix,
                         num_steps_per_communication=num_steps_per_communication,
                         fuse=fuse, layout=layout, fused=fused,
                         fusion_buckets=fusion_buckets,
                         shard_specs=shard_specs)

    def step(self, *, dst_weights=None, require_mutex: bool = True) -> None:
        self.adapt()
        self.combine(dst_weights=dst_weights, require_mutex=require_mutex)

    def combine(self, *, dst_weights=None,
                require_mutex: bool = True) -> None:
        """The second half of :meth:`step`: on communication steps the
        puts and ``win_update``; then the step counter's advance."""
        if self._communicates():
            self._drain_pending()
            payloads = self._payloads()
            if self.overlap:
                payloads = [p.clone() for p in payloads]
            handles = [W.win_put_nonblocking(p, name, dst_weights=dst_weights,
                                             require_mutex=require_mutex)
                       for name, p in zip(self._names, payloads)]
            if self.overlap:
                self._pending = handles
            else:
                for h in handles:
                    W.win_wait(h)
            self._rebuild([W._update_rows(name,
                                          require_mutex=require_mutex)
                           for name in self._names])
        self.step_count += 1

    def _drain_pending(self) -> None:
        for h in self._pending:   # overlapped puts land first
            W.win_wait(h)
        self._pending = []

    def free(self) -> None:
        self._drain_pending()
        super().free()

    def _quiesce(self) -> None:
        self._drain_pending()
        super()._quiesce()


class DistributedPullGetOptimizer(_WindowOptimizerBase):
    """Pull-style async optimizer: adapt locally, publish the parameters
    as the window's memory, then ``win_get`` the in-neighbors' and
    combine (reference factory ``torch/optimizers.py:1225``)."""

    def __init__(self, base, *, window_prefix: str = "pullget",
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 layout: str = "auto"):
        super().__init__(base, window_prefix=window_prefix,
                         num_steps_per_communication=num_steps_per_communication,
                         fuse=fuse, layout=layout)

    def step(self, *, src_weights=None, require_mutex: bool = True) -> None:
        self.adapt()
        self.combine(src_weights=src_weights, require_mutex=require_mutex)

    def combine(self, *, src_weights=None,
                require_mutex: bool = True) -> None:
        if self._communicates():
            # The put with no edge only refreshes main (self_weight 1).
            for h in [W.win_put_nonblocking(p, name, self_weight=1.0,
                                            dst_weights={})
                      for name, p in zip(self._names, self._payloads())]:
                W.win_wait(h)
            for h in [W.win_get_nonblocking(name, src_weights=src_weights,
                                            require_mutex=require_mutex)
                      for name in self._names]:
                W.win_wait(h)
            self._rebuild([W._update_rows(name,
                                          require_mutex=require_mutex)
                           for name in self._names])
        self.step_count += 1


class DistributedPushSumOptimizer(_WindowOptimizerBase):
    """Async push-sum gossip SGD (reference factory
    ``torch/optimizers.py:1180``).

    Every step: the local adapt, a column-stochastic ``win_accumulate`` of
    the parameters (each rank splits weight ``1/(outdeg+1)`` over itself
    and its out-neighbors), ``win_update_then_collect``; the associated P
    tracks the accumulated weight, so :meth:`debias` recovers the
    unbiased iterates.  Gradients should be taken at the de-biased
    parameters."""

    _zero_init = True

    def __init__(self, base, *, window_prefix: str = "pushsum",
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 layout: str = "auto", fused=None, fusion_buckets=None):
        W.turn_on_win_ops_with_associated_p()
        super().__init__(base, window_prefix=window_prefix,
                         num_steps_per_communication=num_steps_per_communication,
                         fuse=fuse, layout=layout, fused=fused,
                         fusion_buckets=fusion_buckets)

    def _out_degree(self) -> np.ndarray:
        topo = basics.load_topology()
        return np.array([len(topology_util.out_neighbor_ranks(topo, r))
                         for r in range(basics.size())], dtype=float)

    def _outgoing_weights(self) -> Dict[tuple, float]:
        topo = basics.load_topology()
        share = 1.0 / (self._out_degree() + 1.0)
        return {(r, o): float(share[r]) for r in range(basics.size())
                for o in topology_util.out_neighbor_ranks(topo, r)}

    def step(self, *, dst_weights=None, require_mutex: bool = True) -> None:
        self.adapt()
        self.combine(dst_weights=dst_weights, require_mutex=require_mutex)

    def combine(self, *, dst_weights=None,
                require_mutex: bool = True) -> None:
        """The accumulate and the collect, every step (the JAX package's
        push-sum ignores ``num_steps_per_communication`` here too)."""
        if dst_weights is None:
            dst_weights = self._outgoing_weights()
        self_share = 1.0 / (self._out_degree() + 1.0)
        # self_weight applies after the edge sends, so the out-edges carry
        # w * p_old and each source's mass (self_share + sum_out w = 1) is
        # conserved: push-sum's column-stochastic invariant.
        for h in [W.win_accumulate_nonblocking(
                p, name, self_weight=self_share, dst_weights=dst_weights,
                require_mutex=require_mutex)
                for name, p in zip(self._names, self._payloads())]:
            W.win_wait(h)
        self._rebuild([W._collect_rows(name, require_mutex=require_mutex)
                       for name in self._names])
        self.step_count += 1

    def collect(self, *, require_mutex: bool = True) -> None:
        """Fold every contribution still in the windows into the
        parameters (the reference's end-of-run collect); the gathered P
        then sums to ``n``."""
        W.win_fence()
        self._rebuild([W._collect_rows(name, require_mutex=require_mutex)
                       for name in self._names])

    def associated_p(self) -> np.ndarray:
        """The ``(n,)`` push-sum weights (the same in every window)."""
        return W.win_associated_p(self._names[0])

    def debias(self, params=None, *, p_min: float = 1e-3
               ) -> List[torch.Tensor]:
        """Each rank's row of ``params`` (default: the parameters) divided
        by its associated P, floored at ``p_min`` (a rank whose mass is
        almost all in flight would divide by ~0); new tensors, in the
        parameters' order."""
        p = np.maximum(self.associated_p(), p_min)
        out = []
        for t in (self.params if params is None else params):
            shape = (-1,) + (1,) * (t.dim() - 1)
            out.append(t.detach() / torch.as_tensor(
                p, dtype=t.dtype, device=t.device).reshape(shape))
        return out
