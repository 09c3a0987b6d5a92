"""Asynchronous one-sided optimizers: win_put, pull-get and push-sum.

The port of ``bluefog_tpu/optim/window_optimizers.py`` (reference
``torch/optimizers.py:844-1178``), in one process or across processes:

- :class:`DistributedWinPutOptimizer`: adapt, ``win_put`` the new
  parameters to the out-neighbors, combine what arrived by ``win_update``;
- :class:`DistributedPullGetOptimizer`: adapt, publish the parameters as
  the window's memory, ``win_get`` the in-neighbors' and combine;
- :class:`DistributedPushSumOptimizer`: adapt, a column-stochastic
  ``win_accumulate`` of the parameters with the push-sum weight (the
  associated P), ``win_update_then_collect``; :meth:`debias` divides by P.

As ``optim/optimizers.py``: ``base`` is a ``torch.optim.Optimizer`` over
rank-major parameters (leading dim ``size()``) or, across processes, over
the owned ranks' rows (leading dim ``len(owned_ranks())``); its ``step()``
is every rank's local adapt, and ``step()`` here updates the parameters
in place.  The combine goes through the windows of ``ops/window.py``, on
the parameters' device.

Fusion: with ``fuse=True`` (the default) each rank's whole parameter row
travels through ONE window: a single contiguous rank-major parameter (the
``flat`` of ``RankReplicas``, in the JAX ravel order) is its own row;
several are concatenated in ``base``'s order, which must be the JAX tree's
leaf order.  ``fuse=False`` keeps a window a parameter (the reference's
per-parameter layout).

``layout`` (``"auto"``, ``"rank"`` or ``"owned"``) is resolved as in the
JAX package's ``init``: ``auto`` is ``rank`` for a leading dim of the
world size and ``owned`` for one of the owned ranks across processes.
Across processes only the owned ranks' rows are combined: in the rank
layout the other rows keep their previous value (the JAX package's
``_merge_owned``), and :meth:`gather` all-gathers the owned rows into the
rank-major view.  The windows' puts complete locally: ``win_update``
combines what has arrived, so the trajectories across processes are not
deterministic; push-sum fences every ``auto_collect_rounds`` steps to
bound the mass in flight.

The async mode (``BLUEFOG_TPU_ASYNC=1``; ``ops/window.py``'s
``configure_async``, armed at :meth:`init`): every step publishes the step
clock (``set_async_step``, which the wire trace tags carry); win_put's
puts overlap the next step as with ``overlap=True``; push-sum drops its
``auto_collect_rounds`` fence, and every ``BLUEFOG_TPU_ASYNC_COLLECT_EVERY``
steps across processes fences the transport, folds the stale residuals
back into staging and collects exactly (the only barrier left).  Off,
every step is bit for bit the lockstep one.

Sharded gossip (:class:`DistributedWinPutOptimizer`'s ``shard_specs``,
``shard_groups``, ``num_shards``, ``ops/sharded.py``): the replicated
leaves ride the fused window over the whole topology, and each rank's own
slice of the sharded leaves rides a second fused window,
``<prefix>.sharded``, whose puts cross only in-group edges and whose
``win_update`` weighs only them (``induced_window_weights``); the ghost
slices are left as they are.  It needs the rank layout and ``fuse=True``,
as in the JAX package.

Observability (``utils/telemetry``, ``utils/profiler``): ``step()`` times
itself into ``bf_optimizer_step_seconds{family="window"}`` and, every
``BLUEFOG_TPU_PROFILE_EVERY`` steps under ``BLUEFOG_TPU_PROFILE=1``, waits
for the device on that step and records a synced sample and a straggler
gather.  Every ``BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY`` steps (default
10) the combine records the consensus-distance gauge: each owned rank's
L2 distance between its adapted parameters and the ``win_update`` result,
reduced on the device, ``n`` floats read back (the JAX package reads both
to the host).  The async mode sets ``bf_async_step_lag``.

Fusion buckets and the fused step: ``fusion_buckets=k`` splits the
replicated leaves (the parameters, or ``leaf_shapes`` of one flat
parameter) into at most ``k`` contiguous byte-balanced buckets
(``optim.functional._bucket_groups``), one window each
(``<prefix>.fusedb<i>``).  ``fused=True`` (or ``fused=None`` under
``BLUEFOG_TPU_FUSED_STEP=1``) runs the win_put and push-sum steps through
``ops/fused_step.py``: the base update, each bucket's flat and its put
plan as one captured program (a CUDA graph on the card), then the host's
local edges, flush, self-publish and drain; the parameters come out bit
for bit those of the eager step.  ``fused=False`` pins the eager step, and
a configuration the fused step cannot take warns once and runs the eager
step.

Churn (``BLUEFOG_TPU_CHURN=1`` across processes): every ``step()`` first
drives the process's churn supervisor (``run/supervisor.py``), so failure
detection, the survivor re-plan and the rebuild of the windows on the card
happen before the step's window ops, as in the JAX package.  A committed
change lands on :attr:`membership_change`; a rank voted out raises (its
:attr:`evicted` set).  After a change the fused programs of the freed
windows are dropped (the next step builds anew at the new epoch, the one
after captures); the rebuilt windows' staging stays zero, as the JAX
supervisor leaves it, so the first combine averages in zeros for a
neighbor whose first put or get has not landed yet.  A send to a peer that died before the gang voted
it out fails; under churn the step counts it (:attr:`churn_send_errors`)
and combines what arrived.  A supervisor built by hand is deferred to:
its owner steps it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from bluefog_tpu_torch import basics
from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import sharded as SH
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.optim.functional import COMBINE_CHUNK
from bluefog_tpu_torch.utils import config, profiler, telemetry
from bluefog_tpu_torch.utils.logging import get_logger

__all__ = ["DistributedWinPutOptimizer", "DistributedPullGetOptimizer",
           "DistributedPushSumOptimizer"]


def _merged_ranges(ranges) -> List[tuple]:
    """Column ranges with adjacent ones merged."""
    out: List[list] = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(r) for r in out]


class _WindowOptimizerBase:
    """The windows (one fused, or one a parameter) and the local adapt."""

    _zero_init = False

    def __init__(self, base: torch.optim.Optimizer, *, window_prefix: str,
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 layout: str = "auto", fused=None, fusion_buckets=None,
                 shard_specs=None, shard_groups=None, num_shards=None,
                 leaf_shapes=None):
        if layout not in ("auto", "rank", "owned"):
            raise ValueError(
                f"layout must be 'auto', 'rank' or 'owned', got {layout!r}")
        if int(num_steps_per_communication) < 1:
            raise ValueError("num_steps_per_communication must be >= 1")
        self.base = base
        self.layout = layout
        self.window_prefix = window_prefix
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.fuse = bool(fuse)
        self.shard_specs = shard_specs
        self.shard_groups = shard_groups
        self.num_shards = None if num_shards is None else int(num_shards)
        self.leaf_shapes = (None if leaf_shapes is None
                            else [tuple(int(d) for d in shape)
                                  for shape in leaf_shapes])
        self.step_count = 0
        # None defers to BLUEFOG_TPU_FUSED_STEP, False pins the eager step.
        self.fused = fused
        self.fusion_buckets = (None if fusion_buckets is None
                               else int(fusion_buckets))
        self._fused_impl = None      # ops.fused_step.FusedStep, at first use
        self._names: Optional[List[str]] = None
        self._shard_plan = None
        self._sharded_name = None
        self._bucket_ranges: List[List[tuple]] = []
        self.init()

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.base.param_groups for p in group["params"]]

    # -- payload layout ----------------------------------------------------
    def _flat(self) -> torch.Tensor:
        """Every parameter's row, raveled and concatenated (a single
        contiguous parameter is its own row, no copy)."""
        ps = self.params
        n = ps[0].shape[0]
        if len(ps) == 1 and ps[0].is_contiguous():
            return ps[0].detach().view(n, -1)
        return torch.cat([p.detach().reshape(n, -1) for p in ps], dim=1)

    def _payloads(self) -> List[torch.Tensor]:
        """The rank-major rows to ship, one a window: each bucket's columns
        of every parameter's row (fused; one bucket: the whole row), or
        the parameters as they are; with a shard plan the buckets cover the
        replicated leaves, and each rank's own slices of the sharded leaves
        follow (:meth:`_shard_rows`)."""
        ps = self.params
        if not self.fuse:
            return list(ps)
        flat = self._flat()
        out = [self._columns(flat, rngs) for rngs in self._bucket_ranges]
        if self._shard_plan is not None:
            out.append(self._shard_rows(flat))
        return out

    @staticmethod
    def _columns(flat: torch.Tensor, rngs) -> torch.Tensor:
        """The columns ``rngs`` of ``flat``: ``flat`` itself, a view, or
        their concatenation."""
        if len(rngs) == 1:
            a, b = rngs[0]
            return flat if (a, b) == (0, flat.shape[1]) else flat[:, a:b]
        return torch.cat([flat[:, a:b] for a, b in rngs], dim=1)

    def _write_columns(self, i: int, a: int, b: int,
                       src: torch.Tensor) -> None:
        """Row ``i``'s columns ``[a, b)`` of the parameters' rows (in the
        concatenated order of :meth:`_flat`) set to ``src``."""
        for p, c0, c1 in zip(self.params, self._pcols, self._pcols[1:]):
            lo, hi = max(a, c0), min(b, c1)
            if lo >= hi:
                continue
            if (lo, hi) == (c0, c1):
                p[i].copy_(src[lo - a:hi - a].view(p.shape[1:]))
            else:
                p[i].view(-1)[lo - c0:hi - c0].copy_(src[lo - a:hi - a])

    def _own_slices(self, flat: torch.Tensor, row: int) -> List[torch.Tensor]:
        """Row ``row``'s own slice of each sharded leaf (views of ``flat``,
        whose rows are the world's ranks: the rank layout)."""
        plan = self._shard_plan
        c = plan.coords[row]
        out = []
        for i in self._shard_leaf_idx:
            shape, d = self._leaf_shapes[i], plan.dims[i]
            chunk = shape[d] // plan.n_shards
            leaf = flat[row, self._starts[i]:self._starts[i + 1]]
            out.append(leaf.view(shape).narrow(d, c * chunk, chunk))
        return out

    def _shard_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """The sharded window's rows: each rank's own slice of every
        sharded leaf, raveled and concatenated (the JAX package's
        ``_shard_payload``)."""
        rows = flat.new_empty((flat.shape[0], self._shard_width))
        for r in range(flat.shape[0]):
            off = 0
            for v in self._own_slices(flat, r):
                rows[r, off:off + v.numel()].view(v.shape).copy_(v)
                off += v.numel()
        return rows

    @torch.no_grad()
    def _rebuild(self, combined: List[List[torch.Tensor]]) -> None:
        """Write the combined rows (a window's, one an owned rank: the
        window's memory, read here only) back into the parameters, the
        inverse of :meth:`_payloads`, in place, a rank at a time.  The rows
        of ranks another process owns keep their previous value (the JAX
        package's ``_merge_owned``); a shard plan's ghost slices keep
        theirs."""
        ps = self.params
        if not self.fuse:
            for p, rows in zip(ps, combined):
                for i, row in zip(self._rows_of_owned, rows):
                    p[i].copy_(row)
            return
        nb = len(self._bucket_ranges)
        if self._shard_plan is not None:
            self._rebuild_sharded(combined[:nb], combined[nb])
            return
        for rngs, rows in zip(self._bucket_ranges, combined):
            for i, row in zip(self._rows_of_owned, rows):
                off = 0
                for a, b in rngs:
                    self._write_columns(i, a, b, row[off:off + b - a])
                    off += b - a

    @torch.no_grad()
    def _rebuild_sharded(self, rep_rows, shard_rows) -> None:
        """:meth:`_rebuild` under a shard plan: the replicated leaves'
        columns (a window a bucket), then the own slices; every other
        column stays."""
        ps = self.params
        single = len(ps) == 1 and ps[0].is_contiguous()
        flat = self._flat()
        for k, (i, sh) in enumerate(zip(self._rows_of_owned, shard_rows)):
            for rngs, rows in zip(self._bucket_ranges, rep_rows):
                off = 0
                for a, b in rngs:
                    flat[i, a:b].copy_(rows[k][off:off + b - a])
                    off += b - a
            off = 0
            for v in self._own_slices(flat, i):
                v.copy_(sh[off:off + v.numel()].view(v.shape))
                off += v.numel()
        if not single:
            n, off = flat.shape[0], 0
            for p in ps:
                size = p[0].numel()
                p.copy_(flat[:, off:off + size].view(p.shape))
                off += size

    def _resolve_shard_plan(self) -> None:
        """Arm sharded gossip when shard specs were given, the knob is on
        and some leaf is sharded; else leave every structure None, the
        replicated layout (the JAX package's ``_resolve_shard_plan``)."""
        self._shard_plan = None
        self._sharded_name = None
        if self.shard_specs is None or not config.get().sharded_gossip:
            return
        n = basics.size()
        ps = self.params
        if self.leaf_shapes is not None:
            shapes = self.leaf_shapes
        else:
            shapes = [tuple(p.shape[1:]) for p in ps]
        leaves = [SH.Leaf((n,) + tuple(s), ps[0].dtype) for s in shapes]
        plan = SH.build_plan(leaves, list(self.shard_specs), n=n,
                             n_shards=self.num_shards,
                             groups=self.shard_groups)
        if not plan.any_sharded:
            return
        if self._layout != "rank":
            raise ValueError(
                f"{type(self).__name__}: shard_specs requires the "
                "rank-major layout (the sharded window's per-coordinate "
                "rows are rank-indexed); owned layout is not supported")
        if not self.fuse:
            raise ValueError(
                f"{type(self).__name__}: shard_specs requires fuse=True "
                "(the sharded slices ride one dedicated fused window)")
        self._shard_plan = plan
        self._leaf_shapes = [tuple(s) for s in shapes]
        self._starts = [0]
        for s in self._leaf_shapes:
            self._starts.append(self._starts[-1] + int(np.prod(s)))
        width = sum(p[0].numel() for p in ps)
        if self._starts[-1] != width:
            raise ValueError(f"leaf_shapes cover {self._starts[-1]} columns, "
                             f"the parameters {width}")
        self._shard_leaf_idx = [i for i, m in enumerate(plan.mask) if m]
        self._shard_width = sum(int(np.prod(shapes[i])) // plan.n_shards
                                for i in self._shard_leaf_idx)
        put_edges, self_w, nbr_w = SH.induced_window_weights(
            plan, basics.load_topology())
        self._shard_edges = put_edges
        self._shard_update_kwargs = {"self_weight": self_w,
                                     "neighbor_weights": nbr_w}

    def _resolve_buckets(self) -> None:
        """The fusion buckets: the column ranges of each replicated
        window's row (the JAX package's ``_buckets``).  The leaves are the
        shard plan's or ``leaf_shapes`` (one flat parameter), else the
        parameters; ``fusion_buckets > 1`` partitions the replicated ones
        into contiguous byte-balanced groups, else they are one bucket."""
        ps = self.params
        widths = [p[0].numel() if p.dim() else 1 for p in ps]
        self._pcols = [0]
        for w in widths:
            self._pcols.append(self._pcols[-1] + w)
        self._bucket_ranges = []
        if not self.fuse:
            return
        plan = self._shard_plan
        split = self.fusion_buckets is not None and self.fusion_buckets > 1
        if plan is not None:
            shapes = self._leaf_shapes
        elif split and self.leaf_shapes is not None:
            shapes = self.leaf_shapes
        else:
            shapes = [tuple(p.shape[1:]) for p in ps]
        sizes = [int(np.prod(s)) for s in shapes]
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        if int(starts[-1]) != self._pcols[-1]:
            raise ValueError(f"leaf_shapes cover {int(starts[-1])} columns, "
                             f"the parameters {self._pcols[-1]}")
        rep = [i for i in range(len(shapes))
               if plan is None or not plan.mask[i]]
        if split and rep:
            from bluefog_tpu_torch.optim.functional import _bucket_groups
            item = ps[0].element_size()
            groups = [[rep[j] for j in g] for g in _bucket_groups(
                [sizes[i] * item for i in rep], self.fusion_buckets)]
        else:
            groups = [rep] if rep else []
        self._bucket_ranges = [
            _merged_ranges((int(starts[i]), int(starts[i + 1])) for i in g)
            for g in groups]

    def _put_weights(self, name: str, dst_weights):
        """A window's put destinations: the sharded window's in-group
        edges, else ``dst_weights``."""
        return self._shard_edges if name == self._sharded_name \
            else dst_weights

    def _update_kwargs(self, name: str) -> dict:
        """The sharded window's explicit in-group update weights (an
        out-of-group staging buffer, had one landed, stays pending)."""
        return self._shard_update_kwargs if name == self._sharded_name \
            else {}

    # -- lifecycle ---------------------------------------------------------
    def init(self) -> None:
        """Create the windows from the parameters' current values (the
        constructor does; again after :meth:`free`), resolving the layout
        as the JAX package's ``init`` does, and arm the async mode from the
        config (``BLUEFOG_TPU_ASYNC``)."""
        n = basics.size()
        self._async_on = W.configure_async()
        self._owned = W._owned_ranks(n)
        rows = {p.shape[0] if p.dim() else None for p in self.params}
        if len(rows) != 1:
            raise ValueError(
                f"{type(self).__name__}: parameters must share one leading "
                f"(row) dim; got {sorted(rows, key=str)}")
        (rows,) = rows
        distrib = W._store.distrib is not None
        if self.layout == "auto":
            if rows == n:
                self._layout = "rank"
            elif distrib and rows == len(self._owned):
                self._layout = "owned"
            else:
                raise ValueError(
                    f"{type(self).__name__}.init: leading dim {rows} is "
                    f"neither the world size ({n}, rank-major) nor this "
                    f"process's owned-rank count ({len(self._owned)}, owned "
                    "layout)")
        else:
            self._layout = self.layout
            want = n if self._layout == "rank" else len(self._owned)
            if rows != want:
                raise ValueError(
                    f"{type(self).__name__}.init: layout={self._layout!r} "
                    f"expects leading dim {want}, got {rows}")
        # The parameter row of each owned rank, in the windows' order.
        self._rows_of_owned = (self._owned if self._layout == "rank"
                               else list(range(len(self._owned))))
        self._resolve_shard_plan()
        self._resolve_buckets()
        payloads = self._payloads()
        if self.fuse:
            nb = len(self._bucket_ranges)
            self._names = ([f"{self.window_prefix}.fused"] if nb == 1 else
                           [f"{self.window_prefix}.fusedb{i}"
                            for i in range(nb)])
            if self._shard_plan is not None:
                self._sharded_name = f"{self.window_prefix}.sharded"
                self._names.append(self._sharded_name)
        else:
            self._names = [f"{self.window_prefix}.{i}"
                           for i in range(len(payloads))]
        # An owned-layout window carries no neighbor rows to seed staging
        # from: one identity put seeds it instead, as in the JAX package,
        # fenced so that no first update combines a seed still in flight.
        zero = self._zero_init or self._layout == "owned"
        for name, payload in zip(self._names, payloads):
            W.win_create(payload, name, zero_init=zero)
        if self._layout == "owned" and not self._zero_init:
            for name, payload in zip(self._names, payloads):
                W.win_put(payload, name)
            W.win_fence()

    def adapt(self) -> None:
        """The local base update alone (every rank at once): the first
        half of :meth:`step`."""
        self.base.step()

    @torch.no_grad()
    def gather(self) -> List[torch.Tensor]:
        """Every rank's parameters, rank-major (for evaluation): in one
        process the parameters themselves; across processes the owned
        rows of every process, all-gathered (through the host when the
        group is gloo and the rows are on a card: gloo moves CPU tensors).
        A collective: every process calls it."""
        if W._store.distrib is None:
            return self.params
        comm = basics.process_ranks()
        out = []
        for p in self.params:
            own = p.detach()[self._rows_of_owned].contiguous()
            host = own.device.type == "cuda" and \
                dist.get_backend() == "gloo"
            full = comm.all_gather(own.cpu() if host else own).wait()
            out.append(full.to(p.device) if host else full)
        return out

    def free(self) -> None:
        # Queued sends reach the wire before their windows go; best effort
        # with a short timeout, so that a dead peer cannot stall teardown.
        try:
            W.win_flush(timeout=5.0)
        except Exception:  # noqa: BLE001 — never abort the teardown
            get_logger().warning(
                "window optimizer free(): the transport flush failed; "
                "continuing the teardown", exc_info=True)
        for name in self._names or []:
            W.win_free(name)
        self._names = None
        if self._fused_impl is not None:
            # Its programs run the freed windows' plans.
            self._fused_impl.close()

    def _quiesce(self) -> None:
        """Complete every window op in flight and, across processes, fence
        the transport, so that a snapshot misses no gossip mass (a
        collective across processes: ``win_fence`` ends in a barrier)."""
        W.win_flush()
        if W._store.distrib is not None:
            W.win_fence()

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

    # The newest committed membership change _maybe_churn_step saw (None
    # until the gang changes); `evicted` is the supervisor's verdict on
    # this rank; the sends that failed before a dead peer was voted out.
    membership_change = None
    evicted = False
    churn_send_errors = 0

    def _maybe_churn_step(self, t: int) -> None:
        """Drive the churn supervisor at this step boundary (with
        ``BLUEFOG_TPU_CHURN=1`` and a live multi-process transport; else
        one config check).  A committed change lands in
        :attr:`membership_change`; if this rank was voted out,
        :attr:`evicted` is set and a RuntimeError tells the loop to exit.
        A live controller that the process-wide supervisor does not own
        (a supervisor built by hand) is left to its owner."""
        if not config.get().churn:
            return
        from bluefog_tpu_torch.ops import membership
        from bluefog_tpu_torch.run import supervisor as sup_mod
        cur = membership.current()
        if cur is not None and (sup_mod._singleton is None
                                or sup_mod._singleton.ctrl is not cur):
            return
        sup = sup_mod.maybe_supervisor()
        if sup is None:
            return
        view = sup.step(t)
        if view is None:
            return
        self.membership_change = view
        if view.evicted:
            self.evicted = True
            raise RuntimeError(
                f"{type(self).__name__}.step: this rank was evicted by "
                f"membership consensus (epoch {view.epoch}); exit the "
                "training loop — the survivors have re-planned without it")
        if self._fused_impl is not None:
            # Its programs ran the freed windows' plans.
            self._fused_impl.close()

    def _wait_all(self, handles) -> None:
        """``win_wait`` every handle; under churn a send that failed on a
        peer not yet voted out is counted, and the step goes on."""
        for h in handles:
            try:
                W.win_wait(h)
            except ConnectionError as e:
                if not W.churn_tolerates(e):
                    raise
                self.churn_send_errors += 1

    def _fence(self) -> None:
        """A step's ``win_fence``; under churn one that fails on a peer
        not yet voted out is counted, and the step goes on."""
        try:
            W.win_fence()
        except ConnectionError as e:
            if not W.churn_tolerates(e):
                raise
            self.churn_send_errors += 1

    def step(self, **kw) -> None:
        """One step: the churn supervisor's step boundary (under
        ``BLUEFOG_TPU_CHURN``), :meth:`adapt`, then :meth:`combine` (``kw``
        goes to the combine), timed; or, when the fused step is wanted and
        this configuration can take it, the same step through
        ``ops/fused_step.py``."""
        self._maybe_churn_step(self.step_count)
        t0 = telemetry.start_timer()
        if not (self._fused_wanted() and self._fused_step(**kw)):
            self.adapt()
            self.combine(**kw)
        self._record_step_time(t0)

    # -- the fused step (ops/fused_step.py) --------------------------------
    def _fused_wanted(self) -> bool:
        """Does this step try the fused step?  ``fused`` True or False
        decides; None defers to ``BLUEFOG_TPU_FUSED_STEP`` (one config
        check: off, nothing fused is imported or built)."""
        if self.fused is not None:
            return bool(self.fused)
        return bool(config.get().fused_step)

    def _fused_step(self, **kw) -> bool:
        """The family's fused step; False runs the eager step (the pull
        family has none, as in the JAX package)."""
        return False

    def _fused_try_step(self, *, family: str, dst_weights=None,
                        self_weight=None, require_mutex: bool = True,
                        pre_drain=None) -> bool:
        """One step through the fused program; False (after one warning a
        reason) when this configuration cannot take it, and the caller
        runs the eager step, which stays the bitwise oracle."""
        from bluefog_tpu_torch.ops import fused_step as F
        if self._fused_impl is None:
            self._fused_impl = F.FusedStep(self)
        try:
            self._fused_impl.step(family=family, dst_weights=dst_weights,
                                  self_weight=self_weight,
                                  require_mutex=require_mutex,
                                  pre_drain=pre_drain)
        except F.FusedFallback:
            return False
        return True

    def _record_step_time(self, t0) -> None:
        """The step's host time into ``bf_optimizer_step_seconds{family=
        "window"}``; on a profile period's step (``BLUEFOG_TPU_PROFILE``),
        the device is waited for and the synced sample recorded with a
        straggler gather (collective: every process steps alike)."""
        dt = telemetry.observe_since(t0, "bf_optimizer_step_seconds",
                                     family="window")
        if dt is None:
            return
        pe = profiler.profile_period()
        if pe and self.step_count % pe == 0:
            outer = profiler.active()
            if outer is not None:
                outer.request_straggler()
                return
            dev = self.params[0].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            profiler.record_synced_step(time.perf_counter() - t0)

    @torch.no_grad()
    def _maybe_sample_consensus(self, payloads, combined) -> None:
        """Every ``BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY`` steps (default
        10), the consensus-distance gauge: each owned rank's L2 distance
        between its adapted row (``payloads``, before the combine) and the
        combined row (``combined``, the weighted neighborhood mean), read
        off the combine this step already did.  Reduced on the device a
        chunk of columns at a time; ``n`` floats cross to the host."""
        k = telemetry.consensus_every()
        if not k or (self.step_count + 1) % k:
            return
        sq = None
        for pre, rows in zip(payloads, combined):
            pre = pre.detach().reshape(pre.shape[0], -1)
            per_rank = []
            for i, row in zip(self._rows_of_owned, rows):
                acc = torch.zeros((), dtype=torch.float32, device=row.device)
                for a, b in zip(pre[i].split(COMBINE_CHUNK),
                                row.reshape(-1).split(COMBINE_CHUNK)):
                    acc += (a.float() - b.float()).square().sum()
                per_rank.append(acc)
            s = torch.stack(per_rank)
            sq = s if sq is None else sq + s
        dist = sq.sqrt().cpu()
        telemetry.record_consensus_distance(float(dist.mean()),
                                            float(dist.max()))

    _async_on = False

    def _async_step_begin(self) -> None:
        """Async mode: publish this step on the step clock (staleness
        ages count against it; the trace tags carry it) and the
        ``bf_async_step_lag`` gauge, the freshest peer step seen less
        this one."""
        if self._async_on:
            W.set_async_step(self.step_count)
            telemetry.set_gauge("bf_async_step_lag",
                                float(W.async_step_lag()),
                                rank=str(basics.rank()))

    def _async_collect_due(self) -> bool:
        """True on the async mode's periodic exact collect across
        processes (``BLUEFOG_TPU_ASYNC_COLLECT_EVERY``): fence, fold the
        stale residuals, collect exactly; fast ranks wait here only."""
        if not self._async_on or W._store.distrib is None:
            return False
        every = config.get().async_collect_every
        return every > 0 and (self.step_count + 1) % every == 0


class DistributedWinPutOptimizer(_WindowOptimizerBase):
    """Push-style async optimizer: adapt locally, ``win_put`` the new
    parameters to the out-neighbors, combine the received ones with
    ``win_update`` (reference factory ``torch/optimizers.py:1271``).

    ``step(dst_weights=...)`` takes ``win_put``'s weight forms, anew each
    call.  ``shard_specs`` (one spec a leaf; ``leaf_shapes``: the leaves of
    a single flat parameter), ``shard_groups`` and ``num_shards`` arm
    sharded gossip (module docstring).  ``overlap=True`` issues the put and does not wait for it: the
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
                 fusion_buckets=None, shard_specs=None, shard_groups=None,
                 num_shards=None, leaf_shapes=None):
        self.overlap = bool(overlap)
        self._pending: List[int] = []
        super().__init__(base, window_prefix=window_prefix,
                         num_steps_per_communication=num_steps_per_communication,
                         fuse=fuse, layout=layout, fused=fused,
                         fusion_buckets=fusion_buckets,
                         shard_specs=shard_specs, shard_groups=shard_groups,
                         num_shards=num_shards, leaf_shapes=leaf_shapes)

    def combine(self, *, dst_weights=None,
                require_mutex: bool = True) -> None:
        """The second half of :meth:`step`: on communication steps the
        puts and ``win_update``; then the step counter's advance.  The
        async mode implies ``overlap``: a slow peer's wire never blocks the
        step."""
        self._async_step_begin()
        if self._communicates():
            self._drain_pending()
            payloads = self._payloads()
            overlap = self.overlap or self._async_on
            if overlap:
                payloads = [p.clone() for p in payloads]
            handles = [W.win_put_nonblocking(
                p, name, dst_weights=self._put_weights(name, dst_weights),
                require_mutex=require_mutex)
                for name, p in zip(self._names, payloads)]
            if overlap:
                # Wake the senders now: the queued gossip rides the wire
                # during the next forward and backward, not after the
                # linger.
                W.win_flush(wait=False)
                self._pending = handles
            else:
                self._wait_all(handles)
            combined = [W._update_rows(name, require_mutex=require_mutex,
                                       **self._update_kwargs(name))
                        for name in self._names]
            self._maybe_sample_consensus(payloads, combined)
            self._rebuild(combined)
        self.step_count += 1

    def _fused_step(self, *, dst_weights=None,
                    require_mutex: bool = True) -> bool:
        # (The async mode is not fused: its step clock stays the eager
        # combine's.)
        if not self._communicates():
            return False
        return self._fused_try_step(
            family="put", dst_weights=dst_weights,
            require_mutex=require_mutex)

    def _drain_pending(self) -> None:
        pending, self._pending = self._pending, []
        self._wait_all(pending)   # overlapped puts land first

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

    def combine(self, *, src_weights=None,
                require_mutex: bool = True) -> None:
        # Gets stay request and reply (a get asks now), but the step clock
        # is published, as in the JAX package.
        self._async_step_begin()
        if self._communicates():
            payloads = self._payloads()
            # The put with no edge only refreshes main (self_weight 1).
            self._wait_all([W.win_put_nonblocking(p, name, self_weight=1.0,
                                                  dst_weights={})
                            for name, p in zip(self._names, payloads)])
            self._wait_all([W.win_get_nonblocking(
                name, src_weights=src_weights, require_mutex=require_mutex)
                for name in self._names])
            combined = [W._update_rows(name, require_mutex=require_mutex)
                        for name in self._names]
            self._maybe_sample_consensus(payloads, combined)
            self._rebuild(combined)
        self.step_count += 1


class DistributedPushSumOptimizer(_WindowOptimizerBase):
    """Async push-sum gossip SGD (reference factory
    ``torch/optimizers.py:1180``).

    Every step: the local adapt, a column-stochastic ``win_accumulate`` of
    the parameters (each rank splits weight ``1/(outdeg+1)`` over itself
    and its out-neighbors), ``win_update_then_collect``; the associated P
    tracks the accumulated weight, so :meth:`debias` recovers the
    unbiased iterates.  Gradients should be taken at the de-biased
    parameters.

    Across processes the step's accumulates complete locally and the
    collect folds what has arrived; every ``auto_collect_rounds`` steps
    (0: never) the step fences the transport first, so that no process
    runs more than that many rounds ahead of a stalled peer and the share
    of a rank's P mass in flight stays bounded (the fence is a barrier:
    every process steps as often).  The async mode replaces that fence
    with the staleness policy and the periodic exact collect
    (``BLUEFOG_TPU_ASYNC_COLLECT_EVERY``): fence, fold the stale residuals,
    collect; ``backstops`` counts them and ``folded_edges`` lists the
    edges each folded."""

    _zero_init = True

    def __init__(self, base, *, window_prefix: str = "pushsum",
                 num_steps_per_communication: int = 1, fuse: bool = True,
                 layout: str = "auto", auto_collect_rounds: int = 8,
                 fused=None, fusion_buckets=None):
        W.turn_on_win_ops_with_associated_p()
        self.auto_collect_rounds = int(auto_collect_rounds)
        self.backstops = 0
        self.folded_edges: List[int] = []
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

    def combine(self, *, dst_weights=None,
                require_mutex: bool = True) -> None:
        """The accumulate and the collect, every step (the JAX package's
        push-sum ignores ``num_steps_per_communication`` here too)."""
        self._async_step_begin()
        if dst_weights is None:
            dst_weights = self._outgoing_weights()
        self_share = 1.0 / (self._out_degree() + 1.0)
        # self_weight applies after the edge sends, so the out-edges carry
        # w * p_old and each source's mass (self_share + sum_out w = 1) is
        # conserved: push-sum's column-stochastic invariant.
        fence_now = (not self._async_on and self.auto_collect_rounds > 0
                     and W._store.distrib is not None
                     and (self.step_count + 1)
                     % self.auto_collect_rounds == 0)
        backstop_now = self._async_collect_due()
        payloads = self._payloads()
        self._wait_all([W.win_accumulate_nonblocking(
            p, name, self_weight=self_share, dst_weights=dst_weights,
            require_mutex=require_mutex)
            for name, p in zip(self._names, payloads)])
        if fence_now or backstop_now:
            self._fence()
            if backstop_now:
                # After the fence nothing is in flight: the residuals
                # folded in, the collect below is exact.
                self.backstops += 1
                self.folded_edges.append(sum(
                    W.win_fold_stale_residuals(name)
                    for name in self._names))
        combined = [W._collect_rows(name, require_mutex=require_mutex)
                    for name in self._names]
        self._maybe_sample_consensus(payloads, combined)
        self._rebuild(combined)
        self.step_count += 1

    def _fused_step(self, *, dst_weights=None,
                    require_mutex: bool = True) -> bool:
        if dst_weights is None:
            dst_weights = self._outgoing_weights()
        fence_now = (not self._async_on and self.auto_collect_rounds > 0
                     and W._store.distrib is not None
                     and (self.step_count + 1)
                     % self.auto_collect_rounds == 0)
        backstop_now = self._async_collect_due()

        def pre_drain():
            # The eager step's fence and backstop, between the program and
            # the collect.
            if fence_now or backstop_now:
                self._fence()
                if backstop_now:
                    self.backstops += 1
                    self.folded_edges.append(sum(
                        W.win_fold_stale_residuals(name)
                        for name in self._names))
        return self._fused_try_step(
            family="pushsum", dst_weights=dst_weights,
            self_weight=1.0 / (self._out_degree() + 1.0),
            require_mutex=require_mutex, pre_drain=pre_drain)

    def collect(self, *, require_mutex: bool = True) -> None:
        """Fold every contribution still in the windows into the
        parameters (the reference's end-of-run collect); the gathered P
        then sums to ``n``."""
        W.win_fence()
        # The async mode's held-back mass too (a no-op outside it).
        for name in self._names:
            W.win_fold_stale_residuals(name)
        self._rebuild([W._collect_rows(name, require_mutex=require_mutex)
                       for name in self._names])

    def associated_p(self) -> np.ndarray:
        """The ``(n,)`` push-sum weights (the same in every window; 1.0 for
        ranks another process owns)."""
        return W.win_associated_p(self._names[0])

    def debias(self, params=None, *, p_min: float = 1e-3
               ) -> List[torch.Tensor]:
        """Each owned rank's row of ``params`` (default: the parameters)
        divided by its associated P, floored at ``p_min`` (a rank whose
        mass is almost all in flight would divide by ~0; a warning names
        the clipped ranks); new tensors, in the parameters' order.  In the
        rank layout across processes, the rows of other processes' ranks
        are divided by 1.0."""
        raw = np.asarray(self.associated_p())
        rank_of_row = np.arange(raw.shape[0])
        if self._layout == "owned":
            rank_of_row = np.asarray(self._owned, dtype=np.int64)
            raw = raw[rank_of_row]
        p = np.maximum(raw, p_min)
        clipped = np.nonzero(raw < p_min)[0]
        if clipped.size:
            get_logger().warning(
                "push-sum debias: associated-P below p_min=%g for rank(s) "
                "%s: most of their mass is in flight; the de-biased "
                "estimate is clipped (finite but biased); bound the "
                "staleness with collect()", p_min,
                rank_of_row[clipped].tolist())
        out = []
        for t in (self.params if params is None else params):
            shape = (-1,) + (1,) * (t.dim() - 1)
            out.append(t.detach() / torch.as_tensor(
                p, dtype=t.dtype, device=t.device).reshape(shape))
        return out
