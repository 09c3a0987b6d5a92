"""Per-step distributed-optimizer functions (the functional core).

The port of ``bluefog_tpu/optim/functional.py`` over rank-major tensors (in
one process every rank's row; with a ``transport``, an
``ops.p2p.ProcessRanks``, the rows of the ranks this process owns):

  AWC (adapt-with-combine): ``x_{t+1} = combine(x_t) + base_update(g_t)``
  ATC (adapt-then-combine): ``x_{t+1} = combine(x_t + base_update(g_t))``
  gradient allreduce:       ``x_{t+1} = x_t + base_update(allreduce(g_t))``

``base`` is a ``torch.optim.Optimizer`` over rank-major parameters (leading
dim ``n``): its update is elementwise, so one ``base.step()`` is every
rank's local step.  ``combine`` is the global average, static or dynamic
neighbor averaging (with an optional per-step ``(n, n)`` weight matrix),
or identity ("empty"); ``compress_combiner`` sends its payload compressed.
The combine updates the parameters in place, over column chunks of the
flat buffer, so its extra memory is a few chunk-sized temporaries rather
than copies of the whole parameter set; a combine that is elementwise
across columns changes no value by chunking.  The ``sparse:<frac>``
combine is not (its block is a share of the whole row and rotates over
it), so it runs on the whole row, or on the whole of each fusion bucket.

Fusion buckets (``fusion_buckets=k``) split the flat buffer into ``k``
byte-balanced runs of whole leaves, as ``_bucket_groups`` does there; each
bucket is combined on its own.  Without ``fusion_buckets``,
``BLUEFOG_TPU_FUSION_BUCKET_MB`` caps each bucket's bytes a rank instead
(0, the default: one bucket).  The leaves are the parameter tensors, or
the columns of a single flat buffer given by ``leaf_sizes``
(``RankReplicas.leaf_sizes``, the JAX ravel's leaves).

Sharded gossip (``shard_plan``, ``ops/sharded.py``): the replicated leaves
ride the fused path over the whole topology, and each rank's own slice of
every sharded leaf is gossiped over the plan's merged replica-group
schedule (:func:`make_shard_combiner`); the other coordinates' slices, the
rank's ghosts, are left as they are, bit for bit.  The slices are gathered
into one ``(rows, S)`` buffer (a leaf at a time where the combine is
elementwise over columns; every sharded leaf at once for ``sparse``, whose
block rotates over the whole buffer, as the JAX package's ravel of the
slices), combined, and scattered back: a copy in and a copy out of the
gossiped columns.  A slice along a leaf's leading dim (the MoE experts'
``E``) is a contiguous column range of the row; others are strided views.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, List, Optional, Sequence

import torch

from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops.p2p import ProcessRanks
from bluefog_tpu_torch.ops.schedule import DynamicSchedule, StaticSchedule

__all__ = ["CommunicationType", "make_combiner", "make_shard_combiner",
           "compress_combiner", "awc_step", "atc_step",
           "gradient_allreduce_step"]

# Columns per chunk of the in-place combine: 16M f32 columns is 64 MiB a row.
COMBINE_CHUNK = 1 << 24


class CommunicationType(enum.Enum):
    """The JAX package's communication types."""
    allreduce = "allreduce"
    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    hierarchical_gossip = "hierarchical.gossip"
    empty = "empty"


Combiner = Callable[..., torch.Tensor]  # (x, step, weights) -> x


def make_combiner(comm: CommunicationType, *,
                  sched: Optional[StaticSchedule] = None,
                  dyn_sched: Optional[DynamicSchedule] = None,
                  transport: Optional[ProcessRanks] = None,
                  local_size: Optional[int] = None,
                  hier: Optional[dict] = None) -> Combiner:
    """Build ``combine(x, step, weights)`` for a communication type.
    ``weights``: an optional ``(n, n)`` matrix that overrides the
    schedule's weights for this call (neighbor_allreduce only).
    ``transport``: the processes' ranks when ``x`` holds this process's
    rows only (``basics.process_ranks()``).  The hierarchical types take
    ``local_size`` (ranks a machine); ``hierarchical_neighbor_allreduce``
    takes ``sched`` or ``dyn_sched`` over the machines, and
    ``hierarchical_gossip`` the level bundle ``hier``: ``inner_sched``,
    ``outer_scheds``, ``outer_every``, ``outer_compression`` and
    ``outer_frac``."""
    def _no_weights(weights, what):
        if weights is not None:
            raise ValueError(
                f"per-step weight overrides are not supported for {what}; "
                "they apply to (dynamic) neighbor_allreduce only")

    if comm == CommunicationType.empty:
        def _empty(x, step=None, weights=None):
            _no_weights(weights, "CommunicationType.empty")
            return x
        _empty.is_identity = True
        return _empty
    if comm == CommunicationType.allreduce:
        def _ar(x, step=None, weights=None):
            _no_weights(weights, "CommunicationType.allreduce")
            return C.allreduce(x, comm=transport)
        _ar.is_allreduce = True  # replica-identical: compress without residual
        return _ar
    if comm == CommunicationType.neighbor_allreduce:
        if dyn_sched is not None:
            def _dyn(x, step, weights=None):
                phase = dyn_sched.phases[int(step) % dyn_sched.period]
                if weights is None:
                    return C.neighbor_allreduce(x, phase, comm=transport)
                # The step's phase, its active edges weighted from the
                # matrix.
                return C.neighbor_allreduce_matrix(x, weights, phase,
                                                   comm=transport)
            # Lets compress_combiner run the rotating-block sparse exchange
            # over the same phases.
            _dyn._sparse_dyn_sched = dyn_sched
            _dyn._transport = transport
            return _dyn
        if sched is None:
            raise ValueError("static neighbor_allreduce needs a schedule")

        def _nbr(x, step=None, weights=None):
            if weights is None:
                return C.neighbor_allreduce(x, sched, comm=transport)
            return C.neighbor_allreduce_matrix(x, weights, sched,
                                               comm=transport)
        _nbr._sparse_sched = sched
        _nbr._transport = transport
        return _nbr
    if comm == CommunicationType.hierarchical_gossip:
        if local_size is None or hier is None:
            raise ValueError("hierarchical gossip needs local_size and the "
                             "compiled level bundle (hier=)")

        def _hgossip(x, step, weights=None):
            _no_weights(weights, "hierarchical_gossip")
            return C.hierarchical_gossip(
                x, step, hier["inner_sched"], hier["outer_scheds"],
                local_size, outer_every=hier.get("outer_every", 1),
                outer_compression=hier.get("outer_compression", "none"),
                outer_frac=hier.get("outer_frac"), comm=transport)
        # The sparse outer block is a share of the whole row.
        _hgossip.whole_row = str(hier.get("outer_compression", "none")
                                 ).startswith("sparse")
        return _hgossip
    if comm == CommunicationType.hierarchical_neighbor_allreduce:
        if local_size is None:
            raise ValueError("the hierarchical combine needs local_size")
        if dyn_sched is not None:
            def _hdyn(x, step, weights=None):
                _no_weights(weights, "hierarchical_neighbor_allreduce")
                return C.dynamic_hierarchical_neighbor_allreduce(
                    x, step, dyn_sched, local_size, comm=transport)
            return _hdyn
        if sched is None:
            raise ValueError("static hierarchical_neighbor_allreduce needs "
                             "a machine schedule")

        def _hier(x, step=None, weights=None):
            _no_weights(weights, "hierarchical_neighbor_allreduce")
            return C.hierarchical_neighbor_allreduce(x, sched, local_size,
                                                     comm=transport)
        return _hier
    raise ValueError(f"unknown communication type {comm}")


def make_shard_combiner(plan, group_combine: Combiner, *,
                        ranks: Optional[Sequence[int]] = None):
    """The combiner of a plan's sharded leaves (the JAX package's
    ``make_shard_combiner``): ``group_combine`` is a combiner over the
    plan's merged replica-group schedule (``make_combiner`` output,
    optionally ``compress_combiner``-wrapped), whose in-group edges keep
    the sharded bytes inside their groups.  ``ranks``: the ranks of the
    rows given (default every rank; across processes, the owned ones).

    The result, ``shard_combine(flat, starts, shapes, step)``, works in
    place on a rank-major ``(rows, P)`` buffer whose leaf ``i`` takes
    columns ``starts[i]:`` of per-rank shape ``shapes[i]``: each row's own
    slice of every sharded leaf (coordinate ``plan.coords[rank]`` along
    the leaf's sharded model dim) is gathered, combined and written back;
    the ghost slices are not touched."""
    rows = list(range(plan.n)) if ranks is None else [int(r) for r in ranks]
    coords = [plan.coords[r] for r in rows]
    sh_idx = [i for i, m in enumerate(plan.mask) if m]
    whole = getattr(group_combine, "whole_row", False)

    def own_slices(flat, starts, shapes, i):
        shape, d = tuple(shapes[i]), plan.dims[i]
        chunk = shape[d] // plan.n_shards
        leaf = flat[:, starts[i]:starts[i] + math.prod(shape)]
        return [leaf[j].view(shape).narrow(d, c * chunk, chunk)
                for j, c in enumerate(coords)]

    def shard_combine(flat, starts, shapes, step=None):
        fn = lambda x: group_combine(x, step=step, weights=None)  # noqa: E731
        for grp in ([sh_idx] if whole else [[i] for i in sh_idx]):
            views = [own_slices(flat, starts, shapes, i) for i in grp]
            width = sum(v[0].numel() for v in views)
            buf = flat.new_empty((len(rows), width))
            for j in range(len(rows)):
                off = 0
                for v in views:
                    k = v[j].numel()
                    buf[j, off:off + k].view(v[j].shape).copy_(v[j])
                    off += k
            for cols in buf.split(buf.shape[1] if whole else COMBINE_CHUNK,
                                  dim=1):
                cols.copy_(fn(cols))
            for j in range(len(rows)):
                off = 0
                for v in views:
                    k = v[j].numel()
                    v[j].copy_(buf[j, off:off + k].view(v[j].shape))
                    off += k
    return shard_combine


def _bucket_groups(nbytes: Sequence[int],
                   fusion_buckets: Optional[int]) -> List[List[int]]:
    """Partition leaf indices (``nbytes``: each leaf's bytes a rank, in
    ravel order) into contiguous fusion buckets, as
    ``bluefog_tpu.optim.functional._bucket_groups``: with
    ``fusion_buckets`` at most that many, each closed once the running
    total crosses its share of the bytes (count mode); else runs capped at
    ``BLUEFOG_TPU_FUSION_BUCKET_MB`` MiB (MB mode: a leaf larger than the
    cap is a bucket of its own), one bucket when the cap is 0."""
    if fusion_buckets is None:
        from bluefog_tpu_torch.utils import config
        cap = config.get().fusion_bucket_mb * (1 << 20)
        if cap <= 0:
            return [list(range(len(nbytes)))]
        groups, cur, cur_bytes = [], [], 0
        for i, nb in enumerate(nbytes):
            if cur and cur_bytes + nb > cap:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
        if cur:
            groups.append(cur)
        return groups
    total = sum(nbytes)
    k = max(1, min(int(fusion_buckets), len(nbytes)))
    if k == 1:
        return [list(range(len(nbytes)))]
    groups, cur, cum, b = [], [], 0, 1
    for i, nb in enumerate(nbytes):
        cur.append(i)
        cum += nb
        if cum * k >= b * total and b < k:
            groups.append(cur)
            cur, b = [], b + 1
    if cur:
        groups.append(cur)
    return groups


def _fused_apply(fn, params: List[torch.Tensor],
                 chunk: Optional[int] = COMBINE_CHUNK,
                 fusion_buckets: Optional[int] = None,
                 leaf_sizes: Optional[Sequence[int]] = None) -> None:
    """Apply ``fn`` (rank-major ``(n, m)`` -> ``(n, m)``) to the parameters
    as one flat buffer, in place: on each fusion bucket's columns, and
    within a bucket ``chunk`` columns at a time (None: the whole bucket at
    once).  A single contiguous rank-major tensor is its own buffer;
    several are raveled into one and written back.  ``leaf_sizes``: the
    columns of each leaf of the buffer (default: each tensor a leaf)."""
    n = params[0].shape[0]
    if len(params) == 1 and params[0].is_contiguous():
        flat = params[0].view(n, -1)
    else:
        flat = torch.cat([p.reshape(n, -1) for p in params], dim=1)
    sizes = (list(leaf_sizes) if leaf_sizes is not None
             else [p[0].numel() for p in params])
    if sum(sizes) != flat.shape[1]:
        raise ValueError(f"leaf_sizes cover {sum(sizes)} columns, the "
                         f"parameters {flat.shape[1]}")
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + size)
    for grp in _bucket_groups([size * flat.element_size() for size in sizes],
                              fusion_buckets):
        bucket = flat[:, starts[grp[0]]:starts[grp[-1] + 1]]
        for cols in bucket.split(chunk or bucket.shape[1], dim=1):
            cols.copy_(fn(cols))
    if flat.data_ptr() != params[0].data_ptr():
        off = 0
        for p in params:
            size = p[0].numel()
            p.copy_(flat[:, off:off + size].view(p.shape))
            off += size


def _apply_columns(fn, flat: torch.Tensor, ranges, whole_row: bool) -> None:
    """``fn`` on the columns ``ranges`` (``[(start, stop), ...]``, in
    order) of the rank-major ``flat``, in place: as one buffer, gathered
    when the ranges are not adjacent, for a ``whole_row`` combine; else a
    run of adjacent ranges at a time, ``COMBINE_CHUNK`` columns at once."""
    runs: List[list] = []
    for a, b in ranges:
        if runs and runs[-1][1] == a:
            runs[-1][1] = b
        else:
            runs.append([a, b])
    if whole_row and len(runs) > 1:
        out = fn(torch.cat([flat[:, a:b] for a, b in runs], dim=1))
        off = 0
        for a, b in runs:
            flat[:, a:b].copy_(out[:, off:off + b - a])
            off += b - a
        return
    for a, b in runs:
        run = flat[:, a:b]
        for cols in run.split(run.shape[1] if whole_row else COMBINE_CHUNK,
                              dim=1):
            cols.copy_(fn(cols))


def _sharded_combine(params: List[torch.Tensor], fn, combine: Combiner,
                     fuse: bool, fusion_buckets: Optional[int],
                     leaf_shapes: Optional[Sequence[Sequence[int]]],
                     plan, shard_combine, step: int) -> None:
    """The JAX package's sharded ``_tree_combine``: the replicated leaves
    through ``fn`` (fused: a fusion bucket at a time), then the sharded
    ones through ``shard_combine``; the leaves are the columns of the
    parameters as one flat buffer."""
    n = params[0].shape[0]
    if len(params) == 1 and params[0].is_contiguous():
        flat = params[0].view(n, -1)
    else:
        flat = torch.cat([p.reshape(n, -1) for p in params], dim=1)
    shapes = ([tuple(s) for s in leaf_shapes] if leaf_shapes is not None
              else [tuple(p.shape[1:]) for p in params])
    starts = [0]
    for shape in shapes:
        starts.append(starts[-1] + math.prod(shape))
    if starts[-1] != flat.shape[1] or len(shapes) != len(plan.mask):
        raise ValueError(f"the plan's {len(plan.mask)} leaves of "
                         f"{starts[-1]} columns do not lay out the "
                         f"parameters' {flat.shape[1]}")
    rep_idx = [i for i, m in enumerate(plan.mask) if not m]
    whole = getattr(combine, "whole_row", False)
    if rep_idx and not getattr(combine, "is_identity", False):
        if fuse:
            nbytes = [math.prod(shapes[i]) * flat.element_size()
                      for i in rep_idx]
            for grp in _bucket_groups(nbytes, fusion_buckets):
                _apply_columns(fn, flat, [(starts[rep_idx[j]],
                                           starts[rep_idx[j] + 1])
                                          for j in grp], whole)
        else:
            for i in rep_idx:
                cols = flat[:, starts[i]:starts[i + 1]]
                cols.copy_(fn(cols))
    shard_combine(flat, starts, shapes, step)
    if flat.data_ptr() != params[0].data_ptr():
        off = 0
        for p in params:
            size = p[0].numel()
            p.copy_(flat[:, off:off + size].view(p.shape))
            off += size


@torch.no_grad()
def _tree_combine(params: List[torch.Tensor], combine: Combiner, step: int,
                  steps_per_comm: int = 1, fuse: bool = True,
                  weights=None, fusion_buckets: Optional[int] = None,
                  leaf_sizes: Optional[Sequence[int]] = None,
                  shard_plan=None, shard_combine=None,
                  leaf_shapes: Optional[Sequence[Sequence[int]]] = None
                  ) -> None:
    """Apply ``combine`` to the rank-major parameters in place, skipping
    steps where ``step % steps_per_comm != 0`` (local aggregation).
    ``fuse=True`` combines one flat buffer (or one per fusion bucket), as
    the JAX package's ravel; ``fuse=False`` combines each tensor on its
    own.  With a ``shard_plan`` that shards some leaf (and its
    ``shard_combine``, :func:`make_shard_combiner`), the replicated leaves
    take ``combine`` and the sharded ones ``shard_combine``; the leaves are
    ``leaf_shapes`` (per-rank shapes of a flat buffer's columns) or the
    parameters.  Without one, this is the replicated path, bit for bit."""
    if step % steps_per_comm:
        return
    fn = lambda x: combine(x, step=step, weights=weights)  # noqa: E731
    if (shard_plan is not None and shard_combine is not None
            and shard_plan.any_sharded):
        _sharded_combine(params, fn, combine, fuse, fusion_buckets,
                         leaf_shapes, shard_plan, shard_combine, step)
        return
    if getattr(combine, "is_identity", False):
        return
    if fuse:
        _fused_apply(fn, params, None if getattr(combine, "whole_row", False)
                     else COMBINE_CHUNK, fusion_buckets, leaf_sizes)
    else:
        for p in params:
            p.copy_(fn(p))


def _sparse_fraction(compression: str) -> float:
    if compression.startswith("topk"):
        raise ValueError(
            "magnitude-only top-k gossip does not converge under the "
            "stateless per-round residual (never-picked coordinates "
            "stay unmixed forever); use compression='sparse:<frac>' — "
            "a step-rotating aligned block that sweeps every "
            "coordinate and reaches EXACT consensus")
    if ":" not in compression:
        raise ValueError(
            f"malformed {compression!r}: use 'sparse:<frac>' "
            "(e.g. 'sparse:0.25')")
    try:
        frac = float(compression.split(":", 1)[1])
    except ValueError:
        raise ValueError(
            f"malformed {compression!r}: the fraction must be a "
            "float in (0, 1], e.g. 'sparse:0.25'") from None
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"sparse fraction must be in (0, 1], got {frac}")
    return frac


def compress_combiner(combine: Combiner, compression: str, *,
                      residual: bool = True,
                      steps_per_comm: int = 1) -> Combiner:
    """Wrap a combiner so that its payload is sent compressed, as
    ``bluefog_tpu.optim.functional.compress_combiner``.

    ``"bf16"`` combines the bfloat16 cast of the parameters and casts the
    result back; with ``residual`` (the parameter-consensus orders) it adds
    back each rank's own rounding ``x - q(x)``, so a rank's float32 master
    weights are never truncated by its own round trip.  ``residual=False``
    keeps an allreduce replica-identical.

    ``"sparse:<frac>"`` sends ``kk = ceil(frac * P)`` entries of each rank's
    ``P``-column row per round: a block of consecutive columns, the same on
    every rank, that starts at ``(round * kk) % P`` and wraps around the
    row, where ``round = step // steps_per_comm`` counts the combines.  The
    residual ``x - q`` keeps the unsent columns as they are.  The block is a
    share of the whole row, so the wrapped combine is marked ``whole_row``
    and takes the row unchunked; the columns must be in the JAX package's
    ravel order (``models.convert.jax_ravel_order``) for the block to cover
    the same parameters as there.  ``"none"`` returns ``combine``."""
    if compression in (None, "none"):
        return combine
    if isinstance(compression, str) and compression.startswith(("sparse",
                                                                "topk")):
        frac = _sparse_fraction(compression)
        if getattr(combine, "is_identity", False):
            return combine  # empty communication: string validated above
        sched = getattr(combine, "_sparse_sched", None)
        dyn_sched = getattr(combine, "_sparse_dyn_sched", None)
        transport = getattr(combine, "_transport", None)
        if sched is None and dyn_sched is None:
            raise ValueError(
                "compression='sparse:<frac>' needs a (static or dynamic) "
                "neighbor_allreduce combiner (the sparse exchange rides "
                "the compiled edge schedule); use 'bf16' for the other "
                "communication types")
        if not residual:
            raise ValueError(
                "sparse compression requires residual error feedback "
                "(decentralized orders); it cannot keep an allreduce "
                "replica-identical")

        def wrapped_sparse(x, step=None, weights=None):
            if weights is not None:
                raise ValueError(
                    "per-step weight overrides are not supported under "
                    "sparse compression (weights are baked into the "
                    "sparse schedule)")
            size = x[0].numel()
            kk = max(1, math.ceil(frac * size))
            rnd_idx = (0 if step is None else int(step)) // max(
                1, int(steps_per_comm))
            rot = (torch.arange(kk, device=x.device) + rnd_idx * kk) % size
            if sched is not None:
                out, q = C.sparse_neighbor_allreduce(
                    x, sched, indices=rot, return_sent=True, comm=transport)
            else:
                out, q = C.dynamic_sparse_neighbor_allreduce(
                    x, 0 if step is None else step, dyn_sched, indices=rot,
                    return_sent=True, comm=transport)
            return out + (x - q)
        wrapped_sparse.whole_row = True
        return wrapped_sparse
    if compression != "bf16":
        raise ValueError(f"unknown compression {compression!r}; "
                         "expected 'none', 'bf16' or 'sparse:<frac>'")
    if getattr(combine, "is_identity", False):
        return combine  # keep _tree_combine's identity fast path

    def wrapped(x, **kw):
        q = x.to(torch.bfloat16)
        out = combine(q, **kw).to(x.dtype)
        if residual:
            out = out + (x - q.to(x.dtype))
        return out
    return wrapped


def awc_step(base: torch.optim.Optimizer, combine: Combiner,
             params: List[torch.Tensor], step: int, *,
             steps_per_comm: int = 1, fuse: bool = True, weights=None,
             fusion_buckets: Optional[int] = None,
             leaf_sizes: Optional[Sequence[int]] = None, shard_plan=None,
             shard_combine=None, leaf_shapes=None) -> int:
    """Adapt-with-combine: combine the parameters, then apply the base
    update to the combined values.  Returns the next step counter."""
    _tree_combine(params, combine, step, steps_per_comm, fuse, weights,
                  fusion_buckets, leaf_sizes, shard_plan, shard_combine,
                  leaf_shapes)
    base.step()
    return step + 1


def atc_step(base: torch.optim.Optimizer, combine: Combiner,
             params: List[torch.Tensor], step: int, *,
             steps_per_comm: int = 1, fuse: bool = True, weights=None,
             fusion_buckets: Optional[int] = None,
             leaf_sizes: Optional[Sequence[int]] = None, shard_plan=None,
             shard_combine=None, leaf_shapes=None) -> int:
    """Adapt-then-combine: local base update first, then combine.
    Returns the next step counter."""
    base.step()
    _tree_combine(params, combine, step, steps_per_comm, fuse, weights,
                  fusion_buckets, leaf_sizes, shard_plan, shard_combine,
                  leaf_shapes)
    return step + 1


@torch.no_grad()
def gradient_allreduce_step(base: torch.optim.Optimizer,
                            params: List[torch.Tensor], step: int, *,
                            acc: Optional[List[torch.Tensor]] = None,
                            steps_per_comm: int = 1,
                            compression: str = "none", fuse: bool = True,
                            fusion_buckets: Optional[int] = None,
                            leaf_sizes: Optional[Sequence[int]] = None,
                            transport: Optional[ProcessRanks] = None):
    """Synchronous gradient averaging (Horovod's order): every rank's
    ``param.grad`` becomes the rank mean, in place, then ``base.step()``;
    every rank applies the same update, so replicas that start equal stay
    equal bit for bit.  Returns ``(step + 1, acc)``.

    With ``steps_per_comm`` J > 1 the gradients add into ``acc`` (a list
    of zeros like the gradients, made on the first call when None), and
    only on steps where ``(step + 1) % J == 0`` is the J-step sum averaged,
    written into ``param.grad`` and applied, and ``acc`` zeroed; on the
    other steps the base optimizer does not run.  (The parameter-consensus
    orders communicate where ``step % J == 0``.)

    Compression is ``compress_combiner(..., residual=False)``: under
    ``bf16`` the average is of the bfloat16 gradients.  ``fuse`` averages
    the gradients as one buffer (per fusion bucket); a mixed-dtype set
    stays per tensor, as in the JAX package."""
    one = compress_combiner(lambda x, **kw: C.allreduce(x, comm=transport),
                            compression,
                            residual=False)
    grads = [p.grad for p in params]
    uniform_dtype = len({g.dtype for g in grads}) <= 1

    def comm(gs):
        if fuse and uniform_dtype:
            _fused_apply(one, gs, COMBINE_CHUNK, fusion_buckets, leaf_sizes)
        else:
            for g in gs:
                g.copy_(one(g))

    if steps_per_comm == 1:
        comm(grads)
        base.step()
        return step + 1, acc
    if acc is None:
        acc = [torch.zeros_like(g) for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g)
    if (step + 1) % steps_per_comm == 0:
        comm(acc)
        for g, a in zip(grads, acc):
            g.copy_(a)
            a.zero_()
        base.step()
    return step + 1, acc
