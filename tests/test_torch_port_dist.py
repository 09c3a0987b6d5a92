"""The port's multi-process transport against its single-process path.

Gloo process groups on the CPU: 4 processes of one rank each (``bfrun``'s
``BFTPU_*`` rendezvous) and 2 processes of two ranks each (``torchrun``'s
``env://`` rendezvous, ``BFTPU_LOCAL_DEVICES=2``).  Every process runs
:func:`scenario` under ``basics.init_distributed``; this process runs the
same scenario under ``basics.init`` with every rank in it, and the owned rows
of each process, put together, must equal the single-process results:

- the neighbor collectives, the sparse exchange and the dense collectives
  bit for bit in float32, their nonblocking handles too; ``allreduce``, and
  ``local_allreduce`` over groups that span processes, within float32
  rounding (1e-6): each process sums its rows in rank order and
  ``dist.all_reduce`` adds the processes' sums in its own order, the same
  bits on every process;
- 3-step trajectories of ``benchmark.Trainer`` (ATC over the dynamic
  topology, also under ``sparse:0.25``) within 1e-6, and of gradient
  allreduce with fusion buckets within 1e-6 absolute and relative;
- ring and Ulysses attention over point-to-point rotation and all-to-all,
  forward and gradients, within 1e-6 of the rank-major form;
- the pipeline schedules (GPipe, 1F1B, interleaved ZB-H1) with a stage a
  rank, their hops through ``ProcessRanks.rotate``: bit for bit the
  rank-major run;
- the tensor-parallel LM with a shard a rank (GQA with 2 kv heads, so the
  kv shards are gathered across processes) and ``moe_apply`` with an expert
  a rank: the logits, the loss and the replicated parameters' gradients, and
  the MoE output, within 1e-6 and the same on every process; the shards'
  and experts' gradients within 1e-6;
- 3 ATC steps of dp (the world's ranks, across processes) x tp 2
  (rank-major in each process) within 1e-6;
- the hierarchical family over machines of 2 ranks (one a process in
  2 x 2, one across two processes in 4 x 1): ``hierarchical_gossip`` (each
  outer codec) bit for bit, the hierarchical neighbor allreduce within 1e-6
  (its local sums by ``dist.all_reduce`` when a machine spans processes),
  and bit for bit through ``bf.hierarchical_neighbor_allreduce`` with a
  machine a process.

The single-process path is held to the JAX package in the other
``test_torch_port_*`` files.  Run as a script, this file is the worker.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N = 4                    # ranks in every layout
SEED = 0
JOIN_TIMEOUT = 120       # seconds a process group may take before it fails

LAYOUTS = {"4x1": (4, 1, "bfrun"), "2x2": (2, 2, "torchrun")}

TRAINER = ["--model", "transformer", "--flash-attention", "--num-layers", "1",
           "--embed-dim", "32", "--num-heads", "2", "--seq-len", "16",
           "--batch-size", "2", "--vocab-size", "64", "--ranks", str(N),
           "--momentum", "0.9", "--num-warmup-batches", "1", "--num-iters",
           "1", "--num-batches-per-iter", "2", "--device", "cpu", "--seed",
           str(SEED)]

# Results compared bit for bit; the rest within 1e-6.
BITWISE = ["neighbor_allreduce", "neighbor_allreduce_override",
           "neighbor_allreduce_weighted", "dynamic_neighbor_allreduce",
           "neighbor_allreduce_matrix", "neighbor_allgather",
           "neighbor_allgather_v", "pair_gossip", "sparse_topk",
           "sparse_aligned", "sparse_dynamic",
           "local_allreduce", "broadcast", "broadcast_parameters",
           "allgather", "allgather_v",
           "nonblocking_neighbor_allreduce", "nonblocking_dynamic",
           "nonblocking_neighbor_allgather", "nonblocking_pair_gossip",
           "nonblocking_broadcast", "nonblocking_allgather",
           "nonblocking_local_allreduce", "pp_gpipe", "pp_1f1b",
           "pp_zb_interleaved", "hier_bf", "hier_gossip_none",
           "hier_gossip_bf16", "hier_gossip_sparse"]
# Sums over the processes by ``dist.all_reduce``: within 1e-6, and the
# same on every rank.
ALL_REDUCE = ["allreduce", "allreduce_sum", "nonblocking_allreduce",
              "local_allreduce_world", "tp_replicated", "moe_ep"]
CLOSE = ["atc_flat", "atc_sparse_flat", "gradient_allreduce_flat",
         "ring_causal", "ring_noncausal", "ulysses_causal",
         "ulysses_noncausal", "tp_shard_grads", "moe_ep_grads",
         "dp_tp_atc_flat", "hier_static", "hier_dynamic"]
# Gradient allreduce sums by ``dist.all_reduce`` (3 steps, values up to ~5):
# also within 1e-6 relative.
CLOSE_RTOL = {"gradient_allreduce_flat": 1e-6}


def scenario(bf) -> dict:
    """Every op on the same seeded inputs; returns ``{name: owned rows}``
    (a rank-major tensor, or a list with one entry an owned rank) and
    ``{name: value}`` of whole-world scalars under ``"scalars"``."""
    from bluefog_tpu_torch import basics, benchmark
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.parallel.ring_attention import ring_attention
    from bluefog_tpu_torch.parallel.ulysses import ulysses_attention
    from bluefog_tpu_torch.replicas import RankReplicas

    n, own = bf.size(), bf.owned_ranks()
    rows = slice(own[0], own[-1] + 1)
    comm = bf.process_ranks()
    rng = np.random.RandomState(SEED)
    world = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(n, *s).astype(np.float32))
    x = world(3, 5)[rows]
    out, handles = {}, {}
    out["neighbor_allreduce"] = bf.neighbor_allreduce(x)
    w = np.abs(rng.randn(n, n)) / n
    out["neighbor_allreduce_override"] = bf.neighbor_allreduce(
        x, self_weight=0.3, src_weights=w)
    period = len(topo.dynamic_phase_table(bf.load_topology()))
    y = x
    for step in range(period + 1):
        y = bf.dynamic_neighbor_allreduce(y, step)
    out["dynamic_neighbor_allreduce"] = y
    out["neighbor_allreduce_matrix"] = C.neighbor_allreduce_matrix(
        x, w, basics.static_schedule(), comm=comm)
    out["neighbor_allgather"] = bf.neighbor_allgather(x)
    lengths = [1, 3, 0, 2]
    ragged = [torch.from_numpy(rng.randn(d, 5).astype(np.float32))
              for d in lengths]
    out["neighbor_allgather_v"] = bf.neighbor_allgather_v(ragged[rows])
    out["allgather_v"] = bf.allgather_v(ragged[rows])
    pairs = [1, 0, 3, 2]
    out["pair_gossip"] = bf.pair_gossip(x, pairs, self_weight=0.3,
                                        target_weight=0.7)
    sched = basics.static_schedule()
    dyn = basics.dynamic_schedule()
    flat = world(40)[rows]
    block = torch.arange(7, 17)
    out["sparse_topk"] = torch.cat(C.sparse_neighbor_allreduce(
        flat, sched, k=6, return_sent=True, comm=comm), 1)
    out["sparse_aligned"] = C.sparse_neighbor_allreduce(
        flat, sched, indices=block, aligned=True, comm=comm)
    out["sparse_dynamic"] = torch.cat(C.dynamic_sparse_neighbor_allreduce(
        flat, 1, dyn, indices=block, return_sent=True, comm=comm), 1)
    out["allreduce"] = bf.allreduce(x)
    out["allreduce_sum"] = bf.allreduce(x, average=False)
    out["local_allreduce"] = bf.local_allreduce(x)
    out["local_allreduce_world"] = C.local_allreduce(x, n, comm=comm)
    out["broadcast"] = bf.broadcast(x, 2)
    out["broadcast_parameters"] = bf.broadcast_parameters(
        {"a": x, "b": [x * 2]}, root_rank=1)["b"][0]
    out["allgather"] = bf.allgather(x)
    handles["nonblocking_allreduce"] = bf.allreduce_nonblocking(x)
    handles["nonblocking_neighbor_allreduce"] = \
        bf.neighbor_allreduce_nonblocking(x)
    handles["nonblocking_dynamic"] = \
        bf.dynamic_neighbor_allreduce_nonblocking(x, 1)
    handles["nonblocking_neighbor_allgather"] = \
        bf.neighbor_allgather_nonblocking(x)
    handles["nonblocking_pair_gossip"] = bf.pair_gossip_nonblocking(x, pairs)
    handles["nonblocking_broadcast"] = bf.broadcast_nonblocking(x, 3)
    handles["nonblocking_allgather"] = bf.allgather_nonblocking(x)
    handles["nonblocking_local_allreduce"] = \
        bf.local_allreduce_nonblocking(x)
    polled = [bf.poll(h) for h in handles.values()]
    for name, h in handles.items():
        out[name] = (bf.synchronize(h) if name.endswith("allgather")
                     else bf.wait(h))
    # A finished handle polls true and waits again to the same result.
    assert all(bf.poll(h) for h in handles.values())
    assert torch.equal(bf.wait(handles["nonblocking_allreduce"]),
                       out["nonblocking_allreduce"])

    bf.set_topology(topo.RingGraph(n), is_weighted=True)
    out["neighbor_allreduce_weighted"] = bf.neighbor_allreduce(x)
    out.update(_hierarchical(bf, x, flat, comm))

    scalars = {"polled": [bool(p) for p in polled]}
    for name, extra in (("atc", []), ("atc_sparse",
                                       ["--compression", "sparse:0.25"])):
        args = benchmark.build_parser().parse_args(
            TRAINER + ["--atc", "--dynamic"] + extra)
        bf.set_topology()
        tr = benchmark.Trainer(args)
        res = benchmark.measure(args, tr, quiet=True)
        out[f"{name}_flat"] = tr.rep.flat.detach().clone()
        scalars[f"{name}_spread"] = res["spread"]
        scalars[f"{name}_steps"] = res["steps"]

    from bluefog_tpu_torch.models import MLP
    gen = torch.Generator().manual_seed(SEED)
    rep = RankReplicas(lambda: MLP(6, (8, 8), num_classes=3), len(own),
                       "cpu")
    with torch.no_grad():
        rep.flat.copy_(torch.randn(1, rep.numel, generator=gen))
    opt = O.DistributedGradientAllreduceOptimizer(
        torch.optim.SGD([rep.flat], lr=0.1), fusion_buckets=2,
        leaf_sizes=rep.leaf_sizes)
    data = world(3, 6)[rows]
    for _ in range(3):
        rep.zero_grad()
        for r, mod in enumerate(rep.modules):
            mod(data[r]).square().mean().backward()
        opt.step()
    out["gradient_allreduce_flat"] = rep.flat.detach().clone()

    axis = comm if comm is not None else n
    B, S, H, D = 2, 8, 4, 16
    for fname, fn in (("ring", ring_attention), ("ulysses",
                                                 ulysses_attention)):
        for causal in (True, False):
            qkv = [world(B, S, H, D)[rows].reshape(-1, S, H, D)
                   .requires_grad_() for _ in range(3)]
            cot = world(B, S, H, D)[rows].reshape(-1, S, H, D)
            o = fn(*qkv, axis=axis, causal=causal)
            grads = torch.autograd.grad((o * cot).sum(), qkv)
            name = f"{fname}_{'causal' if causal else 'noncausal'}"
            out[name] = torch.cat([o.detach()] + list(grads), 1).reshape(
                len(own), -1)
    out.update(_model_parallel(n, rows, axis))
    out["scalars"] = scalars
    return out


def _hierarchical(bf, x, flat, comm) -> dict:
    """The hierarchical family over machines of 2 ranks, and through the
    context's machines (a process's ranks, or all in one process)."""
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import schedule as S
    n, L = bf.size(), 2
    out = {"hier_bf": bf.hierarchical_neighbor_allreduce(x)
           if bf.machine_size() > 1 else x}
    msched = S.compile_static(topo.RingGraph(n // L), use_topo_weights=False)
    out["hier_static"] = C.hierarchical_neighbor_allreduce(x, msched, L,
                                                           comm=comm)
    mdyn = S.compile_dynamic(topo.dynamic_phase_table(
        topo.ExponentialGraph(n // L)), n // L)
    out["hier_dynamic"] = C.dynamic_hierarchical_neighbor_allreduce(
        x, 1, mdyn, L, comm=comm)
    ht = topo.hierarchical_two_level(n, n // L)
    inner = S.compile_static(ht.inner, use_topo_weights=True)
    outer = tuple(S._schedule_from_matrix(ht.outer_slice_matrix(p))
                  for p in range(len(ht.outer_phases)))
    for comp, frac in (("none", None), ("bf16", None), ("sparse", 0.25)):
        y = flat
        for step in range(3):
            y = C.hierarchical_gossip(y, step, inner, outer, L,
                                      outer_every=2, outer_compression=comp,
                                      outer_frac=frac, comm=comm)
        out[f"hier_gossip_{comp}"] = y
    return out


def _model_parallel(n, rows, axis) -> dict:
    """Pipeline, tensor and expert parallelism over the world's ranks
    (``axis``: the transport, or the world's size in one process), and dp
    over the ranks x tp 2 rank-major; each result as the owned ranks'
    rows."""
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.parallel import moe as MO
    from bluefog_tpu_torch.parallel import pipeline as PP
    from bluefog_tpu_torch.parallel import tensor_parallel as TPL
    from bluefog_tpu_torch.replicas import RankReplicas

    m = rows.stop - rows.start
    rng = np.random.RandomState(SEED + 1)
    draw = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32))
    out = {}
    each = lambda *ts: torch.cat([t.reshape(m, -1) for t in ts], 1)  # noqa
    rep = lambda t: t.reshape(1, -1).expand(m, -1)  # noqa: E731

    def stage(p, x):
        return torch.tanh(x @ p[0] + p[1])

    def mse(y, t):
        return ((y - t) ** 2).mean()
    M, d = 6, 5
    x, tgt = draw(M, 2, d), draw(M, 2, d)
    W = (draw(n, d, d) * 0.5)[rows].requires_grad_()
    b = (draw(n, d) * 0.1)[rows].requires_grad_()
    y = PP.pipeline_apply(stage, (W, b), x, axis=axis)
    gW, gb = torch.autograd.grad((y ** 2).sum(), (W, b))
    out["pp_gpipe"] = torch.cat([rep(y.detach()), each(gW, gb)], 1)
    loss, (gW, gb) = PP.pipeline_train_step(stage, (W, b), x, tgt, mse,
                                            axis=axis)
    out["pp_1f1b"] = torch.cat([rep(loss), each(gW, gb)], 1)
    Wc = (draw(n, 2, d, d) * 0.4)[rows]
    bc = (draw(n, 2, d) * 0.1)[rows]
    loss, (gW, gb) = PP.pipeline_train_step_interleaved(
        stage, (Wc, bc), x, tgt, mse, axis=axis, split_backward=True)
    out["pp_zb_interleaved"] = torch.cat([rep(loss), each(gW, gb)], 1)

    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=4,
                            num_kv_heads=2, embed_dim=32, max_seq_len=8,
                            mlp="swiglu", dtype=torch.float32)
    full = TransformerLM(cfg)
    full.reset_parameters(torch.Generator().manual_seed(SEED))
    tp = TPL.TensorParallelLM(cfg, axis)
    tp.load_state_dict(TPL.tp_shard_params(full, full.state_dict(), axis))
    tokens = torch.from_numpy(rng.randint(0, 64, (2, 8)))
    logits = tp(tokens)
    loss = F.cross_entropy(logits.reshape(-1, 64),
                           torch.roll(tokens, -1, 1).reshape(-1))
    loss.backward()
    specs = TPL.tp_param_specs(full, axis)
    params = dict(tp.named_parameters())
    out["tp_replicated"] = rep(torch.cat(
        [logits.detach().reshape(-1), loss.detach().reshape(1)]
        + [params[k].grad.reshape(-1) for k, s in specs.items() if s is None]))
    out["tp_shard_grads"] = each(*[params[k].grad for k, s in specs.items()
                                   if s is not None])

    T = 12
    xt = draw(T, d).expand(m, T, d)
    lg = draw(T, n).expand(m, T, n).clone().requires_grad_()
    We = (draw(n, d, d) * 0.5)[rows].requires_grad_()
    ye = MO.moe_apply(lambda w, z: torch.tanh(z @ w[0]), (We,), xt, lg,
                      axis=axis, capacity=4)
    (ye * draw(T, d)).sum().div(n).backward()
    out["moe_ep"] = ye.detach().reshape(m, -1)
    out["moe_ep_grads"] = each(We.grad, lg.grad)

    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=4,
                            embed_dim=32, max_seq_len=8, dtype=torch.float32)
    full = TransformerLM(cfg)
    full.reset_parameters(torch.Generator().manual_seed(SEED))
    shards = TPL.tp_shard_params(full, full.state_dict(), 2)
    dp_rep = RankReplicas(lambda: TPL.TensorParallelLM(cfg, 2), m, "cpu")
    dp_rep.load_state_dict(shards)
    opt = O.DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([dp_rep.flat], lr=0.1), use_dynamic_topology=True)
    data = torch.from_numpy(rng.randint(0, 64, (n, 2, 9)))[rows]
    for _ in range(3):
        dp_rep.zero_grad()
        for r, mod in enumerate(dp_rep.modules):
            lgt = mod(data[r, :, :-1])
            F.cross_entropy(lgt.reshape(-1, 64),
                            data[r, :, 1:].reshape(-1)).backward()
        opt.step()
    out["dp_tp_atc_flat"] = dp_rep.flat.detach().clone()
    return out


def _worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    bf.init_distributed(device="cpu")
    try:
        res = scenario(bf)
        res["owned"] = bf.owned_ranks()
        res["queries"] = {
            "size": bf.size(), "rank": bf.rank(),
            "local_size": bf.local_size(), "local_rank": bf.local_rank(),
            "machine_size": bf.machine_size(),
            "machine_rank": bf.machine_rank(),
            "is_homogeneous": bf.is_homogeneous()}
        torch.save(res, args.out)
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path, procs: int, per: int, how: str) -> list:
    """Run the worker in ``procs`` processes; each one's results."""
    port = _free_port()
    children = []
    for p in range(procs):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "MASTER_", "WORLD_SIZE",
                                    "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES=str(per),
                   OMP_NUM_THREADS="1")
        if how == "bfrun":
            env.update(BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                       BFTPU_NUM_PROCESSES=str(procs),
                       BFTPU_PROCESS_ID=str(p), BFTPU_LOCAL_ID=str(p))
        else:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(procs), RANK=str(p), LOCAL_RANK=str(p))
        children.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / f"proc{p}.pt")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for c in children:
            logs.append(c.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the {procs}-process group hung past {JOIN_TIMEOUT} s")
    for p, c in enumerate(children):
        assert c.returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    return [torch.load(tmp / f"proc{p}.pt", weights_only=False)
            for p in range(procs)]


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def run(request, tmp_path_factory):
    """``(layout, processes' results, single-process results)``."""
    procs, per, how = LAYOUTS[request.param]
    parts = _launch(tmp_path_factory.mktemp(request.param), procs, per, how)
    import bluefog_tpu_torch as bf
    bf.init(N, device="cpu", local_size=per if procs > 1 else N)
    try:
        want = scenario(bf)
    finally:
        bf.shutdown()
    return request.param, parts, want


def _joined(parts, name):
    got = [p[name] for p in parts]
    if isinstance(got[0], list):
        return [t for part in got for t in part]
    return torch.cat(got)


@pytest.mark.parametrize("name", BITWISE)
def test_collectives_across_processes_are_bitwise(run, name):
    _, parts, want = run
    got = _joined(parts, name)
    if isinstance(want[name], list):
        assert len(got) == len(want[name])
        for a, b in zip(got, want[name]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    else:
        assert got.shape == want[name].shape
        np.testing.assert_array_equal(got.numpy(), want[name].numpy())


@pytest.mark.parametrize("name", ALL_REDUCE)
def test_allreduce_across_processes_within_float32_rounding(run, name):
    _, parts, want = run
    got = _joined(parts, name)
    assert got.shape == want[name].shape
    np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-6,
                               atol=1e-6)
    for row in got[1:]:
        np.testing.assert_array_equal(row.numpy(), got[0].numpy())


@pytest.mark.parametrize("name", CLOSE)
def test_trajectories_and_sequence_parallel_across_processes(run, name):
    _, parts, want = run
    got = _joined(parts, name)
    assert got.shape == want[name].shape
    np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                               rtol=CLOSE_RTOL.get(name, 0), atol=1e-6)


def test_trainer_spread_is_the_worlds(run):
    """``measure``'s consensus spread under the transport is the whole
    world's, the same on every process."""
    _, parts, want = run
    for name in ("atc", "atc_sparse"):
        key = f"{name}_spread"
        for part in parts:
            assert part["scalars"][f"{name}_steps"] == 3
            for k, v in want["scalars"][key].items():
                assert part["scalars"][key][k] == pytest.approx(
                    v, rel=1e-5, abs=1e-9), (key, k)
        assert want["scalars"][key]["after_combine"] < \
            want["scalars"][key]["after_adapt"]


def test_owned_ranks_and_queries(run):
    layout, parts, _ = run
    procs, per, _ = LAYOUTS[layout]
    for p, part in enumerate(parts):
        assert part["owned"] == list(range(p * per, (p + 1) * per))
        assert part["queries"] == {
            "size": N, "rank": p * per, "local_size": per,
            "local_rank": 0, "machine_size": N // per, "machine_rank": p,
            "is_homogeneous": True}


def test_single_process_handles_are_ready_at_once(run):
    """In one process on the CPU every handle polls done at once."""
    _, _, want = run
    assert all(want["scalars"]["polled"])


def test_init_distributed_needs_a_launcher(monkeypatch):
    import bluefog_tpu_torch as bf
    for k in ("BFTPU_COORDINATOR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launcher environment"):
        bf.init_distributed(device="cpu")
    assert not bf.initialized()


if __name__ == "__main__":
    _worker()
