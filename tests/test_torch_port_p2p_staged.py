"""The host-staged point-to-point path of ``ops/p2p.py``, on the CPU.

gloo's send and receive read and write host memory only, so under gloo
``ProcessRanks.exchange`` and ``ProcessRanks.rotate`` move rows that live
on the card through host copies (a gang of processes sharing one card runs
gloo: NCCL refuses two processes on one card).  The CPU has no card, so
each process of a 2 x 2 gloo gang (bfrun's rendezvous) runs the moves
twice, staged (``_host_staged`` forced on) and not: the neighbor
averages, the dynamic walk, the neighbor allgather, pair gossip and a
pipeline hop each way must agree bit for bit, and the staged path must
have been taken.  Run as a script, this file is the worker.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def moves(bf):
    import torch
    own = bf.owned_ranks()
    x = torch.arange(bf.size() * 3, dtype=torch.float32).reshape(
        bf.size(), 3)[own] * 1.5 + 1.0
    out = {"neighbor_allreduce": bf.neighbor_allreduce(x),
           "neighbor_allgather": bf.neighbor_allgather(x),
           "pair_gossip": bf.pair_gossip(x, [2, 3, 0, 1])}
    y = x
    for step in range(3):
        y = bf.dynamic_neighbor_allreduce(y, step)
    out["dynamic"] = y
    comm = bf.process_ranks()
    out["rotate_up"], out["rotate_down"] = (
        comm.rotate([x], up=True)[0], comm.rotate([x], up=False)[0])
    return {k: v.tolist() for k, v in out.items()}


def worker(out_path):
    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import p2p
    bf.init_distributed(device="cpu")
    plain = moves(bf)
    calls = []
    real = p2p._host_staged

    def forced(device):
        calls.append(real(device))
        return True

    p2p._host_staged = forced
    try:
        staged = moves(bf)
    finally:
        p2p._host_staged = real
    bf.barrier()
    bf.shutdown()
    with open(out_path.format(proc=os.environ["BFTPU_PROCESS_ID"]),
              "w") as f:
        json.dump({"plain": plain, "staged": staged,
                   "staged_calls": len(calls),
                   "would_stage_on_cpu": any(calls)}, f)
    return 0


def test_host_staged_p2p_equals_direct(tmp_path):
    out = str(tmp_path / "p{proc}.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", "-np", "2",
         "--devices-per-proc", "2", sys.executable, __file__, out],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    parts = [json.load(open(out.format(proc=p))) for p in range(2)]
    for part in parts:
        assert part["staged_calls"] > 0 and not part["would_stage_on_cpu"]
        assert part["staged"] == part["plain"]
    # The processes' rows together: the ring hop of the world's rows.
    world = np.concatenate([np.array(p["plain"]["rotate_up"])
                            for p in parts])
    x = np.arange(12, dtype=np.float32).reshape(4, 3) * 1.5 + 1.0
    np.testing.assert_array_equal(world, np.roll(x, 1, axis=0))
    mean = np.concatenate([np.array(p["plain"]["dynamic"]) for p in parts])
    np.testing.assert_allclose(mean, np.broadcast_to(x.mean(0), x.shape),
                               rtol=1e-6)


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1]))
