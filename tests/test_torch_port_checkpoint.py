"""The port's checkpoints (DCP) against the JAX package's (orbax).

The two formats differ (a JAX orbax checkpoint is not read by the port),
so the same state goes through each package's own save and restore: a
flax model's parameters and an optimizer state saved by the JAX package
and, converted by ``models.convert``, by the port restore to the same
values, bit for bit; the generic restore, ``leaf_shapes``,
``list_steps``/``latest_step``, ``consensus_average`` (within 1e-6: the
mean's summation order may differ) and ``broadcast_to_ranks`` agree.
Then the port's own: the ``AsyncSaver``'s pinned host copy, and a
coordinated checkpoint of ``Shard`` leaves written by 2 gloo processes
(each its own shard; the replicated leaves checked equal first).
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

from bluefog_tpu.utils import checkpoint as JC
from bluefog_tpu_torch.utils import checkpoint as TC

ROOT = Path(__file__).resolve().parents[1]


def _jax_mlp_tree(seed):
    import jax
    import jax.numpy as jnp
    import optax

    from bluefog_tpu.models import MLP
    model = MLP(features=(8, 6), num_classes=3)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 5)))
    opt_state = optax.adam(1e-3).init(variables["params"])
    mu = jax.tree.map(lambda x: x + 0.5, opt_state[0].mu)
    return variables, mu


def _port_tree(variables, mu):
    from bluefog_tpu_torch.models.convert import params_from_jax
    from bluefog_tpu_torch.models.simple import MLP
    model = MLP(5, features=(8, 6), num_classes=3)
    return {"params": params_from_jax(model, variables),
            "mu": params_from_jax(model, {"params": mu}),
            "step": 7, "lr": 1e-3,
            "rows": [torch.arange(12, dtype=torch.float32).reshape(4, 3),
                     torch.ones(2, dtype=torch.bfloat16)]}


@pytest.mark.parametrize("seed", [0, 1])
def test_saved_state_restores_like_jax(tmp_path, seed):
    """Tolerance: exact.  JAX saves and restores the flax tree; the port
    saves and restores its conversion; each restored value equals the
    conversion of JAX's restored value."""
    import jax
    variables, mu = _jax_mlp_tree(seed)
    jtree = {"variables": jax.tree.map(np.asarray, variables),
             "mu": jax.tree.map(np.asarray, mu)}
    JC.save(str(tmp_path / "jax"), jtree, step=3)
    jback = JC.restore(str(tmp_path / "jax"), step=3)
    want = _port_tree(jback["variables"], jback["mu"])
    tree = _port_tree(variables, mu)
    path = TC.save(str(tmp_path / "port"), tree, step=3)
    assert path.endswith("step_0000000003")
    back = TC.restore(str(tmp_path / "port"), step=3, target=tree)
    assert back.keys() == tree.keys()
    for k in ("params", "mu"):
        assert list(back[k]) == list(want[k])
        for name in want[k]:
            assert back[k][name].dtype == want[k][name].dtype
            assert torch.equal(back[k][name], want[k][name]), name
    assert back["step"] == 7 and isinstance(back["step"], int)
    assert back["lr"] == 1e-3 and isinstance(back["lr"], float)
    assert all(torch.equal(a, b) for a, b in zip(back["rows"],
                                                  tree["rows"]))
    assert TC.list_steps(str(tmp_path / "port")) == \
        JC.list_steps(str(tmp_path / "jax")) == [3]
    assert TC.latest_step(str(tmp_path / "port")) == 3


def test_generic_restore_and_leaf_shapes_match_jax(tmp_path):
    """Without a target both give the generic tree (dicts and lists) with
    the same values; ``leaf_shapes`` (metadata only) the same shapes in
    the same leaf order."""
    rng = np.random.RandomState(0)
    tree = {"b": {"z": rng.randn(3, 2).astype(np.float32),
                  "a": rng.randn(5).astype(np.float32)},
            "a": [rng.randn(2, 2, 2).astype(np.float32),
                  np.arange(4, dtype=np.int32)],
            "c": rng.randn(1).astype(np.float64)}
    JC.save(str(tmp_path / "j"), tree, step=1)
    TC.save(str(tmp_path / "t"), tree, step=1)
    assert TC.leaf_shapes(str(tmp_path / "t"), step=1) == \
        JC.leaf_shapes(str(tmp_path / "j"), step=1)
    jr = JC.restore(str(tmp_path / "j"), step=1)
    tr = TC.restore_host(str(tmp_path / "t"), step=1)
    assert sorted(tr) == sorted(jr)
    for k in ("z", "a"):
        np.testing.assert_array_equal(tr["b"][k], np.asarray(jr["b"][k]))
    jl = jr["a"] if isinstance(jr["a"], list) else \
        [jr["a"][str(i)] for i in range(2)]
    assert isinstance(tr["a"], list)
    for x, y in zip(tr["a"], jl):
        np.testing.assert_array_equal(x, np.asarray(y))
    g = TC.restore(str(tmp_path / "t"), step=1)
    assert isinstance(g["a"][1], torch.Tensor)
    assert g["a"][1].dtype == torch.int32


def test_consensus_average_and_broadcast_match_jax():
    """``consensus_average`` within 1e-6 relative (summation order);
    ``broadcast_to_ranks`` exact; ``save(average_ranks=True)`` stores the
    average."""
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(4, 3, 2).astype(np.float32),
            "c": rng.randint(0, 9, size=(4, 2)).astype(np.int64)}
    ja = JC.consensus_average(tree)
    ta = TC.consensus_average(tree)
    np.testing.assert_allclose(ta["w"].numpy(), np.asarray(ja["w"]),
                               rtol=1e-6)
    jb = JC.broadcast_to_ranks({"w": np.asarray(ja["w"])}, 4)
    tb = TC.broadcast_to_ranks({"w": torch.from_numpy(np.asarray(ja["w"]))},
                               4)
    np.testing.assert_array_equal(tb["w"].numpy(), np.asarray(jb["w"]))


def test_average_ranks_save(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32).reshape(4, 2)}
    TC.save(str(tmp_path), tree, average_ranks=True)
    back = TC.restore_host(str(tmp_path))
    np.testing.assert_array_equal(back["w"], [3.0, 4.0])
    with pytest.raises(ValueError, match="ambiguous"):
        TC.save(str(tmp_path), {"w": TC.Shard(torch.ones(2), 0, 2)},
                average_ranks=True)


def test_async_saver_copies_then_writes(tmp_path):
    """The saver's copy is taken before ``save`` returns: a tensor changed
    right after is saved as it was; the pinned buffers (host tensors here)
    are reused; errors surface once on ``flush``."""
    x = torch.arange(6, dtype=torch.float32)
    s = TC.AsyncSaver()
    try:
        s.save(str(tmp_path), {"x": x, "n": 1}, step=1)
        x.add_(100)
        s.save(str(tmp_path), {"x": x, "n": 2}, step=2, wait=True)
        assert s.last_bytes == 6 * 4 + 8
        assert s.last_write_seconds > 0 and s.last_copy_seconds >= 0
    finally:
        s.shutdown()
    one = TC.restore(str(tmp_path), step=1, target={"x": x, "n": 0})
    two = TC.restore(str(tmp_path), step=2, target={"x": x, "n": 0})
    np.testing.assert_array_equal(one["x"].numpy(), np.arange(6.0))
    np.testing.assert_array_equal(two["x"].numpy(), np.arange(6.0) + 100)
    assert (one["n"], two["n"]) == (1, 2)


def _worker(out, base):
    import torch.distributed as dist
    dist.init_process_group("gloo")
    r = dist.get_rank()
    whole = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tree = {"w": TC.Shard(whole.chunk(2, dim=1)[r].clone(), r, 2, dim=1),
            "b": torch.full((3,), 2.5), "step": 11}
    TC.save(base, tree, step=4)
    target = {"w": TC.Shard(torch.zeros(4, 3), r, 2, dim=1),
              "b": torch.zeros(3), "step": 0}
    back = TC.restore(base, step=4, target=target)
    res = {"mine": torch.equal(back["w"].local, whole.chunk(2, dim=1)[r]),
           "b": back["b"].tolist(), "step": back["step"]}
    host = TC.restore_host(base, step=4)
    res["whole"] = np.array_equal(host["w"], whole.numpy())
    res["shapes"] = TC.leaf_shapes(base, step=4)
    bad = {"w": TC.Shard(torch.zeros(4, 3), r, 2, dim=1),
           "b": torch.full((3,), float(r))}
    try:
        TC.save(base + "_bad", bad)
        res["refused"] = False
    except ValueError:
        res["refused"] = True
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def test_coordinated_sharded_checkpoint_two_processes(tmp_path):
    """2 gloo processes write one checkpoint, each its own shard of ``w``
    (dim 1) under its own key; each restores its shard exactly, the host
    restore joins the whole tensor, and differing replicated leaves are
    refused in both processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kids = []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "MASTER_", "WORLD_SIZE",
                                    "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(p),
                   OMP_NUM_THREADS="1")
        kids.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path / f"r{p}.pt"),
             str(tmp_path / "ck")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [k.communicate(timeout=120)[0] for k in kids]
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
    for p, k in enumerate(kids):
        assert k.returncode == 0, logs[p][-3000:]
    for p in range(2):
        res = torch.load(tmp_path / f"r{p}.pt", weights_only=False)
        assert res["mine"] and res["whole"] and res["refused"]
        assert res["b"] == [2.5] * 3 and res["step"] == 11
        assert sorted(res["shapes"]) == [(), (3,), (4, 6)]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("base")
    a = ap.parse_args()
    _worker(a.out, a.base)
