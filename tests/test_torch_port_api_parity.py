"""The port's public surface against the JAX package's.

``bluefog_tpu_torch`` must hold every name of the reference's
``bluefog.torch`` (``tests/test_api_parity.py``'s
``REFERENCE_TORCH_EXPORTS``) except those of ROADMAP items still queued, and
every public name of ``bluefog_tpu`` that the port still lacks is listed in
:data:`NOT_PORTED` with its ROADMAP item: the list is exact, so the PR that
lands an item deletes its own lines.  Then the names this surface gained,
each against the JAX package on the same seeded inputs: the neighbor
queries, the in-place collectives (the bits of the out-of-place ops, written
into their input), the parameter utilities, the shims, ``suspend`` and
``resume``, and ``hierarchical_gossip_info``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.utils import config as tconfig

from test_api_parity import REFERENCE_TORCH_EXPORTS

N = 8

# Every public name of bluefog_tpu the port lacks, with the ROADMAP item
# that brings it (item 22: the data module, and the jax-only names whose
# role the port's rank-major tensors and process_ranks() take).
NOT_PORTED = {
    "gang": "20", "gang_info": "20", "membership_info": "20",
    "data": "22", "mesh": "22", "hierarchical_mesh": "22",
    "to_numpy": "22",
}


def test_reference_torch_surface_is_covered_but_item_21():
    """The whole of ``REFERENCE_TORCH_EXPORTS`` (item 21 brought the last
    names, the ``timeline_*`` three)."""
    missing = [n for n in REFERENCE_TORCH_EXPORTS if not hasattr(tbf, n)]
    assert missing == []


def _jax_surface():
    """The public names ``bluefog_tpu/__init__.py`` binds (its imports,
    definitions and assignments), not the submodules that later imports
    attach to the package."""
    tree = ast.parse(Path(jbf.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") and hasattr(jbf, n)}


def test_not_ported_list_is_exact():
    """The JAX package's public names the port lacks are exactly
    ``NOT_PORTED``'s: a name that lands must leave the list."""
    lacking = {n for n in _jax_surface() if not hasattr(tbf, n)}
    assert lacking == set(NOT_PORTED)
    assert set(NOT_PORTED.values()) <= {"20", "22"}


@pytest.fixture
def both(devices):
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices)
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    yield
    tbf.shutdown()


def test_neighbor_queries_match_jax(both):
    for r in range(N):
        assert tbf.in_neighbor_ranks(r) == jbf.in_neighbor_ranks(r)
        assert tbf.out_neighbor_ranks(r) == jbf.out_neighbor_ranks(r)
    assert tbf.in_neighbor_ranks() == jbf.in_neighbor_ranks()
    assert tbf.out_neighbor_ranks() == jbf.out_neighbor_ranks()


def test_machine_neighbor_queries_match_jax(devices):
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices,
             local_size=2)
    tbf.init(N, device="cpu", local_size=2,
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    try:
        for m in range(N // 2):
            assert tbf.in_neighbor_machine_ranks(m) == \
                jbf.in_neighbor_machine_ranks(m)
            assert tbf.out_neighbor_machine_ranks(m) == \
                jbf.out_neighbor_machine_ranks(m)
        assert tbf.in_neighbor_machine_ranks() == \
            jbf.in_neighbor_machine_ranks()
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("op", ["allreduce", "allreduce_sum", "broadcast"])
@pytest.mark.parametrize("blocking", [True, False])
def test_inplace_ops_write_the_out_of_place_bits(both, op, blocking):
    x = np.random.RandomState(3).randn(N, 5).astype(np.float32)
    kw = {"allreduce": dict(average=True), "allreduce_sum":
          dict(average=False), "broadcast": {}}[op]
    name = op.split("_")[0]
    args = (3,) if name == "broadcast" else ()
    want = getattr(tbf, name)(torch.from_numpy(x), *args, **kw)
    t = torch.from_numpy(x.copy())
    if blocking:
        out = getattr(tbf, name + "_")(t, *args, **kw)
    else:
        out = tbf.synchronize(getattr(tbf, name + "_nonblocking_")(
            t, *args, **kw))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), want.numpy())
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(getattr(jbf, name + "_")(x, *args, **kw)))


def test_parameter_utilities_match_jax(both):
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(N, 3, 2).astype(np.float32),
              "b": [rng.randn(N, 2).astype(np.float32)]}
    want = jbf.allreduce_parameters(params)
    got = tbf.allreduce_parameters(
        {"w": torch.from_numpy(params["w"]),
         "b": [torch.from_numpy(params["b"][0])]})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))
    state = {"step": np.int32(7), "m": rng.randn(N, 4).astype(np.float32)}
    j_state = jbf.broadcast_optimizer_state(state, 2)
    t_state = tbf.broadcast_optimizer_state(
        {"step": torch.tensor(7), "m": torch.from_numpy(state["m"]),
         "lr": 0.1}, 2)
    assert int(t_state["step"]) == int(j_state["step"]) and \
        t_state["lr"] == 0.1
    np.testing.assert_array_equal(t_state["m"].numpy(),
                                  np.asarray(j_state["m"]))


def test_shims(both):
    assert tbf.get_skip_negotiate_stage() is True
    tbf.set_skip_negotiate_stage(False)
    assert tbf.get_skip_negotiate_stage() is True
    assert tbf.mpi_threads_supported() is True
    assert tbf.unified_mpi_window_model_supported() is True
    # The port answers for torch's NCCL (the JAX package has none).
    assert tbf.nccl_built() == dist.is_nccl_available()
    assert jbf.nccl_built() is False


def test_suspend_refuses_ops_until_resume(both):
    x = torch.zeros(N, 3)
    tbf.win_create(x, "s")
    h = tbf.win_put_nonblocking(x, "s")
    tbf.suspend()
    assert tbf.suspended()
    assert tbf.win_poll(h)           # drained before suspending
    for call in (lambda: tbf.allreduce(x),
                 lambda: tbf.neighbor_allreduce(x),
                 lambda: tbf.win_put(x, "s"),
                 lambda: tbf.win_fence("s")):
        with pytest.raises(RuntimeError, match="suspended"):
            call()
    assert tbf.size() == N and tbf.get_current_created_window_names()
    tbf.suspend()                    # idempotent
    tbf.resume()
    assert not tbf.suspended()
    tbf.win_put(x, "s")
    np.testing.assert_array_equal(tbf.allreduce(x).numpy(), x.numpy())


@pytest.mark.parametrize("comp", ["none", "bf16", "sparse:0.25"])
def test_hierarchical_gossip_info_matches_jax(devices, monkeypatch, comp):
    jbf.init(devices=devices, local_size=2)
    tbf.init(N, device="cpu", local_size=2)
    try:
        assert tbf.hierarchical_gossip_info() is None
        monkeypatch.setenv("BLUEFOG_TPU_HIER", "1")
        monkeypatch.setenv("BLUEFOG_TPU_HIER_OUTER_EVERY", "2")
        monkeypatch.setenv("BLUEFOG_TPU_HIER_OUTER_COMPRESSION", comp)
        jconfig.reload()
        tconfig.reload()
        assert tbf.hierarchical_gossip_info() == \
            jbf.hierarchical_gossip_info()
    finally:
        monkeypatch.undo()
        jconfig.reload()
        tconfig.reload()
        tbf.shutdown()
