"""The port's public surface against the JAX package's.

``bluefog_tpu_torch`` must hold every name of the reference's
``bluefog.torch`` (``tests/test_api_parity.py``'s
``REFERENCE_TORCH_EXPORTS``) except those of ROADMAP items still queued, and
every public name of ``bluefog_tpu`` that the port still lacks is listed in
:data:`NOT_PORTED` with its reason: the list is exact, so a name that
lands must leave it.  Then the names this surface gained,
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

# Every public name of bluefog_tpu the port lacks, with its reason: the
# module items have all landed, and these three hand out jax ``Mesh``
# objects and ``device_get``, whose role the port's rank-major tensors,
# ``allgather`` and ``process_ranks()`` take (ROADMAP, "Not ported, by
# decision").
NOT_PORTED = {
    "mesh": "by decision", "hierarchical_mesh": "by decision",
    "to_numpy": "by decision",
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


def test_bfrun_console_entry_has_its_port():
    """The packaging names ``bfrun = bluefog_tpu.run.run:main``
    (``tests/test_runtime_services.py`` L360); the port's launcher is
    ``bluefog_tpu_torch.run.run:main`` (``python -m
    bluefog_tpu_torch.run``), callable the same way, with every option of
    the JAX launcher and the same defaults."""
    import tomllib

    from bluefog_tpu.run import run as jrun
    from bluefog_tpu_torch.run import run as trun
    meta = tomllib.loads((Path(__file__).resolve().parents[1]
                          / "pyproject.toml").read_text())
    assert meta["project"]["scripts"]["bfrun"] == "bluefog_tpu.run.run:main"
    assert "bluefog_tpu_torch.run" in meta["tool"]["setuptools"]["packages"]
    assert callable(trun.main)

    def options(parser):
        return {o: (a.dest, a.default) for a in parser._actions
                for o in a.option_strings}
    want, got = options(jrun.build_parser()), options(trun.build_parser())
    assert set(want) <= set(got)
    assert all(got[o] == want[o] for o in want)


def test_not_ported_list_is_exact():
    """The JAX package's public names the port lacks are exactly
    ``NOT_PORTED``'s: a name that lands must leave the list."""
    lacking = {n for n in _jax_surface() if not hasattr(tbf, n)}
    assert lacking == set(NOT_PORTED)
    assert set(NOT_PORTED.values()) == {"by decision"}


def test_version_equals_jax():
    """``bluefog_tpu_torch.__version__`` is the JAX package's, read without
    importing torch."""
    assert tbf.__version__ == jbf.__version__
    from bluefog_tpu_torch import version
    assert version.__version__ == jbf.__version__


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
