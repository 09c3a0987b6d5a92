"""The port's schedule pipeline against the JAX package's: the interconnect
model, the placement search, the congestion repack, the native round
compiler and the context's dispatch, on the same seeded inputs.

Everything here is host arithmetic on the same numpy inputs, so the
comparisons are exact: the permutations, the costs, the rounds (pairs and
weight bits) and their provenance stamps.  The combines through the
dispatched schedules agree bit for bit too (the JAX side op by op, under
``jax.disable_jit()``).  The annealer runs 200 iterations in both packages
(the default is 1000) to keep the file within seconds."""

import os

import jax
import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import basics as jbasics
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import placement as JPL
from bluefog_tpu.ops import schedule as JS
from bluefog_tpu.ops import schedule_opt as JSO
from bluefog_tpu.ops import transport as JTR
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import basics as tbasics
from bluefog_tpu_torch import native as tnative
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import placement as TPL
from bluefog_tpu_torch.ops import schedule as TS
from bluefog_tpu_torch.ops import schedule_opt as TSO
from bluefog_tpu_torch.ops import transport as TTR
from bluefog_tpu_torch.utils import config as tconfig

N = 8
KNOBS = ("BLUEFOG_TPU_PLACEMENT", "BLUEFOG_TPU_FAKE_TORUS",
         "BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET", "BLUEFOG_TPU_PLACEMENT_ITERS",
         "BLUEFOG_TPU_TORUS_WRAP", "BLUEFOG_TPU_SCHEDULE_SYNTH",
         "BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH", "BLUEFOG_TPU_HIER")


@pytest.fixture(autouse=True)
def _knobs():
    saved = {k: os.environ.get(k) for k in KNOBS}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jconfig.reload()
    tconfig.reload()
    JPL.set_active(None, None)
    TPL.set_active(None, None)
    tbf.shutdown()


def _env(**kw):
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(kw)
    jconfig.reload()
    tconfig.reload()


def assert_same_rounds(a, b):
    """The same rounds, pair for pair and weight bit for weight bit, and
    the same stamps."""
    assert len(a.rounds) == len(b.rounds)
    for ra, rb in zip(a.rounds, b.rounds):
        assert ra.pairs == rb.pairs
        for f in ("send_scale", "recv_mask", "src_of"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    np.testing.assert_array_equal(a.self_scale, b.self_scale)
    assert JS.schedule_provenance(a) == TS.schedule_provenance(b)
    assert getattr(a, "sketch", None) == getattr(b, "sketch", None)
    ca, cb = getattr(a, "modeled_cost", None), getattr(b, "modeled_cost",
                                                        None)
    assert (ca is None) == (cb is None)
    if ca is not None:
        assert vars(ca) == vars(cb)


def _graphs(mod, n):
    return {"exp2": mod.ExponentialTwoGraph(n), "ring": mod.RingGraph(n),
            "rr0": mod.RandomRegularGraph(n, 4, seed=0),
            "rr2": mod.RandomRegularGraph(n, 4, seed=2)}


# ---------------------------------------------------------------------------
# The native round compiler
# ---------------------------------------------------------------------------

def _matrix(n, density, seed):
    rng = np.random.RandomState(seed)
    w = np.where(rng.rand(n, n) < density, rng.rand(n, n), 0.0)
    np.fill_diagonal(w, rng.rand(n))
    return w


@pytest.mark.parametrize("n,density,seed", [
    (2, 1.0, 0), (5, 0.5, 1), (16, 0.2, 2), (33, 0.3, 3), (64, 0.05, 4),
    (7, 0.0, 5)])
def test_native_rounds_equal_numpy_and_jax(n, density, seed):
    w = _matrix(n, density, seed)
    native = TS._rounds_from_matrix_native(w)
    for oracle in (TS._rounds_from_matrix_py(w),
                   JS._rounds_from_matrix_py(w)):
        assert len(native) == len(oracle)
        for a, b in zip(native, oracle):
            assert a.pairs == b.pairs
            for f in ("send_scale", "recv_mask", "src_of"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_native_round_compiler_builds_keyed_and_raises(tmp_path,
                                                       monkeypatch):
    """The library is keyed by its source and reused; a source that does
    not compile raises with the compiler's output (no fallback)."""
    import shutil
    path = tnative.build_schedule()
    assert path == tnative.schedule_library_path() and path.exists()
    assert path.parent == tnative.BUILD_DIR
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    src = tmp_path / "src"
    src.mkdir()
    (src / "schedule.cc").write_text("int f( { return 1; }\n")
    monkeypatch.setattr(tnative, "SRC_DIR", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    assert tnative.schedule_library_path() != path
    with pytest.raises(RuntimeError, match="round compiler"):
        tnative.build_schedule()


@pytest.mark.parametrize("name", ["exp2", "ring", "rr0", "rr2"])
def test_compiled_schedule_and_provenance_equal_jax(name):
    for n in (8, 13):
        a = JS.compile_static(_graphs(jtopo, n)[name])
        b = TS.compile_static(_graphs(ttopo, n)[name])
        assert_same_rounds(a, b)
        assert isinstance(b, TS.CompiledSchedule)
    dyn_a = JS.compile_dynamic(jtopo.dynamic_phase_table(
        _graphs(jtopo, 8)[name]), 8)
    dyn_b = TS.compile_dynamic(ttopo.dynamic_phase_table(
        _graphs(ttopo, 8)[name]), 8)
    assert dyn_a.provenance == dyn_b.provenance
    for pa, pb in zip(dyn_a.phases, dyn_b.phases):
        assert_same_rounds(pa, pb)


# ---------------------------------------------------------------------------
# Model, routing, cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "2x4", "4x4", "2x2", "garbage",
                                  "8", "2x2x2"])
def test_build_model_fake_torus_cases_equal_jax(spec):
    """JAX ``test_build_model_fake_torus_and_fallbacks``'s cases: the flat
    host (no model), an exact spec, a node count that mismatches or only
    divides, and a malformed spec (warned, no model)."""
    _env(**({} if spec is None else {"BLUEFOG_TPU_FAKE_TORUS": spec}))
    want = JPL.build_model([object() for _ in range(N)])
    got = TPL.build_model([object() for _ in range(N)])
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.name, got.dims, got.device_node, got.wrap_dims,
                got.n_slices) == (want.name, want.dims, want.device_node,
                                  want.wrap_dims, want.n_slices)


class _Dev:
    def __init__(self, coords, slice_index=0):
        self.coords = coords
        self.slice_index = slice_index


@pytest.mark.parametrize("wrap", [None, "1", "0"])
@pytest.mark.parametrize("layout", ["2d", "cube", "two-slices"])
def test_build_model_from_coords_equals_jax(layout, wrap):
    devs = {"2d": [_Dev((x, y, 0)) for x in range(2) for y in range(4)],
            "cube": [_Dev((x, y, z)) for x in range(4) for y in range(4)
                     for z in range(2)],
            "two-slices": [_Dev((x, y, 0), s) for s in range(2)
                           for x in range(2) for y in range(2)]}[layout]
    _env(**({} if wrap is None else {"BLUEFOG_TPU_TORUS_WRAP": wrap}))
    want, got = JPL.build_model(devs), TPL.build_model(devs)
    assert (got.name, got.dims, got.device_node, got.wrap_dims,
            got.n_slices) == (want.name, want.dims, want.device_node,
                              want.wrap_dims, want.n_slices)


def test_torch_devices_carry_no_geometry():
    """A card (or the CPU) exposes no torus coordinates: no model unless
    ``BLUEFOG_TPU_FAKE_TORUS`` names one."""
    _env()
    assert TPL.build_model([torch.device("cpu")] * N) is None
    assert TPL.build_model([torch.device("cuda", 0)] * N) is None


def test_routes_distances_and_tables_equal_jax():
    for dims, slices in (((4, 8), 1), ((2, 2), 2), ((8,), 1)):
        a = JPL.TorusModel(name="t", dims=dims,
                           device_node=tuple(range(int(np.prod(dims))
                                                   * slices)),
                           n_slices=slices)
        b = TPL.TorusModel(name="t", dims=dims, device_node=a.device_node,
                           n_slices=slices)
        for s in range(a.n_nodes):
            for d in range(a.n_nodes):
                np.testing.assert_array_equal(a.route(s, d), b.route(s, d))
                assert a.distance(s, d) == b.distance(s, d)
        np.testing.assert_array_equal(a.route_table, b.route_table)
        np.testing.assert_array_equal(a.link_weights, b.link_weights)


# ---------------------------------------------------------------------------
# Placement search and congestion repack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [None, 8, 5])
@pytest.mark.parametrize("name,seed", [("rr0", 0), ("rr2", 3), ("exp2", 0),
                                       ("ring", 1)])
def test_optimize_placement_equals_jax(name, seed, block):
    """Permutation and costs bit for bit: the annealer's numpy generator,
    its swaps and its acceptances are the same."""
    n = 32
    ja = [JS.compile_static(_graphs(jtopo, n)[name]),
          JS.compile_dynamic(jtopo.dynamic_phase_table(
              _graphs(jtopo, n)[name], max_phases=16), n)]
    tb = [TS.compile_static(_graphs(ttopo, n)[name]),
          TS.compile_dynamic(ttopo.dynamic_phase_table(
              _graphs(ttopo, n)[name], max_phases=16), n)]
    want = JPL.optimize_placement(JPL.synthetic_torus((4, 8)), ja, n,
                                  iters=200, seed=seed, block=block)
    got = TPL.optimize_placement(TPL.synthetic_torus((4, 8)), tb, n,
                                 iters=200, seed=seed, block=block)
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.is_identity == want.is_identity
    assert vars(got.identity_cost) == vars(want.identity_cost)
    assert vars(got.optimized_cost) == vars(want.optimized_cost)
    assert got.improvement_ratio == want.improvement_ratio
    assert got.model_name == want.model_name


@pytest.mark.parametrize("budget", [2.0, 1.5, 0.0])
@pytest.mark.parametrize("name", ["rr0", "rr2", "exp2"])
def test_congestion_repack_equals_jax(name, budget):
    """Round for round under the searched placement, with the same
    ``congestion`` stamp (or the input returned, when nothing moves)."""
    n = 32
    ja = JS.compile_static(_graphs(jtopo, n)[name])
    tb = TS.compile_static(_graphs(ttopo, n)[name])
    jm, tm = JPL.synthetic_torus((4, 8)), TPL.synthetic_torus((4, 8))
    perm = JPL.optimize_placement(jm, ja, n, iters=100, seed=0).perm
    for p in (None, perm):
        want = JSO.congestion_aware_repack(ja, jm, p, budget_factor=budget)
        got = TSO.congestion_aware_repack(tb, tm, p, budget_factor=budget)
        assert_same_rounds(want, got)
        assert (got is tb) == (want is ja)
        assert vars(JPL.schedule_cost(jm, want, p)) == \
            vars(TPL.schedule_cost(tm, got, p))
    small = TS.compile_static(ttopo.RingGraph(4))
    assert TSO.congestion_aware_repack(small, tm, None) is small
    assert TSO.congestion_aware_repack(tb, None, None) is tb


def test_modeled_hops_and_edge_cost_equal_jax():
    n = 8
    ja, tb = (JS.compile_static(jtopo.ExponentialTwoGraph(n)),
              TS.compile_static(ttopo.ExponentialTwoGraph(n)))
    jm, tm = JPL.synthetic_torus((2, 4)), TPL.synthetic_torus((2, 4))
    perm = np.asarray([1, 0, 2, 3, 5, 4, 6, 7])
    JPL.set_active(jm, perm)
    TPL.set_active(tm, perm)
    assert TPL.modeled_schedule_hops(tb) == JPL.modeled_schedule_hops(ja)
    for s in range(n):
        for d in range(n):
            assert TPL.predicted_edge_cost(s, d) == \
                JPL.predicted_edge_cost(s, d)
    TPL.set_active(None, None)
    assert TPL.modeled_schedule_hops(tb) is None
    assert TPL.predicted_edge_cost(0, 5) == 1.0


# ---------------------------------------------------------------------------
# The context: set_topology's placement, the dispatched schedules
# ---------------------------------------------------------------------------

def _both(topo_name, devices, local_size=None):
    jbf.init(lambda: _graphs(jtopo, N)[topo_name], devices=devices,
             local_size=local_size)
    tbf.init(N, device="cpu", local_size=local_size,
             topology_fn=lambda: _graphs(ttopo, N)[topo_name])


@pytest.mark.parametrize("case", ["exp2", "rr0", "ring", "hier", "nosynth",
                                  "nobudget", "sketch", "off"])
def test_context_pipeline_equals_jax(devices, case):
    """``placement_info``, ``synthesis_info``, the stripes' oracle and the
    dispatched static and dynamic schedules, under the fake 2x4 torus:
    the plain path, the two-level gossip's levels in the search (machines
    of 4, the search held within them), synthesis off, the repack's budget
    at 0, one sketch pinned, and placement off."""
    env = {"BLUEFOG_TPU_FAKE_TORUS": "2x4",
           "BLUEFOG_TPU_PLACEMENT_ITERS": "200"}
    topo_name, local = {"hier": ("exp2", 4), "nosynth": ("rr0", None),
                        "nobudget": ("rr0", None), "sketch": ("rr2", None),
                        "off": ("rr0", None)}.get(case, (case, None))
    env.update({"hier": {"BLUEFOG_TPU_HIER": "1"},
                "nosynth": {"BLUEFOG_TPU_SCHEDULE_SYNTH": "0"},
                "nobudget": {"BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET": "0"},
                "sketch": {"BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH":
                           "hierarchical"},
                "off": {"BLUEFOG_TPU_PLACEMENT": "0"}}.get(case, {}))
    _env(**env)
    _both(topo_name, devices, local)
    assert tbf.placement_info() == jbf.placement_info()
    assert tbf.synthesis_info() == jbf.synthesis_info()
    assert (tbf.placement_info() is None) == (case == "off")
    if case == "hier":
        np.testing.assert_array_equal(
            tbasics._ctx.placement_result.perm // 4, np.arange(N) // 4)
    assert TTR.resolve_stripes_static() == JTR.resolve_stripes_static()
    assert TTR.resolve_stripes() == JTR.resolve_stripes()
    want_s, _ = jbasics._nbr_schedule(None)
    assert_same_rounds(want_s, tbasics._dispatch_static())
    ctx = jbasics._ctx
    key = ("dynamic", ctx.topology_version,
           jbasics._sched_path_tag(jconfig.get()), ctx.placement_generation)
    jbf.dynamic_neighbor_allreduce(np.zeros((N, 1), np.float32), 0)
    want_d = ctx._static_scheds[key]
    got_d = tbasics._dispatch_dynamic()
    for pa, pb in zip(want_d.phases, got_d.phases):
        assert_same_rounds(pa, pb)


@pytest.mark.parametrize("topo_name", ["rr0", "exp2"])
def test_combines_over_dispatched_schedules_equal_jax(devices, topo_name):
    """``neighbor_allreduce`` and the dynamic combine through the packed
    and synthesized schedules, bit for bit the JAX package's (op by op)."""
    _env(BLUEFOG_TPU_FAKE_TORUS="2x4", BLUEFOG_TPU_PLACEMENT_ITERS="200")
    _both(topo_name, devices)
    x = np.random.RandomState(3).randn(N, 64).astype(np.float32)
    with jax.disable_jit():
        want = [np.asarray(jbf.neighbor_allreduce(x))] + [
            np.asarray(jbf.dynamic_neighbor_allreduce(x, s))
            for s in range(4)]
    got = [tbf.neighbor_allreduce(torch.from_numpy(x)).numpy()] + [
        tbf.dynamic_neighbor_allreduce(torch.from_numpy(x), s).numpy()
        for s in range(4)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_placement_is_memoized_and_generation_keys_dispatch():
    """Re-installing a seen topology reuses the search; every refresh bumps
    the generation that keys the dispatched schedules, and the optimizers'
    logical schedule stays the compile cache's."""
    _env(BLUEFOG_TPU_FAKE_TORUS="2x4", BLUEFOG_TPU_PLACEMENT_ITERS="100")
    # The model cache is process-global: a file run earlier in the same
    # worker may have left another torus's model in it.
    tbasics._placement_model_cache.clear()
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.RandomRegularGraph(N, 4, seed=1))
    ctx = tbasics._ctx
    first, g0 = ctx.placement_result, ctx.placement_generation
    assert first is not None
    tbasics._dispatch_static()
    assert [k[-1] for k in ctx._schedules if "static_dispatch" in k] == [g0]
    tbf.set_topology(ttopo.RingGraph(N))
    tbf.set_topology(ttopo.RandomRegularGraph(N, 4, seed=1))
    assert ctx.placement_result is first
    assert ctx.placement_generation == g0 + 2
    tbasics._dispatch_static()
    assert [k[-1] for k in ctx._schedules if "static_dispatch" in k] == \
        [g0 + 2]
    assert len(tbasics._placement_model_cache) == 1
    assert tbasics.static_schedule() is TS.compile_static(
        ttopo.RandomRegularGraph(N, 4, seed=1))


def test_placement_off_is_bit_identical(devices):
    """Placement and repack change the order of the sum at most: without
    the round budget the permutation alone moves nothing."""
    x = torch.from_numpy(np.random.RandomState(4).randn(N, 32).astype(
        np.float32))
    outs = []
    for env in ({"BLUEFOG_TPU_PLACEMENT": "0"},
                {"BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET": "0"}):
        _env(BLUEFOG_TPU_FAKE_TORUS="2x4", **env)
        tbf.init(N, device="cpu",
                 topology_fn=lambda: ttopo.RandomRegularGraph(N, 4, seed=1))
        outs.append(tbf.neighbor_allreduce(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_unknown_sketch_raises_as_jax():
    os.environ["BLUEFOG_TPU_SCHEDULE_SYNTH_SKETCH"] = "ring"
    with pytest.raises(ValueError, match="not a known sketch"):
        jconfig.reload()
    with pytest.raises(ValueError, match="not a known sketch"):
        tconfig.reload()
