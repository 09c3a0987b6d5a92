"""The port's telemetry against the JAX package's.

The registry is host arithmetic, so the comparisons are exact: the same
call sequence renders the same Prometheus text and the same snapshot in
both packages, and the same eager ops, placement refreshes, hierarchical
ops and sharded combines leave the same counter and gauge values.  Timings
(every ``*_seconds`` series) and histogram sums are left out of those
comparisons, and so is ``bf_throttle_waits_total``: the JAX package
throttles its asynchronous dispatch on the CPU mesh, and the port's eager
ops wait for their works instead.  A 16-rank context does not fit the
8-device CPU mesh, so the ``BLUEFOG_TPU_FAKE_TORUS=4x4`` and ``16`` cases
run the JAX side in a subprocess with 16 host devices.  Then: telemetry
off mutates nothing, every ``bf_*`` name the port registers is documented,
``aggregate_snapshot`` across two gloo processes, and the endpoint.
"""

import ast
import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import schedule_opt as JSO
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import placement as TPL
from bluefog_tpu_torch.ops import schedule_opt as TSO
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry as TT

ROOT = Path(__file__).resolve().parents[1]
N = 8
KNOBS = ("BLUEFOG_TPU_TELEMETRY", "BLUEFOG_TPU_FAKE_TORUS",
         "BLUEFOG_TPU_PLACEMENT_ITERS", "BLUEFOG_TPU_HIER",
         "BLUEFOG_TPU_TELEMETRY_PORT")


@pytest.fixture(autouse=True)
def _fresh():
    saved = {k: os.environ.get(k) for k in KNOBS}
    JT.reset()
    TT.reset()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jconfig.reload()
    tconfig.reload()
    TPL.set_active(None, None)
    tbf.shutdown()
    JT.reset()
    TT.reset()


def _env(**kw):
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(kw)
    jconfig.reload()
    tconfig.reload()


def _values(snap: dict) -> dict:
    """Counters and gauges, histogram bucket counts too; no timing and no
    histogram sum."""
    out = {}
    for k, v in snap.items():
        name = k.split("{")[0]
        if name.endswith("_sum") or "seconds" in name \
                or name == "bf_throttle_waits_total":
            continue
        out[k] = v
    return out


def _calls(mod):
    mod.inc("bf_comm_calls_total", op="neighbor_allreduce")
    mod.inc("bf_comm_calls_total", 2.5, op="neighbor_allreduce")
    mod.inc("bf_win_ops_total", op="put")
    mod.set_gauge("bf_consensus_distance", 0.125)
    mod.set_gauge("bf_win_tx_queue_depth", 3, peer="h:1", stripe="0")
    mod.set_gauge("bf_straggler_score", float("nan"))
    mod.set_gauge("bf_schedule_max_link_load", float("inf"))
    for v in (3e-7, 1e-6, 4e-6, 2.5e-3, 0.7, 12.0, 80.0):
        mod.observe("bf_step_phase_seconds", v, phase="grad-compute")
    mod.observe("bf_comm_sync_seconds", 0.01)
    for v in (2e-6, 0.3, 70.0):
        mod.observe("bf_win_rpc_seconds", v, op="batch")
    mod.record_comm_traffic("dynamic_neighbor_allreduce", 4096.0, size=8,
                            sched_stats=(1.0, 8.0, None, "naive"), calls=3)
    mod.record_consensus_distance(0.5, 0.75)


def test_registry_and_prometheus_text_equal_jax():
    """The same call sequence: the same text, the same snapshot, the same
    percentiles."""
    _calls(JT)
    _calls(TT)
    assert TT.render_prometheus() == JT.render_prometheus()
    want, got = JT.snapshot(), TT.snapshot()
    assert list(got) == list(want)
    for k in want:
        assert (got[k] == want[k]) or (np.isnan(got[k]) and np.isnan(want[k]))
    assert TT._HIST_BUCKETS == JT._HIST_BUCKETS
    for name, labels in (("bf_step_phase_seconds", {"phase": "grad-compute"}),
                         ("bf_win_rpc_seconds", {"op": "batch"})):
        assert TT.histogram_percentiles(name, **labels) == \
            JT.histogram_percentiles(name, **labels)
    for mod in (JT, TT):
        mod.set_gauge("bf_win_tx_coalesce_ratio", 2.5)
        mod.set_gauge("bf_win_rx_decode_pool_busy", 1)
    want_h, got_h = JT.health(), TT.health()
    for key in ("status", "overdue_ops", "win_tx_coalesce_ratio",
                "win_tx_deepest_queue", "win_rx_decode_pool_busy"):
        assert got_h[key] == want_h[key], key
    records = [{"proc": 0, "c": [["a_total", [["op", "x"]], 1.0]],
                "g": [["g", [], 2.0]], "h": [["h", [], [1, 2], 0.5]]},
               {"proc": 1, "c": [["a_total", [["op", "x"]], 2.0]],
                "g": [["g", [], 5.0]], "h": [["h", [], [0, 1], 0.25]]}]
    assert TT._merge_records(records) == JT._merge_records(records)


def test_disabled_mutates_nothing():
    """``BLUEFOG_TPU_TELEMETRY=0``: every mutator returns before it touches
    the registry, the timers return None, and the eager ops, the
    optimizer's combine and the window ops record nothing."""
    _env(BLUEFOG_TPU_TELEMETRY="0")
    assert not TT.enabled()
    TT.inc("bf_x_total")
    TT.set_gauge("bf_g", 1.0)
    TT.observe("bf_h_seconds", 1.0)
    TT.record_comm_traffic("op", 1.0, size=1, sched_stats=(1, 1))
    TT.record_consensus_distance(1.0, 1.0)
    assert TT.start_timer() is None
    assert TT.observe_since(None, "bf_h_seconds") is None
    assert TT.consensus_every() == 0
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    x = torch.randn(N, 5)
    tbf.neighbor_allreduce(x)
    tbf.dynamic_neighbor_allreduce(x, 1)
    tbf.allreduce(x)
    p = x.clone().requires_grad_()
    p.grad = torch.ones_like(p)
    opt = tbf.optim.DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([p], lr=0.1), use_dynamic_topology=True)
    opt.step()
    tbf.win_create(x, "w")
    tbf.win_put(x, "w")
    tbf.win_update("w")
    tbf.win_free("w")
    reg = TT._registry
    assert not reg.counters and not reg.gauges and not reg.hists


def test_eager_ops_counters_equal_jax(devices):
    """``neighbor_allreduce`` static and dynamic, ``allreduce``,
    ``broadcast``, ``allgather`` and ``pair_gossip`` over
    ``ExponentialTwoGraph(8)``: calls, bytes, rounds, edges, wire bytes,
    provenance, the dispatch cache and the repack's compile cache."""
    _env()
    JSO.clear_compile_cache()
    TSO.clear_compile_cache()
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices)
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    x = np.random.RandomState(0).randn(N, 5).astype(np.float32)
    w = np.full((N, N), 0.0)
    np.fill_diagonal(w, 0.5)
    for r in range(N):
        w[(r + 1) % N, r] = 0.5
    for step in range(3):
        for bf in (jbf, tbf):
            bf.neighbor_allreduce(x)
            bf.dynamic_neighbor_allreduce(x, step)
            bf.allreduce(x)
            bf.broadcast(x, 2)
            bf.allgather(x)
            bf.pair_gossip(x, [1, 0, 3, 2, 5, 4, 7, 6])
            bf.neighbor_allreduce(x, src_weights=w)
    want, got = _values(JT.snapshot()), _values(TT.snapshot())
    assert got == want
    assert 'bf_comm_rounds_total{op="dynamic_neighbor_allreduce"}' in got
    assert got["bf_dispatch_cache_hits_total"] == 14


_JAX_TORUS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import bluefog_tpu as bf
    from bluefog_tpu import topology as tp
    from bluefog_tpu.ops import schedule_opt as SO
    from bluefog_tpu.utils import config, telemetry as T
    out = {}
    for spec in ("4x4", "16"):
        os.environ["BLUEFOG_TPU_FAKE_TORUS"] = spec
        config.reload()
        T.reset()
        SO.clear_compile_cache()
        bf.init(lambda: tp.ExponentialTwoGraph(16))
        x = np.ones((16, 3), np.float32)
        for step in range(2):
            bf.neighbor_allreduce(x)
            bf.dynamic_neighbor_allreduce(x, step)
        bf.set_topology(tp.RingGraph(16))
        bf.neighbor_allreduce(x)
        out[spec] = T.snapshot()
    print(json.dumps(out))
""")


def test_placement_counters_and_gauges_equal_jax():
    """``set_topology`` under ``BLUEFOG_TPU_FAKE_TORUS=4x4`` and ``16``
    (16 ranks): the placement and synthesis gauges, the provenance gauge,
    the repack's rounds saved, congestion moves and compile cache, and the
    dispatched ops' hop bytes and provenance counters."""
    env = dict(os.environ, BLUEFOG_TPU_PLACEMENT_ITERS="200",
               JAX_PLATFORMS="cpu")
    env.pop("BLUEFOG_TPU_FAKE_TORUS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_TORUS, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for spec in ("4x4", "16"):
        _env(BLUEFOG_TPU_FAKE_TORUS=spec, BLUEFOG_TPU_PLACEMENT_ITERS="200")
        TT.reset()
        TSO.clear_compile_cache()
        tbf.init(16, device="cpu",
                 topology_fn=lambda: ttopo.ExponentialTwoGraph(16))
        x = torch.ones(16, 3)
        for step in range(2):
            tbf.neighbor_allreduce(x)
            tbf.dynamic_neighbor_allreduce(x, step)
        tbf.set_topology(ttopo.RingGraph(16))
        tbf.neighbor_allreduce(x)
        got = _values(TT.snapshot())
        assert got == _values(want[spec]), spec
        assert "bf_placement_improvement_ratio" in got
        assert any(k.startswith("bf_schedule_hop_bytes_total") for k in got)


def test_hierarchical_ops_counters_equal_jax(devices):
    """Machines of 4: the hierarchical neighbor allreduce, its dynamic
    walk, ``local_allreduce`` and ``hierarchical_gossip`` with its level
    bytes and outer steps."""
    _env(BLUEFOG_TPU_HIER="1")
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices,
             local_size=4)
    tbf.init(N, device="cpu", local_size=4,
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    x = np.random.RandomState(1).randn(N, 6).astype(np.float32)
    for step in range(3):
        for bf in (jbf, tbf):
            bf.hierarchical_neighbor_allreduce(x)
            bf.dynamic_hierarchical_neighbor_allreduce(x, step)
            bf.local_allreduce(x)
            bf.hierarchical_gossip(x, step)
    want, got = _values(JT.snapshot()), _values(TT.snapshot())
    assert got == want
    assert 'bf_comm_level_bytes_total{level="dcn"}' in got
    assert got["bf_hier_outer_steps_total"] == 3


@pytest.mark.parametrize("order,dynamic", [("atc", True), ("awc", False)])
def test_sharded_combine_level_bytes_equal_jax(devices, order, dynamic):
    """Two steps of the sharded collective optimizer: the level bytes by
    level and shard equal the JAX step's.  (The port's combine also counts
    its calls, rounds and bytes, which the JAX package's jitted step does
    not: those series are the port's own.)"""
    from test_torch_port_sharded import _jax_steps, _port_steps, _specs
    _env()
    _jax_steps(devices, _specs(), order=order, dynamic=dynamic,
               compression="none", lr=0.0, steps=2)
    _port_steps(_specs(), order=order, dynamic=dynamic, compression="none",
                lr=0.0, steps=2)
    level = re.compile(r"^bf_comm_level_bytes_total")
    want = {k: v for k, v in JT.snapshot().items() if level.match(k)}
    got = {k: v for k, v in TT.snapshot().items() if level.match(k)}
    assert got == want and len(got) == 3
    op = "dynamic_neighbor_allreduce" if dynamic else "neighbor_allreduce"
    assert TT.snapshot()[f'bf_comm_calls_total{{op="{op}"}}'] == 2


def _registered_names() -> set:
    """Every literal ``bf_*`` series name the port's sources pass to the
    registry."""
    names = set()
    for path in (ROOT / "bluefog_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
                fn = node.func
                attr = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", "")
                if attr in ("inc", "set_gauge", "observe", "observe_since",
                            "clear_gauge", "clear_counter") and \
                        node.args[0].value.startswith("bf_"):
                    names.add(node.args[0].value)
            if isinstance(node, ast.Call) and len(node.args) > 1 and \
                    isinstance(node.args[1], ast.Constant) and \
                    str(node.args[1].value).startswith("bf_") and \
                    getattr(node.func, "attr", "") == "observe_since":
                names.add(node.args[1].value)
    return names


def test_every_registered_name_is_documented():
    doc = (ROOT / "docs" / "observability.md").read_text()
    names = _registered_names()
    assert "bf_comm_calls_total" in names | {"bf_comm_calls_total"}
    assert {"bf_win_ops_total", "bf_comm_sync_seconds",
            "bf_optimizer_step_seconds", "bf_step_phase_seconds",
            "bf_dispatch_cache_hits_total"} <= names
    missing = sorted(n for n in names if n not in doc)
    assert missing == []


def test_endpoint_serves_metrics_and_healthz():
    """``/metrics`` parses as Prometheus text with the comm series;
    ``/healthz`` answers ``ok``; ``maybe_start_endpoint`` binds the
    port ``BLUEFOG_TPU_TELEMETRY_PORT`` names (0: ephemeral)."""
    _env(BLUEFOG_TPU_TELEMETRY_PORT="0")
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    port = TT.server_port()
    assert port is not None
    try:
        tbf.neighbor_allreduce(torch.ones(N, 2))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        line = re.compile(r'^(# TYPE \w+ (counter|gauge|histogram)|'
                          r'[a-z_]+(\{[^}]*\})? \S+)$')
        assert all(line.match(ln) for ln in text.splitlines()), text
        assert 'bf_comm_calls_total{op="neighbor_allreduce"} 1' in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            body = json.loads(r.read().decode())
        assert body["status"] == "ok" and body["overdue_ops"] == []
        assert TT.start_http_server(0) == port  # idempotent
    finally:
        TT.stop_http_server()
    assert TT.server_port() is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_AGG_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.utils import telemetry as T
    bf.init_distributed(device="cpu")
    p = bf.process_ranks().process
    T.inc("bf_x_total", 1.0 + p, op="a")
    T.set_gauge("bf_g", 10.0 * (p + 1))
    T.observe("bf_h_seconds", 1e-3 * (p + 1))
    bf.neighbor_allreduce(torch.ones(len(bf.owned_ranks()), 3))
    snap = T.aggregate_snapshot()
    print("AGG", json.dumps(snap), flush=True)
    bf.shutdown()
""")


def test_aggregate_snapshot_across_two_gloo_processes():
    """Two processes of two ranks each: counters summed, gauges maxed,
    histograms merged bucket by bucket, one registry a process."""
    port = _free_port()
    procs = []
    for p in range(2):
        env = dict(os.environ, BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_DEVICES="2", OMP_NUM_THREADS="2",
                   BFTPU_WIN_HOST="127.0.0.1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _AGG_WORKER, str(ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [pr.communicate(timeout=120) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-3000:]
    snaps = [json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("AGG"))[4:])
             for out, _ in outs]
    assert snaps[0] == snaps[1]
    snap = snaps[0]
    assert snap['bf_x_total{op="a"}'] == 3.0
    assert snap["bf_g"] == 20.0
    assert snap["bf_h_seconds_count"] == 2.0
    assert snap['bf_h_seconds_bucket{le="0.001"}'] == 1.0
    assert snap['bf_h_seconds_bucket{le="0.0025"}'] == 2.0
    assert snap['bf_comm_calls_total{op="neighbor_allreduce"}'] == 2.0


@pytest.mark.parametrize("native_path", [True, False])
def test_transport_counters_on_both_paths(monkeypatch, native_path):
    """The same puts over loopback: the native path's counters, pumped
    from the C++ ones at the flush, equal the Python path's counted a
    message (calls a peer and op, bytes), with the frames and the
    coalescing ratio on each; a dropped peer's queue-depth gauges go."""
    from bluefog_tpu_torch.ops import transport as TTR
    monkeypatch.setenv("BLUEFOG_TPU_WIN_NATIVE", "1" if native_path else "0")
    monkeypatch.setenv("BLUEFOG_TPU_WIN_COALESCE_LINGER_MS", "50")
    tconfig.reload()
    got = []
    t = TTR.WindowTransport(lambda *m: got.append(m),
                            apply_batch=lambda ms: got.extend(ms))
    try:
        assert t.native_path == native_path
        payload = np.arange(6, dtype=np.float32)
        for src in range(5):
            t.send("127.0.0.1", t.port, TTR.OP_PUT, "w", src, 1, 0.5,
                   payload)
        t.send("127.0.0.1", t.port, TTR.OP_ACCUMULATE, "w", 0, 1, 0.5,
               payload)
        t.flush(timeout=30)
        t._tx_pump_last = 0.0
        if native_path:
            t._pump_native_tx_stats()
        import time
        deadline = time.time() + 10
        while len(got) < 6 and time.time() < deadline:
            time.sleep(0.01)
        snap = TT.snapshot()
        peer = f"127.0.0.1:{t.port}"
        assert snap['bf_win_tx_msgs_total{op="put"}'] == 5
        assert snap['bf_win_tx_msgs_total{op="accumulate"}'] == 1
        assert snap[f'bf_win_tx_bytes_total{{peer="{peer}"}}'] == 6 * 24
        assert snap["bf_win_tx_coalesce_ratio"] >= 1.0
        frames = snap.get("bf_win_native_tx_frames_total" if native_path
                          else "bf_win_tx_batch_size_count")
        assert frames is not None and 1 <= frames <= 6
        t.drop_peer("127.0.0.1", t.port)
        assert not any(k.startswith("bf_win_tx_queue_depth")
                       for k in TT.snapshot())
    finally:
        t.stop()
        monkeypatch.undo()
        tconfig.reload()
    assert len(got) == 6
