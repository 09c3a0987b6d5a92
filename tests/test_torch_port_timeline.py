"""The port's timeline against the JAX package's.

The same ops traced in both packages give the same ``(cat, name, ph)``
event sequence: the eager collectives' ``ENQUEUE`` and
``synchronize``/``COMMUNICATE`` spans, the window ops' per-edge and
op-level spans, the user activities.  The port's native writer
(``native/src/timeline.cc``) and its Python writer write the same events,
both strict JSON with the clock anchor (the native one in its sidecar), and
the JAX package's ``tools.trace_merge`` reads the port's per-rank files
into strict JSON with one lane a rank.  Then the ranges the port enters in
place of ``jax.profiler.TraceAnnotation`` show in a ``torch.profiler``
trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu import tools as jtools
from bluefog_tpu.utils import timeline as JTL
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.utils import timeline as TTL

N = 8


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("BLUEFOG_TIMELINE", raising=False)
    monkeypatch.delenv("BLUEFOG_TPU_PYTHON_TIMELINE", raising=False)
    yield
    JTL.stop_timeline()
    TTL.stop_timeline()
    tbf.shutdown()


def _ops(bf, x):
    """The same op sequence in either package."""
    with bf.timeline_context("grad_sync", "USER"):
        bf.neighbor_allreduce(x)
    bf.dynamic_neighbor_allreduce(x, 1)
    bf.allreduce(x)
    bf.timeline_start_activity("t", "A")
    bf.broadcast(x, 0)
    bf.timeline_end_activity("t", "A")
    bf.win_create(x, "tl")
    bf.win_put(x, "tl")
    bf.win_update("tl")
    bf.win_get("tl")
    bf.win_free("tl")


def _events(path):
    with open(path) as f:
        return json.load(f)  # strict JSON


def _seq(events):
    return [(e.get("cat"), e["name"], e["ph"]) for e in events
            if e["ph"] != "M"]


def _trace_jax(devices, path):
    jbf.init(lambda: jtopo.ExponentialTwoGraph(N), devices=devices)
    JTL.start_timeline(path)
    _ops(jbf, np.random.RandomState(0).randn(N, 4).astype(np.float32))
    JTL.stop_timeline()


def _trace_port(path, python_writer):
    if python_writer:
        os.environ["BLUEFOG_TPU_PYTHON_TIMELINE"] = "1"
    else:
        os.environ.pop("BLUEFOG_TPU_PYTHON_TIMELINE", None)
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    assert tbf.start_timeline(path)
    assert not tbf.start_timeline(path)  # one open timeline
    _ops(tbf, torch.from_numpy(
        np.random.RandomState(0).randn(N, 4).astype(np.float32)))
    assert tbf.stop_timeline()
    assert not tbf.stop_timeline()


@pytest.mark.parametrize("python_writer", [True, False])
def test_event_sequence_equals_jax(devices, tmp_path, python_writer):
    """Both of the port's writers against the JAX package's Python
    writer: the same ``(cat, name, ph)`` sequence, every span closed."""
    os.environ["BLUEFOG_TPU_PYTHON_TIMELINE"] = "1"
    _trace_jax(devices, str(tmp_path / "jax.json"))
    _trace_port(str(tmp_path / "port.json"), python_writer)
    want = _seq(_events(tmp_path / "jax.json"))
    got = _seq(_events(tmp_path / "port.json"))
    assert got == want
    assert ("neighbor_allreduce", "ENQUEUE", "B") in got
    assert ("synchronize", "COMMUNICATE", "E") in got
    assert ("win_update.tl", "UPDATE", "B") in got
    assert got.count(("synchronize", "COMMUNICATE", "B")) == 4
    opened = {}
    for cat, name, ph in got:
        opened[(cat, name)] = opened.get((cat, name), 0) + \
            (1 if ph == "B" else -1)
    assert set(opened.values()) == {0}


def test_native_and_python_writers_write_the_same_events(tmp_path):
    """The same spans through both writers: the same events (name, cat,
    phase, thread; ``X`` spans keep their duration), each file strict JSON
    with its clock anchor, in the file or in the native sidecar."""
    def run(path, python_writer):
        os.environ["BLUEFOG_TPU_PYTHON_TIMELINE"] = \
            "1" if python_writer else "0"
        TTL.start_timeline(path)
        with TTL.op_span("allreduce", "ENQUEUE"):
            TTL.probe_span("bucket0", 10, 25, tid=7)
        with TTL.timeline_context("fwd"):
            pass
        TTL.stop_timeline()
        events = _events(path)
        keep = [(e["name"], e.get("cat"), e["ph"], e["tid"], e.get("dur"))
                for e in events if e["ph"] != "M"]
        return events, keep
    py_events, py = run(str(tmp_path / "py.json"), True)
    nat_events, nat = run(str(tmp_path / "nat.json"), False)
    assert nat == py and len(py) == 5
    anchor = [e for e in py_events if e["name"] == TTL.CLOCK_ANCHOR_NAME]
    assert len(anchor) == 1 and {"monotonic_us", "unix_us", "rank"} <= \
        set(anchor[0]["args"])
    assert not [e for e in nat_events if e["ph"] == "M"]
    with open(str(tmp_path / "nat.json") + ".anchor.json") as f:
        side = json.load(f)
    assert set(side) == {"monotonic_us", "unix_us", "rank"}


def test_trace_merge_reads_the_port_files(tmp_path, monkeypatch):
    """Two processes' files (``<prefix><rank>.json``, the native writer's
    with its sidecar): the JAX package's ``trace_merge`` gives strict JSON
    with one lane a rank."""
    prefix = str(tmp_path / "tl_")
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    x = torch.ones(N, 3)
    for proc in (0, 1):
        monkeypatch.setenv("BFTPU_PROCESS_ID", str(proc))
        monkeypatch.setenv("BLUEFOG_TIMELINE", prefix)
        assert TTL.timeline_enabled()  # autostart names <prefix><proc>.json
        tbf.neighbor_allreduce(x)
        TTL.stop_timeline()
        monkeypatch.delenv("BLUEFOG_TIMELINE")
    assert os.path.exists(prefix + "1.json.anchor.json")
    merged = jtools.trace_merge(prefix)
    events = _events(merged)
    lanes = {e["pid"] for e in events if e.get("ph") != "M"}
    assert lanes == {0, 1}
    assert sum(e.get("cat") == "neighbor_allreduce" for e in events) == 4


def test_ranges_show_in_a_torch_profiler_trace():
    """``record_function`` ranges stand where the JAX package enters
    ``TraceAnnotation``: a user activity and, with a profiler live, the
    framework's op spans."""
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    x = torch.ones(N, 3)
    with torch.profiler.profile() as prof:
        tbf.dynamic_neighbor_allreduce(x, 0)
    names = {e.key for e in prof.key_averages()}
    assert {"dynamic_neighbor_allreduce:ENQUEUE",
            "synchronize:COMMUNICATE"} <= names
    # No timeline, no profiler: op_span enters nothing.
    assert not torch.autograd._profiler_enabled()


def test_suspend_flushes_and_pauses(tmp_path):
    """``suspend()`` pauses the stall watchdog and flushes the timeline;
    ``resume()`` unpauses it."""
    from bluefog_tpu_torch.utils import stall
    os.environ["BLUEFOG_TPU_PYTHON_TIMELINE"] = "1"
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
    TTL.start_timeline(str(tmp_path / "s.json"))
    tbf.neighbor_allreduce(torch.ones(N, 2))
    tbf.suspend()
    assert stall._monitor._paused
    assert TTL._writer.q.empty()
    tbf.resume()
    assert not stall._monitor._paused
