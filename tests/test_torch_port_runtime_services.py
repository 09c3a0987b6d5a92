"""The port's runtime services against the JAX package's: the item-21
knobs, the leveled logger, the stall watchdog, the metrics meters and
writer, and the MB mode of the fusion buckets.

The knobs parse, default and refuse bad values as the JAX ``config`` does
(field for field); the logger maps the six-level scale the same way; a
stalled wait's warning names the probe's missing ranks in the JAX
package's words; ``metric_average`` and ``Metric`` equal the JAX meters on
the same values (exact: float32 means of small integers); the
``MetricsWriter`` lines are the same but for ``ts``; the MB-mode
``_bucket_groups`` gives the JAX package's groups over a grid of leaf sizes
and caps, and a bucketed optimizer's trajectory holds the JAX one within
1e-6.
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import logging as jlogging
from bluefog_tpu.utils import metrics as JM
from bluefog_tpu.utils import stall as JS
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import logging as tlogging
from bluefog_tpu_torch.utils import metrics as TM
from bluefog_tpu_torch.utils import stall as TS
from bluefog_tpu_torch.utils import telemetry as TT

N = 8
ITEM21 = {
    "BLUEFOG_TIMELINE": "timeline_prefix",
    "BLUEFOG_TPU_LOG_LEVEL": "log_level",
    "BLUEFOG_TPU_LOG_HIDE_TIME": "log_hide_time",
    "BLUEFOG_TPU_PYTHON_TIMELINE": "python_timeline",
    "BLUEFOG_TPU_STALL_WARNING_SEC": "stall_warning_sec",
    "BLUEFOG_TPU_TELEMETRY": "telemetry",
    "BLUEFOG_TPU_TELEMETRY_PORT": "telemetry_port",
    "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY": "telemetry_consensus_every",
    "BLUEFOG_TPU_FLIGHT_RECORDER": "flight_recorder",
    "BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS": "flight_recorder_events",
    "BLUEFOG_TPU_FLIGHT_RECORDER_PATH": "flight_recorder_path",
    "BLUEFOG_TPU_PROFILE": "profile",
    "BLUEFOG_TPU_PROFILE_EVERY": "profile_every",
    "BLUEFOG_TPU_FUSION_BUCKET_MB": "fusion_bucket_mb",
}
FIELDS = sorted(set(ITEM21.values()) | {"telemetry_consensus_set"})


@pytest.fixture
def env(monkeypatch):
    for k in ITEM21:
        monkeypatch.delenv(k, raising=False)

    def set_env(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, v)
        jconfig.reload()
        tconfig.reload()
    yield set_env
    monkeypatch.undo()
    jconfig.reload()
    tconfig.reload()


@pytest.mark.parametrize("case", [
    {},
    {"BLUEFOG_TIMELINE": "/tmp/tl_", "BLUEFOG_TPU_LOG_LEVEL": "DEBUG",
     "BLUEFOG_TPU_LOG_HIDE_TIME": "1", "BLUEFOG_TPU_PYTHON_TIMELINE": "yes",
     "BLUEFOG_TPU_STALL_WARNING_SEC": "0.5", "BLUEFOG_TPU_TELEMETRY": "0",
     "BLUEFOG_TPU_TELEMETRY_PORT": "0",
     "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY": "3",
     "BLUEFOG_TPU_FLIGHT_RECORDER": "true",
     "BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS": "128",
     "BLUEFOG_TPU_FLIGHT_RECORDER_PATH": "/tmp/fr",
     "BLUEFOG_TPU_PROFILE": "1", "BLUEFOG_TPU_PROFILE_EVERY": "7",
     "BLUEFOG_TPU_FUSION_BUCKET_MB": "2.5"},
    {"BLUEFOG_TPU_TELEMETRY": "True", "BLUEFOG_TPU_PROFILE": "no",
     "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY": "10",
     "BLUEFOG_TPU_TELEMETRY_PORT": "9100"},
])
def test_item21_knobs_parse_as_jax(env, case):
    env(**case)
    j, t = jconfig.get(), tconfig.get()
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("var,value", [
    ("BLUEFOG_TPU_TELEMETRY_PORT", "http"),
    ("BLUEFOG_TPU_STALL_WARNING_SEC", "a minute"),
    ("BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY", "2.5"),
    ("BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS", "many"),
    ("BLUEFOG_TPU_PROFILE_EVERY", ""),
    ("BLUEFOG_TPU_FUSION_BUCKET_MB", "4MB"),
])
def test_item21_knobs_refuse_as_jax(env, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError) as je:
        jconfig.reload()
    with pytest.raises(ValueError) as te:
        tconfig.reload()
    assert type(te.value) is type(je.value)
    monkeypatch.delenv(var)


def test_defaults_are_the_jax_packages(env):
    env()
    t = tconfig.get()
    assert t.telemetry and t.telemetry_consensus_every == 10
    assert not t.telemetry_consensus_set and t.telemetry_port is None
    assert (t.stall_warning_sec, t.profile_every, t.fusion_bucket_mb,
            t.flight_recorder_events, t.flight_recorder_path) == \
        (60.0, 50, 0.0, 65536, "flightrec")


@pytest.mark.parametrize("level,hide", [
    ("trace", "0"), ("debug", "1"), ("info", "0"), ("warn", "0"),
    ("warning", "1"), ("error", "0"), ("fatal", "0"), ("bogus", "0")])
def test_log_levels_as_jax(env, level, hide):
    env(BLUEFOG_TPU_LOG_LEVEL=level, BLUEFOG_TPU_LOG_HIDE_TIME=hide)
    assert tlogging.TRACE == jlogging.TRACE == 5
    got = {}
    for mod in (jlogging, tlogging):
        logger = logging.getLogger(
            "bluefog_tpu" if mod is jlogging else tlogging.LOGGER_NAME)
        saved = (logger.level, list(logger.handlers), mod._configured)
        logger.handlers.clear()
        mod._configured = False
        try:
            lg = mod.get_logger()
            got[mod] = (lg.level, lg.handlers[0].formatter._fmt)
        finally:
            logger.setLevel(saved[0])
            logger.handlers[:] = saved[1]
            mod._configured = saved[2]
    assert got[tlogging] == got[jlogging]
    assert logging.getLevelName(5) == "TRACE"


def test_stall_warning_names_the_missing_ranks(env, caplog):
    """A wait past the threshold warns with its op name and the probe's
    missing ranks, in the JAX package's words; ``/healthz`` lists it as
    overdue and stalled; the counter counts it."""
    env(BLUEFOG_TPU_STALL_WARNING_SEC="0.3")
    TT.reset()
    for mod in (JS, TS):
        mod.set_peer_probe(lambda: [2, 3])
    try:
        assert TS.StallMonitor._probe_peers() == JS.StallMonitor._probe_peers()
        with caplog.at_level(logging.WARNING, logger=tlogging.LOGGER_NAME):
            with TS.watch("probe-op"):
                time.sleep(1.2)
                hz = TT.health()
        msgs = [r.getMessage() for r in caplog.records
                if r.name == tlogging.LOGGER_NAME]
        assert any("'probe-op'" in m and "stalled" in m and
                   "Unreachable peer ranks: 2, 3." in m for m in msgs), msgs
        assert hz["status"] == "stalled"
        assert [o["op"] for o in hz["overdue_ops"]] == ["probe-op"]
        assert hz["unreachable_peer_ranks"] == [2, 3]
        assert TT.snapshot()['bf_stall_warnings_total{op="probe-op"}'] >= 1
        TS.set_peer_probe(lambda: [])
        assert TS.StallMonitor._probe_peers() == \
            " All peer transports are reachable (hung device op?)."
        TS._monitor.pause()
        assert TS._monitor.overdue_ops() == []
        TS._monitor.unpause()
    finally:
        for mod in (JS, TS):
            mod.set_peer_probe(None)
        TT.reset()


def test_metric_average_and_meter_equal_jax(devices):
    jbf.init(devices=devices)
    tbf.init(N, device="cpu")
    try:
        rng = np.random.RandomState(0)
        vals = rng.randint(-50, 50, size=N).astype(np.float32)
        assert TM.metric_average(vals) == JM.metric_average(vals)
        assert TM.metric_average(torch.from_numpy(vals)) == \
            JM.metric_average(vals)
        assert TM.metric_average(3.5) == JM.metric_average(3.5) == 3.5
        jm, tm = JM.Metric("acc"), TM.Metric("acc")
        for k in range(3):
            jm.update(vals + k)
            tm.update(torch.from_numpy(vals + k))
        assert tm.avg == jm.avg and tm.n == jm.n == 3
    finally:
        tbf.shutdown()


def test_metrics_writer_lines_equal_jax(tmp_path, monkeypatch):
    """The same lines but for ``ts``; one file a process in runs of
    several (``m.<proc>.jsonl``), as the JAX writer names them."""
    for var in ("BFTPU_NUM_PROCESSES", "BFTPU_PROCESS_ID", "WORLD_SIZE",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    lines = {}
    for mod, name in ((JM, "j.jsonl"), (TM, "t.jsonl")):
        with mod.MetricsWriter(str(tmp_path / name)) as w:
            assert w.path == str(tmp_path / name)
            w.log(step=0, loss=1.5, tag="warmup")
            w.log(step=1, loss=np.float32(0.75), acc=np.float64(0.5))
            w.log(rate=12)
            if mod is TM:
                w.log(step=3, loss=torch.tensor(0.25))
            else:
                w.log(step=3, loss=np.float32(0.25))
        recs = [json.loads(ln) for ln in open(tmp_path / name)]
        assert all("ts" in r for r in recs)
        lines[mod] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in recs]
    assert lines[TM] == lines[JM]
    monkeypatch.setenv("BFTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("BFTPU_PROCESS_ID", "1")
    for mod in (JM, TM):
        w = mod.MetricsWriter(str(tmp_path / "m.jsonl"))
        w.close()
        assert w.path == str(tmp_path / "m.1.jsonl")


class _Leaf:
    def __init__(self, numel, dtype):
        self.shape = (numel,)
        self.dtype = np.dtype(dtype)


@pytest.mark.parametrize("cap_mb", ["0", "0.00002", "0.0001", "0.001",
                                    "0.01", "1"])
def test_mb_mode_bucket_groups_equal_jax(env, cap_mb):
    """A grid of leaf sizes (f32 and bf16-sized) under each cap: the same
    groups, and ``fusion_buckets`` still wins over the cap."""
    env(BLUEFOG_TPU_FUSION_BUCKET_MB=cap_mb)
    rng = np.random.RandomState(int(float(cap_mb) * 1e6) % 97)
    for trial in range(20):
        sizes = rng.randint(1, 3000, size=rng.randint(1, 12))
        dtypes = rng.choice(["float32", "float16"], size=len(sizes))
        leaves = [_Leaf(int(s), d) for s, d in zip(sizes, dtypes)]
        nbytes = [int(s) * np.dtype(d).itemsize
                  for s, d in zip(sizes, dtypes)]
        assert TF._bucket_groups(nbytes, None) == \
            JF._bucket_groups(leaves, None)
        k = int(rng.randint(1, 5))
        assert TF._bucket_groups(nbytes, k) == JF._bucket_groups(leaves, k)


@pytest.mark.parametrize("cap_mb", ["0.00002", "0.0001"])
def test_bucketed_trajectory_within_1e6_of_jax(env, devices, cap_mb):
    """Three ATC steps over the dynamic topology with the leaves split
    into MB-capped buckets: the JAX optimizer's trajectory within 1e-6."""
    from test_torch_port_sharded import _jax_steps, _port_steps
    env(BLUEFOG_TPU_FUSION_BUCKET_MB=cap_mb)
    want, _ = _jax_steps(devices, None, order="atc", dynamic=True,
                         compression="none", lr=0.1, steps=3)
    got = _port_steps(None, order="atc", dynamic=True, compression="none",
                      lr=0.1, steps=3, flat=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert len(TF._bucket_groups([20, 128], None)) == 2
