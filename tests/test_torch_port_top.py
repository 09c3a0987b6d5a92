"""``python -m bluefog_tpu_torch.tools top`` against the JAX package's
``tools top``, byte for byte on the same polls.

- ``parse_prometheus``: the exposition bodies of ``tests/test_linkobs.py``
  L467-475 and the port's own ``/metrics`` text.
- ``render_frame``: the frames of ``tests/test_linkobs.py`` L478-505 (the
  link matrix, a DOWN endpoint, the SLO column, the empty matrix) and
  ``tests/test_tuner.py`` L365-378 (the tune column, its probation flag,
  the gauge fallback), and the fused-overlap flag, with the clock in the
  title pinned.
- ``_discover_endpoints``: explicit endpoints, the gang directory the
  port persists, and the refusal without either.
- ``scrape`` against a live port telemetry server, and a dead endpoint;
  ``main_top --once`` over the live server.
Tolerance: exact throughout.
"""

import socket
import types

import pytest

from bluefog_tpu.tools import top as JT
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch.ops import gang as TGANG
from bluefog_tpu_torch.tools import top as TT
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both tools' title clock at one instant."""
    monkeypatch.setattr(JT.time, "strftime", lambda fmt: "12:34:56")
    monkeypatch.setattr(TT.time, "strftime", lambda fmt: "12:34:56")
    jconfig.reload()
    tconfig.reload()
    yield
    jconfig.reload()
    tconfig.reload()


_TEXTS = [
    ("# HELP bf_x whatever\n"
     "bf_async_step_lag 3\n"
     'bf_link_delay_us{dst="0",src="3"} 60000.0\n'
     "garbage-line-no-value\n"
     "bf_bad notanumber\n"),
    "",
    "# TYPE bf_y counter\n\nbf_y_total 1e3\n  bf_z 2.5  \n",
    ('bf_win_op_total{op="put"} 4\nbf_win_op_total{op="get"} 0\n'
     'bf_step_seconds_bucket{le="+Inf"} 7\n'),
]


@pytest.mark.parametrize("text", _TEXTS)
def test_parse_prometheus_equals_jax(text):
    assert TT.parse_prometheus(text) == JT.parse_prometheus(text)


def test_parse_prometheus_of_the_port_registry():
    telemetry.reset()
    try:
        telemetry.inc("bf_win_op_total", 2.0, op="put")
        telemetry.set_gauge("bf_async_step_lag", 3.0, rank="1")
        telemetry.observe("bf_step_seconds", 0.02)
        text = telemetry.render_prometheus()
        got = TT.parse_prometheus(text)
        assert got == JT.parse_prometheus(text)
        assert got['bf_async_step_lag{rank="1"}'] == 3.0
    finally:
        telemetry.reset()


_MATRIX = {
    'bf_link_delay_us{dst="0",src="3"}': 60000.0,
    'bf_link_delay_us{dst="0",src="1"}': 400.0,
    'bf_link_jitter_us{dst="0",src="3"}': 900.0,
    'bf_link_divergence_ratio{dst="0",src="3"}': 150.0,
    "bf_async_step_lag": 2.0,
}
_POLLS = {
    "matrix_and_down": {
        "h:9100": (_MATRIX, {
            "status": "degraded", "async": {"step": 41, "step_lag": 2},
            "links": {"slo": {"rules": ["link_delay_us>=20000"],
                              "breached": ["link_delay_us>=20000"]}}}),
        "h:9101": (None, None)},
    "empty_matrix": {"h:9100": ({}, {"status": "ok"})},
    "tune_column": {
        "h:1": ({"bf_x": 1.0}, {"status": "ok", "tuner": {
            "epoch": 1, "last_knob": "topology=ring+1", "probation": True}}),
        "h:2": ({"bf_x": 1.0}, {"status": "ok"}),
        "h:3": ({"bf_tune_epoch": 2.0}, None)},
    "overlap_membership_age": {
        "10.0.0.1:9100": ({
            "bf_fused_overlap_ratio": 0.25,
            "bf_fused_overlap_divergence_ratio": 0.1,
            'bf_win_tx_queue_depth{peer="a",stripe="0"}': 5.0},
            {"status": "ok",
             "membership": {"epoch": 2, "active_ranks": [0, 1, 2],
                            "world_ranks": 4, "suspect_ranks": [3]},
             "straggler": {"straggler_score": 1.5},
             "win_tx_deepest_queue": {"depth": 7},
             "contribution_age": {"1": {"stalest_sec": 0.25},
                                  "2": {"stalest_sec": 1.5}}}),
        "10.0.0.2:9100": ({"bf_fused_overlap_ratio": 0.5}, {
            "status": "stalled",
            "contribution_age": {"0": {"stalest_sec": 0.75}}})},
}


@pytest.mark.parametrize("case", sorted(_POLLS))
def test_render_frame_equals_jax(case, pinned_clock):
    polls = _POLLS[case]
    frame = TT.render_frame(polls)
    assert frame == JT.render_frame(polls)
    assert TT.render_frame(polls, width=72) == JT.render_frame(polls,
                                                              width=72)
    if case == "matrix_and_down":
        assert "1/2 endpoint(s) up" in frame and "DOWN" in frame
        assert "3 -> 0" in frame and "<- HOT" in frame
        assert "BREACH link_delay_us" in frame and "degraded" in frame
    elif case == "tune_column":
        rows = {ln[:3]: ln for ln in frame.splitlines()
                if ln.startswith("h:")}
        assert "1:topology=ri!" in rows["h:1"]
        assert " - " in rows["h:2"]
        assert "2 " in rows["h:3"][60:]
    elif case == "overlap_membership_age":
        assert "0.25!" in frame and "suspects [3]" in frame
        assert "stalest contribution: src 2" in frame


def test_discover_explicit_endpoints_equal_jax():
    args = types.SimpleNamespace(endpoints="h1:9100, h2:9101,,",
                                 gang_dir=None, telemetry_base=9100)
    assert TT._discover_endpoints(args) == JT._discover_endpoints(args) \
        == ["h1:9100", "h2:9101"]
    none = types.SimpleNamespace(endpoints=None, gang_dir=None,
                                 telemetry_base=9100)
    with pytest.raises(SystemExit) as t_exit:
        TT._discover_endpoints(none)
    with pytest.raises(SystemExit) as j_exit:
        JT._discover_endpoints(none)
    assert str(t_exit.value) == str(j_exit.value)


def test_discover_from_the_port_gang_directory_equals_jax(tmp_path):
    """The replicas the port persists (``GangDirectory.persist``) read by
    both tools: the live processes' hosts at ``base + proc``."""
    d = TGANG.GangDirectory(
        4, {0: "10.0.0.1:7000", 1: "10.0.0.2:7001", 2: "10.0.0.3:7002",
            3: "10.0.0.4:7003"}, epoch=1, active=[0, 1, 3],
        rank_owner={0: 0, 1: 1, 2: 2, 3: 3})
    prefix = str(tmp_path / "gang")
    d.persist(f"{prefix}.0.json")
    args = types.SimpleNamespace(endpoints=None, gang_dir=prefix,
                                 telemetry_base=9200)
    assert TT._discover_endpoints(args) == JT._discover_endpoints(args) \
        == ["10.0.0.1:9200", "10.0.0.2:9201", "10.0.0.4:9203"]


def test_scrape_a_live_port_endpoint_and_a_dead_one(pinned_clock):
    telemetry.reset()
    port = telemetry.start_http_server(0)
    try:
        telemetry.set_gauge("bf_async_step_lag", 4.0)
        metrics, health = TT.scrape(f"127.0.0.1:{port}", timeout=10.0)
        assert metrics == JT.scrape(f"127.0.0.1:{port}", timeout=10.0)[0]
        assert metrics["bf_async_step_lag"] == 4.0
        assert health["status"] in ("ok", "degraded", "stalled")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        assert TT.scrape(f"127.0.0.1:{dead}", timeout=2.0) == (None, None)
        polls = {f"127.0.0.1:{port}": (metrics, health),
                 f"127.0.0.1:{dead}": (None, None)}
        assert TT.render_frame(polls) == JT.render_frame(polls)
    finally:
        telemetry.stop_http_server()
        telemetry.reset()


def test_main_top_once_renders_one_frame(capsys, pinned_clock):
    telemetry.reset()
    port = telemetry.start_http_server(0)
    try:
        telemetry.set_gauge("bf_async_step_lag", 1.0)
        assert TT.main_top(["--endpoints", f"127.0.0.1:{port}",
                            "--once"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("bluefog_tpu top — 12:34:56 — 1/1 endpoint")
        assert "\x1b[2J" not in out and f"127.0.0.1:{port}" in out
        assert out.count("=" * 100) == 2
    finally:
        telemetry.stop_http_server()
        telemetry.reset()
