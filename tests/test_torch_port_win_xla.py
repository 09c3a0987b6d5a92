"""The port's put-plan path (``BLUEFOG_TPU_WIN_XLA``) against its oracle
and the JAX package.

* ``native/src/xlacall.cc`` is the JAX package's host part, line for line
  apart from its header note;
* the frames a plan encodes are byte for byte the JAX package's Python
  encoder's (and the port's host-staged encoder's) for every codec: raw,
  bf16 rounded to nearest even, and the sparse error-feedback sequence;
* through the window store of a loopback rig (even ranks here, odd ranks
  behind a local server transport feeding the same store, as the JAX
  package's ``tests/test_win_xla.py``), the same put and accumulate
  stream leaves bitwise the same window state with ``WIN_XLA=1`` and
  ``=0``, for every codec, with associated P on and off;
* the sparse residuals survive switches of path, a cached plan re-zeros
  its P masses, and the host-copy accounting counts by path.
"""

import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from bluefog_tpu.ops import window as JW
from bluefog_tpu_torch import native
from bluefog_tpu_torch import topology as ttopo
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch.ops import transport as TTR
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.ops import xlaffi
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry as TT

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("BLUEFOG_TPU_WIN_COALESCE", "BLUEFOG_TPU_WIN_NATIVE",
         "BLUEFOG_TPU_WIN_XLA", "BLUEFOG_TPU_WIN_COMPRESSION",
         "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS")
N = 8


@pytest.fixture
def xla_env(monkeypatch):
    """``set_env(**kv)`` reloads the config; caches reset after."""
    def set_env(**kv):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        tconfig.reload()
        xlaffi._reset_for_tests()
    yield set_env
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    tconfig.reload()
    xlaffi._reset_for_tests()
    TW._drop_ef_residuals()


def test_xlacall_is_the_jax_host_part():
    """The port's xlacall.cc is the JAX package's lines up to its XLA FFI
    section, unchanged below the port's header note."""
    jax_src = (ROOT / "bluefog_tpu/native/src/xlacall.cc").read_text()
    port = (ROOT / "bluefog_tpu_torch/native/src/xlacall.cc").read_text()
    inc = '#include "bluefog_native.h"'
    body = jax_src[jax_src.index(inc):]
    body = body[:body.index("// XLA FFI handler")]
    body = body[:body.rindex('}  // extern "C"')] + '}  // extern "C"\n'
    assert port[port.index(inc):] == body
    assert port.index(inc) > 0 and "XLA FFI" in port[:port.index(inc)]


class Recorder:
    """A server transport on the Python drain that records every message
    (op, name, src, dst, weight, p_weight, payload bytes)."""

    def __init__(self):
        self.got = []
        self.cv = threading.Condition()
        self.t = TTR.WindowTransport(self.apply)

    def apply(self, op, name, src, dst, weight, p_weight, payload):
        with self.cv:
            self.got.append((op, name, src, dst, weight, p_weight,
                             bytes(payload)))
            self.cv.notify_all()

    def wait(self, n):
        with self.cv:
            assert self.cv.wait_for(lambda: len(self.got) >= n, timeout=30)


@pytest.mark.parametrize("codec", ["none", "bf16", "sparse:0.4"])
def test_plan_frames_equal_the_jax_encoder(xla_env, codec):
    """Three rounds of a 2-edge plan (so the sparse residual fold runs):
    every frame's op byte, weight and payload equal the JAX package's
    Python encoder's on the same rows, and the port's host-staged
    encoder's."""
    xla_env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_NATIVE=0,
            BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=200)
    server = Recorder()
    xla_env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_NATIVE=1,
            BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=200)
    client = TTR.WindowTransport(lambda *a: None)
    lib = native.lib()
    elems, rounds = 11, 3
    name = f"cx_{codec.replace(':', '_').replace('.', '_')}"
    op = TTR.OP_ACCUMULATE
    codec_id = {"none": 0, "bf16": 1}.get(codec, 2)
    frac = 0.4 if codec.startswith("sparse") else 1.0
    rng = np.random.RandomState(7)
    rows = [rng.randn(2, elems).astype(np.float32) for _ in range(rounds)]
    try:
        assert client.native_path
        lib.bf_xla_drop_residuals(None)
        plan = lib.bf_xla_plan_new(name.encode(), elems, 2, codec_id, frac)
        for i, (src, dst) in enumerate([(0, 1), (0, 2)]):
            assert lib.bf_xla_plan_edge(plan, i, b"127.0.0.1",
                                        server.t.port, op, src, dst,
                                        0.25 * (i + 1), i, 0) == 0
        for r in range(rounds):
            data = np.ascontiguousarray(rows[r])
            assert lib.bf_xla_plan_run(plan, client._tx, data.ctypes.data,
                                       data.size) == 0
            client.flush()
        server.wait(2 * rounds)
        lib.bf_xla_plan_free(plan)
    finally:
        client.stop()
        server.t.stop()
    JW._drop_ef_residuals()
    TW._drop_ef_residuals()
    for k, (r, i) in enumerate((r, i) for r in range(rounds)
                               for i in range(2)):
        src, dst = [(0, 1), (0, 2)][i]
        row = np.ascontiguousarray(rows[r][i])
        if codec == "bf16":
            want = row.astype(ml_dtypes.bfloat16).tobytes()
            port = torch.from_numpy(row).to(torch.bfloat16).view(
                torch.uint8).numpy().tobytes()
            eop = op | TTR.OP_BF16_FLAG
        elif codec.startswith("sparse"):
            want = JW._sparse_payload("ref_" + name, src, dst, row,
                                      frac).tobytes()
            port = TW._sparse_payload("ref_" + name, src, dst,
                                      torch.from_numpy(row), frac).tobytes()
            eop = op | TTR.OP_SPARSE_FLAG
        else:
            want = port = row.tobytes()
            eop = op
        g = server.got[k]
        assert g[0] == eop and (g[1], g[2], g[3]) == (name, src, dst)
        assert g[4] == 0.25 * (i + 1)
        assert g[6] == want, "payload bytes against the JAX encoder"
        assert g[6] == port, "payload bytes against the host-staged path"


class Loopback:
    """The loopback rig: windows made in one process (every rank's slots),
    then a directory where odd ranks belong to a local server transport
    feeding the same store; even ranks' puts to odd ranks cross the
    wire."""

    def __init__(self):
        tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
        self.applied = 0
        self.cv = threading.Condition()
        self.server = TTR.WindowTransport(
            self._apply, apply_batch=self._apply_batch,
            apply_items=self._apply_items)
        self.client = TTR.WindowTransport(lambda *a: None)
        self.saved = TW._store.distrib
        self.names = []

    def _bump(self, k):
        with self.cv:
            self.applied += k
            self.cv.notify_all()

    def _apply(self, *msg):
        TW._apply_inbound(*msg)
        self._bump(1)

    def _apply_batch(self, msgs):
        TW._apply_inbound_batch(msgs)
        self._bump(len(msgs))

    def _apply_items(self, items):
        TW._apply_inbound_items(items)
        self._bump(sum((p[5] + p[6]) if k else 1 for k, p in items))

    def create(self, name, rows, zero_init=True):
        assert tbf.win_create(rows, name, zero_init=zero_init)
        self.server.register_window(name, rows[0].numel())
        self.names.append(name)

    def install(self):
        TW._store.distrib = TW._Distrib(
            self.client, rank_owner={r: r % 2 for r in range(N)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", self.server.port)}, my_proc=0)

    def wait(self, total):
        with self.cv:
            assert self.cv.wait_for(lambda: self.applied >= total,
                                    timeout=30), (self.applied, total)

    def state(self, name):
        return TW.win_state_dict(name)

    def close(self):
        TW._store.distrib = self.saved
        for name in self.names:
            tbf.win_free(name)
        self.client.stop()
        self.server.stop()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


def _drive(xla_env, paths, with_p, codec="none"):
    """One put and accumulate stream through the loopback store; step
    ``i`` takes the plan path when ``paths[i]``.  Returns the window
    state and the engaged plan runs."""
    xla_env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_NATIVE=1,
            BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
            BLUEFOG_TPU_WIN_COMPRESSION=codec)
    TT.reset()
    rig = Loopback()
    try:
        if with_p:
            TW.turn_on_win_ops_with_associated_p()
        rig.create("xeq", torch.zeros(N, 6))
        rig.install()
        total = 0
        for step, plan_path in enumerate(paths):
            t = torch.from_numpy(np.random.RandomState(300 + step).randn(
                N, 6).astype(np.float32))
            with tconfig.override(win_xla=plan_path):
                if step % 2:
                    TW.win_accumulate(t, "xeq",
                                      self_weight=0.5 if step == 3 else None,
                                      require_mutex=False)
                else:
                    TW.win_put(t, "xeq", require_mutex=False)
            total += N  # the ring's 8 remote edges from the even ranks
            rig.wait(total)
        runs = TT.snapshot().get("bf_win_xla_puts_total", 0.0)
        return rig.state("xeq"), runs
    finally:
        rig.close()


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for part in a:
        va, vb = a[part], b[part]
        if isinstance(va, dict):
            assert va.keys() == vb.keys(), part
            for k in va:
                np.testing.assert_array_equal(np.asarray(va[k]),
                                              np.asarray(vb[k]),
                                              err_msg=f"{part}[{k}]")
        elif torch.is_tensor(va) or isinstance(va, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
        else:
            assert va == vb, part


@pytest.mark.parametrize("with_p", [False, True])
@pytest.mark.parametrize("codec", ["none", "bf16", "sparse:0.5"])
def test_plan_path_state_is_the_host_path_state(xla_env, with_p, codec):
    """``WIN_XLA=1`` against ``=0``: the same stream leaves bitwise the
    same staging rows, versions, associated P and memory."""
    plan, runs = _drive(xla_env, [True] * 6, with_p, codec)
    host, host_runs = _drive(xla_env, [False] * 6, with_p, codec)
    assert runs == 6 * N and host_runs == 0
    _assert_state_equal(plan, host)


def test_sparse_residuals_survive_path_switch(xla_env):
    """Alternating the paths on one stream: each folds the other's
    residual, so the state is bitwise the one-path stream's."""
    mixed, runs = _drive(xla_env, [True, False, True, True, False, True],
                         True, "sparse:0.5")
    host, _ = _drive(xla_env, [False] * 6, True, "sparse:0.5")
    assert runs == 4 * N
    _assert_state_equal(mixed, host)


def test_plan_rezeroes_p_after_p_disable(xla_env):
    """A cached plan that shipped P ships 0.0 again once associated P is
    off, as the host-staged path does."""
    xla_env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_NATIVE=1,
            BLUEFOG_TPU_WIN_XLA=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=200)
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    server = Recorder()
    client = TTR.WindowTransport(lambda *a: None)
    saved = TW._store.distrib
    try:
        assert tbf.win_create(torch.zeros(N, 4), "pz", zero_init=True)
        TW._store.distrib = TW._Distrib(
            client, rank_owner={r: r % 2 for r in range(N)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", server.t.port)}, my_proc=0)
        t = torch.ones(N, 4)
        TW.turn_on_win_ops_with_associated_p()
        TW.win_accumulate(t, "pz", require_mutex=False)
        server.wait(N)
        assert [g[5] for g in server.got[:N]] == [1.0] * N
        TW.turn_off_win_ops_with_associated_p()
        TW.win_accumulate(t, "pz", require_mutex=False)
        server.wait(2 * N)
        assert [g[5] for g in server.got[N:2 * N]] == [0.0] * N
    finally:
        TW._store.distrib = saved
        tbf.win_free("pz")
        client.stop()
        server.t.stop()
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


@pytest.mark.parametrize("plan_path", [True, False])
def test_host_copy_accounting_by_path(xla_env, plan_path):
    """The plan path on the CPU reads the tensor's memory: no host copy
    is counted; the Python sender's queue counts its own copy
    (``enqueue``)."""
    xla_env(BLUEFOG_TPU_WIN_COALESCE=1,
            BLUEFOG_TPU_WIN_NATIVE=1 if plan_path else 0,
            BLUEFOG_TPU_WIN_XLA=1 if plan_path else 0,
            BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=200)
    TT.reset()
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    server = Recorder()
    client = TTR.WindowTransport(lambda *a: None)
    saved = TW._store.distrib
    try:
        assert tbf.win_create(torch.zeros(N, 6), "hc", zero_init=True)
        TW._store.distrib = TW._Distrib(
            client, rank_owner={r: r % 2 for r in range(N)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", server.t.port)}, my_proc=0)
        TW.win_put(torch.ones(N, 6), "hc", require_mutex=False)
        server.wait(N)
        snap = TT.snapshot()
        copies = {k: v for k, v in snap.items()
                  if k.startswith("bf_win_host_copy_bytes_total")}
        if plan_path:
            assert copies == {}
            assert snap["bf_win_xla_puts_total"] == N
            assert TW.stats.snapshot()["tx_bytes"] == N * 6 * 4
        else:
            assert copies == {
                'bf_win_host_copy_bytes_total{path="enqueue"}': N * 6 * 4.0}
    finally:
        TW._store.distrib = saved
        tbf.win_free("hc")
        client.stop()
        server.t.stop()
        tbf.shutdown()


def test_info_and_disarm(xla_env):
    xla_env(BLUEFOG_TPU_WIN_XLA=0)
    assert not xlaffi.armed()
    assert xlaffi.disarm_reason() == "BLUEFOG_TPU_WIN_XLA=0"
    assert tbf.win_xla_info()["armed"] is False
    xla_env()
    assert xlaffi.armed() and xlaffi.disarm_reason() is None
