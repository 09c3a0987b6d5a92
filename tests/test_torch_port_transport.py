"""The port's window transport against the JAX package's, on the CPU, in
one process over loopback.

- The ``OP_BATCH`` codec: the port's ``_encode_batch`` and ``_decode_batch``
  byte for byte the JAX package's, both ways.
- The wire across packages and hot paths: frames from the port's native
  (C++) and Python encoders decode bit for bit by the JAX package's
  decoders, and the other way round.
- A JAX ``WindowTransport`` sending puts, accumulates (dense, bf16 and
  sparse payloads) and fences to a port transport: the state the port's
  window store folds is bit for bit what a JAX receiver folds.
- The transport cases of ``tests/test_transport_batch.py``,
  ``tests/test_stripes.py`` and ``tests/test_native.py`` (L96, L165), run
  on the port: FIFO and fence order, error tokens scoped per peer,
  backpressure, retries, peer restart, ``drop_peer`` and
  ``set_partition``, striped interleavings, the fan-out serials, the
  decode pool's order, and the native and Python drains equal bit for
  bit.

The native service builds with ``g++`` at first use; without one the
tests that start a transport skip (decided in the ``built`` fixture).
"""

import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from _jax_native import ensure_jax_native
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import transport as JT
from bluefog_tpu.ops import window as JW
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import native as tnative
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.utils import config

N = 8
_ALL_OPS = (T.OP_PUT, T.OP_ACCUMULATE, T.OP_GET_REQ, T.OP_GET_REPLY,
            T.OP_FENCE_REQ, T.OP_FENCE_ACK, T.OP_MUTEX_ACQ,
            T.OP_MUTEX_GRANT, T.OP_MUTEX_REL)


@pytest.fixture
def built():
    """The port's native service, built from its sources (skips without
    a C++ compiler)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the window transport's native "
                    "service cannot be built")
    tnative.lib()


@pytest.fixture
def env(monkeypatch):
    """Set transport knobs for both packages; their configs reload."""
    def set_env(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        config.reload()
        jconfig.reload()
    yield set_env
    config.reload()
    jconfig.reload()


@pytest.fixture
def store():
    """The port's window store on 8 CPU ranks of a ring, with a fake
    directory (every rank owned here)."""
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
    d, stub = _stub_distrib(W)
    saved = W._store.distrib
    W._store.distrib = d
    try:
        yield stub
    finally:
        W._store.distrib = saved
        W.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


class _Stub:
    """Records what a window store sends (fence acks, mutex grants)
    without a wire."""

    n_stripes = 1

    def __init__(self):
        self.sent = []
        self.cv = threading.Condition()

    def send(self, host, port, op, name, src, dst, weight, tensor,
             p_weight=0.0, stripe=None):
        with self.cv:
            self.sent.append((op, name, src, dst, float(weight)))
            self.cv.notify_all()

    def wait_for(self, pred, timeout=30):
        with self.cv:
            ok = self.cv.wait_for(lambda: pred(self.sent), timeout=timeout)
        assert ok, f"the stub never saw what was expected: {self.sent}"

    def flush(self, *a, **k):
        pass

    def kick(self):
        pass

    def error_token(self, addrs=None):
        return 0

    def register_window(self, *a):
        pass

    def unregister_window(self, *a):
        pass

    def stop(self):
        pass


def _stub_distrib(mod):
    stub = _Stub()
    return mod._Distrib(stub, rank_owner={r: 0 for r in range(N)},
                        proc_addr={0: ("127.0.0.1", 1)}, my_proc=0), stub


class _Recorder:
    def __init__(self):
        self.msgs = []
        self.batches = 0
        self.cv = threading.Condition()

    def apply(self, op, name, src, dst, weight, p_weight, payload):
        with self.cv:
            self.msgs.append((op, name, src, dst, weight, p_weight,
                              bytes(payload)))
            self.cv.notify_all()

    def apply_batch(self, msgs):
        self.batches += 1
        for m in msgs:
            self.apply(*m)

    def apply_items(self, items):
        for kind, payload in items:
            assert kind == 0, "no windows registered: commits impossible"
            self.apply(*payload)

    def wait_for(self, n, timeout=30):
        with self.cv:
            ok = self.cv.wait_for(lambda: len(self.msgs) >= n,
                                  timeout=timeout)
        assert ok, f"only {len(self.msgs)}/{n} messages arrived"


def _dead_port():
    """A bound socket that never listens (connects are refused)."""
    dead = socket.socket()
    dead.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    dead.bind(("127.0.0.1", 0))
    return dead, dead.getsockname()[1]


# ---------------------------------------------------------------------------
# The OP_BATCH codec, byte for byte the JAX package's
# ---------------------------------------------------------------------------

def _random_batches(seed, count=50):
    rng = np.random.RandomState(seed)
    names = ["w", "", "very.long/param:name", "π-window", "x" * 127]
    for _ in range(count):
        msgs = []
        for _ in range(int(rng.randint(1, 40))):
            op = int(rng.choice(_ALL_OPS))
            if op in (T.OP_PUT, T.OP_ACCUMULATE) and rng.rand() < 0.3:
                op |= T.OP_BF16_FLAG
            payload = rng.bytes(int(rng.choice([0, 1, 7, 64, 4096])))
            msgs.append((op, str(rng.choice(names)),
                         int(rng.randint(-1, 64)), int(rng.randint(-1, 64)),
                         float(rng.randn()), float(rng.randn()), payload))
        yield msgs


@pytest.mark.parametrize("encoder,decoder", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_batch_codec_matches_jax_byte_for_byte(encoder, decoder):
    enc = {"port": T, "jax": JT}
    for msgs in _random_batches(0):
        blob = enc[encoder]._encode_batch(msgs)
        assert blob == enc["jax" if encoder == "port" else "port"]. \
            _encode_batch(msgs)
        out = enc[decoder]._decode_batch(memoryview(blob))
        assert len(out) == len(msgs)
        for a, b in zip(msgs, out):
            assert a[:6] == b[:6]
            assert a[6] == bytes(b[6])


def test_batch_decode_rejects_bad_version_and_trailing_bytes():
    msgs = [(T.OP_PUT, "w", 0, 1, 1.0, 0.0, b"\x01\x02")]
    blob = bytearray(T._encode_batch(msgs))
    blob[0] = T.BATCH_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        T._decode_batch(bytes(blob))
    with pytest.raises(ValueError, match="trailing"):
        T._decode_batch(T._encode_batch(msgs) + b"\x00")


def test_wire_constants_are_the_jax_packages():
    names = [k for k in dir(JT) if k.startswith("OP_")]
    assert names and all(getattr(T, k) == getattr(JT, k) for k in names)
    assert T.TRACE_TRAILER.format == JT.TRACE_TRAILER.format
    assert T.BATCH_VERSION == JT.BATCH_VERSION
    idx = np.array([3, 9, 11], np.int32)
    val = np.array([1.5, -2.0, 0.25], np.float32)
    assert T.sparse_encode(val, idx).tobytes() == \
        JT.sparse_encode(val, idx).tobytes()
    for name in ("w", "grad/layer.0", "x" * 100):
        for src in range(16):
            for op in (T.OP_PUT, T.OP_FENCE_REQ, T.OP_GET_REPLY):
                assert T.stripe_for(name, src, op, 4) == \
                    JT.stripe_for(name, src, op, 4)


# ---------------------------------------------------------------------------
# The wire across packages and hot paths
# ---------------------------------------------------------------------------

def _bf16(row):
    import jax.numpy as jnp
    return np.asarray(row, dtype=np.dtype(jnp.bfloat16))


def _mixed_stream(seed, count):
    """Dense, bf16 and sparse data payloads, zero-length control ops and
    awkward names."""
    rng = np.random.RandomState(seed)
    names = ["w", "a.b/c:d", "x" * 127]
    msgs = []
    for _ in range(count):
        if rng.rand() < 0.5:
            op = T.OP_PUT if rng.rand() < 0.4 else T.OP_ACCUMULATE
            row = rng.randn(6).astype(np.float32)
            kind = rng.rand()
            if kind < 0.2:
                op |= T.OP_BF16_FLAG
                payload = _bf16(row)
            elif kind < 0.4:
                op |= T.OP_SPARSE_FLAG
                idx = np.sort(rng.choice(6, size=3, replace=False))
                payload = T.sparse_encode(row[idx], idx.astype(np.int32))
            else:
                payload = row
            msgs.append((op, str(rng.choice(names)), int(rng.randint(N)),
                         int(rng.randint(N)), float(rng.rand() + 0.1),
                         float(rng.rand()), np.ascontiguousarray(payload)))
        else:
            op = int(rng.choice([T.OP_FENCE_REQ, T.OP_MUTEX_ACQ,
                                 T.OP_MUTEX_REL, T.OP_GET_REQ]))
            msgs.append((op, str(rng.choice(names)), int(rng.randint(N)),
                         int(rng.randint(N)), 0.0, 0.0,
                         np.zeros(0, np.float32)))
    return msgs


def _transport(pkg, native_on, env, rec=None):
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=200,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    mod = T if pkg == "port" else JT
    if rec is None:
        t = mod.WindowTransport(lambda *a: None)
    else:
        t = mod.WindowTransport(rec.apply, apply_batch=rec.apply_batch,
                                apply_items=rec.apply_items)
    assert t.native_path == native_on
    return t


ENDS = [("port", True), ("port", False), ("jax", True), ("jax", False)]
# Every (client, server) pair with the port at one end at least.
PAIRS = [(c, s) for c in ENDS for s in ENDS if "port" in (c[0], s[0])]


def _end(e):
    return f"{e[0]}-{'native' if e[1] else 'python'}"


@pytest.mark.parametrize("client,server", PAIRS,
                         ids=[f"{_end(c)}-to-{_end(s)}" for c, s in PAIRS])
def test_frames_decode_bit_identically_across_packages(built, env, client,
                                                       server):
    """Every frame the sender's encoder ships (its C++ arena or its Python
    ``_encode_batch``) is decoded bit for bit, in order, by the receiver's
    decoder (C++ drain or Python), across the two packages."""
    if "jax" in (client[0], server[0]):
        ensure_jax_native()
    msgs = _mixed_stream(7, 120)
    rec = _Recorder()
    srv = _transport(*server, env, rec)
    cli = _transport(*client, env)
    try:
        for (op, name, src, dst, w, pw, payload) in msgs:
            cli.send("127.0.0.1", srv.port, op, name, src, dst, w, payload,
                     p_weight=pw)
        cli.flush()
        rec.wait_for(len(msgs))
        for sent, rx in zip(msgs, rec.msgs):
            assert sent[:6] == rx[:6]
            assert np.ascontiguousarray(sent[6]).tobytes() == rx[6]
    finally:
        cli.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# A JAX sender folds to the same bits on a port receiver
# ---------------------------------------------------------------------------

def _fold_stream(seed=11, groups=12):
    """Groups of puts and accumulates (same-slot folds, window switches,
    bf16 and sparse edges), one flush a group."""
    out = []
    for g in range(groups):
        grng = np.random.RandomState(100 * seed + g)
        group = []
        for k in range(6):
            name = "eqa" if (g + k) % 3 else "eqb"
            dst = int(grng.randint(N))
            src = (dst + 1) % N if grng.rand() < 0.5 else (dst - 1) % N
            op = T.OP_PUT if grng.rand() < 0.3 else T.OP_ACCUMULATE
            row = grng.randn(5).astype(np.float32)
            payload = row
            roll = grng.rand()
            if roll < 0.25 and op == T.OP_ACCUMULATE:
                idx = np.sort(grng.choice(5, size=2, replace=False))
                payload = T.sparse_encode(row[idx], idx.astype(np.int32))
                op |= T.OP_SPARSE_FLAG
            elif roll < 0.5:
                payload = _bf16(row)
                op |= T.OP_BF16_FLAG
            group.append((op, name, src, dst, float(grng.rand() + 0.1),
                          np.ascontiguousarray(payload),
                          float(grng.rand())))
        out.append(group)
    return out


def _receive(env, receiver, server_native, client, client_native, with_p,
             stream):
    """Ship ``stream`` from a ``client`` package's transport into a
    ``receiver`` package's window store through its transport (every rank
    owned there); the store's staging, versions and P after the last
    message was applied."""
    rx_mod, rx_bf = (W, tbf) if receiver == "port" else (JW, jbf)
    x = np.random.RandomState(11).randn(N, 5).astype(np.float32)
    if receiver == "port":
        tbf.init(N, device="cpu", topology_fn=lambda: ttopo.RingGraph(N))
        make = torch.from_numpy
    else:
        jbf.init(lambda: jtopo.RingGraph(N))
        make = np.asarray
    if with_p:
        rx_bf.turn_on_win_ops_with_associated_p()
    applied = [0]
    cv = threading.Condition()

    def done(k):
        with cv:
            applied[0] += k
            cv.notify_all()

    def apply(*m):
        rx_mod._apply_inbound(*m)
        done(1)

    def apply_batch(msgs):
        rx_mod._apply_inbound_batch(msgs)
        done(len(msgs))

    def apply_items(items):
        rx_mod._apply_inbound_items(items)
        done(sum((p[5] + p[6]) if k else 1 for k, p in items))

    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
        BLUEFOG_TPU_WIN_NATIVE=1 if server_native else 0)
    tmod = T if receiver == "port" else JT
    server = tmod.WindowTransport(apply, apply_batch=apply_batch,
                                  apply_items=apply_items)
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
        BLUEFOG_TPU_WIN_NATIVE=1 if client_native else 0)
    cli = (T if client == "port" else JT).WindowTransport(lambda *a: None)
    d, _stub = _stub_distrib(rx_mod)
    saved = rx_mod._store.distrib
    rx_mod._store.distrib = d
    try:
        assert server.native_path == server_native
        for nm in ("eqa", "eqb"):
            assert rx_bf.win_create(make(x), nm, zero_init=True)
            server.register_window(nm, 5)
        total = 0
        for group in stream:
            for (op, name, src, dst, w, payload, pw) in group:
                cli.send("127.0.0.1", server.port, op, name, src, dst, w,
                         payload, p_weight=pw)
                total += 1
            cli.flush()
        with cv:
            assert cv.wait_for(lambda: applied[0] >= total, timeout=30), \
                (applied[0], total)
        return {nm: rx_bf.win_state_dict(nm) for nm in ("eqa", "eqb")}
    finally:
        rx_mod._store.distrib = saved
        cli.stop()
        server.stop()
        rx_bf.turn_off_win_ops_with_associated_p()
        if receiver == "port":
            tbf.shutdown()
        else:
            jbf.win_free()


def _assert_state_bitwise(want, got, ctx):
    for nm in want:
        for part in ("staging", "versions", "p_staging"):
            assert set(want[nm][part]) == set(got[nm][part]), (ctx, nm, part)
            for k, v in want[nm][part].items():
                g = got[nm][part][k]
                g = g.numpy() if isinstance(g, torch.Tensor) else g
                np.testing.assert_array_equal(
                    np.asarray(g), np.asarray(v),
                    err_msg=f"{ctx}: {nm}.{part}[{k}]")


@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("port_native", [True, False])
@pytest.mark.parametrize("with_p", [False, True])
def test_jax_sender_folds_to_the_same_bits_on_the_port(built, env, jax_native,
                                                       port_native, with_p):
    """A JAX transport's puts and accumulates, folded by the port's
    receiver (its C++ drain or its Python batched apply), land the same
    staging, versions and P as on a JAX receiver of the same path."""
    ensure_jax_native()
    stream = _fold_stream()
    want = _receive(env, "jax", port_native, "jax", jax_native, with_p,
                    stream)
    got = _receive(env, "port", port_native, "jax", jax_native, with_p,
                   stream)
    _assert_state_bitwise(want, got, "jax -> port")


@pytest.mark.parametrize("with_p", [False, True])
def test_native_vs_python_drain_state_equivalence_bitwise(built, env,
                                                          with_p):
    """The port's BLUEFOG_TPU_WIN_NATIVE=0/1 oracle: one wire stream lands
    the same state whether the drain's decode and fold ran in C++ or in
    Python."""
    stream = _fold_stream(seed=3)
    nat = _receive(env, "port", True, "port", True, with_p, stream)
    py = _receive(env, "port", False, "port", True, with_p, stream)
    _assert_state_bitwise(py, nat, "native vs python")


# ---------------------------------------------------------------------------
# Loopback transport cases (tests/test_native.py, test_transport_batch.py)
# ---------------------------------------------------------------------------

def test_window_transport_loopback(built):
    """Puts and accumulates arrive with weights and associated-P intact,
    ordered a sender."""
    received = []
    done = threading.Event()

    def apply(op, name, src, dst, weight, p_weight, payload):
        received.append((op, name, src, dst, weight, p_weight,
                         np.frombuffer(payload, np.float32).copy()))
        if len(received) == 3:
            done.set()

    server = T.WindowTransport(apply)
    client = T.WindowTransport(lambda *a: None)
    try:
        x = np.arange(4, dtype=np.float32)
        client.send("127.0.0.1", server.port, T.OP_PUT, "w", 1, 0, 0.25, x,
                    p_weight=0.5)
        client.send("127.0.0.1", server.port, T.OP_ACCUMULATE, "w", 2, 0,
                    0.75, 2 * x, p_weight=0.25)
        client.send("127.0.0.1", server.port, T.OP_PUT,
                    "very.long/param:name", 3, 0, 1.0,
                    np.zeros(0, np.float32))
        assert done.wait(timeout=10), f"only {len(received)} arrived"
        op, name, src, dst, w, pw, data = received[0]
        assert (op, name, src, dst, w, pw) == (T.OP_PUT, "w", 1, 0, 0.25,
                                               0.5)
        np.testing.assert_array_equal(data, x)
        assert received[1][0] == T.OP_ACCUMULATE and received[1][4] == 0.75
        np.testing.assert_array_equal(received[1][6], 2 * x)
        assert received[2][1] == "very.long/param:name"
        assert received[2][6].size == 0
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("native_on", [True, False])
def test_window_transport_large_payload(built, env, native_on):
    """A payload bigger than the drain's first buffer (it grows)."""
    env(BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    got = []
    done = threading.Event()

    def apply(op, name, src, dst, weight, p_weight, payload):
        got.append(np.frombuffer(payload, np.float32).copy())
        done.set()

    server = T.WindowTransport(apply)
    try:
        x = np.random.RandomState(0).randn(3 << 20).astype(np.float32)
        server.send("127.0.0.1", server.port, T.OP_PUT, "big", 0, 0, 1.0, x)
        assert done.wait(timeout=30)
        np.testing.assert_array_equal(got[0], x)
    finally:
        server.stop()


@pytest.mark.parametrize("native_on", [True, False])
def test_coalesced_loopback_keeps_fifo_and_fence_order(built, env,
                                                       native_on):
    """A burst of puts then a FENCE_REQ arrives in send order (the fence
    never overtakes a put), and the puts travel batched."""
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=5,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        for i in range(64):
            client.send("127.0.0.1", server.port, T.OP_PUT, "w", i, 0,
                        float(i), np.full(8, i, np.float32), p_weight=0.5)
        client.send("127.0.0.1", server.port, T.OP_FENCE_REQ, "", 0, -1,
                    0.0, np.zeros(0, np.float32))
        client.flush()
        rec.wait_for(65)
        ops = [m[0] for m in rec.msgs]
        assert ops == [T.OP_PUT] * 64 + [T.OP_FENCE_REQ]
        assert [m[2] for m in rec.msgs[:-1]] == list(range(64))
        for i, m in enumerate(rec.msgs[:-1]):
            np.testing.assert_array_equal(np.frombuffer(m[6], np.float32),
                                          np.full(8, i, np.float32))
        assert rec.batches >= 1, "coalescing on but nothing batched"
        assert client.tx_bytes == 64 * 32
    finally:
        client.stop()
        server.stop()


def test_coalesce_off_sends_a_frame_a_message(built, env):
    env(BLUEFOG_TPU_WIN_COALESCE=0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        assert not client.coalesce and not client.native_path
        for i in range(8):
            client.send("127.0.0.1", server.port, T.OP_ACCUMULATE, "w", i,
                        0, 1.0, np.full(4, i, np.float32))
        client.flush()
        rec.wait_for(8)
        assert rec.batches == 0
        assert [m[2] for m in rec.msgs] == list(range(8))
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("retries", [0, 3])
def test_send_retries_then_raises(built, env, retries):
    """A dead endpoint: the per-message send is retried
    ``BLUEFOG_TPU_WIN_RETRIES`` times with backoff, then raises; on the
    coalesced path the error surfaces at flush()."""
    dead, port = _dead_port()
    try:
        env(BLUEFOG_TPU_WIN_COALESCE=0, BLUEFOG_TPU_WIN_RETRIES=retries,
            BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS=1)
        t = T.WindowTransport(lambda *a: None)
        calls = []
        lib = t._lib

        class _Counting:
            def __getattr__(self, k):
                return getattr(lib, k)

            def bf_winsvc_send(self, *a):
                calls.append(1)
                return lib.bf_winsvc_send(*a)
        t._lib = _Counting()
        try:
            with pytest.raises(ConnectionError):
                t.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
                       np.zeros(4, np.float32))
        finally:
            t.stop()
        assert len(calls) == 1 + retries
        for native_on in (True, False):
            env(BLUEFOG_TPU_WIN_COALESCE=1,
                BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
            q = T.WindowTransport(lambda *a: None)
            try:
                q.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
                       np.zeros(4, np.float32))
                with pytest.raises(ConnectionError):
                    q.flush(timeout=30)
            finally:
                q.stop()
    finally:
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_flush_bytes_caps_frame_size(built, env, native_on):
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_BYTES=8192,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=20,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        row = np.zeros(1024, np.float32)
        for i in range(64):
            client.send("127.0.0.1", server.port, T.OP_PUT, "w", i, 0, 1.0,
                        row)
        client.flush()
        rec.wait_for(64)
        assert rec.batches >= 8, rec.batches
        assert [m[2] for m in rec.msgs] == list(range(64))
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("native_on", [True, False])
def test_error_token_surfaces_failure_to_late_flusher(built, env,
                                                      native_on):
    dead, port = _dead_port()
    env(BLUEFOG_TPU_WIN_COALESCE=1,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    t = T.WindowTransport(lambda *a: None)
    try:
        tok = t.error_token()
        t.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
               np.zeros(4, np.float32))
        with pytest.raises(ConnectionError):
            t.flush(timeout=30)
        with pytest.raises(ConnectionError):
            t.flush(timeout=30, since=tok)
        t.flush(timeout=30, since=t.error_token())
    finally:
        t.stop()
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_error_token_is_scoped_per_peer(built, env, native_on):
    dead, dead_port = _dead_port()
    env(BLUEFOG_TPU_WIN_COALESCE=1,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    live = ("127.0.0.1", server.port)
    try:
        tok = client.error_token({live})
        client.send("127.0.0.1", dead_port, T.OP_PUT, "w", 0, 1, 1.0,
                    np.zeros(4, np.float32))
        client.send(*live, T.OP_PUT, "w", 0, 2, 1.0, np.zeros(4, np.float32))
        client.flush(timeout=30, addrs={live}, since=tok)
        rec.wait_for(1)
        with pytest.raises(ConnectionError):
            client.flush(timeout=30)
    finally:
        client.stop()
        server.stop()
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_backpressure_blocks_producer_not_forever(built, env, native_on):
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_TX_QUEUE=4,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=0,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        for i in range(64):
            client.send("127.0.0.1", server.port, T.OP_PUT, "w", i, 0, 1.0,
                        np.zeros(16, np.float32))
        client.flush()
        rec.wait_for(64)
        assert [m[2] for m in rec.msgs] == list(range(64))
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("native_on", [True, False])
def test_peer_restart_scoped_failure_then_fresh_traffic(built, env,
                                                        native_on):
    """A dead peer fails only the ops that addressed it; restarted on the
    same port, it gets fresh traffic through the same client."""
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_RETRIES=1,
        BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS=5,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=1,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec_a = _Recorder()
    srv_a = T.WindowTransport(rec_a.apply, apply_batch=rec_a.apply_batch)
    dead, port_b = _dead_port()
    client = T.WindowTransport(lambda *a: None)
    addr_a, addr_b = ("127.0.0.1", srv_a.port), ("127.0.0.1", port_b)
    srv_b = None
    try:
        row = np.arange(4, dtype=np.float32)
        tok_a = client.error_token({addr_a})
        tok_b = client.error_token({addr_b})
        client.send(*addr_b, T.OP_PUT, "w", 0, 2, 1.0, row)
        client.send(*addr_a, T.OP_PUT, "w", 0, 1, 1.0, row)
        with pytest.raises(ConnectionError):
            client.flush(timeout=30, addrs={addr_b}, since=tok_b)
        client.flush(timeout=30, addrs={addr_a}, since=tok_a)
        rec_a.wait_for(1)
        dead.close()
        rec_b = _Recorder()
        srv_b = T.WindowTransport(rec_b.apply, apply_batch=rec_b.apply_batch,
                                  port=port_b)
        client.send(*addr_b, T.OP_PUT, "w", 0, 2, 7.0, row)
        client.flush(timeout=30, addrs={addr_b},
                     since=client.error_token({addr_b}))
        rec_b.wait_for(1)
        assert rec_b.msgs[0][4] == 7.0
    finally:
        client.stop()
        srv_a.stop()
        if srv_b is not None:
            srv_b.stop()
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_drop_peer_discards_queue_and_allows_lazy_recreate(built, env,
                                                           native_on):
    dead, port = _dead_port()
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_RETRIES=0,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    t = T.WindowTransport(lambda *a: None)
    try:
        t.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
               np.zeros(4, np.float32))
        t.drop_peer("127.0.0.1", port)
        t.flush(timeout=5)     # the dead peer's queue is gone
        t.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
               np.zeros(4, np.float32))
        with pytest.raises(ConnectionError):
            t.flush(timeout=10)   # a fresh sender met the dead peer again
    finally:
        t.stop()
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_set_partition_drops_sends_and_heals(built, env, native_on):
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_RETRIES=2,
        BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS=50,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    addr = ("127.0.0.1", server.port)
    try:
        client.set_partition({addr})
        client.send(*addr, T.OP_PUT, "w", 0, 1, 1.0, np.zeros(4, np.float32))
        with pytest.raises(ConnectionError):
            client.flush(timeout=30)
        client.set_partition(None)
        client.send(*addr, T.OP_PUT, "w", 0, 1, 1.0, np.zeros(4, np.float32))
        client.flush(timeout=30)
        rec.wait_for(1)
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("native_on", [True, False])
def test_drop_peer_fails_blocked_flusher_immediately(built, env,
                                                     native_on):
    dead, port = _dead_port()
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_RETRIES=0,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=50,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    t = T.WindowTransport(lambda *a: None)
    outcome = []

    def flusher():
        t0 = time.perf_counter()
        try:
            t.flush(timeout=30)
            outcome.append(("ok", time.perf_counter() - t0))
        except ConnectionError:
            outcome.append(("err", time.perf_counter() - t0))

    try:
        t.send("127.0.0.1", port, T.OP_PUT, "w", 0, 1, 1.0,
               np.zeros(4, np.float32))
        th = threading.Thread(target=flusher)
        th.start()
        time.sleep(0.2)
        t.drop_peer("127.0.0.1", port)
        th.join(timeout=10)
        assert not th.is_alive()
        assert outcome and outcome[0][0] == "err"
        assert outcome[0][1] < 3.0, outcome
    finally:
        t.stop()
        dead.close()


@pytest.mark.parametrize("native_on", [True, False])
def test_long_window_name_is_a_value_error(built, env, native_on):
    env(BLUEFOG_TPU_WIN_COALESCE=1,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    t = T.WindowTransport(lambda *a: None)
    try:
        with pytest.raises(ValueError, match="127"):
            t.send("127.0.0.1", t.port, T.OP_PUT, "n" * 200, 0, 1, 1.0,
                   np.zeros(4, np.float32))
    finally:
        t.stop()


# ---------------------------------------------------------------------------
# The window store's batched apply
# ---------------------------------------------------------------------------

def test_batched_apply_matches_sequential_apply(store):
    """``_apply_inbound_batch`` (grouped, folded, one lock hold) lands the
    same staging, versions and P as ``_apply_inbound`` message by message,
    within float32 rounding (a fold sums in another order)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(N, 5).astype(np.float32))
    W.turn_on_win_ops_with_associated_p()
    msgs = []
    for k in range(40):
        name = "ba" if (k // 7) % 2 == 0 else "bb"
        dst = int(rng.randint(N))
        src = (dst + 1) % N if rng.rand() < 0.5 else (dst - 1) % N
        op = T.OP_PUT if rng.rand() < 0.3 else T.OP_ACCUMULATE
        msgs.append((op, name, src, dst, float(rng.rand() + 0.1),
                     float(rng.rand()),
                     rng.randn(5).astype(np.float32).tobytes()))
    states = []
    for apply in (lambda: W._apply_inbound_batch(msgs),
                  lambda: [W._apply_inbound(*m) for m in msgs]):
        for nm in ("ba", "bb"):
            assert tbf.win_create(x, nm, zero_init=True)
        apply()
        states.append({nm: tbf.win_state_dict(nm) for nm in ("ba", "bb")})
        tbf.win_free()
    for nm in ("ba", "bb"):
        for part in ("staging", "versions", "p_staging"):
            for k, v in states[1][nm][part].items():
                np.testing.assert_allclose(
                    np.asarray(states[0][nm][part][k]), np.asarray(v),
                    rtol=1e-6, atol=1e-6, err_msg=f"{nm}.{part}[{k}]")


def test_batched_apply_zero_copy_payloads_are_safe(store):
    """A receive buffer scribbled after the apply leaves the state
    alone."""
    assert tbf.win_create(torch.zeros(N, 4), "zc", zero_init=True)
    buf = bytearray(np.full(4, 7.0, np.float32).tobytes())
    W._apply_inbound_batch([(T.OP_PUT, "zc", 1, 0, 1.0, 0.0,
                             memoryview(buf))])
    buf[:] = b"\xff" * len(buf)
    np.testing.assert_array_equal(W._store.get("zc").staging[(0, 1)],
                                  np.full(4, 7.0, np.float32))


@pytest.mark.parametrize("native_on", [True, False])
def test_batch_frame_through_store_fence_like_sequence(built, env, store,
                                                       native_on):
    """Through a real loopback transport into the store: the accumulates
    of a batch are applied before the trailing fence request is served."""
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=5,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0)
    assert tbf.win_create(torch.zeros(N, 3), "e2e", zero_init=True)
    server = W.make_transport()
    server.register_window("e2e", 3)
    client = T.WindowTransport(lambda *a: None)
    seen = []
    orig = store.send

    def send(host, port, op, name, src, dst, weight, tensor, p_weight=0.0,
             stripe=None):
        if op == T.OP_FENCE_ACK:
            win = W._store.get("e2e")
            with win.lock:
                seen.append(win.versions[(0, 1)])
        orig(host, port, op, name, src, dst, weight, tensor, p_weight,
             stripe)
    store.send = send
    try:
        row = np.arange(3, dtype=np.float32)
        for _ in range(5):
            client.send("127.0.0.1", server.port, T.OP_ACCUMULATE, "e2e", 1,
                        0, 1.0, row)
        client.send("127.0.0.1", server.port, T.OP_FENCE_REQ, "", 1, -1,
                    0.0, np.zeros(0, np.float32))
        client.flush()
        store.wait_for(lambda sent: any(s[0] == T.OP_FENCE_ACK
                                        for s in sent))
        assert seen == [5]
        np.testing.assert_allclose(W._store.get("e2e").staging[(0, 1)],
                                   5 * row)
    finally:
        client.stop()
        server.stop()


def test_native_fold_counts_versions(built, env, store):
    """Three accumulates into one slot fold into one commit entry and
    keep their three version ticks."""
    env(BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=500,
        BLUEFOG_TPU_WIN_NATIVE=1)
    assert tbf.win_create(torch.zeros(N, 4), "fold", zero_init=True)
    entries = []
    done = threading.Event()

    def apply_items(items):
        entries.extend(k for k, _ in items)
        W._apply_inbound_items(items)
        done.set()

    server = T.WindowTransport(W._apply_inbound,
                               apply_batch=W._apply_inbound_batch,
                               apply_items=apply_items)
    client = T.WindowTransport(lambda *a: None)
    try:
        server.register_window("fold", 4)
        row = np.arange(4, dtype=np.float32)
        for _ in range(3):
            client.send("127.0.0.1", server.port, T.OP_ACCUMULATE, "fold",
                        1, 0, 2.0, row)
        client.flush()
        assert done.wait(timeout=20)
        win = W._store.get("fold")
        assert entries == [1] and win.versions[(0, 1)] == 3
        np.testing.assert_array_equal(win.staging[(0, 1)], 6 * row)
    finally:
        client.stop()
        server.stop()


def test_control_ops_of_unported_subsystems_are_dropped(store, monkeypatch):
    """OP_MEMBER and OP_GANG go to the membership and gang handlers, which
    drop them when their subsystems are not installed: nothing is sent,
    parked or applied to a window."""
    from bluefog_tpu_torch.ops import gang, membership
    got = []
    monkeypatch.setattr(membership, "handle_wire",
                        lambda p: got.append(("member", bytes(p))))
    monkeypatch.setattr(gang, "handle_wire",
                        lambda p: got.append(("gang", bytes(p))))
    for op in (T.OP_MEMBER, T.OP_GANG):
        W._apply_inbound(op, "", 0, 0, 0.0, 0.0, b"{}")
    assert got == [("member", b"{}"), ("gang", b"{}")]
    monkeypatch.undo()
    for op in (T.OP_MEMBER, T.OP_GANG):
        W._apply_inbound(op, "", 0, 0, 0.0, 0.0, b"{}")
    assert not store.sent


# ---------------------------------------------------------------------------
# Striping (tests/test_stripes.py)
# ---------------------------------------------------------------------------

def test_resolve_stripes_auto_and_explicit(env, monkeypatch):
    env(BLUEFOG_TPU_WIN_STRIPES="auto")
    assert T.resolve_stripes() == 1
    env(BLUEFOG_TPU_WIN_STRIPES=5)
    assert T.resolve_stripes() == 5
    monkeypatch.setenv("BLUEFOG_TPU_WIN_STRIPES", "bogus")
    with pytest.raises(ValueError, match="BLUEFOG_TPU_WIN_STRIPES"):
        config.reload()
    env(BLUEFOG_TPU_WIN_STRIPES="auto")


def _scripted_stream(seed, n_ops=60):
    """Data ops, fences and mutex acquire/release pairs, with values exact
    in float32 (striping regroups same-slot folds; exact arithmetic makes
    bit for bit the honest assertion)."""
    rng = np.random.RandomState(seed)
    ops, open_ = [], None
    for k in range(n_ops):
        r = rng.rand()
        if open_ is not None and (r < 0.15 or k == n_ops - 1):
            ops.append(("rel",) + open_)
            open_ = None
        elif r < 0.12:
            ops.append(("fence", int(rng.randint(N))))
        elif r < 0.2 and open_ is None:
            open_ = ("wa" if rng.rand() < 0.5 else "wb",
                     int(rng.randint(N)), int(rng.randint(N)))
            ops.append(("acq",) + open_)
        else:
            name = "wa" if rng.rand() < 0.5 else "wb"
            dst = int(rng.randint(N))
            src = (dst + 1) % N if rng.rand() < 0.5 else (dst - 1) % N
            op = T.OP_PUT if rng.rand() < 0.3 else T.OP_ACCUMULATE
            row = rng.randint(-8, 9, size=6).astype(np.float32)
            ops.append(("data", op, name, src, dst,
                        float(rng.choice([0.25, 0.5, 1.0, 2.0])),
                        float(rng.choice([0.0, 0.5, 1.0])), row))
    if open_ is not None:
        ops.append(("rel",) + open_)
    return ops


def _run_striped(stripes, native_on, stream, env, store):
    env(BLUEFOG_TPU_WIN_STRIPES=stripes,
        BLUEFOG_TPU_WIN_NATIVE=1 if native_on else 0,
        BLUEFOG_TPU_WIN_COALESCE=1, BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=2)
    W.turn_on_win_ops_with_associated_p()
    store.sent.clear()
    server = W.make_transport()
    client = T.WindowTransport(lambda *a: None)
    try:
        assert client.n_stripes == stripes
        for nm in ("wa", "wb"):
            assert tbf.win_create(torch.zeros(N, 6), nm, zero_init=True)
            server.register_window(nm, 6)
        host, port, n = "127.0.0.1", server.port, client.n_stripes
        fan_w = W._fanout_weight(n)
        fences = grants = 0

        def count(op):
            return lambda sent: sum(1 for s in sent if s[0] == op)
        for item in stream + [("fence", 0)]:
            if item[0] == "data":
                _, op, name, src, dst, w, pw, row = item
                client.send(host, port, op, name, src, dst, w, row,
                            p_weight=pw)
            elif item[0] == "fence":
                fences += 1
                for k in range(n):
                    client.send(host, port, T.OP_FENCE_REQ, "", item[1], -1,
                                fan_w, np.zeros(0, np.float32), stripe=k)
                client.flush()
                want = fences
                store.wait_for(lambda s: count(T.OP_FENCE_ACK)(s) >= want)
            elif item[0] == "acq":
                _, name, rank, req = item
                client.send(host, port, T.OP_MUTEX_ACQ, name, req, rank,
                            0.0, np.zeros(0, np.float32))
                client.flush()
                grants += 1
                want = grants
                store.wait_for(lambda s: count(T.OP_MUTEX_GRANT)(s) >= want)
            else:
                _, name, rank, req = item
                for k in range(n):
                    client.send(host, port, T.OP_MUTEX_REL, name, req, rank,
                                fan_w, np.zeros(0, np.float32), stripe=k)
        return {nm: tbf.win_state_dict(nm) for nm in ("wa", "wb")}
    finally:
        client.stop()
        server.stop()
        tbf.win_free()


@pytest.mark.parametrize("seed,native_on,stripes",
                         [(0, True, 4), (1, True, 4), (2, True, 4),
                          (0, False, 3), (1, False, 3)])
def test_striped_interleavings_bitwise_equal(built, env, store, seed,
                                             native_on, stripes):
    """Put, accumulate, fence and mutex interleavings sharded over several
    stripes commit the single-stream state bit for bit."""
    stream = _scripted_stream(seed)
    ref = _run_striped(1, native_on, stream, env, store)
    got = _run_striped(stripes, native_on, stream, env, store)
    _assert_state_bitwise(ref, got, f"seed {seed}")


def test_native_vs_python_striped_equivalence(built, env, store):
    stream = _scripted_stream(7)
    a = _run_striped(4, True, stream, env, store)
    b = _run_striped(4, False, stream, env, store)
    _assert_state_bitwise(a, b, "native vs python")


def test_fence_fanout_acks_only_after_every_stripe_drained(built, env,
                                                           store):
    env(BLUEFOG_TPU_WIN_STRIPES=4, BLUEFOG_TPU_WIN_NATIVE=1,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=5)
    assert tbf.win_create(torch.zeros(N, 3), "ff", zero_init=True)
    at_ack = []
    orig = store.send

    def send(host, port, op, name, src, dst, weight, tensor, p_weight=0.0,
             stripe=None):
        if op == T.OP_FENCE_ACK:
            win = W._store.get("ff")
            with win.lock:
                at_ack.append(sum(win.versions.values()))
        orig(host, port, op, name, src, dst, weight, tensor, p_weight,
             stripe)
    store.send = send
    server = W.make_transport()
    server.register_window("ff", 3)
    client = T.WindowTransport(lambda *a: None)
    try:
        rng = np.random.RandomState(11)
        for _ in range(120):
            dst = int(rng.randint(N))
            client.send("127.0.0.1", server.port, T.OP_ACCUMULATE, "ff",
                        (dst + 1) % N, dst, 1.0,
                        rng.randn(3).astype(np.float32))
        for k in range(4):
            client.send("127.0.0.1", server.port, T.OP_FENCE_REQ, "", 2, -1,
                        4.0, np.zeros(0, np.float32), stripe=k)
        client.flush()
        store.wait_for(lambda s: any(x[0] == T.OP_FENCE_ACK for x in s))
        assert at_ack == [120]
    finally:
        client.stop()
        server.stop()


def test_stale_fanout_copies_cannot_complete_a_later_release(store):
    d = W._store.distrib
    ev = threading.Event()
    d.remote_holds[("w", 2, 1)] = ev
    for _ in range(3):       # release #1: 3 of its 4 copies arrive
        W._apply_inbound(T.OP_MUTEX_REL, "w", 1, 2, 4.0, 1.0, b"")
    assert not ev.is_set()
    W._apply_inbound(T.OP_MUTEX_REL, "w", 1, 2, 4.0, 2.0, b"")
    assert not ev.is_set()   # release #2's first copy does not complete it
    W._apply_inbound(T.OP_MUTEX_REL, "w", 1, 2, 4.0, 1.0, b"")
    assert not ev.is_set()   # a straggler of #1 is stale
    for _ in range(3):
        W._apply_inbound(T.OP_MUTEX_REL, "w", 1, 2, 4.0, 2.0, b"")
    assert ev.is_set()
    for _ in range(2):
        W._apply_inbound(T.OP_FENCE_REQ, "", 5, -1, 3.0, 1.0, b"")
    W._apply_inbound(T.OP_FENCE_REQ, "", 5, -1, 3.0, 2.0, b"")
    time.sleep(0.1)
    assert not store.sent
    for _ in range(2):
        W._apply_inbound(T.OP_FENCE_REQ, "", 5, -1, 3.0, 2.0, b"")
    store.wait_for(lambda s: any(x[0] == T.OP_FENCE_ACK for x in s))


def test_single_stripe_reproduces_prestripe_wire(built, env):
    env(BLUEFOG_TPU_WIN_STRIPES=1, BLUEFOG_TPU_WIN_NATIVE=0,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=2)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        host, port = "127.0.0.1", server.port
        expect = []
        for i in range(6):
            row = np.arange(4, dtype=np.float32) * (i + 1)
            client.send(host, port, T.OP_PUT, "w", i, 1, 0.5, row)
            expect.append((T.OP_PUT, "w", i, 1, 0.5, 0.0, row.tobytes()))
        client.send(host, port, T.OP_FENCE_REQ, "", 0, -1,
                    W._fanout_weight(1), np.zeros(0, np.float32), stripe=0)
        expect.append((T.OP_FENCE_REQ, "", 0, -1, 0.0, 0.0, b""))
        client.flush()
        rec.wait_for(len(expect))
        assert rec.msgs == expect
        assert sorted(k[2] for k in client._senders) == [0]
    finally:
        client.stop()
        server.stop()


def test_drop_peer_retires_all_stripes_native(built, env):
    env(BLUEFOG_TPU_WIN_STRIPES=3, BLUEFOG_TPU_WIN_NATIVE=1,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=1)
    rec = _Recorder()
    server = T.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
    client = T.WindowTransport(lambda *a: None)
    try:
        host, port = "127.0.0.1", server.port
        row = np.arange(8, dtype=np.float32)
        for i in range(30):
            client.send(host, port, T.OP_ACCUMULATE, "w", i, 1, 1.0, row)
        client.flush()
        rec.wait_for(30)
        client.drop_peer(host, port)
        for i in range(9):
            client.send(host, port, T.OP_ACCUMULATE, "w", i, 1, 1.0, row)
        client.flush()
        rec.wait_for(39)
    finally:
        client.stop()
        server.stop()


def test_decode_pool_preserves_per_edge_ordering(built, env):
    env(BLUEFOG_TPU_WIN_STRIPES=2, BLUEFOG_TPU_WIN_NATIVE=1,
        BLUEFOG_TPU_WIN_DECODE_THREADS=2,
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS=1)
    seen, bad, count = {}, [], [0]
    cv = threading.Condition()

    def apply_items(items):
        with cv:
            for kind, payload in items:
                if kind:
                    (name, _r, src, _d, _pm, puts, accs, vals, _wb,
                     _tr) = payload
                    if puts + accs == 1:
                        seq = int(vals[0])
                        if seq < seen.get((name, src), -1):
                            bad.append(((name, src), seq))
                        seen[(name, src)] = seq
                    count[0] += puts + accs
                else:
                    count[0] += 1
            cv.notify_all()

    server = T.WindowTransport(lambda *a: None, apply_items=apply_items)
    assert server.decode_threads == 2
    server.register_window("dp", 4)
    client = T.WindowTransport(lambda *a: None)
    try:
        for i in range(400):
            client.send("127.0.0.1", server.port, T.OP_PUT, "dp", i % 4, 1,
                        1.0, np.full(4, float(i), np.float32))
            if i % 37 == 0:
                client.flush()
        client.flush()
        with cv:
            assert cv.wait_for(lambda: count[0] >= 400, timeout=30)
        assert not bad, bad[:5]
    finally:
        client.stop()
        server.stop()
