"""The port's chaos faults against the JAX package's.

``utils/chaos.py`` is host logic: every spec, the malformed ones too,
parses to the same faults (or the same ``ValueError``) in both packages,
exactly; the injectors drive a fake transport through the same partition
and link-delay transitions.  Then the port transport's ``set_send_delay``
sleeps before DATA sends only, as the JAX transport's does.
"""

import time

import numpy as np
import pytest

from bluefog_tpu.utils import chaos as JC
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.utils import chaos as TC

SPECS = [
    None, "", "kill:rank=3:step=40",
    "kill:rank=3:step=40, delay:rank=1:step=10:steps=5:ms=50,"
    "partition:rank=2:step=20",
    "delay:rank=0:step=0", "partition:rank=1:step=2:steps=0",
    "linkdelay:rank=2:step=3:steps=4:ms=12.5",
    "kill:rank=0:step=1:steps=9:ms=3", " , kill:rank=1:step=1 ,",
    "delay:rank=1:step=2:ms=7:steps=3",
]

BAD = [
    "explode:rank=0:step=1",          # unknown kind
    "kill:rank=0",                    # missing step
    "kill:step=4",                    # missing rank
    "kill:rank=0:step=4:bogus=1",     # unknown field
    "kill:rank=-1:step=4",            # negative rank
    "kill:rank=0:step=-2",            # negative step
    "delay:rank=0:step=1:ms",         # field without a value
    "delay:rank=x:step=1",            # not an integer
    "linkdelay:rank=0:step=1:ms=fast",  # not a float
]


def _faults(mod, spec):
    return [(f.kind, f.rank, f.step, f.steps, f.ms, f.active_at(f.step),
             f.active_at(f.step + f.steps)) for f in mod.parse_chaos(spec)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_equals_jax(spec):
    """Tolerance: exact (the same fault tuples, the same kill list)."""
    assert _faults(TC, spec) == _faults(JC, spec)
    assert TC.killed_ranks(TC.parse_chaos(spec)) == \
        JC.killed_ranks(JC.parse_chaos(spec))


@pytest.mark.parametrize("bad", BAD)
def test_parse_chaos_rejects_as_jax(bad):
    """A malformed spec raises ``ValueError`` with the JAX package's
    message in both."""
    with pytest.raises(ValueError) as jerr:
        JC.parse_chaos(bad)
    with pytest.raises(ValueError) as terr:
        TC.parse_chaos(bad)
    assert str(terr.value) == str(jerr.value)


class _FakeTransport:
    def __init__(self):
        self.calls = []

    def set_partition(self, addrs):
        self.calls.append(("partition", sorted(addrs) if addrs else []))

    def set_send_delay(self, sec):
        self.calls.append(("delay", sec))


@pytest.mark.parametrize("spec", [
    "partition:rank=2:step=5:steps=3",
    "linkdelay:rank=2:step=1:steps=4:ms=30,linkdelay:rank=2:step=3:ms=80",
    "delay:rank=2:step=1:steps=2:ms=1,partition:rank=2:step=0:steps=2",
    "kill:rank=3:step=1,partition:rank=1:step=0",
])
def test_injectors_drive_the_same_transitions(spec):
    """The same steps give the same transport calls, in order (engaged
    once, healed once; faults of other ranks ignored)."""
    out = []
    for mod in (JC, TC):
        t = _FakeTransport()
        inj = mod.ChaosInjector(my_ranks=[2], faults=mod.parse_chaos(spec),
                                transport=t,
                                peer_addrs=[("h", 1), ("h", 2)])
        for step in range(12):
            inj.apply(step)
        out.append(t.calls)
    assert out[0] == out[1]
    assert bool(out[1]) == ("rank=2" in spec)


def test_injector_reads_the_config(monkeypatch):
    from bluefog_tpu_torch.utils import config
    monkeypatch.setenv("BLUEFOG_TPU_CHAOS", "kill:rank=5:step=2")
    config.reload()
    try:
        inj = TC.ChaosInjector(my_ranks=[5])
        assert [(f.kind, f.rank, f.step) for f in inj.faults] == \
            [("kill", 5, 2)]
        assert TC.ChaosInjector(my_ranks=[4]).faults == []
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_CHAOS")
        config.reload()


def test_send_delay_sleeps_on_data_ops_only(monkeypatch):
    """``set_send_delay`` sleeps before a DATA op's enqueue (put,
    accumulate, get reply) and never before a control op."""
    slept = []
    monkeypatch.setattr(T.time, "sleep", lambda s: slept.append(s))
    tr = T.WindowTransport.__new__(T.WindowTransport)
    tr.n_stripes = 1
    tr._send_delay = 0.0
    tr._bytes_lock = __import__("threading").Lock()
    tr.tx_bytes = 0
    sent = []
    tr._tx = None
    tr.coalesce = False
    tr._native_send = lambda *a: sent.append(a[2])
    monkeypatch.setattr(T.telemetry, "enabled", lambda: False)
    T.WindowTransport.set_send_delay(tr, 0.06)
    payload = np.zeros(4, np.float32)
    for op in (T.OP_PUT, T.OP_ACCUMULATE | T.OP_BF16_FLAG, T.OP_GET_REPLY,
               T.OP_MEMBER, T.OP_GANG, T.OP_FENCE_REQ, T.OP_MUTEX_ACQ):
        tr.send("h", 1, op, "w", 0, 1, 1.0, payload)
    assert slept == [0.06] * 3
    assert len(sent) == 7
    T.WindowTransport.set_send_delay(tr, 0.0)
    slept.clear()
    tr.send("h", 1, T.OP_PUT, "w", 0, 1, 1.0, payload)
    assert slept == []


@pytest.mark.parametrize("elems", [1 << 16, 8 << 20])
def test_member_frame_ships_at_once_behind_queued_data(elems):
    """An OP_MEMBER heartbeat is urgent on the native sender: queued
    behind a put on the same peer's FIFO (256 KiB, under the byte
    threshold, so only the heartbeat's urgency ships it; and 32 MiB), it
    cuts a 5 s linger and reaches the receiver right after the put."""
    import threading

    from bluefog_tpu_torch.utils import config
    got = []
    ev = threading.Event()

    def apply_items(items):
        for kind, payload in items:
            op = payload[0] if kind == 0 else None
            got.append((kind, op, time.monotonic()))
            if op is not None and (op & ~T.OP_FLAG_MASK) == T.OP_MEMBER:
                ev.set()

    with config.override(win_coalesce_linger_ms=5000.0):
        server = T.WindowTransport(lambda *a: None,
                                   apply_items=apply_items)
        client = T.WindowTransport(lambda *a: None)
    try:
        assert client.native_path
        big = np.ones(elems, np.float32)
        t0 = time.monotonic()
        client.send("127.0.0.1", server.port, T.OP_PUT, "w", 0, 1, 1.0, big)
        client.send("127.0.0.1", server.port, T.OP_MEMBER, "", 0, -1, 0.0,
                    np.frombuffer(b'{"k": "hb"}', np.uint8))
        assert ev.wait(timeout=4.0), "heartbeat waited for the linger"
        assert time.monotonic() - t0 < 4.0
        ops = [op & ~T.OP_FLAG_MASK for k, op, _ in got if k == 0]
        assert ops.index(T.OP_MEMBER) > ops.index(T.OP_PUT)
    finally:
        client.stop()
        server.stop()
