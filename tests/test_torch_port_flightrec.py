"""The port's flight recorder against the JAX package's.

The ring is the same ``bf_rec_*`` code in both packages' native libraries
(the port's copy of ``winsvc.cc``), so the same notes give the same
events, oldest first, the ring wrapping the same way; the dump layout
(magic ``0xBFF11EC0``, version 1, the 48-byte event) is the same bytes, so
each package's ``load`` reads the other's dump.  Off, nothing is recorded
and nothing is dumped.  Then the transport's Python path notes its
ENQUEUE, FLUSH and SENDMSG events.
"""

import ctypes
import time

import numpy as np
import pytest

from bluefog_tpu.utils import flightrec as JF
from bluefog_tpu_torch import native as tnative
from bluefog_tpu_torch.utils import flightrec as TF

CAP = 64
FIELDS = ("src", "dst", "seq", "len", "etype", "op", "stripe", "flags",
          "name")


@pytest.fixture(autouse=True)
def _armed():
    if JF._lib() is None:
        pytest.skip("the JAX package's native core is not built here")
    caps = (TF.enable(CAP) and tnative.lib().bf_rec_enable(CAP),
            JF.enable(CAP) and JF._lib().bf_rec_enable(CAP))
    TF.reset()
    JF.reset()
    yield caps
    TF.reset()
    JF.reset()


def _notes(mod, count):
    for i in range(count):
        mod.note(1 + i % 7, op=i % 13, stripe=i % 3, src=i, dst=-i,
                 seq=(i * 2654435761) & 0xFFFFFFFF, length=100 * i,
                 name=f"win{i}" + "x" * (i % 30))


def _fields(events):
    return [tuple(e[f] for f in FIELDS) for e in events]


def test_event_layout_is_the_jax_packages():
    assert TF.EVENT_DTYPE == JF.EVENT_DTYPE
    assert TF.EVENT_DTYPE.itemsize == 48
    assert ctypes.sizeof(tnative.RecEvent) == 48
    assert (TF.MAGIC, TF.VERSION, TF.HEADER.format) == \
        (JF.MAGIC, JF.VERSION, JF.HEADER.format)
    assert TF.ETYPE_NAMES == JF.ETYPE_NAMES
    assert (TF.ENQUEUE, TF.COMMIT) == (JF.ENQUEUE, JF.COMMIT) == (1, 7)


def test_snapshot_equals_jax(_armed):
    _notes(TF, 10)
    _notes(JF, 10)
    got, want = TF.snapshot(), JF.snapshot()
    assert len(got) == 10
    assert _fields(got) == _fields(want)
    assert got["name"][3] == b"win3xxx"
    assert (np.diff(got["t_us"]) >= 0).all()


def test_ring_wraps_oldest_first_as_jax(_armed):
    tcap, jcap = _armed
    _notes(TF, tcap + 5)
    _notes(JF, jcap + 5)
    got, want = TF.snapshot(), JF.snapshot()
    assert len(got) == tcap
    assert got["src"][0] == 5 and got["src"][-1] == tcap + 4
    if tcap == jcap:
        assert _fields(got) == _fields(want)


def test_dumps_read_both_ways(tmp_path, monkeypatch, _armed):
    """The port's dump through the JAX ``load`` and the other way round:
    the same header (rank, count, the clock anchor) and events."""
    monkeypatch.setenv("BFTPU_PROCESS_ID", "3")
    _notes(TF, 12)
    _notes(JF, 12)
    tpath = TF.dump(str(tmp_path / "port.bin"), reason="test")
    jpath = JF.dump(str(tmp_path / "jax.bin"), reason="test")
    th, tev = JF.load(tpath)
    jh, jev = TF.load(jpath)
    assert th["rank"] == jh["rank"] == 3 and th["count"] == jh["count"] == 12
    assert th["unix_us"] > 0 and th["mono_us"] > 0
    assert _fields(tev) == _fields(jev) == _fields(TF.snapshot())
    for mod, path in ((TF, tpath), (JF, jpath)):
        h, ev = mod.load(path)
        assert len(ev) == 12
    # The default path: <prefix>.<rank>.bin.
    monkeypatch.setenv("BLUEFOG_TPU_FLIGHT_RECORDER_PATH",
                       str(tmp_path / "fr"))
    from bluefog_tpu_torch.utils import config as tconfig
    tconfig.reload()
    try:
        assert TF.dump() == str(tmp_path / "fr.3.bin")
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_FLIGHT_RECORDER_PATH")
        tconfig.reload()
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 40)
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="not a flight-recorder dump"):
            mod.load(str(bad))


def test_dump_on_error_is_rate_limited(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_TPU_FLIGHT_RECORDER_PATH",
                       str(tmp_path / "auto"))
    from bluefog_tpu_torch.utils import config as tconfig
    tconfig.reload()
    try:
        monkeypatch.setattr(TF, "_last_auto_dump", [0.0])
        TF.dump_on_error("first")
        TF.dump_on_error("second, within 30 s")
        assert len(list(tmp_path.glob("auto.*.bin"))) == 1
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_FLIGHT_RECORDER_PATH")
        tconfig.reload()


def test_off_records_and_dumps_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(TF, "_on", False)
    assert not TF.enabled()
    TF.note(TF.ENQUEUE, name="x")
    assert len(TF.snapshot()) == 0
    assert TF.dump(str(tmp_path / "off.bin")) is None
    assert not (tmp_path / "off.bin").exists()
    monkeypatch.delenv("BLUEFOG_TPU_FLIGHT_RECORDER", raising=False)
    assert TF.maybe_enable() is False


def test_python_transport_path_notes_its_events(monkeypatch, _armed):
    """The Python sender notes ENQUEUE, FLUSH and SENDMSG for a put over
    loopback, with the JAX package's fields."""
    from bluefog_tpu_torch.ops import transport as TTR
    from bluefog_tpu_torch.utils import config as tconfig
    monkeypatch.setenv("BLUEFOG_TPU_WIN_NATIVE", "0")
    monkeypatch.setenv("BLUEFOG_TPU_WIN_COALESCE_LINGER_MS", "0")
    tconfig.reload()
    got = []
    t = TTR.WindowTransport(lambda *m: got.append(m))
    try:
        TF.reset()
        payload = np.arange(6, dtype=np.float32)
        t.send("127.0.0.1", t.port, TTR.OP_PUT, "fr", 1, 2, 0.5, payload)
        t.flush(timeout=30)
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.01)
    finally:
        t.stop()
        monkeypatch.undo()
        tconfig.reload()
    ev = TF.snapshot()
    kinds = [int(e["etype"]) for e in ev]
    assert kinds[:3] == [TF.ENQUEUE, TF.FLUSH, TF.SENDMSG]
    enq = ev[0]
    assert (int(enq["op"]), int(enq["src"]), int(enq["dst"]),
            int(enq["len"]), enq["name"]) == (TTR.OP_PUT, 1, 2, 24, b"fr")
    assert int(ev[2]["len"]) == 24 and len(got) == 1
