"""The port's gang join and bootstrap against the JAX package's.

``ops/gang.py``'s directory is host logic: the same directories give the
same dicts, merges (changed flags, conflict resolution) and persisted JSON
files, byte for byte, and ``load_any`` merges the same replicas;
``choose_admission_ranks`` picks the same seats through each package's
placement model.  A member's grant, built from the same window contents
under the same controller state, is the same ``OP_GANG`` payload byte for
byte, and the port decodes a JAX grant onto its device.  Tolerance: exact.
"""

import base64
import json
import os
import types

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.ops import gang as JG
from bluefog_tpu.ops import membership as JM
from bluefog_tpu.ops import placement as JP
from bluefog_tpu.ops import window as JW
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu_torch.ops import gang as TG
from bluefog_tpu_torch.ops import membership as TM
from bluefog_tpu_torch.ops import placement as TP
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry as TT


@pytest.fixture(autouse=True)
def _clean():
    yield
    for g in (JG, TG):
        g.install(None)
    for m in (JM, TM):
        m.install(None)
    JT.reset()
    TT.reset()
    jconfig.reload()
    tconfig.reload()


def _dirs(eps=None, epoch=0, active=(0, 1, 2, 3), owner=None, n=4):
    eps = eps if eps is not None else {p: f"h:{p + 1}" for p in range(4)}
    owner = owner if owner is not None else {r: r for r in range(n)}
    return [G.GangDirectory(n, eps, epoch=epoch, active=active,
                            rank_owner=owner) for G in (JG, TG)]


MERGES = [
    (dict(eps={0: "h:1", 1: "h:2"}, epoch=1, active=(0, 1)),
     dict(eps={1: "h:2", 4: "h:9"}, epoch=2, active=(0, 1, 4),
          owner={0: 0, 1: 1, 2: 4, 3: 3})),
    (dict(epoch=2, active=(0, 1)), dict(eps={0: "h:1"}, epoch=0)),
    (dict(eps={0: "h:5"}), dict(eps={0: "h:2"})),
    (dict(eps={0: "h:2"}), dict(eps={0: "h:5", 7: "z:1"}, epoch=3,
                                active=(0, 7), owner={0: 0, 1: 7})),
]


@pytest.mark.parametrize("i", range(len(MERGES)))
def test_directory_merge_equals_jax(i):
    a_kw, b_kw = MERGES[i]
    (ja, ta), (jb, tb) = _dirs(**a_kw), _dirs(**b_kw)
    assert json.dumps(ta.to_dict()) == json.dumps(ja.to_dict())
    changed = (ja.merge(jb), ta.merge(tb))
    assert changed[0] == changed[1]
    assert json.dumps(ta.to_dict()) == json.dumps(ja.to_dict())
    assert ta.vacant_ranks() == ja.vacant_ranks()
    assert ta.live_endpoints() == ja.live_endpoints()
    back = TG.GangDirectory.from_dict(ja.to_dict())
    assert back.to_dict() == ta.to_dict()


def test_persisted_files_and_load_any_equal_jax(tmp_path):
    """The replica files are the same bytes; ``load_any`` merges the same
    replicas (a corrupt one skipped) into the same directory."""
    for name, G, i in (("jax", JG, 0), ("port", TG, 1)):
        d = tmp_path / name
        a = _dirs(epoch=1, active=(0, 1, 3))[i]
        a.persist(str(d / "gang.0.json"))
        b = _dirs(eps={4: "h:9"}, epoch=2, active=(0, 1, 3, 4),
                  owner={0: 0, 1: 1, 2: 4, 3: 3})[i]
        b.persist(str(d / "gang.1.json"))
        (d / "gang.2.json").write_text("{not json")
        assert not os.path.exists(str(d / "gang.0.json.tmp"))
    for f in ("gang.0.json", "gang.1.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    jm = JG.GangDirectory.load_any(str(tmp_path / "jax" / "gang"))
    tm = TG.GangDirectory.load_any(str(tmp_path / "port" / "gang"))
    assert json.dumps(tm.to_dict()) == json.dumps(jm.to_dict())
    assert tm.epoch == 2 and tm.rank_owner[2] == 4
    with pytest.raises(FileNotFoundError):
        TG.GangDirectory.load_any(str(tmp_path / "nope"))


@pytest.mark.parametrize("spec", ["h1:10,h2:20", " a:1 , b:2,", "nocolon",
                                  "", ":5"])
def test_parse_peers_equals_jax(spec):
    def run(G):
        try:
            return G.parse_peers(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(TG) == run(JG)


@pytest.mark.parametrize("dims,perm_seed", [((4, 4), None), ((4, 4), 3),
                                            ((2, 4), None), ((2, 4), 7)])
def test_choose_admission_ranks_equals_jax(dims, perm_seed):
    """Through each package's placement model: the same seats for the same
    vacancies and actives (ties by rank id), and lowest ids without one."""
    n = int(np.prod(dims))
    perm = (None if perm_seed is None
            else np.random.RandomState(perm_seed).permutation(n))
    rng = np.random.RandomState(11)
    cases = []
    for _ in range(12):
        ranks = rng.permutation(n)
        k = rng.randint(1, n - 1)
        cases.append((sorted(ranks[:k].tolist()), int(rng.randint(1, 4)),
                      sorted(ranks[k:].tolist())))
    out = []
    for G, P in ((JG, JP), (TG, TP)):
        P.set_active(P.synthetic_torus(dims), perm)
        try:
            out.append([G.choose_admission_ranks(v, w, active_ranks=a)
                        for v, w, a in cases])
        finally:
            P.set_active(None, None)
        out.append([G.choose_admission_ranks(v, w, active_ranks=a)
                    for v, w, a in cases])
    assert out[2] == out[0] and out[3] == out[1]


class _FakeTransport:
    def __init__(self):
        self.sent = []

    def send(self, host, port, op, name, src, dst, weight, payload,
             *a, **kw):
        self.sent.append((host, port, op, name, src, dst, weight,
                          bytes(np.asarray(payload, np.uint8))))


def _grant_body(G, M, W):
    """One member's grant to a joiner, on a fake transport: the
    controller commits a shrink ({0, 1, 3} of 4 processes), the service's
    directory knows four endpoints."""
    ctrl = M.MembershipController(
        4, 0, {r: r for r in range(4)}, send_fn=lambda q, p: None,
        active=(0, 1, 3), epoch=1)
    M.install(ctrl)
    svc = G.GangService(G.GangDirectory(
        4, {p: f"h:{p + 1}" for p in range(4)}, epoch=1, active=(0, 1, 3),
        rank_owner={r: r for r in range(4)}))
    G.install(svc)
    tr = _FakeTransport()
    W._store.distrib = types.SimpleNamespace(my_proc=0, my_rank=0,
                                             transport=tr)
    try:
        svc._grant({"k": "join_req", "nonce": "n1", "ep": "10.0.0.9:7001",
                    "want": 1})
    finally:
        W._store.distrib = None
    return (tr.sent, {p: v[:2] for p, v in ctrl.pending_joins.items()},
            svc.grants_total)


def test_grant_payload_equals_jax(devices):
    """The grant message (the window's donor row as base64, the view, the
    directory) is the JAX member's, byte for byte; it reaches the joiner
    as an ``OP_GANG`` frame and the grantor records the pending join."""
    x = np.random.RandomState(0).randn(8, 3, 5).astype(np.float32)
    jbf.init(devices=devices)
    tbf.init(8, device="cpu")
    try:
        JW.win_create(x, "g", zero_init=True)
        TW.win_create(torch.from_numpy(x), "g", zero_init=True)
        jsent, jpend, jn = _grant_body(JG, JM, JW)
        tsent, tpend, tn = _grant_body(TG, TM, TW)
    finally:
        JW.win_free()
        TW.win_free()
        tbf.shutdown()
    assert tsent == jsent and len(tsent) == 1
    assert tsent[0][2] == TW.OP_GANG
    assert tpend == jpend and tn == jn == 1
    body = json.loads(tsent[0][-1])
    assert body["k"] == "grant" and body["ranks"] == [2]
    # The port decodes the JAX member's grant straight onto its device.
    g = TG._decode_grant(json.loads(jsent[0][-1]), "10.0.0.9:7001",
                         device=torch.device("cpu"))
    assert g.proc == 4 and g.ranks == (2,) and g.epoch == 1
    assert g.directory.vacant_ranks() == [2]
    row = g.windows["g"]["rows"][2]
    assert isinstance(row, torch.Tensor)
    np.testing.assert_array_equal(row.numpy(), x[0])


def test_decode_grant_bf16_rows():
    rows = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    msg = {"k": "grant", "proc": 5, "ranks": [2], "epoch": 3,
           "active": [0, 1, 3], "n_ranks": 4,
           "rank_owner": {"0": 0, "1": 1, "2": 2, "3": 3},
           "endpoints": {"0": "h:1"},
           "windows": {"w": {"shape": [2, 3], "dtype": "bfloat16",
                             "rows": {"2": base64.b64encode(
                                 rows.view(torch.uint8).numpy().tobytes()
                             ).decode()}}}}
    g = TG._decode_grant(msg, "h:9", device=torch.device("cpu"))
    assert torch.equal(g.windows["w"]["rows"][2], rows)
    assert TG._dtype_name(torch.bfloat16) == "bfloat16"
    assert TG._host_bytes(rows) == rows.view(torch.uint8).numpy().tobytes()


def test_handle_wire_and_waiters():
    """Garbage and frames nobody wants are dropped; a grant resolves its
    joiner's nonce waiter with no service installed; ``OP_GANG`` reaches
    the handler through the window store's drain entry."""
    import threading
    TG.handle_wire(b"not json")
    TG.handle_wire(b"\xff\xfe junk")
    ev = threading.Event()
    TG._join_waiters["abc"] = [ev, None]
    try:
        TW._apply_inbound(TW.OP_GANG, "", -1, -1, 0.0, 0.0, json.dumps(
            {"k": "grant", "nonce": "abc", "proc": 4, "ranks": [2],
             "n_ranks": 4}).encode())
        assert ev.is_set() and TG._join_waiters["abc"][1]["proc"] == 4
    finally:
        TG._join_waiters.pop("abc", None)


def test_service_summary_health_and_persist(tmp_path):
    svc = TG.GangService(_dirs(epoch=2, active=(0, 1, 3))[1],
                         persist_path=str(tmp_path / "g"))
    TG.install(svc)
    s = TG.health_summary()
    assert s["epoch"] == 2 and s["vacant_ranks"] == [2]
    assert TT.health()["gang_directory"]["epoch"] == 2
    assert tbf.gang_info() == s and tbf.gang is TG
    svc.persist()
    assert TT.snapshot().get("bf_gang_directory_epoch") == 2.0
    assert os.path.exists(str(tmp_path / "g") + ".json")
    TG.install(None)
    assert TG.health_summary() is None
    assert "gang_directory" not in TT.health()


def test_entry_points_require_the_knob(monkeypatch):
    tconfig.reload()
    with pytest.raises(RuntimeError, match="ELASTIC_JOIN"):
        TG.init_elastic()
    with pytest.raises(RuntimeError, match="ELASTIC_JOIN"):
        TG.join_gang("h:1")
    monkeypatch.setenv("BLUEFOG_TPU_ELASTIC_JOIN", "1")
    monkeypatch.delenv("BFTPU_GANG_PEERS", raising=False)
    tconfig.reload()
    with pytest.raises(RuntimeError, match="BFTPU_GANG_PEERS"):
        TG.init_elastic()
    assert TG.bootstrap_endpoints() is None
    monkeypatch.setenv("BFTPU_GANG_PEERS", "a:1,b:2")
    assert TG.bootstrap_endpoints() == [("a", 1), ("b", 2)]


def test_item20_knob_defaults_equal_jax(monkeypatch):
    for k in ("BLUEFOG_TPU_CHURN", "BLUEFOG_TPU_CHURN_HEARTBEAT_MS",
              "BLUEFOG_TPU_CHURN_SUSPECT_MS",
              "BLUEFOG_TPU_CHURN_STRAGGLER_STEPS",
              "BLUEFOG_TPU_ELASTIC_JOIN", "BLUEFOG_TPU_GANG_DIR_PATH",
              "BLUEFOG_TPU_JOIN_TIMEOUT_MS", "BLUEFOG_TPU_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    fields = ("churn", "churn_heartbeat_ms", "churn_suspect_ms",
              "churn_straggler_steps", "elastic_join", "gang_dir_path",
              "join_timeout_ms", "chaos")
    for env in ({}, {"BLUEFOG_TPU_CHURN": "1",
                     "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
                     "BLUEFOG_TPU_CHURN_SUSPECT_MS": "500",
                     "BLUEFOG_TPU_CHURN_STRAGGLER_STEPS": "3",
                     "BLUEFOG_TPU_ELASTIC_JOIN": "1",
                     "BLUEFOG_TPU_GANG_DIR_PATH": "/x/g",
                     "BLUEFOG_TPU_JOIN_TIMEOUT_MS": "500",
                     "BLUEFOG_TPU_CHAOS": "kill:rank=3:step=2"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jconfig.reload()
        tconfig.reload()
        assert [getattr(tconfig.get(), f) for f in fields] == \
            [getattr(jconfig.get(), f) for f in fields]


@pytest.mark.parametrize("schedule", ["overlapping", "older_last", "eight"])
def test_concurrent_persists_keep_the_newest_replica(tmp_path, caplog,
                                                     monkeypatch, schedule):
    """Threads of one process persist its replica at once (the commit's
    and an anti-entropy merge's): no write fails, no temporary file is
    left, and the replica on disk is the newest snapshot.
    ``overlapping``: two writes reach the rename together; ``older_last``:
    the epoch-1 snapshot's rename waits until the epoch-2 persist has
    finished (or 1 s); ``eight``: eight threads, each raising the epoch
    before its persist, reach the rename together."""
    import threading
    svc = TG.GangService(_dirs(epoch=1, active=(0, 1, 3))[1],
                         persist_path=str(tmp_path / "g"))
    real_replace = os.replace
    barrier = threading.Barrier(8 if schedule == "eight" else 2,
                                timeout=1.0)
    a_at_rename, b_done = threading.Event(), threading.Event()

    def replace(src, dst):
        if not str(dst).startswith(str(tmp_path)):
            return real_replace(src, dst)
        me = threading.current_thread().name
        if schedule != "older_last":
            try:
                barrier.wait()
            except threading.BrokenBarrierError:
                pass
        elif me == "a":
            a_at_rename.set()
            b_done.wait(1.0)
        real_replace(src, dst)
        if me == "b":
            b_done.set()

    monkeypatch.setattr(TG.os, "replace", replace)

    def raise_and_persist():
        with svc._lock:
            svc.directory.epoch += 1
        svc.persist()
    if schedule == "eight":
        threads = [threading.Thread(target=raise_and_persist, name=str(i))
                   for i in range(8)]
        for t in threads:
            t.start()
    else:
        threads = [threading.Thread(target=svc.persist, name="a"),
                   threading.Thread(target=svc.persist, name="b")]
        threads[0].start()
        if schedule == "older_last":
            assert a_at_rename.wait(5.0)
            with svc._lock:
                svc.directory.epoch = 2
        threads[1].start()
    for t in threads:
        t.join(20.0)
    assert not any(t.is_alive() for t in threads)
    assert "persist" not in caplog.text, caplog.text
    assert sorted(os.listdir(tmp_path)) == ["g.json"]
    on_disk = TG.GangDirectory.load(str(tmp_path / "g.json"))
    assert on_disk.epoch == svc.directory.epoch
    assert (tmp_path / "g.json").read_text() == \
        json.dumps(svc.directory.to_dict())


def test_directory_persists_to_one_path_at_once(tmp_path, monkeypatch):
    """Two threads write one replica path through
    ``GangDirectory.persist`` with their renames together: neither
    raises, no temporary file is left, and the file is one of the two
    directories' JSON whole."""
    import threading
    path = str(tmp_path / "gang.0.json")
    dirs = [_dirs(epoch=e, active=(0, 1, 3))[1] for e in (1, 2)]
    real_replace = os.replace
    barrier = threading.Barrier(2, timeout=1.0)

    def replace(src, dst):
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            pass
        real_replace(src, dst)

    monkeypatch.setattr(TG.os, "replace", replace)
    errors = []

    def write(d):
        try:
            d.persist(path)
        except Exception as e:  # noqa: BLE001 — the test's verdict
            errors.append(e)
    threads = [threading.Thread(target=write, args=(d,)) for d in dirs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert errors == []
    assert sorted(os.listdir(tmp_path)) == ["gang.0.json"]
    assert (tmp_path / "gang.0.json").read_text() in \
        [json.dumps(d.to_dict()) for d in dirs]


def test_a_failed_replica_write_leaves_no_temporary_file(tmp_path,
                                                         monkeypatch):
    """A rename that fails raises from ``GangDirectory.persist`` (the
    service logs it), leaves the previous replica and no temporary file."""
    path = tmp_path / "gang.0.json"
    a, b = (_dirs(epoch=e, active=(0, 1, 3))[1] for e in (1, 2))
    a.persist(str(path))

    def refuse(src, dst):
        raise OSError("refused")
    monkeypatch.setattr(TG.os, "replace", refuse)
    with pytest.raises(OSError, match="refused"):
        b.persist(str(path))
    assert sorted(os.listdir(tmp_path)) == ["gang.0.json"]
    assert path.read_text() == json.dumps(a.to_dict())
