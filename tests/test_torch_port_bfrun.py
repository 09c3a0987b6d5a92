"""The port's ``bfrun`` (``python -m bluefog_tpu_torch.run``) against the
JAX package's launcher, on the CPU with gloo.

- ``parse_hosts`` held to the JAX function on the same specs, the errors
  too (``tests/test_runtime_services.py``'s cases);
- ``test_bfrun_local_fanout``, ``test_bfrun_host_slots_local``: the same
  ``BFTPU_*`` rendezvous in every child;
- ``test_bfrun_distributed_consensus`` and ``test_multiprocess_collectives``
  (P=2): children that join one ``torch.distributed`` gloo group through
  ``bf.init_distributed(device="cpu")``, two ranks a process, and check
  the allreduce, the neighbor averages, the dynamic walk, the
  hierarchical and pair gossip against numpy;
- ``tests/test_churn.py`` L541-640: the ``--chaos`` parser and its
  refusals, ``_wait_gang``'s toleration of a chaos kill, the gang stopped
  on any other failure, the TERM -> KILL escalation and ``_exit_reason``,
  each the same text as the JAX launcher's;
- the port's ``--devices-per-proc`` sets only ``BFTPU_LOCAL_DEVICES``
  (nothing forces the CPU), and its exit summary ends a clean finish too
  (the JAX launcher prints it only when it stops the gang).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bluefog_tpu.run import run as JR
from bluefog_tpu_torch.run import run as TR

REPO = str(Path(__file__).resolve().parents[1])


def _bfrun(argv, timeout=300, env=None):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=env)


# -- host slots --------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [
    ("h1:2,h2:2", 4), ("h1:2,h2:2", 3), ("h1,h2", 2), (" h1:1 , h2:1 ", 2),
    ("h1:2,h1:2", 4), ("h1:1", 2), ("h1:zero", 1), ("h1:0", 1), (":3", 1),
    ("h1:3,,h2", 4)])
def test_parse_hosts_equals_jax(spec, n):
    """``test_parse_hosts_slots`` / ``_errors``: slot-major placement, a
    bare hostname one slot, repeated hosts accumulating local ranks; the
    same ValueError messages."""
    def run(fn):
        try:
            return fn(spec, n)
        except ValueError as e:
            return ("ValueError", str(e))
    got, want = run(TR.parse_hosts), run(JR.parse_hosts)
    assert got == want
    if spec == "h1:2,h2:2" and n == 3:
        assert got == [("h1", 0), ("h1", 1), ("h2", 0)]


_PROBE = (
    "import os, json\n"
    "out = os.path.join({tmp!r}, 'rank' + os.environ['BFTPU_PROCESS_ID'] "
    "+ '.json')\n"
    "json.dump({{k: os.environ.get(k) for k in (\n"
    "    'BFTPU_COORDINATOR', 'BFTPU_NUM_PROCESSES', 'BFTPU_PROCESS_ID',\n"
    "    'BFTPU_LOCAL_ID', 'BFTPU_LOCAL_SIZE', 'BFTPU_LOCAL_DEVICES',\n"
    "    'JAX_PLATFORMS', 'XLA_FLAGS', 'BLUEFOG_TPU_CHAOS',\n"
    "    'BLUEFOG_TPU_CHURN')}}, open(out, 'w'))\n")


def _probe(tmp_path, argv, np_):
    script = tmp_path / "probe.py"
    script.write_text(_PROBE.format(tmp=str(tmp_path)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    out = _bfrun(["-np", str(np_), *argv, sys.executable, str(script)],
                 env=env)
    assert out.returncode == 0, out.stderr
    return [json.load(open(tmp_path / f"rank{r}.json")) for r in range(np_)]


def test_bfrun_local_fanout(tmp_path):
    """N local processes with the rendezvous environment: distinct ids,
    one coordinator, the process count."""
    lines = _probe(tmp_path, [], 3)
    assert sorted(ln["BFTPU_PROCESS_ID"] for ln in lines) == ["0", "1", "2"]
    assert len({ln["BFTPU_COORDINATOR"] for ln in lines}) == 1
    assert all(ln["BFTPU_NUM_PROCESSES"] == "3" for ln in lines)


def test_bfrun_host_slots_local(tmp_path):
    """``-H 127.0.0.1:3``: three local processes, slot-major local ids."""
    lines = _probe(tmp_path, ["-H", "127.0.0.1:3"], 3)
    assert [ln["BFTPU_LOCAL_ID"] for ln in lines] == ["0", "1", "2"]
    assert all(ln["BFTPU_LOCAL_SIZE"] == "3" for ln in lines)
    assert all(ln["BFTPU_NUM_PROCESSES"] == "3" for ln in lines)


def test_devices_per_proc_sets_only_the_owned_ranks(tmp_path):
    """The JAX launcher forces a virtual CPU mesh here (``XLA_FLAGS``,
    ``JAX_PLATFORMS=cpu``); the port's sets ``BFTPU_LOCAL_DEVICES`` and
    nothing else, so a child runs where its own ``--device`` says.
    ``--chaos`` exports the spec and arms churn, as the JAX launcher's."""
    lines = _probe(tmp_path, ["--devices-per-proc", "2", "--chaos",
                              "delay:rank=1:step=3:ms=5"], 2)
    for ln in lines:
        assert ln["BFTPU_LOCAL_DEVICES"] == "2"
        assert ln["JAX_PLATFORMS"] is None and ln["XLA_FLAGS"] is None
        assert ln["BLUEFOG_TPU_CHAOS"] == "delay:rank=1:step=3:ms=5"
        assert ln["BLUEFOG_TPU_CHURN"] == "1"
    env = {}
    assert TR.local_devices_env(env, 3) == {"BFTPU_LOCAL_DEVICES": "3"}


# -- gloo gangs ----------------------------------------------------------------

_CONSENSUS = r"""
import sys
sys.path.insert(0, @REPO@)
import numpy as np, torch
import bluefog_tpu_torch as bf
bf.init_distributed(device="cpu")
assert bf.size() == 4, bf.size()
own = bf.owned_ranks()
assert len(own) == 2, own
x = torch.arange(4, dtype=torch.float32)[own, None].repeat(1, 2) + 1.0
out = bf.allreduce(x, average=False)
assert torch.allclose(out, torch.full_like(out, 10.0)), out
print("OK", bf.rank(), float(out[0, 0]))
bf.shutdown()
"""


def test_bfrun_distributed_consensus(tmp_path):
    """Two processes of two ranks each join one gloo group through the
    ``BFTPU_*`` rendezvous; the allreduce sums every rank (1+2+3+4)."""
    script = tmp_path / "train.py"
    script.write_text(_CONSENSUS.replace("@REPO@", repr(REPO)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = _bfrun(["-np", "2", "--devices-per-proc", "2",
                  sys.executable, str(script)], env=env)
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    assert out.stdout.count("OK") == 2, out.stdout
    assert ("bfrun: gang exit summary — rank 0: exit 0; rank 1: exit 0"
            in out.stderr)


_COLLECTIVES = r"""
import math, sys
sys.path.insert(0, @REPO@)
import numpy as np, torch
import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.ops import schedule as S

bf.init_distributed(device="cpu")
n = bf.size()
own = bf.owned_ranks()
rng = np.random.RandomState(7)
x = rng.randn(n, 3).astype(np.float32)
xo = torch.from_numpy(x[own])

def check(out, expected, what, atol=1e-5):
    np.testing.assert_allclose(out.numpy(), expected[own], rtol=1e-4,
                               atol=atol, err_msg=what)

G = topo.ExponentialTwoGraph(n)
bf.set_topology(G)
w_uni = S.uniform_weights(topo.weight_matrix(G))
check(bf.neighbor_allreduce_nonblocking(xo).wait(),
      np.einsum("sd,s...->d...", w_uni, x), "static uniform")
bf.set_topology(G, is_weighted=True)
check(bf.neighbor_allreduce(xo),
      np.einsum("sd,s...->d...", topo.weight_matrix(G), x),
      "static weighted")
bf.set_topology(topo.ExponentialTwoGraph(n))
k = int(math.log2(n))
for step in range(2 * k):
    d = 2 ** (step % k)
    expected = np.stack([(x[i] + x[(i - d) % n]) / 2.0 for i in range(n)])
    check(bf.dynamic_neighbor_allreduce(xo, step), expected,
          f"dynamic step {step}")
cur = xo
for step in range(k):
    cur = bf.dynamic_neighbor_allreduce(cur, step)
check(cur, np.broadcast_to(x.mean(0), x.shape), "dynamic consensus",
      atol=1e-4)
local, machines = bf.local_size(), bf.machine_size()
assert machines > 1
MG = topo.RingGraph(machines)
bf.set_machine_topology(MG)
sums = np.stack([x[m * local:(m + 1) * local].sum(0)
                 for m in range(machines)])
wm = S.uniform_weights(topo.weight_matrix(MG))
msum = np.einsum("sm,s...->m...", wm, sums)
check(bf.hierarchical_neighbor_allreduce(xo),
      np.stack([msum[r // local] / local for r in range(n)]),
      "hierarchical ring")
pairs = [r + 1 if r % 2 == 0 else r - 1 for r in range(n)]
check(bf.pair_gossip(xo, pairs),
      np.stack([(x[r] + x[pairs[r]]) / 2.0 for r in range(n)]),
      "pair gossip")
print("MP-COLLECTIVES-OK", bf.rank())
bf.shutdown()
"""


def test_multiprocess_collectives_under_bfrun(tmp_path):
    """``test_multiprocess_collectives`` at P=2 (4 ranks a process): the
    eager collectives across two gloo processes launched by the port's
    bfrun, against numpy, with tagged output."""
    script = tmp_path / "prog.py"
    script.write_text(_COLLECTIVES.replace("@REPO@", repr(REPO)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = _bfrun(["-np", "2", "--devices-per-proc", "4", "--tag-output",
                  sys.executable, str(script)], env=env)
    assert out.returncode == 0, \
        f"stdout={out.stdout}\nstderr={out.stderr[-4000:]}"
    lines = [ln for ln in out.stdout.splitlines() if "MP-COLLECTIVES-OK" in ln]
    assert sorted(ln.split("]")[0] for ln in lines) == ["[0", "[1"]


# -- chaos and the gang's stop (tests/test_churn.py L541-640) ------------------

def test_bfrun_parser_accepts_chaos_spec():
    argv = ["-np", "4", "--chaos", "kill:rank=3:step=40", "python", "x.py"]
    args = TR.build_parser().parse_args(argv)
    assert args.chaos == "kill:rank=3:step=40"
    jargs = JR.build_parser().parse_args(argv)
    assert vars(args) == vars(jargs)


@pytest.mark.parametrize("spec,msg", [
    ("explode:rank=0:step=1", "unknown fault kind"),
    ("kill:rank=5:step=1", "outside the 2-process gang")])
def test_bfrun_rejects_bad_chaos_spec_and_out_of_range_rank(capsys, spec,
                                                            msg):
    argv = ["-np", "2", "--chaos", spec, "python", "x.py"]
    assert JR.main(argv) == 2
    want = capsys.readouterr().err
    assert TR.main(argv) == 2
    got = capsys.readouterr().err
    assert got == want and msg in got


def test_bfrun_refusals_equal_jax(capsys):
    for argv in (["-np", "2"], ["-np", "0", "python"],
                 ["-np", "2", "--join", "h:1", "python"],
                 ["-np", "1", "--grow", "1", "python"],
                 ["-np", "2", "-H", "h1:1", "python"]):
        assert JR.main(argv) == 2
        want = capsys.readouterr().err
        assert TR.main(argv) == 2
        assert capsys.readouterr().err == want


class _FakeProc:
    def __init__(self, rc=None):
        self.rc = rc
        self.terminated = self.killed = False

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        if self.rc is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.rc

    def terminate(self):
        self.terminated = True

    def kill(self):
        self.killed = True


def test_wait_gang_tolerates_chaos_killed_rank():
    procs = [_FakeProc(0), _FakeProc(-9), _FakeProc(0)]
    entries = [(p, "127.0.0.1", False) for p in procs]
    assert TR._wait_gang(entries, ["ssh"], "tag", tolerate={1}) == 0
    assert not any(p.terminated or p.killed for p in procs)


def test_wait_gang_still_kills_on_untolerated_failure(capsys):
    def run(R):
        procs = [_FakeProc(0), _FakeProc(3), _FakeProc(0)]
        entries = [(p, "127.0.0.1", False) for p in procs]
        assert R._wait_gang(entries, ["ssh"], "tag", tolerate={0}) == 3
        return capsys.readouterr().err
    err = run(TR)
    assert err == run(JR)
    assert "gang exit summary" in err and "rank 1: exit 3" in err


@pytest.mark.parametrize("rc", [0, 2, -9, -15, None])
def test_exit_reason_spellings(rc):
    assert TR._exit_reason(rc) == JR._exit_reason(rc)
    assert TR._exit_reason(-9) == "killed by SIGKILL"
    assert "UNRESPONSIVE" in TR._exit_reason(None)


def test_kill_gang_prints_summary_with_escalation(capsys):
    class _Hung(_FakeProc):
        def kill(self):
            self.killed = True
            self.rc = -9

        def wait(self, timeout=None):
            if self.killed:
                return self.rc
            raise subprocess.TimeoutExpired("fake", timeout)

    def run(R):
        entries = [(p, "127.0.0.1", False) for p in (_FakeProc(0), _Hung())]
        R._kill_gang(entries, ["ssh"], "tag", kill_grace=0.2)
        return capsys.readouterr().err
    err = run(TR)
    assert err == run(JR)
    assert "rank 0: exit 0" in err
    assert "rank 1: killed by SIGKILL after SIGTERM timeout" in err


def test_gang_stops_on_a_failure_and_tolerates_a_chaos_kill(tmp_path):
    """Real processes: one exits 3 while another sleeps, and the launcher
    stops the sleeper and returns 3 with the summary; a rank the chaos
    spec kills (SIGKILL of itself) is tolerated and the others finish."""
    script = tmp_path / "p.py"
    script.write_text(
        "import os, signal, sys, time\n"
        "r = int(os.environ['BFTPU_PROCESS_ID'])\n"
        "mode = sys.argv[1]\n"
        "if mode == 'fail' and r == 1: sys.exit(3)\n"
        "if mode == 'chaos' and r == 1:\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "time.sleep(60 if mode == 'fail' else 0.2)\n")
    out = _bfrun(["-np", "3", sys.executable, str(script), "fail"],
                 timeout=120)
    assert out.returncode == 3
    assert "rank 1: exit 3" in out.stderr
    assert "rank 0: killed by SIGTERM" in out.stderr
    out = _bfrun(["-np", "3", "--chaos", "kill:rank=1:step=0",
                  sys.executable, str(script), "chaos"],
                 timeout=120)
    assert out.returncode == 0, out.stderr
    assert ("rank 0: exit 0; rank 1: killed by SIGKILL; rank 2: exit 0"
            in out.stderr)
