"""The port's notebooks (``bluefog_tpu_torch/notebooks/``) against the JAX
package's (``examples/``), on the CPU.

- ``interactive_helloworld.ipynb`` run cell by cell in this process, as
  ``test_helloworld_notebook_cells_execute`` runs the JAX notebook, with
  ``BFTPU_DEVICE=cpu`` (what ``ibfrun --device cpu`` exports): the printed
  lines are the JAX notebook's, and the consensus values agree within a
  relative 1e-6 (the two packages sum a ring round's three terms in
  another order, so after 200 float32 rounds the values differ by
  2.1e-6 around a mean of 3.5);
- ``cluster_notebook.ipynb`` in kernel mode: a two-process ``ibfrun
  --hosts 127.0.0.1:2 --kernel-file`` gang (4 ranks a process, gloo)
  driven by ``jupyter_client``: its cells give ``CLUSTER-NB-OK True`` and
  the JAX package's consensus within 1e-6; an IPython-only cell
  (``%time 1``) is refused before it ships and the gang then still answers
  a plain cell; ``%bfstat`` and a CRLF cell run; the kernel shuts down and
  the gang exits 0;
- both notebooks are valid nbformat, carry no JAX, and are package data.
"""

import io
import json
import os
import re
import subprocess
import sys
import time
import tomllib
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import bluefog_tpu as jbf

from test_torch_port_cluster_repl import jax_dynamic_exp2

REPO = Path(__file__).resolve().parents[1]
NOTEBOOKS = REPO / "bluefog_tpu_torch" / "notebooks"
NAMES = ["interactive_helloworld", "cluster_notebook"]


def _code_cells(path):
    nb = json.loads(Path(path).read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", NAMES)
def test_notebook_is_valid_and_torch_only(name):
    import nbformat
    nb = nbformat.read(NOTEBOOKS / f"{name}.ipynb", as_version=4)
    nbformat.validate(nb)
    src = "\n".join(_code_cells(NOTEBOOKS / f"{name}.ipynb"))
    assert "jax" not in src and "bluefog_tpu " not in src + " "
    assert "to_numpy" not in src
    for cell in _code_cells(NOTEBOOKS / f"{name}.ipynb"):
        compile(cell, name, "exec")
    # The markdown and code cells of the JAX notebook, in its order.
    jax_nb = json.loads((REPO / "examples" / f"{name}.ipynb").read_text())
    assert [c.cell_type for c in nb.cells] == \
        [c["cell_type"] for c in jax_nb["cells"]]


def test_notebooks_are_package_data():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["bluefog_tpu_torch"]
    assert "notebooks/*.ipynb" in data
    assert sorted(p.stem for p in NOTEBOOKS.glob("*.ipynb")) == sorted(NAMES)


def _run_in_process(path):
    ns = {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        for cell in _code_cells(path):
            exec(cell, ns)  # noqa: S102
    return buf.getvalue(), ns


_NUM = re.compile(r"-?\d+\.\d*(?:e-?\d+)?|-?\d+")


def _split(line):
    """A printed line as (its text with the numbers taken out, the
    numbers)."""
    return _NUM.sub("#", line), [float(v) for v in _NUM.findall(line)]


def test_helloworld_notebook_equals_jax(monkeypatch):
    monkeypatch.setenv("BFTPU_DEVICE", "cpu")
    monkeypatch.delenv("BFTPU_LOCAL_DEVICES", raising=False)
    import bluefog_tpu_torch as tbf
    try:
        got, ns = _run_in_process(
            NOTEBOOKS / "interactive_helloworld.ipynb")
        assert not ns["bf"].suspended()
        assert ns["bf"].device().type == "cpu"
    finally:
        tbf.shutdown()
    want, _ = _run_in_process(REPO / "examples" /
                              "interactive_helloworld.ipynb")
    assert jbf.size() == 8
    # numpy wraps the 8 values over two lines in both.
    got_l = got.replace("\n ", " ").splitlines()
    want_l = want.replace("\n ", " ").splitlines()
    assert len(got_l) == len(want_l) == 8, (got, want)
    target = 3.5
    for g, w in zip(got_l, want_l):
        (gt, gv), (wt, wv) = _split(g), _split(w)
        assert gt == wt, (g, w)
        if g.startswith("max deviation from mean:"):
            # |x - 3.5|, both float32 rounding: the values' bound applies.
            assert abs(gv[0] - wv[0]) <= 1e-6 * target
            assert gv[0] < 1e-3
        else:
            np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=0)
    assert "ranks: 8 | my rank: 0" in got
    assert "comm while suspended -> RuntimeError" in got


# -- kernel mode --------------------------------------------------------------

def _gang_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "BFTPU_IBF_TOKEN")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO)
    return env


def _execute(kc, code, timeout=120):
    """Run one cell; its stream text, error and reply status."""
    msg_id = kc.execute(code)
    text, err = [], None
    while True:
        m = kc.get_iopub_msg(timeout=timeout)
        if m["parent_header"].get("msg_id") != msg_id:
            continue
        kind, content = m["msg_type"], m["content"]
        if kind == "stream":
            text.append(content["text"])
        elif kind == "error":
            err = f"{content['ename']}: {content['evalue']}"
        elif kind == "status" and content["execution_state"] == "idle":
            break
    while True:
        reply = kc.get_shell_msg(timeout=timeout)
        if reply["parent_header"].get("msg_id") == msg_id:
            return "".join(text), err, reply["content"]["status"]


@pytest.fixture(scope="module")
def kernel_gang(tmp_path_factory):
    from jupyter_client import BlockingKernelClient
    tmp = tmp_path_factory.mktemp("kernel")
    conn = tmp / "bf-kernel.json"
    out_path = tmp / "gang.txt"
    t0 = time.monotonic()
    res = {"cells": []}
    with open(out_path, "w") as sink:
        p = subprocess.Popen(
            [sys.executable, "-m", "bluefog_tpu_torch.run.interactive",
             "-np", "2", "--hosts", "127.0.0.1:2", "--devices-per-proc",
             "4", "--device", "cpu", "--kernel-file", str(conn)],
            stdout=sink, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=_gang_env())
        kc = None
        try:
            # The file is written by the kernel's initialize; the client
            # waits for the kernel's heartbeat.
            deadline = time.monotonic() + 120
            while not conn.exists() or not conn.stat().st_size:
                assert p.poll() is None and time.monotonic() < deadline, \
                    out_path.read_text()
                time.sleep(0.1)
            time.sleep(0.2)
            kc = BlockingKernelClient(connection_file=str(conn))
            kc.load_connection_file()
            kc.start_channels()
            kc.wait_for_ready(timeout=120)
            res["ready_s"] = time.monotonic() - t0
            for cell in _code_cells(NOTEBOOKS / "cluster_notebook.ipynb"):
                res["cells"].append(_execute(kc, cell))
            res["cons"] = _execute(
                kc, "import json\n"
                "print('CONS', json.dumps(x.ravel().tolist()))")
            res["magic"] = _execute(kc, "%time 1")
            res["plain"] = _execute(
                kc, "print('PLAIN', bf.rank(), float(bf.allreduce("
                "torch.ones(len(bf.owned_ranks()), 1), average=False)"
                "[0, 0]))")
            res["bfstat"] = _execute(kc, "%bfstat")
            res["crlf"] = _execute(kc, "a = 2\r\nprint('CRLF', a * 3)")
            kc.shutdown()
            res["rc"] = p.wait(timeout=60)
        finally:
            if kc is not None:
                kc.stop_channels()
            if p.poll() is None:
                p.kill()
                p.wait()
    res["gang_out"] = out_path.read_text()
    return res


def test_kernel_runs_the_cluster_notebook(kernel_gang):
    cells = kernel_gang["cells"]
    assert [status for _, _, status in cells] == ["ok"] * 3, cells
    assert cells[0][0] == "ranks: 8 processes: 2\n"
    assert cells[2][0] == "CLUSTER-NB-OK True\n"
    # The worker ran the same cells (its stdout is the launcher's).
    assert "CLUSTER-NB-OK True" in kernel_gang["gang_out"]


def test_kernel_consensus_equals_jax(kernel_gang):
    text, err, status = kernel_gang["cons"]
    assert status == "ok", err
    got = np.array(json.loads(text.split("CONS", 1)[1]))
    np.testing.assert_allclose(got, jax_dynamic_exp2(), rtol=0, atol=1e-6)


def test_kernel_refuses_ipython_only_syntax_then_answers(kernel_gang):
    text, err, status = kernel_gang["magic"]
    assert status == "error" and "IPython-only syntax" in err, err
    assert "Wall time" not in text + kernel_gang["gang_out"]
    text, err, status = kernel_gang["plain"]
    assert status == "ok" and text == "PLAIN 0 8.0\n", (text, err)
    assert "PLAIN 4 8.0" in kernel_gang["gang_out"]


def test_kernel_bfstat_and_crlf(kernel_gang):
    text, _, status = kernel_gang["bfstat"]
    assert status == "ok"
    assert text.startswith("[bfstat] proc 0/2: ranks [0, 1, 2, 3] of 8")
    assert "[bfstat] proc 1/2: ranks [4, 5, 6, 7] of 8" in \
        kernel_gang["gang_out"]
    assert kernel_gang["crlf"][:3:2] == ("CRLF 6\n", "ok")


def test_kernel_gang_exits_zero(kernel_gang):
    assert kernel_gang["rc"] == 0, kernel_gang["gang_out"][-3000:]
    assert "bluefog_tpu_torch cluster kernel: 8 rank(s) across 2 " \
        "process(es) on cpu" in kernel_gang["gang_out"]
