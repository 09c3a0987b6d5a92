"""The port's window benchmark (``python -m
bluefog_tpu_torch.window_benchmark``) against ``examples/window_benchmark.py``.

* One process at a small ``--elements`` on the CPU: the JSON summary has
  the JAX example's keys (on its 8-device CPU mesh), every time positive.
* ``--multiproc`` relaunches itself under the port's bfrun (``-np 2
  --devices-per-proc 2``, gloo): three launches (no compression, ``bf16``,
  the owned-rows layout), each process's puts a second and bytes a second
  for each edge that crosses the process boundary.
"""

import json
import math

from _bench_rigs import finish, python_snippet, stop

ARGS = ["--elements", "4096", "--rounds", "2", "--json"]

_JAX = """
import runpy, sys
sys.argv = ["window_benchmark.py", *{args!r}]
runpy.run_path("examples/window_benchmark.py", run_name="__main__")
"""

_PORT = """
import sys
from bluefog_tpu_torch import window_benchmark
window_benchmark.main([*{args!r}, "--device", "cpu"])
"""


def test_single_process_keys_equal_jax():
    pj = python_snippet(_JAX.format(args=ARGS), jax=True, extra={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    pt = python_snippet(_PORT.format(args=ARGS), jax=False)
    try:
        got = finish(pt, "port window_benchmark")
        want = finish(pj, "jax window_benchmark")
    finally:
        stop(pj, pt)
    assert set(got) == set(want)
    assert got["n"] == want["n"] == 8
    assert got["elements"] == want["elements"] == 4096
    assert got["mb_per_rank"] == want["mb_per_rank"]
    for k, v in got.items():
        if k.endswith("_s"):
            assert math.isfinite(v) and v > 0, k


def test_multiproc_under_port_bfrun():
    p = python_snippet(_PORT.format(args=[*ARGS[:3], "1", "--json",
                                          "--multiproc"]), jax=False)
    try:
        rows = finish(p, "port window_benchmark --multiproc")["multiproc"]
    finally:
        stop(p)
    assert len(rows) == 6
    legs = sorted((r["compression"], r["layout"], r["proc"]) for r in rows)
    assert legs == sorted((c, lay, pr) for c, lay in (
        ("none", "rank-major"), ("bf16", "rank-major"), ("none", "owned"))
        for pr in (0, 1))
    for r in rows:
        assert r["edges"] == 4 and r["cross_edges"] == 2, r
        assert r["puts_per_s_per_edge"] > 0 and r["device"] == "cpu"
        wire = 4096 * 4 * (0.5 if r["compression"] == "bf16" else 1.0)
        assert math.isclose(r["bytes_per_s_per_edge"],
                            wire * r["puts_per_s_per_edge"], rel_tol=1e-9)
    print(json.dumps(rows))
