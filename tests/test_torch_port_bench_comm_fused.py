"""The port's put-plan, fused-step and probe rigs (``python -m
bluefog_tpu_torch.bench_comm --ffi-smoke | --fused-smoke |
--probe-smoke``) and the port bench's ``fused_step`` block.

* The three smokes pass on the CPU with the JAX rigs' ``metric`` and
  ``detail`` keys; on the CPU the plans stage no byte on any path (the JAX
  rig's zero-copy check), the fused step is bit for bit the eager one,
  ``FUSED_STEP=0`` is inert and the disarmed plans fall back with one
  warning.
* The fused rig's eager trajectory, ``_fused_rig(False, 2, 48, 2, 10,
  synced=True)`` from the rig's own ``RandomState(7)`` init, within 1e-6
  of the JAX rig's; the port's fused run bit for bit its eager run.
* The port bench's ``fused_step`` block: ``{"enabled": false}`` with
  ``BLUEFOG_TPU_FUSED_STEP`` unset; with it set, the root
  ``_fused_step_summary``'s keys.
"""

import json

import numpy as np
import pytest

from _bench_rigs import finish, python_snippet, run_pair, stop

MODES = ("ffi-smoke", "fused-smoke", "probe-smoke")
RIG = (2, 48, 2, 10)   # leaves, cols, buckets, steps of the trajectory leg

_JAX_TRAJECTORY = """
import json, sys
import numpy as np
sys.argv = ["bench_comm.py"]
import bench_comm as B
B._fused_env_setup()
_, p, fsteps = B._fused_rig(False, {leaves}, {cols}, {buckets}, {steps},
                            synced=True)
print(json.dumps({{k: v.tolist() for k, v in p.items()}}))
"""

_JAX_SUMMARY = """
import json
import bench
print(json.dumps(bench._fused_step_summary()))
"""


@pytest.fixture(scope="module")
def lines():
    return {m: run_pair([f"--{m}"]) for m in MODES}


@pytest.fixture(scope="module")
def jax_trajectory():
    from _jax_native import ensure_jax_native
    ensure_jax_native()
    leaves, cols, buckets, steps = RIG
    p = python_snippet(_JAX_TRAJECTORY.format(
        leaves=leaves, cols=cols, buckets=buckets, steps=steps), jax=True)
    try:
        return {k: np.asarray(v, np.float32)
                for k, v in finish(p, "jax _fused_rig").items()}
    finally:
        stop(p)


@pytest.fixture
def fused_env():
    from bluefog_tpu_torch import bench_comm
    prev = bench_comm._fused_env_setup()
    yield bench_comm
    bench_comm._fused_env_restore(prev)


@pytest.mark.parametrize("mode", MODES)
def test_exit_metric_and_detail_keys(lines, mode):
    jax, port = lines[mode]
    assert port["metric"] == jax["metric"]
    assert port["unit"] == jax["unit"]
    assert set(port["detail"]) == set(jax["detail"])


def test_ffi_smoke_plans_engage_and_stage_nothing_on_cpu(lines):
    jax, port = lines["ffi-smoke"]
    sweep = port["detail"]["sweep"]
    assert [r["mode"] for r in sweep] == ["native", "ffi"]
    assert set(sweep[0]) >= set(jax["detail"]["sweep"][0])
    native, ffi = sweep
    assert ffi["ffi_engaged"] is True and native["ffi_engaged"] is False
    assert ffi["host_copy_bytes"] == {"stage": 0, "plan_stage": 0,
                                      "enqueue": 0}
    assert ffi["puts"] == native["puts"] > 0


def test_fused_smoke_legs(lines):
    jax, port = lines["fused-smoke"]
    d = port["detail"]
    assert d["trajectory"]["steps"] == jax["detail"]["trajectory"]["steps"]
    assert d["trajectory"]["bitwise"] is True
    assert d["trajectory"]["max_abs_diff"] == 0.0
    assert d["trajectory"]["puts_total"] == \
        jax["detail"]["trajectory"]["puts_total"]
    assert d["env_off"] == {"bitwise": True, "inert": True}
    assert d["fallback"] == {"warnings": 1, "bitwise_eager": True}


def test_probe_smoke_lands_every_surface(lines):
    jax, port = lines["probe-smoke"]
    d = port["detail"]
    assert 0.0 < port["value"] <= 1.0
    assert d["fused_steps"] == jax["detail"]["fused_steps"] == 8
    assert d["probe_events"] > 0 and d["divergence"] > 0
    assert d["probe_lanes"] and d["merged_events"] > 0
    assert set(d["overlap"]) == set(jax["detail"]["overlap"])


def test_eager_rig_trajectory_equals_jax(fused_env, jax_trajectory):
    _, got, _ = fused_env._fused_rig(False, *RIG, synced=True)
    assert set(got) == set(jax_trajectory)
    err = max(float(np.abs(got[k] - jax_trajectory[k]).max()) for k in got)
    print(f"fused rig, eager: max |port - jax| = {err:.3e}")
    assert err <= 1e-6


def test_fused_rig_is_the_eager_rig_bitwise(fused_env):
    _, eager, _ = fused_env._fused_rig(False, *RIG, synced=True)
    _, fused, fsteps = fused_env._fused_rig(True, *RIG, synced=True)
    assert fsteps == RIG[-1]
    for k in eager:
        np.testing.assert_array_equal(fused[k], eager[k], err_msg=k)


def test_bench_fused_block_off(monkeypatch):
    from bluefog_tpu_torch import bench
    from bluefog_tpu_torch.utils import config
    monkeypatch.delenv("BLUEFOG_TPU_FUSED_STEP", raising=False)
    config.reload()
    assert bench._fused_step_summary("cpu") == {"enabled": False}


def test_bench_fused_block_keys_equal_jax(monkeypatch):
    from bluefog_tpu_torch import bench
    from bluefog_tpu_torch.utils import config
    from _jax_native import ensure_jax_native
    ensure_jax_native()
    p = python_snippet(_JAX_SUMMARY, jax=True, extra={
        "BLUEFOG_TPU_FUSED_STEP": "1",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    monkeypatch.setenv("BLUEFOG_TPU_FUSED_STEP", "1")
    config.reload()
    try:
        got = bench._fused_step_summary("cpu")
        want = finish(p, "jax _fused_step_summary")
    finally:
        stop(p)
        monkeypatch.delenv("BLUEFOG_TPU_FUSED_STEP")
        config.reload()
    assert want["enabled"] is True and "skipped" not in want
    assert set(got) == set(want), json.dumps([sorted(got), sorted(want)])
    # 4 warm steps and 20 timed ones, every one fused.
    assert got["fused_steps"] == want["fused_steps"] == 24
    for k in ("leaves", "cols", "fusion_buckets", "steps"):
        assert got[k] == want[k], k
