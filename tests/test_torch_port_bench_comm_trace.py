"""The port's tracing and async-mode rigs (``python -m
bluefog_tpu_torch.bench_comm --tracerec-smoke | --async-smoke``) against
the root ``bench_comm.py``'s.

Both exit 0 with the same ``metric`` and ``detail`` keys.  Tracing: the
same count of edges with contribution ages (their source labels equal),
the recorder's chain from enqueue to commit, the ``TELEMETRY=0`` guard.
Async: the stale edges, each source's rejected count and origin step and
the /healthz block equal the JAX rig's, and the fold and the zero-mutation
guard hold.  Each rig runs in a subprocess (``tests/_bench_rigs.py``).
"""

import pytest

from _bench_rigs import run_pair

MODES = ("tracerec-smoke", "async-smoke")
ENQUEUE, COMMIT = 1, 7   # utils/flightrec.py's event types


@pytest.fixture(scope="module")
def lines():
    return {m: run_pair([f"--{m}"]) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_exit_metric_and_detail_keys(lines, mode):
    jax, port = lines[mode]
    assert port["metric"] == jax["metric"]
    assert port["unit"] == jax["unit"]
    assert set(port["detail"]) == set(jax["detail"])


def test_tracerec_ages_and_recorder(lines):
    jax, port = lines["tracerec-smoke"]
    assert port["value"] == jax["value"] > 0
    assert set(port["detail"]["contribution_age"]) == \
        set(jax["detail"]["contribution_age"])
    assert {ENQUEUE, COMMIT} <= set(port["detail"]["etypes"])
    assert port["detail"]["rec_events"] > 0
    assert port["detail"]["zero_mutation_ok"] is True


def test_async_counters_equal_jax(lines):
    jax, port = lines["async-smoke"]
    assert port["value"] == jax["value"] == 8
    got, want = port["detail"]["healthz_async"], \
        jax["detail"]["healthz_async"]
    assert got["stale_rejected"] == want["stale_rejected"]
    assert got["peer_steps"] == want["peer_steps"]
    assert got == want
    assert port["detail"]["fold_restored_exactly"] is True
    assert port["detail"]["zero_mutation_ok"] is True
