"""The port's schedule bench, placement and synthesis reports
(``python -m bluefog_tpu_torch.bench_comm --smoke | --placement-smoke |
--synth-smoke``) against the root ``bench_comm.py``'s on the same seed.

Both exit 0 with the same ``metric`` and ``detail`` keys, and every field
that does not depend on timing is equal: rounds, edges, round reduction,
modeled link loads, hop bytes, serial times, lower bounds, synthesized
rounds, provenance and the strict wins; the outputs' differences and the
end-to-end legs' (``max_output_diff``, the packed and synthesized
schedules' drift) within 1e-6.  ``ms_per_op_*`` are timings and left out.
The JAX rigs run on the virtual CPU mesh, the port's on the CPU, each in a
subprocess (``tests/_bench_rigs.py``).
"""

import pytest

from _bench_rigs import run_pair

MODES = ("smoke", "placement-smoke", "synth-smoke")
TOPOLOGIES = ("ring", "exp2", "star", "random_regular")


@pytest.fixture(scope="module")
def lines():
    return {m: run_pair([f"--{m}"]) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_exit_metric_and_detail_keys(lines, mode):
    jax, port = lines[mode]
    assert port["metric"] == jax["metric"]
    assert port["unit"] == jax["unit"]
    assert set(port["detail"]) == set(jax["detail"])
    assert port["value"] == jax["value"]


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_schedule_bench_equals_jax(lines, name):
    jax, port = lines["smoke"]
    assert port["detail"]["n"] == jax["detail"]["n"] == 8
    want = jax["detail"]["per_topology"][name]
    got = port["detail"]["per_topology"][name]
    assert set(got) == set(want)
    for k in ("rounds_naive", "rounds_optimized", "edges",
              "round_reduction"):
        assert got[k] == want[k], k
    assert got["max_output_diff"] <= 1e-6
    assert abs(got["max_output_diff"] - want["max_output_diff"]) <= 1e-6


@pytest.mark.parametrize("torus", ("4x8", "8x8"))
def test_placement_tori_equal_jax(lines, torus):
    jax, port = lines["placement-smoke"]
    assert port["detail"]["tori"][torus] == jax["detail"]["tori"][torus]


def test_placement_end_to_end_equals_jax(lines):
    jax, port = lines["placement-smoke"]
    want, got = jax["detail"]["e2e"], port["detail"]["e2e"]
    assert got["placement_info"] == want["placement_info"]
    assert got["bit_identical_placement_only"] is True
    assert got["packed_max_output_diff"] <= 1e-6
    assert abs(got["packed_max_output_diff"]
               - want["packed_max_output_diff"]) <= 1e-6


@pytest.mark.parametrize("torus", ("4x8", "8x8", "2x(4x8)", "4x(4x4)"))
def test_synthesis_tori_equal_jax(lines, torus):
    jax, port = lines["synth-smoke"]
    assert port["detail"]["tori"][torus] == jax["detail"]["tori"][torus]


def test_synthesis_wins_and_end_to_end_equal_jax(lines):
    jax, port = lines["synth-smoke"]
    assert port["detail"]["strict_wins"] == jax["detail"]["strict_wins"]
    want, got = jax["detail"]["e2e"], port["detail"]["e2e"]
    assert set(got) == set(want)
    for k in ("synth_provenance", "synth_serial", "packed_serial"):
        assert got[k] == want[k], k
    for k in ("synth_vs_naive_max_diff", "hatch_max_diff"):
        assert got[k] <= 1e-6 and abs(got[k] - want[k]) <= 1e-6, k
