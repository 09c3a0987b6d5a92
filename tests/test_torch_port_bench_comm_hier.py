"""The port's hierarchical and sharded gossip reports
(``python -m bluefog_tpu_torch.bench_comm --hier-smoke |
--sharded-smoke``) against the root ``bench_comm.py``'s on the same seed.

Both exit 0 with the same ``metric`` and ``detail`` keys.  The DCN rows,
the modeled serial times and the sharded byte and round fields are equal;
the simulated consensus distances and the end-to-end legs' errors within
1e-6; the hierarchical gossip's info and the sharded plan's replicated
fraction equal.  Each rig runs in a subprocess (``tests/_bench_rigs.py``).
"""

import pytest

from _bench_rigs import run_pair

MODES = ("hier-smoke", "sharded-smoke")
EXACT_HIER = ("n", "n_slices", "dcn_rows_flat_per_step",
              "dcn_rows_hier_per_step", "dcn_rows_reduction",
              "dcn_serial_flat", "dcn_serial_hier", "dcn_serial_reduction",
              "steps", "policy")


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


@pytest.mark.parametrize("torus", ("2x(4x8)", "4x(4x4)"))
def test_hier_torus_equals_jax(lines, torus):
    jax, port = lines["hier-smoke"]
    want = jax["detail"]["tori"][torus]
    got = port["detail"]["tori"][torus]
    assert set(got) == set(want)
    for k in EXACT_HIER:
        assert got[k] == want[k], k
    for k in ("consensus_flat", "consensus_hier"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["consensus_hier"] <= got["consensus_flat"] + 1e-12


def test_hier_end_to_end_equals_jax(lines):
    jax, port = lines["hier-smoke"]
    want, got = jax["detail"]["e2e"], port["detail"]["e2e"]
    assert got["hier_info"] == want["hier_info"]
    d = got["product_equivalence_max_diff"]
    assert d <= 1e-6
    assert abs(d - want["product_equivalence_max_diff"]) <= 1e-6


@pytest.mark.parametrize("frac", ("100%", "75%", "50%", "25%"))
def test_sharded_fraction_equals_jax(lines, frac):
    jax, port = lines["sharded-smoke"]
    assert (port["detail"]["fractions"][frac]
            == jax["detail"]["fractions"][frac])


def test_sharded_end_to_end_equals_jax(lines):
    jax, port = lines["sharded-smoke"]
    want, got = jax["detail"]["e2e"], port["detail"]["e2e"]
    assert set(got) == set(want)
    for k in ("steps", "dcn_bytes", "dcn_bytes_expected",
              "replicated_fraction"):
        assert got[k] == want[k], k
    for k in ("replicated_oracle_max_err", "sharded_oracle_max_err"):
        assert got[k] <= 1e-6 and abs(got[k] - want[k]) <= 1e-6, k
