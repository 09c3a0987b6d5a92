"""The port's window-transport rigs (``python -m
bluefog_tpu_torch.bench_comm --transport-smoke | --stripe-smoke``)
against the root ``bench_comm.py``'s.

Both exit 0 with the same ``metric`` and ``detail`` keys, and the smokes'
structural checks hold on the port: the legacy path sends no batch frame,
the coalesced Python path delivers batches, the native path engages
(the port has no run without it), the tracing leg measures per-edge
delays, the link observatory's off switch is inert and its report has
edges; two stripes engage and a single stripe keeps the pre-stripe wire.
Rates are timings and left out.  Each rig runs in a subprocess
(``tests/_bench_rigs.py``).
"""

import pytest

from _bench_rigs import run_pair

MODES = ("transport-smoke", "stripe-smoke")


@pytest.fixture(scope="module")
def lines():
    return {m: run_pair([f"--{m}"]) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_exit_metric_and_detail_keys(lines, mode):
    jax, port = lines[mode]
    assert port["metric"] == jax["metric"]
    assert port["unit"] == jax["unit"]
    assert set(port["detail"]) == set(jax["detail"])


def test_transport_smoke_structure(lines):
    jax, port = lines["transport-smoke"]
    d = port["detail"]
    assert d["native_available"] is True and d["smoke"] is True
    assert d["legacy"]["batches_seen"] == 0
    modes = [(r["mode"], r["row_bytes"]) for r in d["sweep"]]
    assert modes == [(r["mode"], r["row_bytes"])
                     for r in jax["detail"]["sweep"]]
    for r in d["sweep"]:
        assert set(r) == set(jax["detail"]["sweep"][0])
        if r["mode"] == "python":
            assert r["batches_seen"] > 0
        else:
            assert r["native_engaged"] is True
    assert [r["peers"] for r in d["peers"]] == [1, 2]
    assert all(r["native_engaged"] for r in d["peers"])
    assert set(d["ratios_by_row_bytes"]) == {"64", "256", "4096"}
    assert d["tracing"]["edges"], "no per-edge delays"
    assert set(d["tracing"]) == set(jax["detail"]["tracing"])
    assert d["links"]["overhead_cell"]["off_inert"] is True
    assert d["links"]["report"]["edges"]


def test_stripe_smoke_structure(lines):
    jax, port = lines["stripe-smoke"]
    assert port["value"] >= 2 and port["value"] == jax["value"]
    d = port["detail"]
    assert d["single_stripe_wire_ok"] is True
    assert d["striped_cell"]["native_engaged"] is True
    assert d["striped_cell"]["stripes_engaged"] >= 2
    assert set(d["striped_cell"]) == set(jax["detail"]["striped_cell"])
