"""The LM's ``flat`` in the JAX ravel order, as ``sparse:<frac>`` needs.

``sparse:0.25`` combines a rotating block of a quarter of ``flat``'s
columns, so a column must be the same coordinate in both packages.  3 ATC
steps over the dynamic topology on 4 ranks, each package computing its own
gradients, float32: parameters at 1e-6 (as
``test_sparse_combine_is_bitwise_jax``), losses at 1e-4."""

import numpy as np
import pytest

from test_torch_port_train import (BATCH, N, SEQ, V, _jax_llama_run,
                                   _param_diff, _port_llama_run)


@pytest.mark.parametrize("variant", ["mha", "llama"])
def test_sparse_trajectory_needs_the_jax_ravel_order(devices, variant):
    """``sparse:0.25`` combines a rotating block of a quarter of ``flat``'s
    columns: with ``flat`` in the JAX ravel order the 3-step trajectory
    matches the JAX package at 1e-6; in the module's own order the block
    covers other coordinates and the parameters part by far more."""
    tokens = np.random.RandomState(2).randint(
        0, V, (N, BATCH, SEQ)).astype(np.int32)
    init, j_losses, j_params = _jax_llama_run(devices, tokens, variant,
                                              compression="sparse:0.25")
    t_losses, rep = _port_llama_run(init, tokens, variant,
                                    compression="sparse:0.25")
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    assert _param_diff(rep, j_params) <= 1e-6
    _, module_order = _port_llama_run(init, tokens, variant,
                                      compression="sparse:0.25",
                                      order="module")
    assert _param_diff(module_order, j_params) > 1e-3
