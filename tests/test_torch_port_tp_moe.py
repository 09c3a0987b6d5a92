"""Tensor parallelism of switch-MoE blocks, and of any block under remat
(``parallel/tensor_parallel.py``), against the JAX package and the port's
unsharded model, on seeded inputs.

- The JAX test's case (``tests/test_models.py::
  test_switch_moe_expert_parallel_sharding_matches``: vocab 64, 2 layers, 4
  heads, width 32, seq 16, float32, 4 experts, batch 4, tokens from
  ``RandomState(1)``) through ``TensorParallelLM`` at tp 2, its experts
  whole on every shard or cut over a 4-rank expert axis (``moe_apply``):
  the logits within 2e-5 of the JAX unsharded model.
- Loss (cross-entropy plus the blocks' load-balancing losses) and every
  gradient against the unsharded port model at rtol 5e-4 / atol 1e-5 (the
  tp forward's gradient tolerance), remat ``full`` and ``dots`` against no
  remat within 1e-6.
- Across 2 gloo processes of 2 ranks (``BFTPU_*`` rendezvous): tp over the
  world's 4 ranks with the experts whole, and tp 2 in each process with the
  experts over the world's ranks, each without remat and under ``full`` and
  ``dots``: every process's logits, loss and gradients within 1e-6 of the
  same model with rank-major axes in one process.  The recompute runs the
  blocks' collectives again on every process; one that skipped or
  reordered one would hang the group (a 120 s join timeout) or change the
  gradients.

Run as a script, this file is the worker.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu import models as jmodels
from bluefog_tpu_torch.models import transformer as TT
from bluefog_tpu_torch.models.convert import (
    tensor_parallel_params_from_jax, transformer_params_from_jax)
from bluefog_tpu_torch.parallel import tensor_parallel as TP

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
REMAT_TOL = 1e-6
DIST_TOL = 1e-6
AUX_WEIGHT = 0.01
JOIN_TIMEOUT = 120
KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
          max_seq_len=16, num_experts=4)
REMATS = {"none": None, "full": "full", "dots": "dots"}
# (tp axis, ep axis) in one process, for the layouts the tests name
LAYOUTS = {"whole": (2, None), "ep": (2, 4)}


def _cfg(remat=None):
    return TT.TransformerConfig(dtype=torch.float32, remat=remat is not None,
                                remat_policy=remat or "full", **KW)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX test's model, params, tokens and unsharded logits, and the
    port's unsharded model on the same weights."""
    jm = jmodels.TransformerLM(jmodels.TransformerConfig(dtype=jnp.float32,
                                                         **KW))
    tokens = np.random.RandomState(1).randint(0, 64, (4, 16))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    ref = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    tm = TT.TransformerLM(_cfg())
    tm.load_state_dict(transformer_params_from_jax(jax.device_get(params)))
    return tm, torch.from_numpy(tokens), ref, jax.device_get(params)


def _tp(tm, tp, ep, remat=None, attn=TT.local_attention):
    model = TP.TensorParallelLM(_cfg(remat), tp, attn, ep_axis=ep)
    model.load_state_dict(TP.tp_shard_params(tm, tm.state_dict(), tp,
                                             ep_axis=ep))
    return model


def _loss(model, tokens):
    aux = []
    logits = model(tokens, moe_aux=aux)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         torch.roll(tokens, -1, 1).reshape(-1))
    return logits, ce + AUX_WEIGHT * torch.stack(aux).sum(), aux


def _grads(model, specs):
    """Every gradient in the unsharded layout: the shards put back."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        spec = specs[name]
        if spec is not None:
            g = torch.cat(list(g), spec[1])
        out[name] = g
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tp_moe_logits_match_jax(jax_case, layout):
    """Also with the flax tree converted straight into the tp layout
    (``models.convert.tensor_parallel_params_from_jax``): the same
    tensors as cutting the unsharded port model's."""
    tm, tokens, ref, flax = jax_case
    tp, ep = LAYOUTS[layout]
    model = _tp(tm, tp, ep)
    converted = tensor_parallel_params_from_jax(flax, _cfg(), tp,
                                                ep_axis=ep)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(converted[name].numpy(), t.numpy())
    with torch.no_grad():
        out = model(tokens).numpy()
    np.testing.assert_allclose(out, ref, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("remat", sorted(REMATS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tp_moe_grads_match_unsharded(jax_case, layout, remat):
    """The loss with the aux losses and every gradient against the
    unsharded port model; under remat, against the same tp model without
    it."""
    tm, tokens, _, _ = jax_case
    tp, ep = LAYOUTS[layout]
    tm.zero_grad()
    _, want_loss, want_aux = _loss(tm, tokens)
    want_loss.backward()
    want = {n: p.grad.clone() for n, p in tm.named_parameters()}
    specs = TP.tp_param_specs(tm, tp, ep_axis=ep)
    model = _tp(tm, tp, ep, REMATS[remat])
    logits, loss, aux = _loss(model, tokens)
    loss.backward()
    got = _grads(model, specs)
    np.testing.assert_allclose(float(loss.detach()),
                               float(want_loss.detach()), rtol=1e-5)
    np.testing.assert_allclose([float(a) for a in aux],
                               [float(a) for a in want_aux], rtol=1e-6)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    if REMATS[remat] is None:
        return
    plain = _tp(tm, tp, ep)
    p_logits, p_loss, _ = _loss(plain, tokens)
    p_loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               p_logits.detach().numpy(), atol=REMAT_TOL,
                               rtol=0)
    for name, g in _grads(plain, specs).items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                   atol=REMAT_TOL, rtol=0, err_msg=name)


def test_dense_blocks_under_remat_match_no_remat():
    """Remat applies to the dense tp blocks too (GQA: the kv gather runs
    again in the recompute)."""
    kw = dict(KW, num_experts=0, num_kv_heads=2)
    g = torch.Generator().manual_seed(0)
    tm = TT.TransformerLM(TT.TransformerConfig(dtype=torch.float32, **kw))
    tm.reset_parameters(g)
    tokens = torch.randint(0, 64, (2, 16), generator=g)
    grads = []
    for remat in (None, "full", "dots"):
        cfg = TT.TransformerConfig(dtype=torch.float32,
                                   remat=remat is not None,
                                   remat_policy=remat or "full", **kw)
        model = TP.TensorParallelLM(cfg, 4, TT.local_attention)
        model.load_state_dict(TP.tp_shard_params(tm, tm.state_dict(), 4))
        logits = model(tokens)
        F.cross_entropy(logits.reshape(-1, 64),
                        tokens.reshape(-1)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for other in grads[1:]:
        for name, gr in other.items():
            np.testing.assert_allclose(gr.numpy(), grads[0][name].numpy(),
                                       atol=REMAT_TOL, rtol=0, err_msg=name)


def test_ep_layout_checks_its_axis():
    cfg = _cfg()
    with pytest.raises(ValueError, match="one expert a rank"):
        TP.TensorParallelLM(cfg, 2, ep_axis=2)
    with pytest.raises(ValueError, match="num_experts=0"):
        TP.TensorParallelLM(TT.TransformerConfig(
            dtype=torch.float32, **dict(KW, num_experts=0)), 2, ep_axis=4)


def test_tensor_parallel_training_moe_remat_loss_falls():
    """The entry point with ``--num-experts`` and ``--remat``."""
    from bluefog_tpu_torch import tensor_parallel_training as TPT
    res = TPT.main(["--device", "cpu", "--steps", "12", "--num-experts",
                    "4", "--remat"])
    assert res["losses"][-1] < res["losses"][0]


# ---------------------------------------------------------------------------
# Across gloo processes
# ---------------------------------------------------------------------------

def _dist_model(seed=0):
    g = torch.Generator().manual_seed(seed)
    tm = TT.TransformerLM(_cfg())
    tm.reset_parameters(g)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 64,
                                                               (2, 16)))
    return tm, tokens


def scenario(tp_axis, ep_of) -> dict:
    """Both dist layouts under each remat policy: logits, loss and this
    process's parameters' gradients.  ``tp_axis`` is the world's axis
    (``bf.process_ranks()``, or 4 rank-major); ``ep_of(world)`` the expert
    axis of the ep layout."""
    tm, tokens = _dist_model()
    out = {}
    for layout, (tp, ep) in {"whole": (tp_axis, None),
                             "ep": (2, ep_of(tp_axis))}.items():
        for remat in sorted(REMATS):
            model = _tp(tm, tp, ep, REMATS[remat])
            logits, loss, _ = _loss(model, tokens)
            loss.backward()
            out[f"{layout}/{remat}"] = {
                "logits": logits.detach(), "loss": loss.detach(),
                "grads": {n: p.grad for n, p in model.named_parameters()}}
    return out


def _worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    bf.init_distributed(device="cpu")
    try:
        comm = bf.process_ranks()
        res = scenario(comm, lambda world: world)
        res["lo"], res["m"] = comm.lo, comm.hi - comm.lo
        torch.save(res, args.out)
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_moe")
    port = _free_port()
    children = []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "MASTER_", "WORLD_SIZE",
                                    "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES="2",
                   OMP_NUM_THREADS="1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_ID=str(p))
        children.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / f"proc{p}.pt")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for c in children:
            logs.append(c.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the 2-process group hung past {JOIN_TIMEOUT} s")
    for p, c in enumerate(children):
        assert c.returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    parts = [torch.load(tmp / f"proc{p}.pt", weights_only=False)
             for p in range(2)]
    want = scenario(4, lambda world: 4)
    return parts, want


@pytest.mark.parametrize("remat", sorted(REMATS))
@pytest.mark.parametrize("layout", ["whole", "ep"])
def test_tp_moe_across_processes_matches_one_process(dist_run, layout,
                                                     remat):
    parts, want = dist_run
    key = f"{layout}/{remat}"
    tm, _ = _dist_model()
    ref = want[key]
    tp, ep = (4, None) if layout == "whole" else (2, 4)
    specs = TP.tp_param_specs(tm, tp, ep_axis=ep)
    for part in parts:
        got = part[key]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   ref["logits"].numpy(), atol=DIST_TOL,
                                   rtol=DIST_TOL)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=DIST_TOL)
        lo, m = part["lo"], part["m"]
        for name, g in got["grads"].items():
            spec = specs[name]
            # A cut parameter holds this process's shards of the world's
            # axis (tp in "whole", the experts in "ep").
            w = ref["grads"][name]
            if spec is not None and spec[0] == 4:
                w = w[lo:lo + m]
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=DIST_TOL,
                                       rtol=DIST_TOL, err_msg=name)
    if remat != "none":
        for part in parts:
            plain = part[f"{layout}/none"]
            np.testing.assert_allclose(part[key]["logits"].numpy(),
                                       plain["logits"].numpy(),
                                       atol=REMAT_TOL, rtol=0)


if __name__ == "__main__":
    _worker()
