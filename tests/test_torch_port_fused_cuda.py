"""The fused window step and the put-plan path on the card.

* ``csrc/hostfn.cu`` builds; its host functions run on a stream as
  callbacks and, captured, as host nodes of a CUDA graph at every replay:
  a plan run writes its status, a probe lands in the ring on the host's
  clock.
* Through a loopback rig on the card (even ranks here, odd ranks behind a
  local server transport feeding the same store): the put-plan path's
  window state is bitwise the host-staged path's, and the fused step
  (eager first step, then captured and replayed) leaves the parameters
  and every window bit for bit where the eager step leaves them, with
  every status 0, for each codec.

Imports neither JAX nor ``bluefog_tpu``; on a machine with a GPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_fused_cuda.py
"""

import threading
import time

import pytest
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import native
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.ops import hostfn, xlaffi
from bluefog_tpu_torch.ops import transport as TR
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.optim import window_optimizers as WO
from bluefog_tpu_torch.utils import config, probes, telemetry

pytestmark = pytest.mark.cuda

N = 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, host functions)")


class _Rig:
    """Windows made in one process, then a directory whose odd ranks live
    behind a local server transport feeding the same store."""

    def __init__(self, device):
        bf.init(N, device=device, topology_fn=lambda: topo.RingGraph(N))
        self.applied = 0
        self.cv = threading.Condition()
        self.server = TR.WindowTransport(
            self._one, apply_batch=self._batch, apply_items=self._items,
            alloc=W._pinned_alloc(torch.device(device)))
        self.client = TR.WindowTransport(lambda *a: None)
        self.saved = W._store.distrib

    def _bump(self, k):
        with self.cv:
            self.applied += k
            self.cv.notify_all()

    def _one(self, *m):
        W._apply_inbound(*m)
        self._bump(1)

    def _batch(self, msgs):
        W._apply_inbound_batch(msgs)
        self._bump(len(msgs))

    def _items(self, items):
        W._apply_inbound_items(items)
        self._bump(sum((p[5] + p[6]) if k else 1 for k, p in items))

    def install(self, names_elems):
        for name, elems in names_elems:
            self.server.register_window(name, elems)
        W._store.distrib = W._Distrib(
            self.client, rank_owner={r: r % 2 for r in range(N)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", self.server.port)}, my_proc=0)

    def wait(self, total):
        with self.cv:
            assert self.cv.wait_for(lambda: self.applied >= total,
                                    timeout=60), (self.applied, total)

    def close(self):
        W._store.distrib = self.saved
        self.client.stop()
        self.server.stop()
        W.turn_off_win_ops_with_associated_p()
        bf.shutdown()


def _digest(state):
    out = {}
    for part, v in state.items():
        if isinstance(v, dict):
            out[part] = {k: (t.numpy().tobytes() if torch.is_tensor(t)
                             else t) for k, t in v.items()}
        else:
            out[part] = v
    return out


def test_host_functions_run_on_stream_and_in_graph():
    _need_card()
    hostfn.load()
    lib = native.lib()
    probes._reset_for_tests()
    assert probes.arm()
    status = torch.full((1,), -99, dtype=torch.int32, pin_memory=True)
    buf = torch.ones(1, 4, dtype=torch.float32, pin_memory=True)
    # Plan 0 does not exist: its run returns -9 into the status slot.
    keep = [hostfn.enqueue_probe(probes.GRAD_READY),
            hostfn.enqueue_plan_run(0, 1, buf.data_ptr(), 4,
                                    status.data_ptr())]
    torch.cuda.synchronize()
    assert int(status[0]) == -9
    ev = probes.drain()
    assert [p for _t, p, _s in ev] == [probes.GRAD_READY]
    x = torch.zeros(4, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        x.add_(1.0)
        keep.append(hostfn.enqueue_probe(probes.STEP_END))
        keep.append(hostfn.enqueue_plan_run(0, 1, buf.data_ptr(), 4,
                                            status.data_ptr()))
    torch.cuda.synchronize()
    assert probes.drain() == []   # captured, not run
    for _ in range(3):
        status.fill_(7)
        t0 = time.monotonic_ns()
        g.replay()
        torch.cuda.synchronize()
        assert int(status[0]) == -9
        (t, p, _), = probes.drain()
        assert p == probes.STEP_END and t0 <= t <= time.monotonic_ns()
    assert torch.equal(x.cpu(), torch.full((4,), 3.0))
    del g
    for a in keep:
        hostfn.free(a)
    assert lib.bf_probe_total() >= 4


@pytest.mark.parametrize("codec", ["none", "bf16", "sparse:0.5"])
def test_plan_path_and_fused_step_are_bitwise_on_card(codec):
    _need_card()
    results = {}
    for mode in ("eager_host", "eager_plan", "fused"):
        with config.override(win_compression=codec, win_coalesce=True,
                             win_native=True, win_coalesce_linger_ms=500.0,
                             win_xla=mode != "eager_host"):
            xlaffi._reset_for_tests()
            rig = _Rig("cuda")
            try:
                g = torch.Generator().manual_seed(0)
                params = [torch.nn.Parameter(
                    torch.randn((N,) + s, generator=g).cuda())
                    for s in ((4096,), (1000, 3))]
                cls = WO.DistributedPushSumOptimizer \
                    if codec.startswith("sparse") \
                    else WO.DistributedWinPutOptimizer
                opt = cls(torch.optim.SGD(params, lr=0.5, momentum=0.9),
                          fused=mode == "fused", fusion_buckets=2)
                rig.install([(n, sum(b - a for a, b in r)) for n, r in
                             zip(opt._names, opt._bucket_ranges)])
                expect = [0]
                orig = W._update_rows

                def synced(name, **kw):
                    rig.wait(expect[0])
                    return orig(name, **kw)
                W._update_rows = synced
                try:
                    for s in range(4):
                        gg = torch.Generator().manual_seed(100 + s)
                        for p in params:
                            p.grad = torch.randn(p.shape,
                                                 generator=gg).cuda()
                        expect[0] += N * len(opt._names)
                        opt.step(require_mutex=False)
                finally:
                    W._update_rows = orig
                torch.cuda.synchronize()
                if mode == "fused":
                    impl = opt._fused_impl
                    assert impl.fused_steps == 4 and impl.replays == 3
                    assert impl.captures == 1 and impl.last_statuses == \
                        [0] * len(opt._names)
                    assert telemetry.snapshot()["bf_fused_step_active"] == 1
                if mode == "eager_plan":
                    assert W.stats.snapshot()["plan_stage_bytes"] > 0
                results[mode] = (
                    [p.detach().cpu() for p in params],
                    {n: _digest(W.win_state_dict(n)) for n in opt._names})
                opt.free()
            finally:
                rig.close()
    base_p, base_s = results["eager_host"]
    for mode in ("eager_plan", "fused"):
        p, s = results[mode]
        for a, b in zip(base_p, p):
            assert torch.equal(a, b), mode
        assert s == base_s, mode
