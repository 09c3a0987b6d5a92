"""The port's input pipeline against the JAX package's.

``data.DistributedSampler`` gives the same index matrices, epoch by
epoch, shuffled or not, static shards or not, with and without
``drop_last``; ``ShardedLoader`` the same batches (the port's as tensors
on the device, the CPU here; JAX's as arrays), bit for bit; the transform
runs on the prefetch thread; errors surface in the consumer; an abandoned
consumer releases the producer.  Tolerance: exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

from bluefog_tpu import data as JD
from bluefog_tpu_torch import data as TD


@pytest.mark.parametrize("kw", [
    dict(num_samples=40, num_ranks=4),
    dict(num_samples=43, num_ranks=4, drop_last=False),
    dict(num_samples=43, num_ranks=4, drop_last=True),
    dict(num_samples=30, num_ranks=8, shuffle=False),
    dict(num_samples=37, num_ranks=3, static_shards=True, seed=5),
    dict(num_samples=37, num_ranks=3, static_shards=True, drop_last=False),
])
def test_sampler_equals_jax(kw):
    js, ts = JD.DistributedSampler(**kw), TD.DistributedSampler(**kw)
    assert len(ts) == len(js)
    for epoch in range(3):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        np.testing.assert_array_equal(ts.indices(), js.indices())
        assert [c.tolist() for c in ts] == [c.tolist() for c in js]


def test_sampler_too_few_samples_raises():
    for D in (JD, TD):
        with pytest.raises(ValueError, match="cannot shard"):
            D.DistributedSampler(3, num_ranks=4)


def _arrays():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(70, 3).astype(np.float32),
            "y": np.arange(70, dtype=np.int64)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=3, drop_last=False),
    dict(batch_size=5, static_shards=True, seed=2),
    dict(batch_size=4, shuffle=False)])
def test_sharded_loader_equals_jax(kw):
    """The same batches, epoch by epoch, shapes ``(ranks, batch, ...)``."""
    jl = JD.ShardedLoader(_arrays(), num_ranks=4, sharding=False, **kw)
    tl = TD.ShardedLoader(_arrays(), num_ranks=4,
                          device=torch.device("cpu"), **kw)
    assert len(tl) == len(jl) == tl.steps_per_epoch
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for a, b in zip(jb, tb):
            assert sorted(b) == sorted(a)
            for k in a:
                assert isinstance(b[k], torch.Tensor)
                assert b[k].shape[:2] == (4, kw["batch_size"])
                np.testing.assert_array_equal(b[k].numpy(), a[k])


def test_loader_default_device_is_bf_device():
    import bluefog_tpu_torch as tbf
    tbf.init(2, device="cpu")
    try:
        b = next(iter(TD.ShardedLoader(_arrays(), batch_size=2)))
        assert b["x"].shape == (2, 2, 3) and b["x"].device.type == "cpu"
    finally:
        tbf.shutdown()


def test_transform_runs_on_the_prefetch_thread():
    seen = []

    def tf(batch):
        seen.append(threading.current_thread().name)
        return {"x": batch["x"] * 2}
    tl = TD.ShardedLoader(_arrays(), batch_size=4, num_ranks=2,
                          transform=tf, device=torch.device("cpu"))
    out = list(tl)
    assert out and set(seen) == {"bf-data-prefetch"}


def test_prefetch_raw_mode_and_errors():
    src = [{"a": np.ones(2)}, {"a": np.zeros(2)}]
    raw = list(TD.prefetch_to_device(iter(src), device=False))
    assert raw[0] is src[0] or np.array_equal(raw[0]["a"], src[0]["a"])

    def bad():
        yield {"a": np.ones(2)}
        raise RuntimeError("boom")
    it = TD.prefetch_to_device(bad(), device=torch.device("cpu"))
    assert torch.equal(next(it)["a"], torch.ones(2, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_abandoned_consumer_releases_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"a": np.full(2, i)}
            i += 1
    it = TD.prefetch_to_device(endless(), size=2, device=False)
    next(it)
    it.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.5)
    assert len(produced) == n     # the producer stopped
