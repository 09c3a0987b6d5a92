"""The window store against a caller on a side stream, on the card.

Window ops run on the device's default stream; a caller may have another
stream current.  Each op must then read what the caller wrote before it,
and the caller must read an op's results, and overwrite its payload,
after it.  Sleeps on one stream or the other open each race wide: without
the ordering, a put reads its payload before it is written, and the
caller overwrites an accumulate's payload before it is read and reads the
update's rows before they are computed.

Imports neither JAX nor ``bluefog_tpu``, so that it runs on a machine
with a GPU and no JAX; there, without this directory's ``conftest.py``
(which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_window_cuda.py
"""

import contextlib

import pytest
import torch

import bluefog_tpu_torch as bf

pytestmark = pytest.mark.cuda

N, COLS = 4, 1 << 22
SLEEP_CYCLES = 100_000_000     # ~50-60 ms of a spinning kernel on an H100


def _sleep(stream):
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)


def _window_ops(dev, side_stream: bool):
    """A put, an accumulate and two updates; on the card from a side
    stream, with each race opened by sleeps."""
    bf.init(N, device=dev)
    try:
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(N, COLS, generator=gen).to(dev)
        bf.win_create(torch.zeros_like(x), "s")
        cuda = side_stream and dev == "cuda"
        side = torch.cuda.Stream() if cuda else None
        default = torch.cuda.default_stream() if cuda else None
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            # The payload is written late on the caller's stream: the put
            # must wait for it.
            y = torch.empty_like(x)
            if cuda:
                _sleep(side)
            y.copy_(x)
            bf.win_put(y, "s")
            # The window ops run late: the caller must not overwrite the
            # payload before the accumulate has read it ...
            z = 0.5 * x
            if cuda:
                _sleep(default)
            bf.win_accumulate(z, "s")
            z.fill_(float("nan"))
            # ... nor read the update's rows before they are computed.
            if cuda:
                _sleep(default)
            first = bf.win_update("s")
            second = bf.win_update("s", self_weight=0.5,
                                   neighbor_weights={
                                       (r, (r - 1) % N): 0.25
                                       for r in range(N)})
        if cuda:
            torch.cuda.synchronize()
        return [first.cpu(), second.cpu()]
    finally:
        bf.shutdown()


def test_side_stream_caller_sees_window_ops_in_order():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA streams)")
    want = _window_ops("cpu", side_stream=False)
    # Twice: a kernel's first launch loads its module, which may wait for
    # the whole device and so close the races the sleeps open.
    for _ in range(2):
        got = _window_ops("cuda", side_stream=True)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            assert torch.equal(g, w), float((g - w).abs().max())
