"""How ``StreamingSR`` hands results out (``parallel/streaming.py``): the
result pool's bookkeeping on plain CPU tensors, the choice between a lent
buffer and the slot's own, ``_take`` on both, and the CPU stream, which
lends nothing. The pinned path on the card is in
``tests/test_torch_port_cuda.py``. The file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_handoff.py -q
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.parallel import streaming
from m2trans_tpu_torch.parallel.streaming import ResultPool, StreamingSR
from m2trans_tpu_torch.utils import spans

SHAPE = (2, 8, 8, 3)
NBYTES = 2 * 8 * 8 * 3 * 4


def _plain(shape, dtype):
    return torch.empty(shape, dtype=dtype)


class _Passed:
    """Stands in for a CUDA event whose work is done."""

    def synchronize(self):
        pass


# each keeps the result alive by one holder the consumer may make of it
KEEPERS = {
    "lent tensor": lambda t: t,
    "its array": lambda t: t.numpy(),
    "a view of the array": lambda t: t.numpy()[1:],
    "a view of a view": lambda t: t.numpy()[1:][:, 2:],
    "a reinterpreted view": lambda t: t.numpy().view(np.uint8),
    "a tensor on a view": lambda t: torch.from_numpy(t.numpy()[:1]),
    "a tensor on the tensor": lambda t: t.view(-1),
}


@pytest.mark.parametrize("keeper", sorted(KEEPERS))
def test_lent_bytes_fall_only_when_every_holder_is_gone(keeper):
    pool = ResultPool(_plain)
    lent = pool.lend(SHAPE, torch.float32)
    assert ResultPool.is_lent(lent) and pool.lent_bytes == NBYTES
    held = KEEPERS[keeper](lent)
    del lent
    assert pool.lent_bytes == NBYTES
    again = pool.lend(SHAPE, torch.float32)  # the held buffer is not lent again
    mem = held.numpy() if isinstance(held, torch.Tensor) else held
    assert not np.shares_memory(again.numpy(), mem)
    assert pool.lent_bytes == 2 * NBYTES and pool.made == 2
    del held, again, mem
    assert pool.lent_bytes == 0


def test_a_held_buffer_is_never_lent_again():
    """Of 20 results held, none shares memory with another; dropped, their
    buffers are lent again and no new one is made."""
    pool = ResultPool(_plain)
    held = [pool.lend(SHAPE, torch.float32).numpy() for _ in range(20)]
    for i, a in enumerate(held):
        a[...] = i
    assert [float(a.mean()) for a in held] == list(range(20))
    assert len({a.ctypes.data for a in held}) == 20 and pool.made == 20
    ptrs = {a.ctypes.data for a in held}
    del held, a
    again = [pool.lend(SHAPE, torch.float32) for _ in range(20)]
    assert {t.data_ptr() for t in again} == ptrs and pool.made == 20


def test_buffers_are_kept_by_shape_and_dtype():
    pool = ResultPool(_plain)
    a = pool.lend(SHAPE, torch.float32)
    ptr = a.data_ptr()
    del a
    b = pool.lend(SHAPE, torch.uint8)
    c = pool.lend((1, 8, 8, 3), torch.float32)
    assert b.dtype == torch.uint8 and tuple(c.shape) == (1, 8, 8, 3) and pool.made == 3
    d = pool.lend(SHAPE, torch.float32)
    assert d.data_ptr() == ptr and pool.made == 3


def test_past_the_limit_the_pool_lends_nothing(monkeypatch):
    monkeypatch.setattr(streaming, "HANDOFF_LIMIT_BYTES", 3 * NBYTES)
    pool = ResultPool(_plain)
    held = [pool.lend(SHAPE, torch.float32) for _ in range(3)]
    assert pool.lend(SHAPE, torch.float32) is None
    del held[0]
    assert pool.lend(SHAPE, torch.float32) is not None and pool.made == 3


def test_free_buffers_of_other_shapes_make_room(monkeypatch):
    """At the limit, free buffers of another shape are let go to make a new
    one; buffers still lent are not."""
    monkeypatch.setattr(streaming, "HANDOFF_LIMIT_BYTES", 3 * NBYTES)
    pool = ResultPool(_plain)
    small = [pool.lend((1, 8, 8, 3), torch.float32) for _ in range(6)]
    assert pool.lend(SHAPE, torch.float32) is None
    del small[:2]
    big = pool.lend(SHAPE, torch.float32)
    assert big is not None and pool.lent_bytes == 3 * NBYTES
    assert pool.lend(SHAPE, torch.float32) is None  # four small ones still lent
    del small
    assert pool.lend(SHAPE, torch.float32) is not None and pool.made == 8


def test_a_result_dropped_on_another_thread_comes_back():
    pool = ResultPool(_plain)
    box = [pool.lend(SHAPE, torch.float32).numpy()]
    ptr = box[0].ctypes.data
    worker = threading.Thread(target=box.clear)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and box == []
    assert pool.lent_bytes == 0
    assert pool.lend(SHAPE, torch.float32).data_ptr() == ptr and pool.made == 1


def _runner(depth=2):
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    run = StreamingSR(init_m2trans(cfg, seed=0), cfg, policy=ComputePolicy(), depth=depth)
    run.results = ResultPool(_plain)
    return run


def test_landing_lends_until_the_limit_then_takes_the_slot(monkeypatch):
    """Each result lands in a lent buffer and ``_take`` hands that buffer
    out; past the limit it lands in the slot's buffer, is counted in
    ``copied_out``, and ``_take`` copies it out."""
    monkeypatch.setattr(streaming, "HANDOFF_LIMIT_BYTES", 2 * NBYTES)
    run = _runner()
    slot = torch.full(SHAPE, 7.0)
    got = []
    for i in range(4):
        out = run._landing(slot)
        out.fill_(i)
        got.append((out, StreamingSR._take(out, _Passed())))
    assert (run.handed_out, run.copied_out) == (2, 2)
    for i, (out, res) in enumerate(got):
        lent = i < 2
        assert (out is not slot) == lent
        assert np.shares_memory(res, out.numpy()) == lent
    assert [float(r.mean()) for _, r in got] == [0.0, 1.0, 2.0, 3.0]
    assert float(slot.mean()) == 3.0  # the copies left the slot's buffer free


def test_take_opens_a_handoff_span_only_for_a_lent_buffer():
    run = _runner()
    lent, slot = run._landing(torch.zeros(SHAPE)), torch.zeros(SHAPE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        StreamingSR._take(slot, _Passed())
        StreamingSR._take(lent, _Passed())
        StreamingSR._take(slot, None)
    names = [e.name for e in prof.events() if e.name.startswith("m2t::")]
    assert names == [spans.STREAM_HANDOFF]


@pytest.mark.parametrize("depth", [1, 2])
def test_cpu_stream_lends_nothing_and_opens_no_handoff(depth):
    """A CPU model's stream hands out its results as before: the frames of
    the synchronous call, no buffer lent, no ``m2t::stream.handoff``."""
    run = _runner(depth)
    frames = [np.random.default_rng(i).random((1, 12, 12, 3), dtype=np.float32)
              for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = list(run.stream(frames))
    names = [e.name for e in prof.events() if e.name.startswith("m2t::stream.")]
    assert spans.STREAM_HANDOFF not in names and names.count(spans.STREAM_COPY_OUT) == 5
    assert (run.handed_out, run.copied_out, run.results.made) == (0, 0, 0)
    assert run._slots == {}
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, run(f))


def test_a_stream_left_early_waits_for_the_copies_it_drops(monkeypatch):
    """Closed after its first result, a stream waits on the event of each
    request still in flight before their buffers go back to the pool."""
    run = _runner(depth=3)
    waited = []

    class Event:
        def __init__(self, seq):
            self.seq = seq

        def synchronize(self):
            waited.append(self.seq)

    def submit(frames, slot, seq=None):
        return run._landing(torch.zeros(SHAPE)), Event(seq)

    monkeypatch.setattr(run, "_submit", submit)
    frames = run.stream([None] * 6)
    first = next(frames)
    assert run.results.lent_bytes == 3 * NBYTES
    frames.close()
    assert waited[-2:] == [1, 2]
    assert run.results.lent_bytes == NBYTES  # the result taken is still held
    del first
    assert run.results.lent_bytes == 0
