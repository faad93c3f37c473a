"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the harness's look for a card and drives the rest of a run
of a cell (its driver, its comparison, its limits from
``h100bench/limits/``) on the CPU at a tiny size (n_feats 16, one block,
small frames), with one fault planted in the port: a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced. The exchange between chips is no fault a one-card cell can
have. A sound run of the same size reads ``correct`` true.

The control (the reference in fp8 in the program's place) is run on the
card at each cell's own size: ``test_control_fails_on_the_card``, marked
``cuda``.
"""

import json
import os

import numpy as np
import pytest
import torch

from h100bench.core import spec
from h100bench.drivers import Context
from h100bench.reference import compare

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 2 ** 31 + 11
TINY_STREAM = {"x4-serve-b8": {"batch": 2, "lr_hw": [32, 32],
                               "pool": 4, "distinct": 4, "sample": 3},
               "x4-live-256-u8": {"lr_hw": [32, 40],
                                  "pool": 4, "distinct": 4, "sample": 3}}
TINY_TRAIN = {"phantoms": 4, "phantom_hw": [96, 96]}


def _ctx(cell, seconds=0.6):
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    traffic = dict(spec.traffic(w["traffic"]))
    traffic.update(TINY_STREAM.get(cell, TINY_TRAIN))
    name = "tiny-x4" if spec.config(bench, w["config"])["model"]["scale"] == 4 else "tiny-x2"
    with open(os.path.join(DATA, f"{name}.json"), encoding="utf-8") as fh:
        config = json.load(fh)
    return Context(cell=cell, seed=SEED, seconds=seconds, trace=False, config=config,
                   traffic=traffic, device="cpu")


def _correct(cell, **kw):
    ctx = _ctx(cell, **kw)
    out = spec.driver(ctx.traffic["driver"]).run(ctx)
    checked = compare.judged(out["numbers"], compare.limits(cell))
    return out["complete"] and compare.passes(checked), checked


STREAM_CELLS = ["x4-serve-b8", "x4-live-256-u8"]
TRAIN_CELLS = ["x2-train-recipe-b2", "x2-train-l1-b2"]


@pytest.mark.parametrize("cell", STREAM_CELLS + TRAIN_CELLS)
def test_sound_run_is_correct(cell):
    ok, checked = _correct(cell)
    assert ok, checked


def _patch_take(monkeypatch, alter):
    from m2trans_tpu_torch.parallel.streaming import StreamingSR

    take = StreamingSR._take
    seen = []

    def broken(out, done):
        res = take(out, done)
        seen.append(res)
        return alter(res, seen)

    monkeypatch.setattr(StreamingSR, "_take", staticmethod(broken))


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_stream_state_unchanged(cell, monkeypatch):
    # every request is answered with the first frames the stream produced
    _patch_take(monkeypatch, lambda res, seen: seen[0].copy())
    assert not _correct(cell)[0]


@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_stream_answer_altered(cell, monkeypatch):
    # every answer's frames mirrored where they are produced
    def alter(res, seen):
        return np.ascontiguousarray(res[:, :, ::-1])

    _patch_take(monkeypatch, alter)
    assert not _correct(cell)[0]


def test_stream_half_batch(monkeypatch):
    # the forward runs the first half of a batch and leaves the rest out
    import m2trans_tpu_torch.parallel.streaming as streaming

    fwd = streaming.serving_forward

    def half(model, x, *args):
        y = fwd(model, x[: x.shape[0] // 2], *args)
        return torch.cat([y, torch.zeros_like(y)])

    monkeypatch.setattr(streaming, "serving_forward", half)
    assert not _correct("x4-serve-b8")[0]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_state_unchanged(cell, monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    ok, checked = _correct(cell)
    assert not ok and checked["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_half_batch(cell, monkeypatch):
    from m2trans_tpu_torch.train.loop import Trainer

    step = Trainer.step

    def half(self, it, batch, do_cutout=False):
        return step(self, it, tuple(np.ascontiguousarray(a[: len(a) // 2]) for a in batch),
                    do_cutout)

    monkeypatch.setattr(Trainer, "step", half)
    assert not _correct(cell)[0]


def _control(cell, device):
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    ctx = Context(cell=cell, seed=SEED, seconds=1.0, trace=False,
                  config=spec.config(bench, w["config"]),
                  traffic=spec.traffic(w["traffic"]), device=device)
    return spec.driver(ctx.traffic["driver"]).control(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STREAM_CELLS + TRAIN_CELLS)
def test_control_fails_on_the_card(cell, card):
    numbers = _control(cell, card)
    assert not compare.passes(compare.judged(numbers, compare.limits(cell))), numbers
