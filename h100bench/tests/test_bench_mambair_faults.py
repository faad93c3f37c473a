"""A run of the MambaIR cell with its scan broken underneath reads
``correct`` false.

As ``test_bench_faults.py``: each test skips the harness's look for a card
and drives the rest of a run of ``mambair-x4-serve-b8`` (its driver, its
comparison, its limit from ``h100bench/limits/``) on the CPU, here at the
published width (embed_dim 180, d_inner 360) but one group of three
VSSBlocks and 2 x 24 x 20 frames (``data/tiny-mambair.json``): the scan's
state-space term grows with the width, so a narrow model would hide the
fault. The planted fault: a scan that drops the reversed directions (y =
y_0 + y_1, their D x terms included). A sound run of the same size reads
``correct`` true.

The controls run on the card at the cell's own size
(``test_control_fails_on_the_card``, marked ``cuda``): the reference with
its products in fp8 fails; with its scan's state kept in bf16 it is a
reading for ``PERF.md``, not a fault.
"""

import json
import os

import pytest
import torch

from h100bench.core import spec
from h100bench.drivers import Context
from h100bench.reference import compare

CELL = "mambair-x4-serve-b8"
DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 2 ** 31 + 11
SMALL = {"batch": 2, "lr_hw": [24, 20], "pool": 4, "distinct": 4, "sample": 3}


def _correct(seconds=0.6):
    bench = spec.benchmark()
    traffic = dict(spec.traffic(spec.workload(bench, CELL)["traffic"]))
    traffic.update(SMALL)
    with open(os.path.join(DATA, "tiny-mambair.json"), encoding="utf-8") as fh:
        config = json.load(fh)
    ctx = Context(cell=CELL, seed=SEED, seconds=seconds, trace=False, config=config,
                  traffic=traffic, device="cpu")
    out = spec.driver(ctx.traffic["driver"]).run(ctx)
    checked = compare.judged(out["numbers"], compare.limits(CELL))
    return out["complete"] and compare.passes(checked), checked


def test_sound_run_is_correct():
    ok, checked = _correct()
    assert ok, checked


def test_scan_without_the_reversed_directions(monkeypatch):
    # the scan runs directions 0 and 1 only: the reversed orders' B, C and D zeroed
    import m2trans_tpu_torch.models.mambair as mambair

    scan = mambair.ss2d_scan

    def forward_only(x, xdbl, dt_w, dt_b, a, ds):
        b, h, w, _ = x.shape
        proj = xdbl.reshape(b, h, w, 4, -1).clone()
        proj[..., 2:, dt_w.shape[-1]:] = 0
        keep = torch.tensor([1.0, 1.0, 0.0, 0.0])[:, None]
        return scan(x, proj.reshape(xdbl.shape), dt_w, dt_b, a, ds * keep)

    monkeypatch.setattr(mambair, "ss2d_scan", forward_only)
    ok, checked = _correct()
    assert not ok and checked["mean_abs"]["value"] > checked["mean_abs"]["limit"], checked


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    bench = spec.benchmark()
    w = spec.workload(bench, CELL)
    ctx = Context(cell=CELL, seed=SEED, seconds=1.0, trace=False,
                  config=spec.config(bench, w["config"]), traffic=spec.traffic(w["traffic"]),
                  device=card)
    drv = spec.driver(ctx.traffic["driver"])
    numbers = drv.control(ctx)
    assert not compare.passes(compare.judged(numbers, compare.limits(CELL))), numbers
    print("state_bf16 control", drv.control(ctx, "state_bf16"))
