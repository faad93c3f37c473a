"""Throughput benchmark of the PyTorch port; the counterpart of bench.py.

    python -m m2trans_tpu_torch.bench [--device cuda|cpu] [--n-blocks 8]
        [--batch 8] [--hw 96]

Prints ONE JSON line:
  {"metric": "x4_sr_output_megapixels_per_sec_per_chip", "value": N,
   "unit": "MP/s", "method": ..., "ms_per_step_device": ...,
   "wall_mps": ..., "ms_per_step_wall": ..., "baseline_mps": ...,
   "vs_baseline": ..., "device": ..., "power_limit_w": ...}

Recipe (bench.py's): the flagship x4 model (n_feats 64, n_blocks 8, seeded
weights), a batch of 8 96x96 LR frames -> 384x384 SR, bf16 with the
kernels; throughput counts OUTPUT megapixels. One step of the chain is
``x <- x * 0.999 + mean(y) * 1e-3`` with ``y`` the forward of ``x``, so
every HR pixel feeds the next input.

``value`` (``method: "cuda_graph_slope"``): the forward of a step is the one
``StreamingSR`` serves on the card, ``models/graphed.py::GraphedForward``,
a CUDA graph captured on the first step and replayed after (its key check,
pool and output cast included); the chain's update around it is a few small
eager launches. n chained steps are then n replays, the counterpart of
bench.py's ``lax.fori_loop`` chain. Chains of n1 = 4 and n2 = 36 steps are
timed with CUDA events, and the value is the median over 5 pairs of the
slope (t2 - t1) / (n2 - n1): device time a step, the graph's gaps between
kernels included. bench.py perturbs the parameters inside its loop only so
that XLA cannot hoist the weight preparation out of it; the port's server
keeps that preparation on the modules between calls
(``models/m2trans.py::_prepared``), and the graph replays it as the server
does, so no perturbation is needed: the bench measures what the server
runs.

``wall_mps`` / ``ms_per_step_wall``: the same step with the serving forward
run eagerly (``models/graphed.py::serving_forward``) from a Python loop, a
call a step (bench.py's per-call method), timed on the host clock
over a chain that ends in a synchronise, median slope of 3 pairs (n = 2,
18): what the port served before it replayed graphs.

``baseline_mps``: the same recipe in the reference's numerics, measured in
this process on this device: f32 (``ComputePolicy()``, TF32 off, no
kernels), eager, per-call wall as above. ``vs_baseline`` = value /
baseline_mps. (bench.py divides by a constant estimated for another GPU;
this one is measured.)

``--device cpu`` runs on the CPU with the kernels' plain versions and no
graph: ``method`` is then ``"eager_slope"``, ``value`` the per-call eager
slope and ``ms_per_step_device`` null. ``--device cuda`` (the default)
fails without a card.
"""

from __future__ import annotations

import argparse
import json
import time

from m2trans_tpu_torch.tools.timing import card, graph_seconds_per_step, median_slope

METRIC = "x4_sr_output_megapixels_per_sec_per_chip"
WALL_N = (2, 18)     # eager steps per timed run
WALL_PAIRS = 3


def chain_step(forward):
    """``step(x) = x * 0.999 + mean(forward(x)) * 1e-3``, the chain's body,
    ``forward`` the serving forward (f32 out)."""

    def step(x):
        return x * 0.999 + forward(x).mean() * 1e-3

    return step


def eager_seconds_per_step(step, x0) -> float:
    """Host-clock seconds a step of the eager per-call chain."""
    import torch

    def run(n):
        x = x0
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        if x.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)  # warm: builds the kernels and the cached weight operands
    return median_slope(run, WALL_N, WALL_PAIRS)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="x4 SR throughput (PyTorch port)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=96, help="LR frame side")
    args = ap.parse_args(argv)

    import torch

    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward
    from m2trans_tpu_torch.models.m2trans import (
        ComputePolicy,
        init_m2trans,
        policy_from_config,
    )
    from m2trans_tpu_torch.parallel import mesh as mesh_lib

    device = mesh_lib.init_from_env(args.device)
    cfg = Config(scale=4, n_feats=64, n_blocks=args.n_blocks, colors=3,
                 dtype="bfloat16", use_pallas=True)
    model = init_m2trans(cfg, seed=0, device=device)
    x0 = torch.rand(args.batch, args.hw, args.hw, 3,
                    generator=torch.Generator().manual_seed(1)).to(device)
    out_mp = args.batch * (args.hw * cfg.scale) ** 2 / 1e6

    def eager(policy):
        return chain_step(lambda x: serving_forward(model, x, cfg, policy, False))

    policy = policy_from_config(cfg)
    with torch.inference_mode():
        wall = eager_seconds_per_step(eager(policy), x0)
        if device.type == "cuda":
            method = "cuda_graph_slope"
            dev = graph_seconds_per_step(
                chain_step(GraphedForward(model, cfg, policy)), x0)
            value = out_mp / dev
        else:
            method, dev, value = "eager_slope", None, out_mp / wall
        base = eager_seconds_per_step(eager(ComputePolicy()), x0)
    baseline_mps = out_mp / base
    line = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "MP/s",
        "method": method,
        "ms_per_step_device": None if dev is None else round(dev * 1e3, 3),
        "wall_mps": round(out_mp / wall, 2),
        "ms_per_step_wall": round(wall * 1e3, 3),
        "baseline_mps": round(baseline_mps, 2),
        "vs_baseline": round(value / baseline_mps, 3),
        **card(device),
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
