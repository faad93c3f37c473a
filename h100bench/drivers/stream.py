"""Serving through ``StreamingSR.stream``: the general driver of the
``stream`` traffic mixes.

The mix's parameters: ``batch`` frames of ``lr_hw`` a request; ``out``
"f32" or "u8" (quantised on the card); ``depth`` requests in flight;
``pool`` seeded phantom frames, from which ``distinct`` request batches
are drawn once and sent in turn; ``sample`` requests checked against the
reference; ``trace_seconds`` the traced window's length. The loop is
closed: the next request is handed over as soon as the stream asks for
it, as in an offline job whose whole backlog is there.

Set-up makes the weights on the card from the seed (the reference
``state_dict`` layout), loads them into the port's model through its
reference loader, builds ``StreamingSR`` (bf16 with the kernels, a CUDA
graph a frame shape), captures the request shape and sends ``2 * depth``
requests. The window then runs ``seconds``; every request handed over in
it is waited for. ``serve_mps`` counts the output megapixels of the
requests back inside the window over its length.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from h100bench.core import counts, phantoms, stats, weights
from h100bench.core.trace import Traced, reduce
from h100bench.drivers import (
    Context,
    Reservoir,
    free_device,
    memory_peak,
    port_config,
    settle,
    span,
)
from h100bench.reference import compare
from h100bench.reference import m2trans as ref
from h100bench.reference.precision import F32, Precision, full_f32


def make_inputs(ctx: Context):
    """The request batches, from the seed: ``distinct`` batches of
    ``batch`` frames drawn from a pool of ``pool`` phantoms."""
    t = ctx.traffic
    h, w = t["lr_hw"]
    rng = np.random.default_rng([ctx.seed, 0])
    pool = phantoms.rgb_frames(rng, t["pool"], h, w)
    picks = rng.integers(0, t["pool"], (t["distinct"], t["batch"]))
    return [np.ascontiguousarray(pool[p]) for p in picks]


def build_server(ctx: Context, sd):
    import torch

    from m2trans_tpu_torch.models.m2trans import M2Trans
    from m2trans_tpu_torch.parallel.streaming import StreamingSR
    from m2trans_tpu_torch.train.convert import load_reference_state_dict

    cfg = port_config(ctx.config)
    with torch.device("meta"):
        net = M2Trans(cfg)
    net = load_reference_state_dict(net.to_empty(device=ctx.device), sd)
    return StreamingSR(net, cfg, depth=ctx.traffic["depth"],
                       output_u8=ctx.traffic["out"] == "u8")


def reference_outputs(ctx: Context, sd, inputs, prec: Precision = F32):
    """The reference's served output of each input batch (on the device,
    one request at a time)."""
    import torch

    model = ctx.config["model"]
    outs = []
    with torch.no_grad(), full_f32():
        for x in inputs:
            y = ref.forward(sd, torch.from_numpy(x).to(ctx.device), model, prec)
            outs.append(ref.served(y, ctx.traffic["out"]).cpu())
    return outs


def run(ctx: Context) -> Dict[str, Any]:
    import torch

    t, model = ctx.traffic, ctx.config["model"]
    cuda = ctx.device == "cuda"
    sd = weights.m2trans_state_dict(model, ctx.seed, ctx.device)
    ctx.mark("weights")
    batches = make_inputs(ctx)
    ctx.mark("inputs")
    server = build_server(ctx, sd)
    del sd
    ctx.mark("server")
    h, w = t["lr_hw"]
    server.warmup((t["batch"], h, w, 3))
    ctx.mark("capture")
    for _ in server.stream(batches[:2 * t["depth"]]):
        pass
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    settle()
    setup_s = time.perf_counter() - ctx.t_start

    seconds = min(ctx.seconds, t["trace_seconds"]) if ctx.trace else ctx.seconds
    sample = Reservoir(t["sample"], np.random.default_rng([ctx.seed, 1]))
    sent, back = 0, []
    on = ctx.trace

    with Traced(on, cuda) as traced, span(on, "h100bench::window"):
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def requests():
            nonlocal sent
            while time.perf_counter() < t_end:
                sent += 1
                yield batches[(sent - 1) % len(batches)]

        frames = server.stream(requests())
        while True:
            with span(on, "h100bench::stream_next"):
                out = next(frames, None)
            if out is None:
                break
            back.append(time.perf_counter())
            sample.offer(len(back) - 1, out)
        if cuda:
            torch.cuda.synchronize()
    trace = reduce(traced.prof) if on else None

    pixels = t["batch"] * h * w * model["scale"] ** 2
    e2e = {"serve_mps": stats.rate([(b, pixels / 1e6) for b in back], t0, t_end),
           "setup_s": setup_s}
    peak = memory_peak(ctx.device)
    del server
    free_device(ctx.device)

    keys = [k for k, _ in sample.items]
    sd = weights.m2trans_state_dict(model, ctx.seed, ctx.device)
    refs = reference_outputs(ctx, sd, [batches[k % len(batches)] for k in keys])
    numbers = compare.served_numbers(
        [(torch.as_tensor(out), r) for (_, out), r in zip(sample.items, refs)], t["out"])
    complete = len(back) == sent and sent > 0
    if trace is not None:
        trace.update(kind="serve", units=sum(1 for b in back if t0 <= b <= t_end),
                     flops_per_unit=counts.forward_flops(model, t["batch"], h, w),
                     k1_bound_ms_per_unit=counts.k1_bound_ms(model, t["batch"], h, w))
    return {"attempted": sent, "failed": sent - len(back),
            "e2e": e2e, "trace": trace, "numbers": numbers, "complete": complete,
            "memory_peak_bytes": peak}


def control(ctx: Context) -> Dict[str, float]:
    """The control: the reference with its products in fp8 put in the
    program's place, on the same sampled inputs (as many as a run checks),
    compared as a run compares."""
    sd = weights.m2trans_state_dict(ctx.config["model"], ctx.seed, ctx.device)
    batches = make_inputs(ctx)
    rng = np.random.default_rng([ctx.seed, 1])
    picks = rng.integers(0, len(batches), ctx.traffic["sample"])
    inputs = [batches[k] for k in picks]
    low = reference_outputs(ctx, sd, inputs, Precision("fp8"))
    high = reference_outputs(ctx, sd, inputs)
    return compare.served_numbers(list(zip(low, high)), ctx.traffic["out"])
