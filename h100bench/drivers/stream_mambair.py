"""Serving MambaIR through ``StreamingSR.stream``: the general driver of the
``stream_mambair`` traffic mixes.

The mix's parameters are the ``stream`` driver's (:mod:`.stream`): ``batch``
frames of ``lr_hw`` a request, ``out``, ``depth``, ``pool``, ``distinct``,
``sample``, ``trace_seconds``; the loop is closed. The configuration's
``model`` holds MambaIR's sizes under the released yml's names.

Set-up makes the weights on the card from the seed in the released
state-dict layout (:func:`h100bench.reference.mambair.state_dict`), loads
them into the port's MambaIR through its release loader, builds
``StreamingSR`` (bf16 with the scan kernel, a CUDA graph a frame shape),
captures the request shape and sends ``2 * depth`` requests. The window
then runs ``seconds``; every request handed over in it is waited for.
``serve_mps`` counts the output megapixels of the requests back inside the
window over its length. The sampled requests are checked against the
reference's forward, a request at a time.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

from h100bench.core import mambair_counts, stats
from h100bench.core.trace import Traced, reduce
from h100bench.drivers import (
    Context,
    Reservoir,
    free_device,
    memory_peak,
    settle,
    span,
)
from h100bench.drivers.stream import make_inputs
from h100bench.reference import compare
from h100bench.reference import mambair as ref
from h100bench.reference.precision import F32, Precision, full_f32

PORT_FIELDS = ("scale", "colors", "rgb_range", "n_feats", "n_blocks")


def build_server(ctx: Context, sd):
    import torch

    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.mambair import MambaIR, load_mambair_state_dict
    from m2trans_tpu_torch.parallel.streaming import StreamingSR

    model = ctx.config["model"]
    cfg = Config(model="MambaIR", **{k: model[k] for k in PORT_FIELDS}, **ctx.config["port"],
                 extras={k: v for k, v in model.items() if k not in PORT_FIELDS})
    with torch.device("meta"):
        net = MambaIR(cfg)
    net = load_mambair_state_dict(net.to_empty(device=ctx.device), sd)
    return StreamingSR(net, cfg, depth=ctx.traffic["depth"],
                       output_u8=ctx.traffic["out"] == "u8")


def reference_outputs(ctx: Context, sd, inputs, prec: Precision = F32,
                      state_bf16: bool = False):
    """The reference's served output of each input batch, a request at a
    time on the device."""
    import torch

    outs = []
    with torch.no_grad(), full_f32():
        for x in inputs:
            y = ref.forward(sd, torch.from_numpy(x).to(ctx.device), ctx.config["model"], prec,
                            state_bf16)
            outs.append(ref.served(y, ctx.traffic["out"]).cpu())
    return outs


def run(ctx: Context) -> Dict[str, Any]:
    import torch

    t, model = ctx.traffic, ctx.config["model"]
    cuda = ctx.device == "cuda"
    sd = ref.state_dict(model, ctx.seed, ctx.device)
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
    sd = ref.state_dict(model, ctx.seed, ctx.device)
    refs = reference_outputs(ctx, sd, [batches[k % len(batches)] for k in keys])
    numbers = compare.served_numbers(
        [(torch.as_tensor(out), r) for (_, out), r in zip(sample.items, refs)], t["out"])
    complete = len(back) == sent and sent > 0
    if trace is not None:
        b = t["batch"]
        trace.update(kind="serve", units=sum(1 for x in back if t0 <= x <= t_end),
                     flops_per_unit=mambair_counts.forward_flops(model, b, h, w),
                     mambair_scan_bound_ms_per_unit=mambair_counts.scan_bound_ms(model, b, h, w))
    return {"attempted": sent, "failed": sent - len(back),
            "e2e": e2e, "trace": trace, "numbers": numbers, "complete": complete,
            "memory_peak_bytes": peak}


def control(ctx: Context, kind: str = "fp8") -> Dict[str, float]:
    """A control in the program's place, on the same sampled inputs (as
    many as a run checks), compared as a run compares: the reference with
    its products in fp8 (``kind`` "fp8"), or with its scan's state rounded
    to bf16 after every update ("state_bf16")."""
    sd = ref.state_dict(ctx.config["model"], ctx.seed, ctx.device)
    batches = make_inputs(ctx)
    rng = np.random.default_rng([ctx.seed, 1])
    picks = rng.integers(0, len(batches), ctx.traffic["sample"])
    inputs = [batches[k] for k in picks]
    if kind == "fp8":
        low = reference_outputs(ctx, sd, inputs, Precision("fp8"))
    elif kind == "state_bf16":
        low = reference_outputs(ctx, sd, inputs, state_bf16=True)
    else:
        raise ValueError(f"unknown control {kind!r}")
    high = reference_outputs(ctx, sd, inputs)
    return compare.served_numbers(list(zip(low, high)), ctx.traffic["out"])
