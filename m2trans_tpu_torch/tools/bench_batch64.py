"""Large-batch serving throughput of the port and its micro-batch sweep; the
counterpart of scripts/bench_batch64.py (and of the sweeps of
scripts/ab_batch64.py and scripts/bench_batch.py).

    python -m m2trans_tpu_torch.tools.bench_batch64 [--batch 64]
        [--micro 8 16 32 64] [--pairs 5] [--n-blocks 8]
        [--device cuda|cpu] [--out PATH]

A batch of 64 LR frames of 96x96 through ``m2trans_apply_microbatched``
(the x4 flagship, n_feats 64, 8 blocks, seeded weights, bf16 with the
kernels, f32 out as the server hands it out) at each ``micro_batch``: the
forward and its cast are captured into one CUDA graph
(``models/graphed.py::capture``), chained output to input and timed by the
CUDA-event slope of chains of 4 and 36 replays (median of ``--pairs``).
Each graph is freed before the next; ``max_memory_allocated`` is read
after its capture and replays, from a reset before its capture. The
profiler's device time of one replay comes last. ``MICRO_BATCH``
(``models/m2trans.py``) is not changed here: the sweep says which value
the card prefers.

The last JSON line holds, a micro-batch: ``mps``, ``ms_per_batch``,
``device_ms``, ``peak_gib``, ``launches`` (the wrappers' launches in the
capture). ``--device cpu`` runs one eager forward a micro-batch with the
kernels' plain versions and prints null for every time and memory number.
"""

from __future__ import annotations

import argparse

from m2trans_tpu_torch.tools.timing import (
    card,
    device_ms,
    graph_seconds_per_step,
    peak_gib,
    report,
)


def graphed_microbatched(model, cfg, policy, x0, micro_batch):
    """``step(x)``: x copied into the static input of a CUDA graph of the
    f32-out forward at ``micro_batch``, the graph replayed; returns the
    static output. Also the launches counted in the capture."""
    import torch

    from m2trans_tpu_torch.models.graphed import capture, counting, served
    from m2trans_tpu_torch.models.m2trans import m2trans_apply_microbatched
    from m2trans_tpu_torch.models.served import SERVED

    inp = torch.zeros_like(x0)

    def fn():
        return served(m2trans_apply_microbatched(model, inp, cfg, policy,
                                                 micro_batch=micro_batch), False)

    with counting(SERVED["M2Trans"].counted) as both:
        graph, out = capture(fn, torch.cuda.graph_pool_handle())
    launches = {k: v // 2 for k, v in both.items()}  # the side-stream run and the capture

    def step(x):
        inp.copy_(x)
        graph.replay()
        return out

    return step, launches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hw", type=int, default=96, help="LR frame side")
    ap.add_argument("--micro", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from m2trans_tpu_torch.bench import chain_step
    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.graphed import served
    from m2trans_tpu_torch.models.m2trans import (
        init_m2trans,
        m2trans_apply_microbatched,
        policy_from_config,
    )
    from m2trans_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh_lib.init_from_env(args.device)
    on_card = dev.type == "cuda"
    cfg = Config(scale=4, n_feats=args.n_feats, n_blocks=args.n_blocks, colors=3,
                 dtype="bfloat16", use_pallas=True)
    policy = policy_from_config(cfg)
    model = init_m2trans(cfg, seed=0, device=dev)
    x0 = torch.rand(args.batch, args.hw, args.hw, 3,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    out_mp = args.batch * (args.hw * 4) ** 2 / 1e6
    micro = {}
    with torch.inference_mode():
        for mb in args.micro:
            entry = micro[str(mb)] = {"mps": None, "ms_per_batch": None, "device_ms": None,
                                      "peak_gib": None, "launches": None}
            if not on_card:
                y = served(m2trans_apply_microbatched(model, x0, cfg, policy,
                                                      micro_batch=mb), False)
                if y.shape != (args.batch, args.hw * 4, args.hw * 4, 3):
                    raise RuntimeError(f"micro_batch {mb}: output {tuple(y.shape)}")
                continue
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            step, entry["launches"] = graphed_microbatched(model, cfg, policy, x0, mb)
            sec = graph_seconds_per_step(chain_step(step), x0, pairs=args.pairs)
            entry.update(mps=out_mp / sec, ms_per_batch=sec * 1e3, peak_gib=peak_gib(dev))
            print(f"micro_batch {mb}: {entry}", flush=True)
            del step
        for mb in args.micro if on_card else ():  # the profiler last
            torch.cuda.empty_cache()
            step, _ = graphed_microbatched(model, cfg, policy, x0, mb)
            micro[str(mb)]["device_ms"] = device_ms(lambda: step(x0))
            del step
    line = {"metric": "large_batch_serving_mps", "unit": "MP/s",
            "method": "cuda_graph_slope (chains of 4 / 36 replays); profiler",
            "micro_batch": micro, **card(dev),
            "config": {"batch": args.batch, "hw": args.hw, "scale": 4,
                       "n_feats": args.n_feats, "n_blocks": args.n_blocks,
                       "dtype": "bfloat16", "use_pallas": True, "pairs": args.pairs,
                       "seed": 0}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
