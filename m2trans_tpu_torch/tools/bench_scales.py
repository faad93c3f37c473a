"""Serving throughput of the port at each scale; the counterpart of
scripts/bench_scales.py.

    python -m m2trans_tpu_torch.tools.bench_scales [--scales 4 3 2]
        [--batch 8] [--out-hw 384] [--pairs 5] [--n-blocks 8]
        [--device cuda|cpu] [--out PATH]

bench.py's recipe at every scale: a batch of 8 frames and a 384x384 output,
so the body runs on LR frames of 96, 128 and 192 for x4, x3 and x2; the
flagship width (n_feats 64, 8 blocks, seeded weights) in bf16 with the
kernels. The forward is the serving graph (``models/graphed.py``), chained
output to input as in ``python -m m2trans_tpu_torch.bench``; the CUDA-event
slope of chains of 4 and 36 replays, median of ``--pairs`` pairs, is the
device time a batch. Each scale's model and graph are freed before the next
(``del``, ``torch.cuda.empty_cache()``). Then, last, the profiler: the
device time of one replay and its split by kind of kernel
(``tools/timing.py::kernel_kind``; at x2 K1 c256 sees four times the
windows of x4).

The last JSON line holds, a scale: ``mps`` (output megapixels per second),
``ms_per_batch`` (the slope), ``device_ms``, ``split`` (device ms by kind),
``lr_size``, ``launches`` (the kernel wrappers' launches in the capture).
``--device cpu`` runs one eager forward a scale with the kernels' plain
versions and prints null for every time.
"""

from __future__ import annotations

import argparse

from m2trans_tpu_torch.tools.timing import (
    card,
    device_ms,
    device_split,
    graph_seconds_per_step,
    report,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=int, nargs="+", default=[4, 3, 2])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out-hw", type=int, default=384, help="SR output side")
    ap.add_argument("--pairs", type=int, default=5, help="chain pairs a scale")
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from m2trans_tpu_torch.bench import chain_step
    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward
    from m2trans_tpu_torch.models.m2trans import init_m2trans, policy_from_config
    from m2trans_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh_lib.init_from_env(args.device)
    on_card = dev.type == "cuda"

    def runner(scale):
        cfg = Config(scale=scale, n_feats=args.n_feats, n_blocks=args.n_blocks, colors=3,
                     dtype="bfloat16", use_pallas=True)
        hw = args.out_hw // scale
        x0 = torch.rand(args.batch, hw, hw, 3,
                        generator=torch.Generator().manual_seed(1)).to(dev)
        model = init_m2trans(cfg, seed=0, device=dev)
        return cfg, model, GraphedForward(model, cfg, policy_from_config(cfg)), x0

    scales = {}
    with torch.inference_mode():
        for s in args.scales:
            cfg, model, graphed, x0 = runner(s)
            out_mp = args.batch * (x0.shape[1] * s) * (x0.shape[2] * s) / 1e6
            if on_card:
                sec = graph_seconds_per_step(chain_step(graphed), x0, pairs=args.pairs)
                (launches,) = graphed.capture_launches.values()
            else:
                y = serving_forward(model, x0, cfg, graphed.policy, False)
                if y.shape != (args.batch, x0.shape[1] * s, x0.shape[2] * s, 3):
                    raise RuntimeError(f"x{s}: output {tuple(y.shape)}")
                sec, launches = None, None
            scales[f"x{s}"] = {"lr_size": x0.shape[1],
                               "mps": None if sec is None else out_mp / sec,
                               "ms_per_batch": None if sec is None else sec * 1e3,
                               "launches": launches}
            print(f"x{s}: {scales[f'x{s}']}", flush=True)
            del cfg, model, graphed, x0
            if on_card:
                torch.cuda.empty_cache()
        for s in args.scales:  # the profiler last
            entry = scales[f"x{s}"]
            entry["device_ms"] = entry["split"] = None
            if on_card:
                cfg, model, graphed, x0 = runner(s)
                graphed(x0)
                entry["device_ms"] = device_ms(lambda: graphed(x0))
                entry["split"] = device_split(lambda: graphed(x0))
                del cfg, model, graphed, x0
                torch.cuda.empty_cache()
    line = {"metric": "per_scale_output_mps", "unit": "MP/s",
            "method": "cuda_graph_slope (chains of 4 / 36 replays); profiler",
            "scales": scales, **card(dev),
            "config": {"batch": args.batch, "out_hw": args.out_hw, "n_feats": args.n_feats,
                       "n_blocks": args.n_blocks, "dtype": "bfloat16", "use_pallas": True,
                       "pairs": args.pairs, "seed": 0}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
