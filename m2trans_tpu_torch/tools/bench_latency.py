"""Single-frame serving latency of the port; the counterpart of
scripts/bench_latency.py.

    python -m m2trans_tpu_torch.tools.bench_latency [--sizes 96 256 512]
        [--frames 1100] [--n-blocks 8] [--device cuda|cpu] [--out PATH]

The x4 flagship (n_feats 64, seeded weights) in bf16 with the kernels
serves one frame at a time through ``StreamingSR.stream`` (graphed: a CUDA
graph per frame shape, ``models/graphed.py``), for each LR size and each
output (f32, and u8 quantised on the card). Each runner is warmed with
``runner.warmup`` first, which captures its shape, so no capture is timed.
``--frames`` frames a (size, output), cycled from 8 seeded frames; 1,100 by
default, so the p99 has at least 10 samples beyond it.

For each (size, output) the last JSON line holds:

- ``p50_ms``, ``p90_ms``, ``p99_ms``: enqueue to the result lying in the
  slot's pinned host buffer (the frame's CUDA event,
  ``parallel/streaming.py``), with ``samples`` and ``beyond_p50`` /
  ``beyond_p90`` / ``beyond_p99``, the samples above each;
- ``copy_back_bytes``: the bytes a frame copies back to the host (the port
  hands out f32 where the JAX server hands out bf16);

- ``device_ms``: the profiler's device time of one replay of the graph
  (measured last);

and for each size ``device_chain_ms``: the f32 graph's replays chained
output to input (``x <- x * 0.999 + mean(y) * 1e-3``), the CUDA-event slope
a frame.
``memory_reserved_gib`` is read with all six runners' graphs alive.

``--device cpu`` runs the same path eagerly with the kernels' plain versions
and prints null for every time and memory number.
"""

from __future__ import annotations

import argparse

from m2trans_tpu_torch.tools.timing import card, device_ms, graph_seconds_per_step, report

POOL = 8  # distinct frames a size, cycled
DEPTH = 2  # frames in flight, StreamingSR's default


def _percentiles(lat_s):
    lat = sorted(lat_s)
    out = {"samples": len(lat)}
    for q in (50, 90, 99):
        v = lat[min(len(lat) - 1, int(q / 100 * len(lat)))]
        out[f"p{q}_ms"] = v * 1e3
        out[f"beyond_p{q}"] = sum(t > v for t in lat)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[96, 256, 512],
                    help="LR frame sides")
    ap.add_argument("--frames", type=int, default=1100)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from m2trans_tpu_torch.bench import chain_step
    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.m2trans import init_m2trans
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.parallel.streaming import StreamingSR

    dev = mesh_lib.init_from_env(args.device)
    on_card = dev.type == "cuda"
    cfg = Config(scale=4, n_feats=args.n_feats, n_blocks=args.n_blocks, colors=3,
                 dtype="bfloat16", use_pallas=True)
    model = init_m2trans(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    sizes, chains, runners = {}, {}, []
    with torch.inference_mode():
        for hw in args.sizes:
            pool = [rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
                    for _ in range(POOL)]
            entry = {}
            for label, u8 in (("f32", False), ("u8", True)):
                runner = StreamingSR(model, cfg, output_u8=u8, depth=DEPTH)
                runner.warmup(pool[0].shape)
                frames = (pool[i % POOL] for i in range(args.frames))
                n = sum(1 for _ in runner.stream(frames, collect_stats=True))
                stats = _percentiles(runner.latencies_s)
                if not on_card:
                    stats = {k: (v if k == "samples" else None) for k, v in stats.items()}
                entry[label] = {"frames": n, **stats,
                                "copy_back_bytes": hw * 4 * hw * 4 * 3 * (1 if u8 else 4),
                                "captures": runner.graphed and runner.graphed.captures}
                runners.append(runner)
                print(f"{hw}x{hw} -> x4 {label}: {entry[label]}", flush=True)
            x0 = torch.from_numpy(pool[0]).to(dev)
            chains[hw] = ((runners[-2].graphed, runners[-1].graphed), x0)
            entry["device_chain_ms"] = (
                graph_seconds_per_step(chain_step(runners[-2].graphed), x0) * 1e3
                if on_card else None)
            sizes[f"{hw}x{hw}"] = entry
        reserved = torch.cuda.memory_reserved(dev) / 2 ** 30 if on_card else None
        for hw, (graphed, x0) in chains.items():  # the profiler last
            for label, g in zip(("f32", "u8"), graphed):
                sizes[f"{hw}x{hw}"][label]["device_ms"] = (
                    device_ms(lambda: g(x0)) if on_card else None)
    line = {"metric": "x4_single_frame_latency", "unit": "ms",
            "method": "StreamingSR.stream percentiles; cuda_graph_slope chain; profiler",
            "sizes": sizes, "memory_reserved_gib": reserved, **card(dev),
            "config": {"scale": 4, "n_feats": args.n_feats, "n_blocks": args.n_blocks,
                       "dtype": "bfloat16", "use_pallas": True, "depth": DEPTH,
                       "frames": args.frames, "seed": 0}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
