"""Batch / streaming inference CLI of the PyTorch port; mirrors infer.py.

Runs super-resolution over a directory of frames (a cine loop) or one
image and prints one JSON report: throughput, p50/p90/p99 per-frame
latency, the device, and the launches of the port's kernels.

Usage:
  python -m m2trans_tpu_torch.infer --config configs/M2Trans_x4_test.yml \
      --model_path model_x4.pt --input frames_dir/ --output sr_out/ \
      [--f32] [--u8] [--depth N] [--mesh-space N|0] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; the CPU runs only when asked for (``--device cpu``), with the
kernels' plain versions.

On the card, one device and no mesh, every frame shape's forward is
captured as a CUDA graph on its first frame and replayed after
(``parallel/streaming.py``). The kernel wrappers count launches when they
are captured, not when a graph replays them, so the report then gives the
captures, the replays and the launches of one capture (by frame shape), not
launches by frame. On the CPU and with a mesh the forward runs launch by
launch and the report gives the kernel launches of the run.

Spatial sharding: ``--mesh-space N`` > 1 shards every frame's rows over N
ranks, launched as ``python -m torch.distributed.run --nproc_per_node N -m
m2trans_tpu_torch.infer ... --mesh-space N`` (each rank on
``cuda:LOCAL_RANK``; ranks that share a card use gloo). ``--mesh-space 0``
(the default) shards bf16 frames of 512x512 pixels or more over as many of
the ranks as divide every frame's padded height (none with one rank); a
rank left out runs each frame on its own. Rank 0 writes the PNGs and the
report.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="M2Trans inference (PyTorch port)")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--model_path", type=str, default=None)
    ap.add_argument("--input", type=str, required=True,
                    help="image file or directory of frames")
    ap.add_argument("--output", type=str, default=None)
    ap.add_argument("--mesh-space", type=int, default=0,
                    help="ranks that shard each frame's height; 0 = auto "
                         "(shard large bf16 frames over the ranks there "
                         "are), 1 = one device; N must equal the number "
                         "of ranks launched")
    ap.add_argument("--depth", type=int, default=2,
                    help="frames in flight in the stream (1: each frame is "
                         "waited for before the next is enqueued)")
    ap.add_argument("--f32", action="store_true",
                    help="f32 parity numerics instead of bf16 + kernels")
    ap.add_argument("--u8", action="store_true",
                    help="quantize SR frames to uint8 on the device before "
                         "the copy back (4x fewer bytes)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.graphed import COUNTED
    from m2trans_tpu_torch.models.m2trans import policy_from_config
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.parallel.spatial import auto_space_mesh_multi
    from m2trans_tpu_torch.parallel.streaming import StreamingSR
    from m2trans_tpu_torch.train.checkpoint import load_params_any

    device = mesh_lib.init_from_env(args.device)
    rank, n_ranks = mesh_lib.world()
    if args.mesh_space > 0 and args.mesh_space != n_ranks:
        raise ValueError(
            f"--mesh-space {args.mesh_space} needs {args.mesh_space} ranks, "
            f"this run has {n_ranks}: {mesh_lib.launch_hint(args.mesh_space)}")

    cfg = load_config(args.config, overrides={"model_path": args.model_path})
    model = load_params_any(cfg.model_path, cfg, device=device)
    policy = policy_from_config(cfg) if args.f32 else None

    paths = ([os.path.join(args.input, f)
              for f in sorted(os.listdir(args.input))]
             if os.path.isdir(args.input) else [args.input])
    frames = []
    for p in paths:
        with Image.open(p) as img:
            frames.append(np.asarray(img.convert("RGB"), np.float32)[None] / 255.0)
    if not frames:
        raise SystemExit("no input frames found")

    mesh = None
    if args.mesh_space > 1:
        mesh = mesh_lib.space_mesh(args.mesh_space)
    elif args.mesh_space == 0:
        # every distinct frame shape, so the count divides all padded heights
        shapes = sorted({(f.shape[1], f.shape[2]) for f in frames})
        mesh = auto_space_mesh_multi(shapes, cfg,
                                     policy or StreamingSR.default_policy())
        if mesh is not None and rank == 0:
            print(f"## auto spatial sharding: {mesh.n} shards over H for "
                  f"{len(shapes)} frame shape(s) ##")
    writer = rank == 0
    runner = StreamingSR(model, cfg, mesh=mesh, policy=policy, output_u8=args.u8,
                         depth=args.depth)
    graphed = runner.graphed
    runner.warmup(frames[0].shape)
    if args.output and writer:
        os.makedirs(args.output, exist_ok=True)

    launches0 = {k: f.launches for k, f in COUNTED.items()}
    counts0 = (graphed.captures, graphed.replays) if graphed else None
    t0 = time.perf_counter()
    n_px = 0
    for path, sr in zip(paths, runner.stream(frames, collect_stats=True)):
        n_px += sr.shape[1] * sr.shape[2]
        if args.output and writer:
            u8 = (sr[0] if args.u8 else
                  np.clip(sr[0] * 255.0 + 0.5, 0, 255).astype(np.uint8))
            Image.fromarray(u8).save(os.path.join(args.output, os.path.basename(path)))
    wall = time.perf_counter() - t0

    report = {
        "frames": len(frames),
        "depth": runner.depth,
        "fps": round(len(frames) / wall, 2),
        "output_megapixels_per_sec": round(n_px / 1e6 / wall, 2),
        **{k.replace("_s", "_ms"): round(v * 1e3, 2)
           for k, v in runner.latency_percentiles().items()},
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "mesh_space": mesh.n if mesh is not None else 1,
        "ranks": n_ranks,
        "backend": mesh_lib.backend(),
    }
    if graphed:
        report["cuda_graphs"] = {
            "captures": graphed.captures - counts0[0],
            "replays": graphed.replays - counts0[1],
            "launches_per_capture": {"x".join(map(str, shape)): n for shape, n
                                     in graphed.capture_launches.items()}}
    else:
        report["kernel_launches"] = {k: f.launches - launches0[k]
                                     for k, f in COUNTED.items()}
    if writer:
        print(json.dumps(report))
    if n_ranks > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
