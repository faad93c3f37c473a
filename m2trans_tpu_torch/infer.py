"""Batch / streaming inference CLI of the PyTorch port; mirrors infer.py.

Runs super-resolution over a directory of frames (a cine loop) or one
image and prints one JSON report: throughput, p50/p90/p99 per-frame
latency, the device, and the launches of the port's kernels.

Usage:
  python -m m2trans_tpu_torch.infer --config configs/M2Trans_x4_test.yml \
      --model_path model_x4.pt --input frames_dir/ --output sr_out/ \
      [--f32] [--u8] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; the CPU runs only when asked for (``--device cpu``), with the
kernels' plain versions.
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
                    help="spatial shards over the frame height; only 0 "
                         "(auto) and 1 (one device) are ported yet")
    ap.add_argument("--f32", action="store_true",
                    help="f32 parity numerics instead of bf16 + kernels")
    ap.add_argument("--u8", action="store_true",
                    help="quantize SR frames to uint8 on the device before "
                         "the copy back (4x fewer bytes)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    if args.mesh_space not in (0, 1):
        raise NotImplementedError(
            f"--mesh-space {args.mesh_space}: spatial sharding is not yet "
            "ported to the torch package")

    import numpy as np
    import torch
    from PIL import Image

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import policy_from_config
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused
    from m2trans_tpu_torch.parallel.streaming import StreamingSR
    from m2trans_tpu_torch.train.checkpoint import load_params_any

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")

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

    runner = StreamingSR(model, cfg, policy=policy, output_u8=args.u8)
    runner.warmup(frames[0].shape)
    if args.output:
        os.makedirs(args.output, exist_ok=True)

    counted = {"cftm_branch": cftm_branch, "ff_conv": ff_conv,
               "tail_band": tail_band_fused}
    launches0 = {k: f.launches for k, f in counted.items()}
    t0 = time.perf_counter()
    n_px = 0
    for path, sr in zip(paths, runner.stream(frames, collect_stats=True)):
        n_px += sr.shape[1] * sr.shape[2]
        if args.output:
            u8 = (sr[0] if args.u8 else
                  np.clip(sr[0] * 255.0 + 0.5, 0, 255).astype(np.uint8))
            Image.fromarray(u8).save(os.path.join(args.output, os.path.basename(path)))
    wall = time.perf_counter() - t0

    report = {
        "frames": len(frames),
        "fps": round(len(frames) / wall, 2),
        "output_megapixels_per_sec": round(n_px / 1e6 / wall, 2),
        **{k.replace("_s", "_ms"): round(v * 1e3, 2)
           for k, v in runner.latency_percentiles().items()},
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "kernel_launches": {k: f.launches - launches0[k]
                            for k, f in counted.items()},
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
