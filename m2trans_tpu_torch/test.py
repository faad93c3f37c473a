"""Evaluation CLI of the PyTorch port; mirrors test.py: PSNR/SSIM/FSIM/GMSD
over the configured benchmark directories from a reference ``.pt``
checkpoint.

Usage:
  python -m m2trans_tpu_torch.test --config configs/M2Trans_x4_test.yml \
      [--model_path model_x4.pt] [--no-full_metrics] [--save_image] \
      [--bucket N] [--dtype float32|bfloat16] [--device cuda|cpu]

The config's ``dtype: float32`` is the parity run (TF32 off, no kernels);
``--dtype bfloat16`` is the fast run and, as in the port's infer CLI, goes
through the CUDA kernels (it sets ``use_pallas``; a config that sets
``dtype: bfloat16`` itself chooses with its own ``use_pallas``).
``--device`` defaults to ``cuda`` and fails when no CUDA device is present;
the CPU runs only when asked for, with the kernels' plain versions.

Under ``python -m torch.distributed.run --nproc_per_node N`` every rank
evaluates and bf16 frames of 512x512 pixels or more are sharded by rows
over the N ranks; rank 0 prints the metrics and saves the images.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="M2Trans eval (PyTorch port)")
    parser.add_argument("--config", type=str,
                        default="./configs/M2Trans_x2_test.yml")
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--full_metrics", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="also compute FSIM/GMSD (reference "
                             "test.py:95-99); --no-full_metrics skips them")
    parser.add_argument("--save_image", action="store_true")
    parser.add_argument("--bucket", type=int, default=0,
                        help="pad LR frames to multiples of N: a few shapes "
                             "instead of one per frame (approximate; 0 = exact)")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="float32 = bit-parity eval (default); "
                             "bfloat16 = fast serving numerics")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a CUDA device) or cpu")
    args = parser.parse_args(argv)

    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.data.pipeline import create_datasets
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.train.checkpoint import load_params_any
    from m2trans_tpu_torch.train.evaluate import evaluate_all

    device = mesh_lib.init_from_env(args.device)
    rank, n_ranks = mesh_lib.world()
    cfg = load_config(args.config, overrides={
        "model_path": args.model_path, "dtype": args.dtype,
        "use_pallas": True if args.dtype == "bfloat16" else None})
    _, eval_sets = create_datasets(cfg, train=False)
    model = load_params_any(cfg.model_path, cfg, device=device)

    results = evaluate_all(model, cfg, eval_sets,
                           full_metrics=args.full_metrics,
                           save_root=("test_results" if args.save_image
                                      and rank == 0 else None),
                           bucket=args.bucket)
    if n_ranks > 1:
        torch.distributed.destroy_process_group()
    for name, m in results.items() if rank == 0 else ():
        print(f"[{name}-X{cfg.scale}] "
              f"PSNR:{m['psnr']:.2f},SSIM:{m['ssim']:.4f}" +
              (f"\nFSIM:{m['fsim']:.4f},GMSD:{m['gmsd']:.4f}"
               if "fsim" in m else ""))


if __name__ == "__main__":
    main()
