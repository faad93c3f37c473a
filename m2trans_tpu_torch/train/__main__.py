"""Training CLI of the PyTorch port; mirrors train.py.

Usage:
  python -m m2trans_tpu_torch.train --config <yml> [--resume <exp_dir>]
      [--device cuda|cpu]

The config is the JAX package's flat YAML; ``dtype: bfloat16`` with
``use_pallas: true`` trains through the port's CUDA kernels (K1/K2 forward,
K1b/K2b backward). ``--device`` defaults to ``cuda`` and fails when no
CUDA device is present; the CPU runs only when asked for, with the
kernels' plain versions.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="M2Trans training (PyTorch port)")
    parser.add_argument("--config", type=str,
                        default="./configs/M2Trans_x4.yml")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; fails without a CUDA device) or cpu")
    args = parser.parse_args(argv)

    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import param_count
    from m2trans_tpu_torch.train.loop import Trainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg = load_config(args.config, overrides={"resume": args.resume})
    print(f"## device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'} ##")
    if cfg.dtype == "float32":
        print("## dtype float32 runs parity numerics (TF32 off); dtype: "
              "bfloat16 with use_pallas: true runs the CUDA kernels ##")
    if cfg.lambda_clip > 0 and not cfg.medclip_path:
        print("## lambda_clip > 0 but no medclip_path set: training with "
              "L1 only (set medclip_path to pretrained MedCLIP weights) ##")

    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    trainer = Trainer(cfg, device=device)
    if SummaryWriter is not None:
        trainer.writer = SummaryWriter(logdir=trainer.experiment_path)
    print(f"## params: {param_count(trainer.model)} "
          f"({param_count(trainer.model, trainable_only=True)} trainable) ##")
    trainer.run()


if __name__ == "__main__":
    main()
