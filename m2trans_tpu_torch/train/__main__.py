"""Training CLI of the PyTorch port; mirrors train.py.

Usage:
  python -m m2trans_tpu_torch.train --config <yml> [--resume <exp_dir>]
      [--device cuda|cpu]

The config is the JAX package's flat YAML; ``dtype: bfloat16`` with
``use_pallas: true`` trains through the port's CUDA kernels (K1/K2 forward,
K1b/K2b backward). ``--device`` defaults to ``cuda`` and fails when no
CUDA device is present; the CPU runs only when asked for, with the
kernels' plain versions. With ``lambda_clip > 0`` and ``medclip_path`` (a
directory with the released MedCLIP ``pytorch_model.bin``, ``vocab.txt``
and ``tokenizer_config.json``) the step adds the MedCLIP semantic loss on
the captions of ``captions_path`` (utf-16, a caption a line), tokenized by
the port's own WordPiece tokenizer.

Data parallelism: ``mesh_data: N`` in the config and ``python -m
torch.distributed.run --nproc_per_node N -m m2trans_tpu_torch.train ...``
(each rank on ``cuda:LOCAL_RANK``; ranks that share a card use gloo).
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
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.train.loop import Trainer
    from m2trans_tpu_torch.utils.flops import model_complexity_report

    device = mesh_lib.init_from_env(args.device)
    rank, n_ranks = mesh_lib.world()
    cfg = load_config(args.config, overrides={"resume": args.resume})
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"## device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'} ##")
    if n_ranks > 1:
        say(f"## {n_ranks} ranks, {mesh_lib.backend()} "
            f"{mesh_lib.shared_card_note()} ##")
    if cfg.dtype == "float32":
        say("## dtype float32 runs parity numerics (TF32 off); dtype: "
            "bfloat16 with use_pallas: true runs the CUDA kernels ##")
    semantic_loss_fn = None
    if cfg.lambda_clip > 0 and cfg.medclip_path:
        from m2trans_tpu_torch.losses.semantic import make_semantic_loss

        semantic_loss_fn = make_semantic_loss(cfg, device)
    elif cfg.lambda_clip > 0:
        say("## lambda_clip > 0 but no medclip_path set: training with "
            "L1 only (set medclip_path to pretrained MedCLIP weights) ##")

    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    trainer = Trainer(cfg, device=device, semantic_loss_fn=semantic_loss_fn)
    if SummaryWriter is not None and rank == 0:
        trainer.writer = SummaryWriter(logdir=trainer.experiment_path)
    if rank == 0:  # FLOPs/params report (reference train.py:148-152)
        print(model_complexity_report(trainer.model, cfg))
    trainer.run()
    if n_ranks > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
