"""The paper's whole training recipe through the port's train CLI; the
counterpart of scripts/train_full_recipe.py.

    python -m m2trans_tpu_torch.tools.train_full_recipe [--epochs 3]
        [--n-train 24] [--n-eval 3] [--device cuda|cpu] [--out PATH]

It builds fixtures in a temporary directory outside the repository (removed
afterwards), then runs ``python -m m2trans_tpu_torch.train --config <yml>``
in a subprocess that sees the same single card:

- US1K-layout training and benchmark trees of speckle phantoms
  (:func:`speckle_phantom`, smooth tissue fields times Rayleigh-like
  speckle), 384x384 HR, LR by ``ops/resize.py::bicubic_resize`` with
  ``align_corners=False``; PNG for training, JPEG (quality 97) for the
  held-out set, its LR made from the decoded JPEG; written with Pillow;
- a MedCLIP directory as the release lays it out: ``pytorch_model.bin``
  written by ``models/medclip/model.py::medclip_release_state_dict`` from
  the port's seeded MedCLIP at its published width (Swin-tiny 224 +
  BERT-base, about 550 MB in f32), a WordPiece ``vocab.txt`` that covers
  the captions and ``tokenizer_config.json``; the train CLI reads them
  through ``make_semantic_loss`` and the port's own tokenizer;
- a UTF-16 captions file, a caption a line.

The yml is the JAX script's: x4 flagship (n_feats 64, 8 blocks), patch 384,
bf16 with the kernels, L1 + 0.01 x the staged MedCLIP semantic loss (MedCLIP
in bf16), cutmix and cutout, Adam and the cosine schedule, a checkpoint and
PSNR/SSIM validation an epoch; but ``batch_size: 2``, the reference's and
the shipped ymls' (the JAX script's 8 was chosen for its lane packing).

The last JSON line holds the loss last logged in each epoch, the PSNR/SSIM
of each validation, the subprocess's wall seconds and its steps/s (the
log lines' durations, each epoch's first left out: it holds the previous
validation or the captures), the card and the config. ``--device cpu``
trains on the CPU (the options for a tiny model are for tests) and prints
null for the wall seconds and steps/s.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from m2trans_tpu_torch.tools.timing import card, report

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_TIMEOUT_S = 3000
CAPTIONS = [
    "longitudinal view of the carotid artery with clear intima",
    "transverse liver section with homogeneous echotexture",
    "thyroid nodule with well defined hypoechoic margin",
    "kidney cortex and medulla with normal echogenicity",
    "breast lesion with posterior acoustic enhancement",
    "gallbladder wall without thickening or stones",
]


def speckle_phantom(rng, h, w):
    """Smooth anatomy field x speckle: bandlimited gaussian blobs and a
    few bright ellipse interfaces, modulated by Rayleigh-like noise
    (scripts/train_full_recipe.py's ``_speckle_phantom``, the same draws
    and values)."""
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(6):  # smooth tissue regions
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(h / 8, h / 2), rng.uniform(w / 8, w / 2)
        amp = rng.uniform(0.2, 0.8)
        img += amp * np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
    for _ in range(3):  # bright curved interfaces (vessel walls)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(h / 8, h / 3)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img += 0.6 * np.exp(-((d - r) / 2.5) ** 2)
    img = img / (img.max() + 1e-6)
    # Rayleigh-ish multiplicative speckle, band-limited a touch
    n = rng.rayleigh(scale=0.4, size=(h, w)).astype(np.float32)
    k = np.ones((2, 2), np.float32) / 4
    npad = np.pad(n, ((0, 1), (0, 1)), mode="edge")
    n = (sliding_window_view(npad, (2, 2)) * k).sum((-1, -2))
    img = np.clip(img * (0.4 + n), 0, 1)
    return (img * 255).astype(np.uint8)


def downscale(hr_u8, scale: int):
    """(H, W) u8 -> (H/s, W/s) u8: bicubic with ``align_corners=False``,
    clipped to [0, 255] and truncated, as the JAX script makes its LR."""
    import numpy as np
    import torch

    from m2trans_tpu_torch.ops.resize import bicubic_resize

    h, w = hr_u8.shape
    x = torch.from_numpy(hr_u8.astype(np.float32))[None, ..., None]
    lr = bicubic_resize(x, (h // scale, w // scale), align_corners=False)
    return np.clip(lr[0, ..., 0].numpy(), 0, 255).astype(np.uint8)


def build_fixtures(root: str, *, scale: int = 4, size: int = 384, n_train: int = 24,
                   n_eval: int = 3, medclip_tiny: bool = False, seed: int = 0):
    """The data trees, the MedCLIP directory and the captions under
    ``root``; returns (medclip dir, captions path)."""
    import numpy as np
    import torch
    from PIL import Image

    from m2trans_tpu_torch.models.medclip.model import (
        MedCLIPConfig,
        init_medclip,
        medclip_release_state_dict,
    )

    rng = np.random.default_rng(seed)
    hr_dir = os.path.join(root, "US1K", "US1K_train_HR")
    lr_dir = os.path.join(root, "US1K", "US1K_train_LR_bicubic", f"X{scale}")
    bhr = os.path.join(root, "benchmark", "UI5", "HR")
    blr = os.path.join(root, "benchmark", "UI5", "LR_bicubic", f"X{scale}")
    for d in (hr_dir, lr_dir, bhr, blr):
        os.makedirs(d, exist_ok=True)

    def rgb(a):
        return Image.fromarray(np.stack([a] * 3, -1))

    for i in range(1, n_train + 1):
        hr = speckle_phantom(rng, size, size)
        rgb(hr).save(os.path.join(hr_dir, f"{i:04d}.png"))
        rgb(downscale(hr, scale)).save(os.path.join(lr_dir, f"{i:04d}x{scale}.png"))
    for i in range(n_eval):  # held-out pairs; the LR from the decoded JPEG
        path = os.path.join(bhr, f"val{i}.jpg")
        rgb(speckle_phantom(rng, size, size)).save(path, quality=97)
        with Image.open(path) as img:
            hr_dec = np.asarray(img.convert("RGB"))[..., 0]
        rgb(downscale(hr_dec, scale)).save(os.path.join(blr, f"val{i}x{scale}.jpg"),
                                           quality=97)

    mc_dir = os.path.join(root, "medclip-vit")
    os.makedirs(mc_dir, exist_ok=True)
    mcfg = MedCLIPConfig.tiny() if medclip_tiny else MedCLIPConfig()
    torch.save(medclip_release_state_dict(init_medclip(mcfg, seed=seed)),
               os.path.join(mc_dir, "pytorch_model.bin"))
    words = sorted({w for c in CAPTIONS for w in c.split()})
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
             + list("abcdefghijklmnopqrstuvwxyz0123456789"))
    with open(os.path.join(mc_dir, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")
    with open(os.path.join(mc_dir, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True}, fh)
    cap_path = os.path.join(root, "captions.txt")
    with open(cap_path, "w", encoding="utf-16") as fh:
        for i in range(n_train):
            fh.write(CAPTIONS[i % len(CAPTIONS)] + "\n")
    return mc_dir, cap_path


def parse_run(out: str, log_every: int):
    """The train CLI's output -> (loss last logged an epoch, validations,
    steps/s from the log lines after each epoch's first, or None)."""
    losses, secs = {}, {}
    for ep, loss, dur in re.findall(
            r"Epoch:(\d+),.*?loss: ([0-9.eE+-]+),.*time: ([0-9.]+)", out):
        losses[int(ep)] = float(loss)
        secs.setdefault(int(ep), []).append(float(dur))
    vals = [{"epoch": i + 1, "psnr": float(p), "ssim": float(s)} for i, (p, s) in
            enumerate(re.findall(r"\], PSNR/SSIM: ([0-9.]+)/([0-9.]+)", out))]
    later = [t for ts in secs.values() for t in ts[1:]]
    rate = log_every * len(later) / sum(later) if later and sum(later) > 0 else None
    return losses, vals, rate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--n-train", type=int, default=24)
    ap.add_argument("--n-eval", type=int, default=3)
    ap.add_argument("--size", type=int, default=384, help="HR side of the phantoms")
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--medclip-tiny", action="store_true",
                    help="MedCLIPConfig.tiny() and 56x56 patches (tests)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch
    import yaml

    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    dev = torch.device("cpu" if args.device == "cpu" else "cuda", 0)
    log_every = 5
    with tempfile.TemporaryDirectory(prefix="m2t_full_recipe_") as root:
        print("== building fixtures ==", flush=True)
        mc_dir, cap_path = build_fixtures(root, size=args.size, n_train=args.n_train,
                                          n_eval=args.n_eval, medclip_tiny=args.medclip_tiny)
        cfg = {
            "scale": 4, "rgb_range": 1.0, "colors": 3, "n_feats": args.n_feats,
            "num_heads": 4, "n_blocks": args.n_blocks, "patch_size": args.size,
            "batch_size": 2, "data_repeat": 5, "data_augment": 1,
            "cutout": True, "cutmix": True,
            "epochs": args.epochs, "lr": 2.0e-4, "eta_min": 1.0e-6,
            "log_every": log_every, "test_every": 1,
            "log_path": os.path.join(root, "experiments"), "log_name": "fullrecipe_x4",
            "lambda_l1": 1.0, "lambda_clip": 0.01,
            "threads": 4, "save_image": False,
            "data_path": root, "training_dataset": "us1k",
            "eval_sets": ["CCA-US"], "train_range": [1, args.n_train + 1],
            "dtype": "bfloat16", "use_pallas": True, "mesh_data": 1,
            "medclip_path": mc_dir, "medclip_dtype": "bfloat16",
            "medclip_tiny": args.medclip_tiny, "captions_path": cap_path,
        }
        yml = os.path.join(root, "fullrecipe_x4.yml")
        with open(yml, "w") as fh:
            yaml.safe_dump(cfg, fh)
        env = dict(os.environ)
        if dev.type == "cuda":  # the card this process would use, and only it
            visible = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
            env["CUDA_VISIBLE_DEVICES"] = visible
        cmd = [sys.executable, "-m", "m2trans_tpu_torch.train", "--config", yml,
               "--device", dev.type]
        print("== launching python -m m2trans_tpu_torch.train ==", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=TRAIN_TIMEOUT_S)
        wall = time.perf_counter() - t0
    sys.stdout.write(proc.stdout[-6000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise RuntimeError(f"the train CLI exited {proc.returncode}")
    losses, vals, rate = parse_run(proc.stdout, log_every)
    if len(losses) != args.epochs or len(vals) != args.epochs:
        raise RuntimeError(f"the train CLI logged losses of epochs {sorted(losses)} "
                           f"and {len(vals)} validations, want {args.epochs}")
    on_card = dev.type == "cuda"
    shown = {k: v for k, v in cfg.items()
             if k not in ("log_path", "data_path", "medclip_path", "captions_path")}
    line = {"metric": "full_recipe_training",
            "recipe": "python -m m2trans_tpu_torch.train; x4 flagship, patch 384, batch 2, "
                      "bf16 + kernels; L1 + 0.01 x staged MedCLIP semantic loss (seeded "
                      "release-format pytorch_model.bin, bf16, the port's tokenizer); "
                      "cutmix + cutout; Adam + cosine; speckle phantoms",
            "epochs": args.epochs, "train_loss_last_logged_per_epoch": losses,
            "val_trajectory": vals, "wall_s": wall if on_card else None,
            "steps_per_s": rate if on_card else None, **card(dev),
            "config": {**shown, "n_train": args.n_train, "n_eval": args.n_eval}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
