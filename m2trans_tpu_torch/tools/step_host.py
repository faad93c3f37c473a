"""The train step's host side on the card, to compare two checkouts.

    python3 m2trans_tpu_torch/tools/step_host.py [--root DIR]

Imports ``m2trans_tpu_torch`` from ``--root`` (by default the checkout this
file lies in), so the same script measures another checkout unpacked
beside it (``git archive``): run it for both in one call on the card, in
the order parent, change, change, parent. At the flagship width (x4,
n_feats 64, 8 blocks, seeded weights), batch 2 x 96x96 -> 384x384, the
step the Trainer takes on one card (``make_train_step``, graphed): the L1
step in bf16 with the kernels and the recipe's step (+ 0.01 x the MedCLIP
semantic loss, MedCLIP f32 at its published width, seeded), cutmix,
cutout and input noise on, draws anew each step. For each it prints:

- host ms a step in each ``record_function`` label (``m2t::augment``, and
  ``m2t::wait`` inside it where the checkout has it, ``m2t::device_step``),
  torch.profiler's CPU view over 20 steps;
- event ms a step (CUDA events around one step, median of 20);
- steps/s of 60 steps queued back to back with one synchronise at the end
  (host clock): what the host lets the device reach;
- the Trainer's steps/s (bf16 with the kernels, the C++ loader, a
  synthetic US1K tree, 48 steps, the log lines 2-6 of 8 steps).

The card's name and power limit come first; the last line is one JSON
object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

LABELS = ("m2t::augment", "m2t::wait", "m2t::device_step")


def _timing():
    """``tools/timing.py`` of this checkout, loaded by its path: the
    checkout under ``--root`` may predate it."""
    spec = importlib.util.spec_from_file_location(
        "m2t_step_host_timing", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rate(fn, n=60):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _trainer_rate(root_dir, dev, tmp):
    import numpy as np
    import yaml
    from PIL import Image

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.train.loop import Trainer

    data = os.path.join(tmp, "data")
    rng = np.random.default_rng(23)
    for sub in ("US1K/US1K_train_HR", "US1K/US1K_train_LR_bicubic/X4",
                "benchmark/UI5/HR", "benchmark/UI5/LR_bicubic/X4"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    for i in range(1, 4):
        img = rng.integers(0, 256, (400, 392, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(data, "US1K/US1K_train_HR", f"{i:04d}.png"))
        Image.fromarray(img[::4, ::4]).save(
            os.path.join(data, "US1K/US1K_train_LR_bicubic/X4", f"{i:04d}x4.png"))
    img = rng.integers(0, 256, (128, 96, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(data, "benchmark/UI5/HR/b0.jpg"))
    Image.fromarray(img[::4, ::4]).save(os.path.join(data, "benchmark/UI5/LR_bicubic/X4/b0x4.jpg"))
    with open(os.path.join(root_dir, "configs", "M2Trans_x4.yml")) as fh:
        ycfg = yaml.safe_load(fh)
    ycfg.update(dtype="bfloat16", use_pallas=True, data_path=data, train_range=[1, 4],
                data_repeat=32, epochs=1, log_every=8, test_every=2,
                eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"), threads=2)
    yml = os.path.join(tmp, "train.yml")
    with open(yml, "w") as fh:
        yaml.dump(ycfg, fh)
    buf = io.StringIO()
    stdout = sys.stdout
    try:
        with contextlib.redirect_stdout(buf):
            Trainer(load_config(yml), device=dev).run()
            sys.stdout.log.close()
    finally:
        sys.stdout = stdout
    secs = [float(ln.rsplit("time: ", 1)[1]) for ln in buf.getvalue().splitlines()
            if ln.startswith("Epoch:")]
    return 8 * len(secs[1:]) / sum(secs[1:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    args = ap.parse_args()
    root_dir = os.path.abspath(args.root)
    sys.path.insert(0, root_dir)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_host: no CUDA device", file=sys.stderr)
        return 2
    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.m2trans import init_m2trans
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    import m2trans_tpu_torch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip())
    print(f"m2trans_tpu_torch from {os.path.dirname(m2trans_tpu_torch.__file__)}")
    dev = torch.device("cuda")
    timing = _timing()
    ship = load_config(os.path.join(root_dir, "configs", "M2Trans_x4.yml"))
    aug = dict(cutmix=True, data_add_noise=True, dtype="bfloat16", use_pallas=True)
    mcfg = MedCLIPConfig()
    fn = SemanticLossFn(init_medclip(mcfg, seed=4, device=dev), mcfg, None)
    trng = np.random.default_rng(23)
    ids = trng.integers(5, mcfg.text.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    ids[1, 31:] = mask[1, 31:] = 0
    caps = {"input_ids": ids, "attention_mask": mask}
    gen = torch.Generator().manual_seed(0)
    lr_b = torch.rand(2, 96, 96, 3, generator=gen).to(dev)
    hr_b = torch.rand(2, 384, 384, 3, generator=gen).to(dev)
    out = {}
    for name, cfg, f in (("L1 bf16 + kernels", ship.replace(**aug), None),
                         ("recipe (MedCLIP f32)", ship.replace(lambda_clip=0.01, **aug), fn)):
        model = init_m2trans(cfg, seed=0, device=dev)
        step = make_train_step(cfg, model, make_optimizer(cfg, model), f)
        rng = np.random.default_rng(5)

        def call():
            return step(lr_b, hr_b, captions=caps if f is not None else None, rng=rng,
                        do_cutout=True)

        out[name] = {"event_ms": timing.events(call), "steps_per_s": _rate(call),
                     "host_ms": timing.host(call, LABELS)}
        del model, step
    with tempfile.TemporaryDirectory() as tmp:
        out["Trainer steps/s"] = _trainer_rate(root_dir, dev, tmp)
    for name, v in out.items():
        print(f"{name}: {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
