"""The port's share of the card's peaks, a whole program at a time; the
counterpart of scripts/roofline.py, scripts/roofline_scales.py and
scripts/roofline_train.py.

    python -m m2trans_tpu_torch.tools.roofline
        [--programs fwd-x4 fwd-x3 fwd-x2 step-L1 step-recipe step-f32]
        [--n-blocks 8] [--device cuda|cpu] [--out PATH]

Programs (the flagship width, n_feats 64, 8 blocks, seeded weights):

- ``fwd-x4`` / ``fwd-x3`` / ``fwd-x2``: the serving forward, batch 8, 384x384
  output, bf16 with the kernels, replayed from its CUDA graph
  (``models/graphed.py``);
- ``step-L1``: the x4 train step, batch 2, 96x96 -> 384x384, bf16 with the
  kernels, cutmix, cutout and noise, replayed from its graph
  (``train/graphed.py``);
- ``step-recipe``: the same with 0.01 x the MedCLIP semantic loss (MedCLIP
  f32 at its published width);
- ``step-f32``: the step at the shipped ymls' dtype, f32 with TF32 off and
  no kernel, augmentations as ``step-L1``.

For each the last JSON line holds the operations and compulsory bytes of
``utils/roofline.py`` (the function's products counted on the plain f32
path at the same shapes, whatever runs it; each operand once), the
program's ``ms`` (CUDA-event slope of chained replays or queued steps) and
``device_ms`` (the profiler's device time of one call, measured last), and

- ``mfu`` = operations / (device s x 989e12), the share of the dense bf16
  tensor-core peak;
- ``hbm_floor_share`` = compulsory bytes / (device s x 3.35e12);
- for a program with f32 products (``step-recipe``'s MedCLIP, ``step-f32``)
  also ``mfu_f32_peak`` against 67 TFLOP/s; ``peak`` names the peak that
  applies.

The card's name and power limit stand beside them (the data sheet's peaks
assume 700 W). ``--device cpu`` counts the operations and bytes and prints
null for every time and share.
"""

from __future__ import annotations

import argparse

from m2trans_tpu_torch.tools.timing import (
    card,
    device_ms,
    graph_seconds_per_step,
    report,
)

STEP_BATCH = 2  # the shipped ymls' batch_size
PROGRAMS = ("fwd-x4", "fwd-x3", "fwd-x2", "step-L1", "step-recipe", "step-f32")
PEAK = {"fwd": "bf16 (989 TFLOP/s)", "step-L1": "bf16 (989 TFLOP/s)",
        "step-recipe": "bf16 for the SR side, f32 (67 TFLOP/s) for MedCLIP",
        "step-f32": "f32 (67 TFLOP/s)"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--programs", nargs="+", default=list(PROGRAMS), choices=PROGRAMS)
    ap.add_argument("--fwd-batch", type=int, default=8)
    ap.add_argument("--out-hw", type=int, default=384, help="forward output side")
    ap.add_argument("--step-hw", type=int, default=96, help="step LR side")
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--medclip-tiny", action="store_true",
                    help="MedCLIPConfig.tiny() and 56x56 patches (tests)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from m2trans_tpu_torch.bench import chain_step
    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.graphed import GraphedForward
    from m2trans_tpu_torch.models.m2trans import init_m2trans, param_count, policy_from_config
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.tools.bench_clip_train import StepCase
    from m2trans_tpu_torch.utils import roofline
    from m2trans_tpu_torch.utils.flops import model_flops

    dev = mesh_lib.init_from_env(args.device)
    on_card = dev.type == "cuda"
    fn = None
    if "step-recipe" in args.programs:
        mcfg = MedCLIPConfig.tiny() if args.medclip_tiny else MedCLIPConfig()
        fn = SemanticLossFn(init_medclip(mcfg, seed=4, device=dev), mcfg, None,
                            clip_size=56 if args.medclip_tiny else 224)

    def build(name):
        """(program, call, chained step, x0, counts) of a program."""
        if name.startswith("fwd"):
            s = int(name[-1])
            cfg = Config(scale=s, n_feats=args.n_feats, n_blocks=args.n_blocks, colors=3,
                         dtype="bfloat16", use_pallas=True)
            hw = args.out_hw // s
            model = init_m2trans(cfg, seed=0, device=dev)
            x0 = torch.rand(args.fwd_batch, hw, hw, 3,
                            generator=torch.Generator().manual_seed(1)).to(dev)
            graphed = GraphedForward(model, cfg, policy_from_config(cfg))
            counts = {"flops": model_flops(model, cfg, hw, hw, args.fwd_batch),
                      "bytes": roofline.forward_bytes(cfg, param_count(model),
                                                      args.fwd_batch, hw, hw, 2)}
            return model, (lambda: graphed(x0)), chain_step(graphed), x0, counts
        kind = "L1" if name in ("step-L1", "step-f32") else "recipe-f32"
        c = StepCase(kind, STEP_BATCH, dev, fn, hw=args.step_hw,
                     n_feats=args.n_feats, n_blocks=args.n_blocks)
        if name == "step-f32":
            c.cfg = c.cfg.replace(dtype="float32", use_pallas=False)
        model, opt, step = c.make()
        n = param_count(model, trainable_only=True)
        clip_n = (sum(p.numel() for p in c.fn.model.parameters())
                  if c.fn is not None else 0)
        counts = {"flops": roofline.step_flops(model, c.cfg, STEP_BATCH, args.step_hw,
                                               args.step_hw, c.fn),
                  "bytes": roofline.step_bytes(c.cfg, n, STEP_BATCH, args.step_hw,
                                               args.step_hw, 4 if name == "step-f32" else 2,
                                               medclip_params=clip_n)}
        rng = np.random.default_rng(5)
        return (model, opt, step), (lambda: c.call(step, rng)), \
            (lambda x: (c.call(step, rng), x)[1]), None, counts

    programs = {}
    for name in args.programs:
        held, call, chained, x0, counts = build(name)
        f32 = name in ("step-recipe", "step-f32")
        entry = programs[name] = {**counts, "ms": None, "device_ms": None,
                                  **roofline.shares(counts["flops"], counts["bytes"],
                                                    None, f32),
                                  "peak": PEAK.get(name, PEAK["fwd"])}
        with torch.inference_mode(name.startswith("fwd")):
            call()
            if on_card:
                ns = (4, 36) if name.startswith("fwd") else (2, 12)
                entry["ms"] = graph_seconds_per_step(chained, x0, ns=ns, pairs=3) * 1e3
        print(f"{name}: {entry}", flush=True)
        del held, call, chained
        if on_card:
            torch.cuda.empty_cache()
    for name in args.programs if on_card else ():  # the profiler last
        held, call, _, _, counts = build(name)
        entry = programs[name]
        with torch.inference_mode(name.startswith("fwd")):
            entry["device_ms"] = device_ms(call, n=5, warm=2)
        entry.update(roofline.shares(counts["flops"], counts["bytes"], entry["device_ms"],
                                     name in ("step-recipe", "step-f32")))
        del held, call
        torch.cuda.empty_cache()
    line = {"metric": "roofline_share", "unit": "share of peak",
            "method": "FlopCounterMode on the plain f32 path; compulsory bytes; "
                      "profiler device time of the graphed program",
            "peaks": {"bf16_flop_per_s": roofline.BF16_FLOP_PER_S,
                      "f32_flop_per_s": roofline.F32_FLOP_PER_S,
                      "hbm_bytes_per_s": roofline.HBM_BYTES_PER_S},
            "programs": programs, **card(dev),
            "config": {"n_feats": args.n_feats, "n_blocks": args.n_blocks,
                       "fwd_batch": args.fwd_batch, "out_hw": args.out_hw,
                       "step_batch": STEP_BATCH, "step_hw": args.step_hw,
                       "lambda_clip": 0.01, "seed": 0}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
