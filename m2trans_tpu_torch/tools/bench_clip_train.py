"""The train step of the port, L1 and the paper's recipe, at batch 2 and 8,
at x4 (default), x3 or x2; the counterpart of scripts/bench_clip_train.py,
scripts/bench_clip_wired.py and scripts/ab_train_scales.py.

    python -m m2trans_tpu_torch.tools.bench_clip_train [--scale 4|3|2]
        [--batches 2 8] [--kinds L1 recipe-f32 recipe-bf16] [--pairs 3]
        [--hw LR_SIDE] [--n-blocks 8] [--device cuda|cpu] [--out PATH]

The step the Trainer takes on one card (``train/loop.py::make_train_step``,
replayed from ``train/graphed.py::GraphedTrainStep``): the model at
``--scale`` (n_feats 64, 8 blocks, seeded weights) in bf16 with the
kernels, LR frames of ``384 // scale`` square (96 / 128 / 192; ``--hw``
overrides it) and HR of ``scale`` times that, 384x384 at every scale
(seeded), cutmix, cutout and input noise on, drawn anew each step from a
seeded host generator. ``L1`` is the L1 step;
``recipe-f32`` / ``recipe-bf16`` add 0.01 x the MedCLIP semantic loss
(MedCLIP at its published width, Swin-tiny 224 + BERT-base, seeded, in f32
or bf16; 3 patches of 224x224 an image; token ids of length 64 from a seed,
the second row's mask ragged).

For each kind and batch the last JSON line holds:

- ``ms_queued``: steps queued back to back, the CUDA-event slope of chains of
  2 and 12 steps (median of ``--pairs``): what the card does a step when the
  host keeps up;
- ``ms_sync``: CUDA events around one step, median of 10;
- ``device_ms``: the profiler's device time of one step (measured last);
- ``peak_gib``: ``max_memory_allocated`` over the model, Adam, the capture
  and the timed steps;
- ``captures`` and ``launches_per_capture`` (the kernel wrappers' launches
  in each capture: 32 K1, 8 K3, 1 K2, 32 K1b, 1 K2b at every scale).

The line's ``metric`` is ``x{scale}_train_step_ms`` and ``config.scale``
the scale.

Before the profiler, at each batch of ``--batches`` above 2 (the batch the
card first held the graphed step to eager at), 3 replayed steps are held
against 3 eager steps from the same state and draws:
losses, parameters and Adam's state bit for bit (``replay_vs_eager``;
where two eager runs differ, each parameter's update within a relative L2
of 5e-2); the result is ``replay_vs_eager`` of the batch.

``--device cpu`` takes one eager step a kind and batch with the kernels'
plain versions and prints null for every time and memory number.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from m2trans_tpu_torch.tools.timing import (
    card,
    device_ms,
    events,
    graph_seconds_per_step,
    peak_gib,
    report,
)

KINDS = ("L1", "recipe-f32", "recipe-bf16")
STEP_TOL = 5e-2  # rel L2 of a parameter's update, replay vs eager (PERF.md §2)
TOKENS = 64
CHECK_STEPS = 3  # replayed steps held against eager steps
HR_SIDE = 384  # the HR side at every scale (scripts/ab_train_scales.py's OUT)


def step_config(kind: str, batch: int, n_feats: int = 64, n_blocks: int = 8,
                scale: int = 4):
    """The Config of a kind at ``scale``: bf16 with the kernels, cutmix,
    cutout and noise; the recipe's ``lambda_clip`` 0.01 and MedCLIP's
    dtype."""
    from m2trans_tpu_torch.config import Config

    recipe = kind != "L1"
    return Config(scale=scale, n_feats=n_feats, n_blocks=n_blocks, batch_size=batch,
                  dtype="bfloat16", use_pallas=True, cutmix=True, cutout=True,
                  data_add_noise=True, lambda_clip=0.01 if recipe else 0.0,
                  medclip_dtype="bfloat16" if kind == "recipe-bf16" else "float32")


def captions(batch: int, vocab_size: int, seed: int = 23) -> Dict:
    """Token ids of length 64 from ``seed``, the second row's mask ragged."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, (batch, TOKENS)).astype(np.int32)
    mask = np.ones((batch, TOKENS), np.int32)
    if batch > 1:
        ids[1, 31:] = mask[1, 31:] = 0
    return {"input_ids": ids, "attention_mask": mask}


class StepCase:
    """A kind's train step at a batch, from seeded weights and data."""

    def __init__(self, kind: str, batch: int, dev, fn=None, *, hw: int = 96,
                 n_feats: int = 64, n_blocks: int = 8, scale: int = 4):
        import torch

        self.cfg = step_config(kind, batch, n_feats, n_blocks, scale)
        self.fn = fn if kind != "L1" else None
        gen = torch.Generator().manual_seed(1)
        self.lr = torch.rand(batch, hw, hw, 3, generator=gen).to(dev)
        self.hr = torch.rand(batch, scale * hw, scale * hw, 3, generator=gen).to(dev)
        self.caps = (captions(batch, self.fn.mcfg.text.vocab_size)
                     if self.fn is not None else None)
        self.dev = dev

    def make(self, graphs: bool = True):
        """(model, optimizer, step) from init seed 0."""
        from m2trans_tpu_torch.models.m2trans import init_m2trans
        from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

        model = init_m2trans(self.cfg, seed=0, device=self.dev)
        opt = make_optimizer(self.cfg, model)
        return model, opt, make_train_step(self.cfg, model, opt, self.fn, graphs=graphs)

    def call(self, step, rng):
        return step(self.lr, self.hr, captions=self.caps, rng=rng, do_cutout=True)


def _run_steps(case: StepCase, graphs: bool, steps: int):
    """``steps`` steps from init: [losses, *parameters, *Adam's state], and
    the step."""
    import numpy as np
    import torch

    from m2trans_tpu_torch.train.graphed import LOSS_NAMES

    model, opt, step = case.make(graphs)
    losses = []
    for i in range(steps):
        aux = case.call(step, np.random.default_rng(230 + i))
        losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
    torch.cuda.synchronize()
    flat = [torch.stack(losses)] + [p.detach().clone() for p in model.parameters()] + [
        v.clone() for p in model.parameters() if p in opt.state
        for v in opt.state[p].values()]
    return flat, step


def replay_vs_eager(case: StepCase, steps: int = 3) -> str:
    """``steps`` replayed steps against as many eager steps from the same
    state and draws; "bit for bit", or, where two eager runs already
    differ, each parameter's update within a relative L2 of ``STEP_TOL``.
    Raises otherwise, and where the replay is not finite."""
    import torch

    from m2trans_tpu_torch.models.m2trans import init_m2trans

    eager, _ = _run_steps(case, False, steps)
    again, _ = _run_steps(case, False, steps)
    graphed, step = _run_steps(case, True, steps)
    if step.graphed is None or step.graphed.replays != steps:
        raise RuntimeError("the graphed step did not replay")
    if not all(bool(torch.isfinite(t.float()).all()) for t in graphed):
        raise RuntimeError("the replayed step is not finite")
    if all(torch.equal(a, b) for a, b in zip(eager, again)):
        diff = [i for i, (a, b) in enumerate(zip(graphed, eager)) if not torch.equal(a, b)]
        if diff:
            raise RuntimeError(f"replay differs from eager in {len(diff)} tensors "
                               f"(first {diff[:3]}); two eager runs agree")
        return "bit for bit"
    init = [p.detach() for p in init_m2trans(case.cfg, seed=0, device=case.dev).parameters()]
    worst = 0.0
    for a, b, p0 in zip(graphed[1:], eager[1:], init):
        da, db = (a - p0).double(), (b - p0).double()
        if bool(db.any()):
            worst = max(worst, float((da - db).norm() / db.norm()))
    if worst > STEP_TOL:
        raise RuntimeError(f"two eager runs differ, and the replay's updates are "
                           f"{worst:.3g} from eager's (> {STEP_TOL})")
    return f"eager itself not deterministic; updates within rel L2 {worst:.3g}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=4, choices=(2, 3, 4))
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 8])
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--hw", type=int, default=None,
                    help=f"LR side (default {HR_SIDE} // scale)")
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--n-feats", type=int, default=64)
    ap.add_argument("--medclip-tiny", action="store_true",
                    help="MedCLIPConfig.tiny() and 56x56 patches (tests)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    hw = args.hw or HR_SIDE // args.scale

    import numpy as np
    import torch

    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh_lib.init_from_env(args.device)
    on_card = dev.type == "cuda"
    mcfg = MedCLIPConfig.tiny() if args.medclip_tiny else MedCLIPConfig()
    clip = init_medclip(mcfg, seed=4, device=dev)
    fns: Dict[str, Optional[SemanticLossFn]] = {"L1": None}
    for kind, dtype in (("recipe-f32", None), ("recipe-bf16", torch.bfloat16)):
        if kind in args.kinds:
            fns[kind] = SemanticLossFn(clip, mcfg, None, dtype=dtype,
                                       clip_size=56 if args.medclip_tiny else 224)

    def case(kind, batch):
        return StepCase(kind, batch, dev, fns[kind], hw=hw, n_feats=args.n_feats,
                        n_blocks=args.n_blocks, scale=args.scale)

    steps: Dict[str, dict] = {}
    for kind in args.kinds:
        for batch in args.batches:
            c = case(kind, batch)
            entry = steps[f"{kind} b{batch}"] = dict.fromkeys(
                ("ms_queued", "ms_sync", "device_ms", "peak_gib", "captures",
                 "launches_per_capture"))
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            model, opt, step = c.make()
            rng = np.random.default_rng(5)
            loss = c.call(step, rng)["loss"]
            if not bool(torch.isfinite(loss)):
                raise RuntimeError(f"{kind} b{batch}: loss {float(loss)}")
            if on_card:
                entry["ms_queued"] = graph_seconds_per_step(
                    lambda x: (c.call(step, rng), x)[1], None, ns=(2, 12),
                    pairs=args.pairs) * 1e3
                entry["ms_sync"] = events(lambda: c.call(step, rng), n=10, warm=2)
                entry["peak_gib"] = peak_gib(dev)
                entry["captures"] = step.graphed.captures
                entry["launches_per_capture"] = list(step.graphed.capture_launches.values())
            print(f"{kind} b{batch}: {entry}", flush=True)
            del model, opt, step
    checks = {}
    for batch in (b for b in args.batches if b > 2 and on_card):
        for kind in args.kinds:
            checks[f"{kind} b{batch}"] = replay_vs_eager(case(kind, batch),
                                                          CHECK_STEPS)
            print(f"{kind} b{batch}: {CHECK_STEPS} replayed steps vs eager: "
                  f"{checks[f'{kind} b{batch}']}", flush=True)
            torch.cuda.empty_cache()
    for name, entry in steps.items() if on_card else ():  # the profiler last
        kind, batch = name.rsplit(" b", 1)
        c = case(kind, int(batch))
        model, opt, step = c.make()
        rng = np.random.default_rng(5)
        entry["device_ms"] = device_ms(lambda: c.call(step, rng), n=5, warm=2)
        del model, opt, step
        torch.cuda.empty_cache()
    line = {"metric": f"x{args.scale}_train_step_ms", "unit": "ms",
            "method": "cuda_graph_slope of queued steps (chains of 2 / 12); events; "
                      "profiler",
            "steps": steps, "replay_vs_eager": checks, **card(dev),
            "config": {"scale": args.scale, "n_feats": args.n_feats,
                       "n_blocks": args.n_blocks, "lr_hw": hw, "dtype": "bfloat16",
                       "use_pallas": True, "cutmix": True, "cutout": True, "data_add_noise": True,
                       "lambda_clip": 0.01, "medclip": "tiny" if args.medclip_tiny
                       else "Swin-tiny 224 + BERT-base", "tokens": TOKENS,
                       "pairs": args.pairs, "check_steps": CHECK_STEPS, "seed": 0}}
    report(line, args.out)
    return line


if __name__ == "__main__":
    main()
