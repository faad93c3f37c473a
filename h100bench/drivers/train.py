"""Training through ``Trainer.step`` over the port's loader: the general
driver of the ``train`` traffic mixes.

The mix's parameters: ``lambda_clip`` (0: the L1 step ``train.py`` takes
without MedCLIP), ``phantoms`` HR images of ``phantom_hw`` written for the
loader, ``checked_steps`` (the first steps, which the reference follows),
``trace_seconds``. Batch, patch, repeat and the rest are the
configuration's ``training`` keys as shipped.

Set-up writes the seeded phantoms (HR and bicubic LR) as the port's uint8
npy cache under ``TMPDIR`` (the C++ loader maps it), a captions file and,
with the semantic loss, builds MedCLIP at its published widths from
seeded weights in the release layout through the port's loader; it builds
the port's ``Trainer`` (bf16 with the kernels, one card), loads the seeded
M2Trans weights into its model through the reference loader, and takes
the first ``checked_steps`` steps through ``Trainer.step`` on the loader's
first batches (the first captures the step's CUDA graph). The window then
goes on with the same trainer and loader, epoch after epoch, until
``seconds`` have passed, and waits for the card: ``train_step_ms`` is the
window's length over the steps taken in it, the loader's waits and its
epoch boundaries included.

After the checked steps the step's forward maps the first checked batch's
LR once more, and the SR is kept. After the window the reference follows
the checked steps from the same weights and batches; the loader's batches are checked by themselves
(:mod:`h100bench.reference.loader_check`).
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Any, Dict, List

import numpy as np

from h100bench.core import counts, phantoms, weights
from h100bench.core.trace import Traced, reduce
from h100bench.drivers import (
    Context,
    free_device,
    memory_peak,
    port_config,
    settle,
    span,
)
from h100bench.reference import compare, loader_check
from h100bench.reference.precision import Precision
from h100bench.reference.train_step import train_steps

WORDS = tuple(("longitudinal transverse view section carotid artery liver kidney thyroid "
         "breast gallbladder spleen bladder vessel wall intima media lumen nodule "
         "lesion cyst cortex medulla margin echotexture homogeneous heterogeneous "
         "hypoechoic hyperechoic anechoic isoechoic posterior acoustic shadowing "
         "enhancement normal thickened smooth irregular calcification flow plaque "
         "stenosis tissue fat muscle tendon probe depth gain near far field left "
         "right upper lower clear with without and of").split())
SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def write_data(ctx: Context, root: str):
    """The phantoms as the port's npy cache of a US1K tree under ``root``;
    returns (HR uint8 (N, H, W, 3), LR uint8 (N, H/s, W/s, 3))."""
    t, s = ctx.traffic, ctx.config["model"]["scale"]
    h, w = t["phantom_hw"]
    rng = np.random.default_rng([ctx.seed, 2])
    hr = np.stack([phantoms.speckle_phantom(rng, h, w) for _ in range(t["phantoms"])])
    lr = np.stack([phantoms.downscale(img, s) for img in hr])
    hr, lr = (np.repeat(a[..., None], 3, axis=-1) for a in (hr, lr))
    hr_dir = os.path.join(root, "us1k_cache", "us1k_hr", "rgb")
    lr_dir = os.path.join(root, "us1k_cache", f"us1k_lr_x{s}", "rgb")
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)
    for i in range(len(hr)):
        np.save(os.path.join(hr_dir, f"{i + 1:04d}.npy"), hr[i])
        np.save(os.path.join(lr_dir, f"{i + 1:04d}x{s}.npy"), lr[i])
    return hr, lr


def captions(ctx: Context) -> List[str]:
    rng = np.random.default_rng([ctx.seed, 3])
    return [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), rng.integers(6, 16)))
            for _ in range(ctx.traffic["phantoms"])]


def tokens(text: str, max_length: int):
    """[CLS] word ids [SEP], [PAD] to ``max_length``: the WordPiece ids of
    a caption whose words are whole entries of the vocabulary."""
    vocab = {tok: i for i, tok in enumerate(SPECIAL + WORDS)}
    ids = [vocab["[CLS]"], *[vocab[wd] for wd in text.split()][:max_length - 2], vocab["[SEP]"]]
    return ids + [0] * (max_length - len(ids)), [1] * len(ids) + [0] * (max_length - len(ids))


def clip_on(ctx: Context) -> bool:
    return ctx.traffic["lambda_clip"] > 0


def build_trainer(ctx: Context, root: str, caps: List[str]):
    import torch

    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, load_medclip_torch
    from m2trans_tpu_torch.models.medclip.tokenizer import WordPieceTokenizer
    from m2trans_tpu_torch.train.convert import load_reference_state_dict
    from m2trans_tpu_torch.train.loop import Trainer

    t, dev = ctx.traffic, torch.device(ctx.device)
    cap_path = os.path.join(root, "captions.txt")
    with open(cap_path, "w", encoding="utf-16") as fh:
        fh.write("\n".join(caps) + "\n")
    cfg = port_config(ctx.config, data_path=root, train_range=(1, t["phantoms"] + 1),
                      eval_sets=[], log_path=os.path.join(root, "experiments"),
                      seed=ctx.seed, lambda_clip=t["lambda_clip"], captions_path=cap_path,
                      save_image=False)
    loss_fn = None
    if clip_on(ctx):
        mc = ctx.config["medclip"]
        mcfg = MedCLIPConfig.tiny() if mc["port_config"] == "tiny" else MedCLIPConfig()
        sd = weights.medclip_state_dict(mc, ctx.seed, dev)
        model = load_medclip_torch(sd, mcfg, dev)
        del sd
        ctx.mark("medclip")
        loss_fn = SemanticLossFn(model, mcfg, WordPieceTokenizer(SPECIAL + WORDS),
                                 n_patches=mc["n_patches"], clip_size=mc["clip_size"],
                                 max_length=mc["max_length"])
    stdout = sys.stdout
    try:
        trainer = Trainer(cfg, device=dev, semantic_loss_fn=loss_fn)
    finally:
        sys.stdout = stdout  # the Trainer tees stdout into its log
    ctx.mark("trainer")
    sd = weights.m2trans_state_dict(ctx.config["model"], ctx.seed, dev)
    load_reference_state_dict(trainer.model, sd)
    return trainer


def program_steps(ctx: Context, trainer, epoch) -> Dict[str, Any]:
    """The checked steps through ``Trainer.step``: their batches, losses,
    first gradient (Adam's first moment after step 1 / (1 - beta1)), the
    parameters' change, and the SR of the first batch's LR that the step's
    forward (``m2trans_apply`` under the training policy) gives after them."""
    import torch

    from m2trans_tpu_torch.models.m2trans import m2trans_apply, policy_from_config

    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    params = dict(trainer.model.named_parameters())
    before = {n: params[n].detach().clone() for n in names}
    batches, losses, grad = [], [], None
    for it in range(ctx.traffic["checked_steps"]):
        batch = next(epoch)
        batches.append(tuple(np.array(a, copy=True) for a in batch[:2]))
        out = trainer.step(it, batch)
        losses.append(float(out["loss"]))
        if grad is None:  # a step that left Adam unmoved has no moment: 0
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            state = trainer.optimizer.state
            grad = {n: (state[params[n]]["exp_avg"].detach().clone() / (1 - beta1)
                        if "exp_avg" in state.get(params[n], {})
                        else torch.zeros_like(params[n])) for n in names}
    change = {n: params[n].detach() - before[n] for n in names}
    with torch.no_grad():  # the step's own forward, as the steps left the model
        x = torch.as_tensor(batches[0][0]).to(ctx.device).float()
        sr = m2trans_apply(trainer.model, x, trainer.cfg,
                           policy_from_config(trainer.cfg)).float().cpu()
    return {"batches": batches, "losses": losses, "grad": grad, "change": change,
            "sr": sr}


def reference_steps(ctx: Context, batches, caps, *, prec=None, fault=None) -> dict:
    import torch

    cfgm, tr = ctx.config, ctx.config["training"]
    sd = weights.m2trans_state_dict(cfgm["model"], ctx.seed, ctx.device)
    clip = None
    if clip_on(ctx):
        mc = cfgm["medclip"]
        rng = np.random.default_rng(ctx.seed)  # the Trainer's generator
        toks, offs = [], []
        for it, (_, hr) in enumerate(batches):
            b, hh, ww = hr.shape[:3]
            rows = [tokens(caps[(it * b + i) % len(caps)], mc["max_length"]) for i in range(b)]
            toks.append(tuple(torch.tensor([r[j] for r in rows], device=ctx.device)
                              for j in (0, 1)))
            n = mc["n_patches"] - 1
            ys = rng.integers(0, hh - mc["clip_size"], (n, b))
            xs = rng.integers(0, ww - mc["clip_size"], (n, b))
            offs.append((ys, xs))
        clip = {"sd": weights.medclip_state_dict(mc, ctx.seed, ctx.device), "cfg": mc,
                "tokens": toks, "offsets": offs}
    return train_steps(sd, cfgm["model"], batches, lr=tr["lr"], lambda_l1=tr["lambda_l1"],
                       lambda_clip=ctx.traffic["lambda_clip"], clip=clip,
                       prec=prec or Precision("f32"), fault=fault)


def run(ctx: Context) -> Dict[str, Any]:
    import torch

    t, model = ctx.traffic, ctx.config["model"]
    cuda = ctx.device == "cuda"
    root = ctx.scratch_dir()
    hr_imgs, lr_imgs = write_data(ctx, root)
    ctx.mark("data")
    caps = captions(ctx)
    trainer = build_trainer(ctx, root, caps)
    loader = trainer.train_loader
    epoch = iter(loader)
    checked = program_steps(ctx, trainer, epoch)
    ctx.mark("checked steps")
    it = t["checked_steps"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    settle()
    setup_s = time.perf_counter() - ctx.t_start

    seconds = min(ctx.seconds, t["trace_seconds"]) if ctx.trace else ctx.seconds
    on, steps = ctx.trace, 0
    with Traced(on, cuda) as traced, span(on, "h100bench::window"):
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            with span(on, "h100bench::next_batch"):
                batch = next(epoch, None)
            if batch is None:
                epoch, it = iter(loader), 0
                continue
            with span(on, "h100bench::step"):
                trainer.step(it, batch)
            it += 1
            steps += 1
        if cuda:
            torch.cuda.synchronize()
        t_close = time.perf_counter()
    trace = reduce(traced.prof) if on else None
    e2e = {"train_step_ms": (t_close - t0) * 1e3 / max(steps, 1), "setup_s": setup_s}
    peak = memory_peak(ctx.device)
    loader.close() if hasattr(loader, "close") else None
    del trainer, loader, epoch
    free_device(ctx.device)

    ref = reference_steps(ctx, checked["batches"], caps)
    numbers = compare.train_numbers(checked, ref)
    bad = loader_check.unmatched(checked["batches"], hr_imgs, lr_imgs, model["scale"])
    shutil.rmtree(root, ignore_errors=True)
    if trace is not None:
        b, lh, lw = checked["batches"][0][0].shape[:3]
        trace.update(kind="train", units=steps,
                     flops_per_unit=counts.step_flops(model, b, lh, lw, ctx.config.get("medclip"),
                                                      t["lambda_clip"]),
                     k1b_bound_ms_per_unit=counts.k1b_bound_ms(model, b, lh, lw))
    return {"attempted": steps, "failed": 0, "e2e": e2e, "trace": trace,
            "numbers": numbers, "complete": bad == 0 and steps > 0,
            "memory_peak_bytes": peak}


def control(ctx: Context) -> Dict[str, float]:
    """The control: the reference's steps with their products in fp8 in
    the program's place, on the loader's first batches, compared as a run
    compares."""
    return fault(ctx, None, Precision("fp8"))


FAULTS = ("half_batch",)


def fault(ctx: Context, name, prec=None) -> Dict[str, float]:
    """A fault of ``FAULTS`` planted in the reference put in the program's
    place (or, with ``prec``, the reference in that precision), read as a
    run reads the program."""
    root = ctx.scratch_dir()
    write_data(ctx, root)
    caps = captions(ctx)
    trainer = build_trainer(ctx, root, caps)
    checked = program_steps(ctx, trainer, iter(trainer.train_loader))
    trainer.train_loader.close() if hasattr(trainer.train_loader, "close") else None
    del trainer
    free_device(ctx.device)
    ref = reference_steps(ctx, checked["batches"], caps)
    other = reference_steps(ctx, checked["batches"], caps, prec=prec, fault=name)
    shutil.rmtree(root, ignore_errors=True)
    return compare.train_numbers(other, ref)
