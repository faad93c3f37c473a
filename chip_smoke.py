#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``m2trans_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes of the x4 serving, training and eval paths,
drives the flagship forward (x4, n_feats 64, 8 blocks, seeded weights,
batch 8 x 96x96 bf16) and the serving CLI ``python -m
m2trans_tpu_torch.infer``, a flagship bf16 train step (batch 2 x 96x96 ->
384x384) and the training CLI ``python -m m2trans_tpu_torch.train`` on a
synthetic US1K tree, the standalone ops (``tblock_apply``,
``make_branch_fn``, the lane relayouts) and the eval CLI ``python -m
m2trans_tpu_torch.test`` with FSIM/GMSD on a synthetic benchmark tree, and
times the kernels, the forward and the train step with CUDA events; then
(phase 17) the training recipe's step: the same train step with the MedCLIP
semantic loss at MedCLIP's published width (Swin-tiny 224, BERT-base,
seeded random weights), held against the plain bf16 step, and the
``Trainer`` for an epoch with a captions file, timed with and without the
loss; then (phases 18 and 19) the frame sharded by rows and the data
parallelism: the sharded flagship forward at 1x512x512 (bf16 + kernels at
world size 1 under NCCL and on 2 ranks that share the card under gloo, f32
at 1x256x256) against the single-device forward, the infer CLI under
``torch.distributed.run --nproc_per_node 2`` with ``--mesh-space 2``, one
DDP train step of 2 ranks against phase 10's one-process step and the train
CLI with ``mesh_data: 2``; then (phase 20) the 2-D (data, space) mesh: 4
ranks sharing the card under gloo as 2 x 2, a batch of 2 x 512x512 over the
data rows and each image's rows over its row, against the single-device
forward; then (phase 21) the ``Trainer`` with the C++ loader (built with g++
in phase 2, beside the kernels), a profiler trace that must name the
kernels, the TensorBoard panels and the complexity report; then (phase 22)
the serving forward replayed from a CUDA graph per frame shape
(``models/graphed.py``) against the eager forward bit for bit (bf16 with the
kernels at 8x96x96 and 1x512x512, u8 on and off; f32 at 1x256x256), the
launches its capture counts, a recapture after weights are loaded in place,
event and device times of eager and replay, the memory its graphs hold,
phase 6's PNGs (the infer CLI, which replays graphs) against an eager
``StreamingSR(graphs=False)`` run on the same frames, and ``python -m
m2trans_tpu_torch.bench`` (its JSON line printed); then (phase 23) the
train step replayed from a CUDA graph (``train/graphed.py``) against the
eager step bit for bit over 3 steps (the x4 L1 step in bf16 with the
kernels, the shipped yml's f32 step, the recipe's step with MedCLIP f32),
the launches its capture counts, event, device and host ms eager vs
replay, the memory its captures hold, the Trainer's steps/s with and
without graphs and the train CLI's, and the eval forward's graphs: the
eval's s/frame split into reads, forward and metrics, eager and replayed,
and the eval CLI's lines against an eager evaluation; then (phase 24) the
augmentations inside the train step's graph (L1 bf16 with the kernels and
the recipe, 8 steps, replay vs eager bit for bit, how often each fired,
host ms of the augmentations and of the graphed device part), the
``Trainer`` for 3 epochs validating each (bf16 with the kernels and f32):
later validations capture nothing and equal eager ones, their s/frame
split, and the metrics graphs' rows against the eager rows; then (phases
25-30) the measurement tools of ``m2trans_tpu_torch/tools/`` at short
settings, each printing its JSON line: the single-frame latency, the
scales, batch 64 by micro-batch, the recipe's step and the x2 / x3 L1
step at batch 8 (3 replayed steps bit for bit against eager), the
roofline of the forward and the L1 step, and the whole recipe through the
train CLI for an epoch with a release-format ``pytorch_model.bin``,
``vocab.txt`` and UTF-16 captions (the port's own tokenizer); then (phase
31) the shipped x2 and x3 configurations at full width: the train step of
``configs/M2Trans_x{2,3}.yml`` in bf16 with the kernels and the
augmentations (3 replayed steps against eager bit for bit, the launches
of a capture, the gradients against the plain bf16 step's), the shipped
f32 step, and the train, eval (``_test`` ymls, f32 against bf16, graphed
against eager) and infer CLIs (graphed against eager) on frames
whose HR sides are no multiple of the scale; then (phase 32) MedCLIP's
Swin window attention (``csrc/swin_attn.cu``) against its plain version at
Swin-tiny's stage shapes, its device times beside its bound, the plain
version's and masked ``scaled_dot_product_attention``'s, MedCLIP's parts
and the x2 recipe step with the kernels and with the plain attention. The
CLIs and Trainers of one process (phases 6, 11, 15, 17, 21) replay graphs, as users
run them on one card; the steps whose launches are counted or held against
the plain step (phases 7, 10, 17) run eagerly (``graphs=False``). Every
phase prints one line and the first failure exits non-zero. The line
before the last is the JSON kernel report (K1's, K1b's and K1n's numbers
are one CFTM's four launches, levels 0, 1, 2, 2; ``bound_ms`` is the larger
of bytes / 3.35 TB/s and operations / 989 TFLOP/s, counted from the
operands of this run; K1's, K2's, K3's, K1b's and K2b's rows also carry
``device_ms``, the device time from torch.profiler, and K1's and K1b's the
body each level launched),
the last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or the
``m2trans_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join("configs", "M2Trans_x4_test.yml")
K1_TOL = (5e-2, 5e-3)   # max, mean |kernel - plain|, bf16 (test_cftm_fused.py)
K2_TOL = 8e-3           # max |kernel - plain|, bf16 (test_tail_band.py)
FWD_TOL = (1e-1, 5e-3)  # max, mean |kernels - plain bf16| of the forward
F32_MEAN_TOL = 2e-2     # mean |kernels - f32| of the forward (test_model.py)
# K1b / K2b vs their plain VJPs, every gradient: max|a - b| <=
# max(GRAD_ATOL, GRAD_RTOL * max|b|) (test_cftm_fused.py, test_tail_band.py)
GRAD_ATOL, GRAD_RTOL = 2e-3, 2e-2
# train step, kernels vs plain bf16, relative L2 per parameter tensor:
# <= max(STEP_TOL, 1.5 e), e the plain bf16 gradient's distance from f32
# (two independent bf16 roundings of size e differ by about 1.41 e)
STEP_TOL = 5e-2
# K3 vs its plain version: max|a - b| <= max(K3_ATOL, K3_RTOL * max|b|); the
# two differ in the f32 order of the tap sums, one bf16 ulp at a rounding tie
K3_ATOL, K3_RTOL = 2e-3, 2e-2
# eval CLI, bf16 through the kernels vs f32: PSNR dB, and SSIM / FSIM / GMSD
EVAL_TOL = (0.1, 2e-3)
BUCKET_TOL = 0.05       # dB, --bucket 32 vs exact, f32


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def need_no_reference_package() -> None:
    """The port runs without jax and without the JAX package."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "m2trans_tpu"))
    need(not bad, f"the port loaded {bad[:5]}")


def time_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median of ``n`` CUDA-event timings of ``fn`` after ``warm`` calls."""
    from m2trans_tpu_torch.tools.timing import events

    return events(fn, n, warm)


def errs(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def device_ms(fn, n: int = 20, warm: int = 3, copies: bool = False):
    """Device time of one call of ``fn`` from torch.profiler
    (``tools/timing.py::device_ms``)."""
    from m2trans_tpu_torch.tools.timing import device_ms as measure

    return measure(fn, n, warm, copies)


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def ff_case(shape, seed=0):
    """K3 operands: unit-normal oc and x, the conv's weight and bias with
    PyTorch's init bounds."""
    import torch

    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_weight_hwio

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    bnd = (9 * c) ** -0.5
    oc = torch.randn(shape, generator=g).bfloat16().cuda()
    x = torch.randn(shape, generator=g).bfloat16().cuda()
    w = ((torch.rand(c, c, 3, 3, generator=g) * 2 - 1) * bnd).cuda()
    b = ((torch.rand(c, generator=g) * 2 - 1) * bnd).bfloat16().cuda()
    return oc, x, ff_weight_hwio(w), b


def smooth_frame(rng, h, w):
    """A smooth u8 frame of h x w x 3: a sum of random sinusoids plus a
    little noise."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for _ in range(6):
        fy, fx = rng.uniform(0.005, 0.08, 2)
        img += rng.uniform(0.2, 1.0, 3) * np.sin(
            2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.28))[..., None]
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img * 255 + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def write_benchmark_tree(root, rng, shapes):
    """Synthetic CCA-US (benchmark/UI5) tree for the x4 eval CLI: smooth HR
    frames of the LR ``shapes`` times 4, LR x4 by striding, written as
    JPEGs with Pillow."""
    from PIL import Image

    hr_dir = os.path.join(root, "benchmark/UI5/HR")
    lr_dir = os.path.join(root, "benchmark/UI5/LR_bicubic/X4")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    for i, (h, w) in enumerate(shapes):
        u8 = smooth_frame(rng, 4 * h, 4 * w)
        Image.fromarray(u8).save(os.path.join(hr_dir, f"e{i}.jpg"), quality=95)
        Image.fromarray(u8[::4, ::4]).save(os.path.join(lr_dir, f"e{i}x4.jpg"),
                                           quality=95)


def write_eval_sets(root, rng, scale, hr_shapes, sets=("UI5", "US15", "US1K_23")):
    """Synthetic eval sets under ``root/benchmark`` (CCA-US = UI5, US-CASE =
    US15, US1K_23): a smooth HR frame of each of ``hr_shapes`` a set, its
    LR x``scale`` by striding the largest multiple of ``scale`` of each
    side (a bicubic LR's size), JPEGs (US1K_23's LR a PNG, as the loader
    reads it), written with Pillow."""
    from PIL import Image

    for name in sets:
        hr_dir = os.path.join(root, "benchmark", name, "HR")
        lr_dir = os.path.join(root, "benchmark", name, "LR_bicubic", f"X{scale}")
        os.makedirs(hr_dir)
        os.makedirs(lr_dir)
        ext = ".png" if name == "US1K_23" else ".jpg"
        for i, (h, w) in enumerate(hr_shapes):
            u8 = smooth_frame(rng, h, w)
            lr = u8[:h - h % scale:scale, :w - w % scale:scale]
            Image.fromarray(u8).save(os.path.join(hr_dir, f"e{i}.jpg"), quality=95)
            Image.fromarray(lr).save(os.path.join(lr_dir, f"e{i}x{scale}{ext}"),
                                     quality=95)


def parse_eval(out: str) -> dict:
    """The eval CLI's two lines -> {psnr, ssim, fsim, gmsd}."""
    lines = out.strip().splitlines()
    need(len(lines) == 2 and lines[0].startswith("[CCA-US-X4] PSNR:")
         and lines[1].startswith("FSIM:"), f"eval CLI printed {out!r}")
    vals = {}
    for part in lines[0].split("] ")[1].split(",") + lines[1].split(","):
        k, v = part.split(":")
        vals[k.lower()] = float(v)
    return vals


def branch_case(levels, bsz=8, hw=96, cb=16, seed=0):
    """K1 operands at the slice shapes: x as a channel slice of a 4*cb
    NHWC body tensor, as the model passes it (cb = 16 on the model path; any
    other base width goes to the general body)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c = cb * 4 ** levels
    body = torch.randn(bsz, hw, hw, 4 * cb, generator=g).bfloat16().cuda()
    x = body[..., cb:2 * cb]
    add = torch.randn(bsz, hw, hw, cb, generator=g).bfloat16().cuda()
    w = (torch.randn(c, 3 * c, generator=g) * c ** -0.5).bfloat16().cuda()
    rel_h = torch.randn(10, c // 2, generator=g).cuda()
    rel_w = torch.randn(10, c // 2, generator=g).cuda()
    s = (torch.rand(bsz, cb, generator=g) + 0.5).cuda()
    t = (torch.randn(bsz, cb, generator=g) * 0.2).cuda()
    return (x, w, rel_h, rel_w, s, t), add


def tail_case(scale, bsz, h, w, nf=64, seed=0, with_grad=False):
    """K2 operands: random tail weights with PyTorch's init bounds and a
    unit-normal body output (and, with ``with_grad``, a cotangent of K2's
    phase-plane output)."""
    import torch

    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_operands

    g = torch.Generator().manual_seed(seed)

    def u(shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) * fan_in ** -0.5).cuda()

    if scale == 4:
        p = {"c0": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
             "c1": {"w": u((4 * nf, nf, 1, 1), nf), "b": u((4 * nf,), nf)},
             "c2": {"w": u((3, nf, 3, 3), 9 * nf)}}
    else:
        p = {"c0": {"w": u((nf * scale ** 2, nf, 1, 1), nf),
                    "b": u((nf * scale ** 2,), nf)},
             "c1": {"w": u((3, nf, 3, 3), 9 * nf)}}
    y = torch.randn(bsz, h, w, nf, generator=g).bfloat16().cuda()
    ops = tail_band_operands(p, y, scale=scale)
    if not with_grad:
        return ops
    return ops, torch.randn(bsz, h, w, scale * scale * 3,
                            generator=g).bfloat16().cuda()


def grad_errs(got, want, what):
    """Max |a - b| over the gradients, each held to its bound."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            need(a is None, f"{what}: gradient {i} should be None")
            continue
        need(a.shape == b.shape and a.dtype == b.dtype,
             f"{what}: gradient {i} {a.dtype}{tuple(a.shape)} vs "
             f"{b.dtype}{tuple(b.shape)}")
        need(torch_isfinite(a), f"{what}: gradient {i} not finite")
        mx, _ = errs(a, b)
        tol = max(GRAD_ATOL, GRAD_RTOL * float(b.float().abs().max()))
        need(mx <= tol, f"{what}: gradient {i} max err {mx} > {tol}")
        worst = max(worst, mx)
    return worst


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def write_us1k_tree(root, rng, n=3, hr=(400, 392), eval_hr=(128, 96), scale=4):
    """Synthetic US1K tree for the training CLI: n HR PNGs of ``hr`` (at
    least a 384x384 patch, its sides multiples of ``scale``) with LR
    x``scale`` by striding, and one CCA-US (benchmark/UI5) pair of
    ``eval_hr`` (x4; none where ``eval_hr`` is None), written with
    Pillow."""
    import numpy as np
    from PIL import Image

    dirs = {k: os.path.join(root, v) for k, v in (
        ("hr", "US1K/US1K_train_HR"), ("lr", f"US1K/US1K_train_LR_bicubic/X{scale}"),
        ("bhr", "benchmark/UI5/HR"), ("blr", "benchmark/UI5/LR_bicubic/X4"))}
    os.makedirs(dirs["hr"], exist_ok=True)
    os.makedirs(dirs["lr"], exist_ok=True)
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (*hr, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(dirs["hr"], f"{i:04d}.png"))
        Image.fromarray(img[::scale, ::scale]).save(
            os.path.join(dirs["lr"], f"{i:04d}x{scale}.png"))
    if eval_hr is None:
        return
    os.makedirs(dirs["bhr"], exist_ok=True)
    os.makedirs(dirs["blr"], exist_ok=True)
    img = rng.integers(0, 256, (*eval_hr, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(dirs["bhr"], "b0.jpg"))
    Image.fromarray(img[::4, ::4]).save(os.path.join(dirs["blr"], "b0x4.jpg"))


def word_tokenizer(vocab_size: int):
    """A tokenizer for the phases whose MedCLIP has seeded weights and no
    vocabulary file (phase 30 runs the port's WordPiece tokenizer on one):
    [CLS] = 2, an id a word from its CRC, [SEP] = 3, zero padding to
    ``max_length``; numpy, as ``SemanticLossFn.tokenize`` asks."""
    import zlib

    import numpy as np

    def tokenize(texts, max_length, **_):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            words = [5 + zlib.crc32(w.encode()) % (vocab_size - 5)
                     for w in text.lower().split()]
            row = [2] + words[:max_length - 2] + [3]
            ids[i, :len(row)] = row
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}

    return tokenize


def profile_call(fn, n: int = 2, warm: int = 1) -> dict:
    """One torch.profiler (CUPTI) run over ``n`` calls of ``fn`` after
    ``warm``, device activity only (the host's ops are not traced, which
    keeps the profile of a 3,000-kernel step quick): the device ms and the
    kernels (copies and memsets left out) of one call, and the 6 kernels
    with the most device time; ms None where the profiler records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from m2trans_tpu_torch.tools.timing import is_device_work

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = []
    for ev in prof.key_averages():
        if is_device_work(ev):
            us = getattr(ev, "device_time_total", None)
            kernels.append((ev.cuda_time_total if us is None else us, ev.count, ev.key))
    total = sum(k[0] for k in kernels)
    top = sorted(kernels, reverse=True)[:6]
    return {"ms": total / 1e3 / n if total else None,
            "launches": sum(c for _, c, key in kernels
                            if not key.startswith(("Memcpy", "Memset"))) // n,
            "top": "; ".join(f"{key[:48]} {us / 1e3 / n:.3f} ms x{c // n}"
                             for us, c, key in top)}


def profile_split(fn) -> str:
    """Device time of one call of ``fn`` by kind of kernel
    (``tools/timing.py::kernel_kind``), from torch.profiler (CUPTI); "not
    measured" where it records no device time."""
    from m2trans_tpu_torch.tools.timing import device_split

    kinds = device_split(fn)
    if kinds is None:
        return "not measured (the profiler recorded no device time)"
    return ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items()) + \
        f"; total {sum(kinds.values()):.3f} ms"


def semantic_step_phase(dev, tcfg, lr_b, hr_b, loss_k, train_launches, work,
                        mcfg=None, clip_size=224, timed=True) -> None:
    """Phase 17, the recipe's step: the x4 bf16 train step with the MedCLIP
    semantic loss at MedCLIP's published width (``mcfg`` None: Swin-tiny
    224, BERT-base; seeded random weights), 3 patches an image, token ids of
    length 64 from a seed with a ragged mask, held against the plain bf16
    step; the staged loss against the loss in one piece; MedCLIP in bf16;
    the Trainer for an epoch with captions; then (``timed``) event and
    device times with and without the loss. ``loss_k`` and
    ``train_launches`` are phase 10's L1 and launches of the same step
    without the loss. With a small ``mcfg`` and ``timed=False`` it also runs
    on the CPU (the kernels' plain versions, no launches), as a CPU test
    rehearses it."""
    import numpy as np
    import torch
    import yaml

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.losses.semantic import (
        SemanticLossFn,
        clip_image_sims,
        clip_text_embed,
        crop_offsets,
        semantic_loss_staged,
    )
    from m2trans_tpu_torch.models.m2trans import init_m2trans
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch, cftm_branch_bwd
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_bwd, tail_band_fused
    from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step

    def step_grads(m):
        return {n: p.grad for n, p in m.named_parameters() if p.requires_grad}

    def sub(a, b):  # device ms of a minus b's
        return None if None in (a["ms"], b["ms"]) else a["ms"] - b["ms"]

    t0 = time.perf_counter()
    mcfg = mcfg or MedCLIPConfig()
    size = dict(clip_size=clip_size)
    medclip = init_medclip(mcfg, seed=4, device=dev)
    n_medclip = sum(p.numel() for p in medclip.parameters())
    tokenizer = word_tokenizer(mcfg.text.vocab_size)
    fns = {"float32": SemanticLossFn(medclip, mcfg, tokenizer, **size),
           "bfloat16": SemanticLossFn(medclip, mcfg, tokenizer, dtype=torch.bfloat16, **size)}
    init_s = time.perf_counter() - t0
    trng = np.random.default_rng(17)
    ids = trng.integers(5, mcfg.text.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    ids[1, 23:] = mask[1, 23:] = 0
    caps = {"input_ids": ids, "attention_mask": mask}
    ccfg = tcfg.replace(lambda_clip=0.01)

    def clip_model(c, fn):  # eager: its launches are counted a step
        m = init_m2trans(c, seed=0, device=dev)
        return m, make_train_step(c, m, make_optimizer(c, m), fn, graphs=False)

    def clip_step(st):  # the same crop offsets every call
        return st(lr_b, hr_b, captions=caps, rng=np.random.default_rng(18))

    counters = (cftm_branch, ff_conv, tail_band_fused, cftm_branch_bwd, tail_band_bwd)
    model_c, step_c = clip_model(ccfg, fns["float32"])
    for f in counters:
        f.launches = 0
    aux = {k: float(v) for k, v in clip_step(step_c).items()}
    clip_launches = {f.__name__: f.launches for f in counters}
    need(clip_launches == train_launches,
         f"the semantic-loss step launched {clip_launches}, want {train_launches}")
    need(all(np.isfinite(v) for v in aux.values()) and aux["clip"] > 0,
         f"semantic-loss step losses {aux}")
    need(abs(aux["l1"] - loss_k) <= 1e-5 * loss_k, f"the semantic-loss step's L1 "
         f"{aux['l1']} is not the L1 step's {loss_k} (same weights and batch)")
    grads_c = step_grads(model_c)
    ref = {}
    for name, c in (("plain", ccfg.replace(use_pallas=False)),
                    ("f32", ccfg.replace(dtype="float32", use_pallas=False)),
                    ("l1 only", tcfg.replace(lambda_clip=0.0))):
        m, st = clip_model(c, fns["float32"])
        ref[name] = (float(clip_step(st)["clip"]), step_grads(m))
    worst, worst_name, worst_e = 0.0, "", 0.0
    for name, gr in grads_c.items():
        need(gr is not None and torch_isfinite(gr), f"gradient of {name} not finite")
        d = rel_l2(gr, ref["plain"][1][name])
        e = rel_l2(ref["plain"][1][name], ref["f32"][1][name])
        need(d <= max(STEP_TOL, 1.5 * e),
             f"semantic-loss step: {name} kernels vs plain bf16 rel L2 {d:.4g} > "
             f"max({STEP_TOL}, 1.5 * {e:.4g})")
        if d > worst:
            worst, worst_name, worst_e = d, name, e
    # d clip / d sr reaches the model through K2b's cotangent
    moved = rel_l2(grads_c["head.weight"], ref["l1 only"][1]["head.weight"])
    need(moved > 0, "the semantic loss does not move the gradient")

    # the staged loss equals the loss in one piece (f32 encoders)
    fn32 = fns["float32"]
    with torch.no_grad():
        sr_t = torch.rand(hr_b.shape, generator=torch.Generator().manual_seed(19)).to(dev)
        offs = crop_offsets(np.random.default_rng(19), *hr_b.shape[:3], 2, clip_size)
        const = fn32.const_stage_from_params(fn32.model, hr_b, caps, offsets=offs)
        staged = float(fn32.loss_staged_from_params(fn32.model, sr_t, const))
        mono = float(fn32(sr_t, hr_b, caps, offsets=offs))
    need(abs(staged - mono) <= 1e-4 * abs(mono),
         f"staged semantic loss {staged} vs one piece {mono}: over rtol 1e-4")

    # medclip_dtype bfloat16 runs too, within the JAX test's bf16 bound
    model_16, step_16 = clip_model(ccfg, fns["bfloat16"])
    aux16 = {k: float(v) for k, v in clip_step(step_16).items()}
    c32, c16 = aux["clip"] / ccfg.lambda_clip, aux16["clip"] / ccfg.lambda_clip
    need(all(np.isfinite(v) for v in aux16.values()) and aux16["clip"] > 0
         and abs(c16 - c32) < 0.05 * max(1.0, abs(c32)),
         f"bf16 MedCLIP loss {c16} vs f32 {c32}")

    # the Trainer for an epoch of 3 steps with captions, on a US1K tree
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_us1k_tree(os.path.join(tmp, "data"), np.random.default_rng(3))
        cap_file = os.path.join(tmp, "captions.txt")
        with open(cap_file, "w", encoding="utf-16") as f:
            f.write("carotid artery in long axis\nthyroid nodule\nliver parenchyma\n")
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as f:
            ycfg = yaml.safe_load(f)
        ycfg.update(dtype="bfloat16", use_pallas=True, data_path=os.path.join(tmp, "data"),
                    train_range=[1, 4], data_repeat=2, epochs=1, log_every=1,
                    eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"), threads=2,
                    captions_path=cap_file, n_feats=tcfg.n_feats, n_blocks=tcfg.n_blocks)
        yml = os.path.join(tmp, "train.yml")
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            trainer = Trainer(load_config(yml), device=dev, semantic_loss_fn=fn32)
            trainer.run()
            sys.stdout.log.close()
        trainer_s = time.perf_counter() - t1
    clip_logged = [float(ln.split("CLIPloss: ")[1].split()[0])
                   for ln in buf.getvalue().splitlines() if "CLIPloss: " in ln]
    need(len(clip_logged) == 3 and min(clip_logged) > 0,
         f"Trainer with captions logged CLIPloss {clip_logged}")
    correct_s = time.perf_counter() - t0
    print(f"phase 17 semantic-loss train step x4 bf16 + kernels, 2x96x96 -> 384x384, "
          f"MedCLIP at {mcfg.vision.image_size}² / BERT {mcfg.text.num_layers} layers "
          f"({n_medclip / 1e6:.1f} M parameters, seeded, built in {init_s:.1f} s), 3 "
          f"patches an image, 64 tokens: launches {clip_launches}; loss {aux['loss']:.6f} "
          f"L1 {aux['l1']:.6f} clip {aux['clip']:.8f} (bf16 MedCLIP clip "
          f"{aux16['clip']:.8f}); gradients vs plain bf16 worst rel L2 {worst:.4g} "
          f"({worst_name}; plain vs f32 {worst_e:.4g}, bound "
          f"{max(STEP_TOL, 1.5 * worst_e):.4g}); the loss moves head.weight's gradient "
          f"by rel L2 {moved:.3g}; staged {staged:.8f} vs one piece {mono:.8f}; Trainer "
          f"1 epoch with captions in {trainer_s:.1f} s, CLIPloss {clip_logged}; checks "
          f"in {correct_s:.1f} s")
    if not timed:
        return

    # times: CUDA events first (median of 10), peak memory, then the profiler
    model_l1, step_l1 = clip_model(tcfg.replace(lambda_clip=0.0), None)
    runs = {"l1": lambda: step_l1(lr_b, hr_b), "clip f32": lambda: clip_step(step_c),
            "clip bf16": lambda: clip_step(step_16)}
    ev_ms, peak_gb = {}, {}
    for name, fn in runs.items():
        ev_ms[name] = time_ms(fn, n=10)
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak_gb[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = {name: profile_call(fn) for name, fn in runs.items()}
    # MedCLIP's parts, f32 and bf16: BERT (text stage), the HR-side Swin
    # forward (const stage, resize and crops included), the SR-side Swin
    # forward + backward to sr (the differentiated stage)
    sr_leaf = torch.rand(hr_b.shape, generator=torch.Generator().manual_seed(20)).to(dev)
    parts = {}
    for dname, fn in fns.items():
        ids_t = torch.as_tensor(ids, device=dev).long()
        mask_t = torch.as_tensor(mask, device=dev).long()
        with torch.no_grad():
            t_emb = clip_text_embed(fn.model, ids_t, mask_t)
            sim_y = clip_image_sims(fn.model, hr_b, offs, t_emb)

        def sr_side():
            s = sr_leaf.bfloat16().requires_grad_(True)  # the step's sr is bf16
            semantic_loss_staged(fn.model, s, offs, t_emb, sim_y).backward()

        def text():
            with torch.no_grad():
                clip_text_embed(fn.model, ids_t, mask_t)

        def hr_side():
            with torch.no_grad():
                clip_image_sims(fn.model, hr_b, offs, t_emb)

        parts[dname] = {"BERT": profile_call(text), "Swin fwd (HR)": profile_call(hr_side),
                        "Swin fwd + bwd (SR)": profile_call(sr_side)}
    split_c = profile_split(runs["clip f32"])
    medclip_txt = "; ".join(
        f"{d} " + ", ".join(f"{k} {fmt_ms(v['ms'])} ({v['launches']} kernels)"
                            for k, v in p.items())
        + f"; in the step (with - without) {fmt_ms(sub(prof[f'clip {d[:4]}'], prof['l1']))}"
        for d, p in (("f32", parts["float32"]), ("bf16", parts["bfloat16"])))
    print("phase 17 times: event ms (median of 10) "
          + ", ".join(f"{k} {v:.3f}" for k, v in ev_ms.items())
          + "; device ms (profiler) " + ", ".join(f"{k} {fmt_ms(v['ms'])}"
                                                  for k, v in prof.items())
          + "; kernels launched a step " + ", ".join(f"{k} {v['launches']}"
                                                     for k, v in prof.items())
          + "; peak GiB " + ", ".join(f"{k} {v:.2f}" for k, v in peak_gb.items())
          + f"; MedCLIP by part (device ms): {medclip_txt}; top kernels of the f32 SR "
          f"side: {parts['float32']['Swin fwd + bwd (SR)']['top']}; of the bf16 SR side: "
          f"{parts['bfloat16']['Swin fwd + bwd (SR)']['top']}; split of the f32-MedCLIP "
          f"step (MedCLIP's kernels in 'other', the MedCLIP bucket the difference "
          f"above): {split_c}; phase 17 in {time.perf_counter() - t0:.1f} s")


SHARD_FRAME = (1, 512, 512)   # the sharded serving frame, LR
SHARD_F32_FRAME = (1, 256, 256)
SHARD_F32_ATOL = 2e-4         # f32, TF32 off (tests/test_spatial.py)


def seeded_frame(shape, seed):
    import torch

    return torch.rand(*shape, 3, generator=torch.Generator().manual_seed(seed))


def parallel_rank(rank, n, lr_np, hr_np):
    """One of ``n`` ranks that share the card under gloo (phases 18 and 19):
    the sharded flagship forward (bf16 + kernels at 1x512x512 with its
    kernel launches, event and device time; f32 at 1x256x256) against the
    single-device forward on this rank, then one DDP train step on the
    global batch (lr_np, hr_np) with its launches; returns what it found."""
    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans, m2trans_apply
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch, cftm_branch_bwd
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_bwd, tail_band_fused
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.parallel.spatial import spatial_sharded_forward
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    dev = mesh_lib.init_from_env("cuda")
    out = {"device": str(dev), "shared": mesh_lib.shared_card_note(),
           "backend": mesh_lib.backend()}
    cfg = load_config(os.path.join(ROOT, CONFIG))
    model = init_m2trans(cfg, seed=0, device=dev)
    mesh = mesh_lib.space_mesh()
    kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    fwd_counters = (cftm_branch, ff_conv, tail_band_fused)
    with torch.inference_mode():
        x = seeded_frame(SHARD_FRAME, 5).to(dev)
        single = m2trans_apply(model, x, cfg, kern)
        for f in fwd_counters:
            f.launches = 0
        y = spatial_sharded_forward(model, x, cfg, mesh=mesh, policy=kern)
        torch.cuda.synchronize()
        out["launches"] = [f.launches for f in fwd_counters]
        out["shape"] = tuple(y.shape)
        out["finite"] = bool(torch.isfinite(y.float()).all())
        out["err"] = errs(y, single)
        out["ms"] = time_ms(lambda: spatial_sharded_forward(model, x, cfg, mesh=mesh,
                                                            policy=kern), n=5, warm=1)
        out["single_ms"] = time_ms(lambda: m2trans_apply(model, x, cfg, kern), n=5, warm=1)
        out["device_ms"], out["copy_ms"] = device_ms(lambda: spatial_sharded_forward(
            model, x, cfg, mesh=mesh, policy=kern), n=3, warm=1, copies=True)
        out["single_device_ms"] = device_ms(lambda: m2trans_apply(model, x, cfg, kern),
                                            n=3, warm=1)
        x32 = seeded_frame(SHARD_F32_FRAME, 6).to(dev)
        y32 = spatial_sharded_forward(model, x32, cfg, mesh=mesh, policy=ComputePolicy())
        ref32 = m2trans_apply(model, x32, cfg, ComputePolicy())
        out["f32_err"] = errs(y32, ref32)
        out["f32_shape"] = tuple(y32.shape)

    # 19. one DDP step of the flagship bf16 + kernels on the global batch
    tcfg = cfg.replace(dtype="bfloat16", use_pallas=True)
    model_t = init_m2trans(tcfg, seed=0, device=dev)
    step = make_train_step(tcfg, model_t, make_optimizer(tcfg, model_t))  # DDP: n ranks
    counters = fwd_counters + (cftm_branch_bwd, tail_band_bwd)
    for f in counters:
        f.launches = 0
    aux = step(torch.from_numpy(lr_np).to(dev), torch.from_numpy(hr_np).to(dev))
    torch.cuda.synchronize()
    out["train_launches"] = [f.launches for f in counters]
    out["loss"] = float(mesh_lib.all_reduce_sum(aux["loss"])) / n
    flat = torch.cat([p.detach().reshape(-1) for p in model_t.parameters()])
    out["replica_diff"] = float((flat - mesh_lib.broadcast(flat, 0)).abs().max())
    if rank == 0:
        out["grads"] = {k: p.grad.float().cpu().numpy() for k, p in model_t.named_parameters()
                        if p.requires_grad}
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "m2trans_tpu"))
    return out


def parallel_phases(dev, model, cfg, lr_b, hr_b, grads_k, grads_p, grads_f, work):
    """Phases 18 and 19: the sharded flagship forward at world size 1 under
    NCCL in this process and on 2 ranks that share the card under gloo, the
    infer CLI under torch.distributed.run with --mesh-space 2, the DDP train
    step of 2 ranks against phase 10's one-process step, and the train CLI
    with mesh_data 2. Returns the launches a rank for the kernels line."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml
    from PIL import Image

    from m2trans_tpu_torch.models.m2trans import ComputePolicy, m2trans_apply
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch, cftm_branch_plain
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.parallel.spatial import HALO_ROWS, spatial_sharded_forward
    from m2trans_tpu_torch.train.convert import reference_state_dict

    t0 = time.perf_counter()
    kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    counters = (cftm_branch, ff_conv, tail_band_fused)
    # K1 with the sharded CFTM's identity affine at the extended-shard
    # heights of a 512-row frame: 2 ranks (256 + 2 x 96) and 4 (128 + 2 x 96)
    parts = []
    for rows in (512 // 2 + 2 * HALO_ROWS, 512 // 4 + 2 * HALO_ROWS):
        for levels in (0, 1, 2):
            args, _ = branch_case(levels, bsz=1, hw=512, seed=rows + levels)
            xs = torch.rand(1, rows, 512, 64, device=dev).to(torch.bfloat16)[..., 16:32]
            s = torch.full_like(args[4], 0.5 if levels else 1.0)
            t = torch.zeros_like(args[5])
            got = cftm_branch(xs, *args[1:4], s, t, levels=levels)
            want = cftm_branch_plain(xs, *args[1:4], s, t, levels=levels)
            mx, mean = errs(got, want)
            need(mx < K1_TOL[0] and mean < K1_TOL[1],
                 f"K1 at 1x{rows}x512x16 L={levels}: max {mx} mean {mean}")
            parts.append(f"{rows} rows L{levels} max {mx:.3g} mean {mean:.3g}")

    # (a) world size 1 under NCCL, in this process
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "s"), 1),
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            with torch.inference_mode():
                x = seeded_frame(SHARD_FRAME, 5).to(dev)
                single = m2trans_apply(model, x, cfg, kern)
                for f in counters:
                    f.launches = 0
                y1 = spatial_sharded_forward(model, x, cfg, mesh=mesh_lib.space_mesh(),
                                             policy=kern)
                torch.cuda.synchronize()
                launches1 = [f.launches for f in counters]
                err1 = errs(y1, single)
        finally:
            dist.destroy_process_group()
    need(launches1 == [32, 8, 1], f"sharded forward, NCCL world 1: launches {launches1}")
    need(err1[0] < FWD_TOL[0] and err1[1] < FWD_TOL[1],
         f"sharded forward, NCCL world 1, vs single-device: max/mean {err1}")
    del single, y1
    torch.cuda.empty_cache()

    # (b), (c) and phase 19's step: 2 ranks sharing the card under gloo
    ranks = mesh_lib.run_ranks(parallel_rank, 2, (lr_b.cpu().numpy(), hr_b.cpu().numpy()),
                               timeout_s=400, group_timeout_s=300)
    for r, res in enumerate(ranks):
        need(res["loaded"] == [], f"rank {r} loaded {res['loaded']}")
        need(res["backend"] == "gloo" and res["shared"], f"rank {r}: {res['backend']}")
        need(res["launches"] == [32, 8, 1],
             f"rank {r}: sharded forward launched {res['launches']}, want 32 K1, 8 K3, 1 K2")
        need(res["finite"] and res["shape"] == (1, 2048, 2048, 3),
             f"rank {r}: sharded output {res['shape']}, finite {res['finite']}")
        need(res["err"][0] < FWD_TOL[0] and res["err"][1] < FWD_TOL[1],
             f"rank {r}: sharded vs single-device bf16 max/mean {res['err']}")
        need(res["f32_err"][0] <= SHARD_F32_ATOL and res["f32_shape"] == (1, 1024, 1024, 3),
             f"rank {r}: f32 sharded vs single-device max {res['f32_err'][0]}")
    print(f"phase 18 sharded flagship x4 forward, {SHARD_FRAME[0]}x{SHARD_FRAME[1]}x"
          f"{SHARD_FRAME[2]} bf16 + kernels: world 1 under NCCL launches K1/K3/K2 "
          f"{launches1}, vs single-device max {err1[0]:.3g} mean {err1[1]:.3g}; "
          f"{ranks[0]['shared']}: launches a rank "
          + " / ".join(str(r["launches"]) for r in ranks) + ", vs single-device max/mean "
          + " / ".join(f"{r['err'][0]:.3g}/{r['err'][1]:.3g}" for r in ranks)
          + f"; f32 (TF32 off) {SHARD_F32_FRAME[1]}x{SHARD_F32_FRAME[2]} max "
          + " / ".join(f"{r['f32_err'][0]:.3g}" for r in ranks)
          + "; a frame a rank, event ms sharded vs single-device "
          + " / ".join(f"{r['ms']:.3f} vs {r['single_ms']:.3f}" for r in ranks)
          + ", device ms " + " / ".join(f"{fmt_ms(r['device_ms'])} (memory copies "
                                        f"{fmt_ms(r['copy_ms'])}) vs "
                                        f"{fmt_ms(r['single_device_ms'])}" for r in ranks)
          + "; K1 at the extended-shard shapes: " + "; ".join(parts))

    # 19. the DDP step against phase 10's one-process step
    grads = ranks[0]["grads"]
    worst, worst_name, worst_e = 0.0, "", 0.0
    for name, g in grads.items():
        d = rel_l2(torch.from_numpy(g), grads_k[name].float().cpu())
        e = rel_l2(grads_p[name], grads_f[name])
        need(d <= max(STEP_TOL, 1.5 * e), f"DDP step: {name} vs one process rel L2 "
             f"{d:.4g} > max({STEP_TOL}, 1.5 * {e:.4g})")
        if d >= worst:
            worst, worst_name, worst_e = d, name, e
    for r, res in enumerate(ranks):
        need(res["train_launches"] == [32, 8, 1, 32, 1],
             f"rank {r}: DDP step launched {res['train_launches']}, want 32 + 8 + 1 "
             "forward and 32 + 1 backward")
        need(res["replica_diff"] == 0.0, f"rank {r}: parameters differ from rank 0's "
             f"by {res['replica_diff']}")
    print(f"phase 19 DDP x4 bf16 + kernels train step, 2 ranks x 1 (global batch 2x96x96 "
          f"-> 384x384), {ranks[0]['shared']}: launches a rank "
          + " / ".join(str(r["train_launches"]) for r in ranks)
          + f"; loss {ranks[0]['loss']:.6f}; gradients vs phase 10's one-process step worst "
          f"rel L2 {worst:.4g} ({worst_name}; bound {max(STEP_TOL, 1.5 * worst_e):.4g}); "
          "parameters equal on both ranks after Adam")

    # the CLIs under torch.distributed.run, both at once (each mostly waits
    # for its ranks to start): infer on 2 ranks in f32, its PNGs within 1
    # level of one device's; train with mesh_data 2 for 1 epoch of 2 steps
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        pt = os.path.join(tmp, "model_x4.pt")
        torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
        frames, out = os.path.join(tmp, "frames"), os.path.join(tmp, "out")
        os.makedirs(frames)
        rng = np.random.default_rng(1)
        shapes = {"f0.png": (128, 128), "f1.png": (128, 128), "f2.png": (128, 128),
                  "f3.png": (100, 76)}
        for name, hw in shapes.items():
            Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                os.path.join(frames, name))
        write_us1k_tree(os.path.join(tmp, "data"), np.random.default_rng(4), n=2)
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as f:
            ycfg = yaml.safe_load(f)
        ycfg.update(dtype="bfloat16", use_pallas=True, data_path=os.path.join(tmp, "data"),
                    train_range=[1, 3], data_repeat=2, epochs=1, log_every=1, batch_size=2,
                    eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"), threads=2,
                    mesh_data=2)
        yml = os.path.join(tmp, "train.yml")
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        run2 = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m"]
        cmds = {"infer": run2 + ["m2trans_tpu_torch.infer", "--config", CONFIG,
                                 "--model_path", pt, "--input", frames, "--output", out,
                                 "--mesh-space", "2", "--f32"],
                "train": run2 + ["m2trans_tpu_torch.train", "--config", yml]}
        t1 = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
                 for k, c in cmds.items()}
        try:
            res = {k: p.communicate(timeout=300) for k, p in procs.items()}
        finally:  # a launcher cut by the timeout takes its ranks with it
            for p in procs.values():
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
        cli_s = time.perf_counter() - t1
        for k, p in procs.items():
            need(p.returncode == 0, f"{k} CLI under torch.distributed.run exited "
                 f"{p.returncode}:\n{res[k][1][-8000:]}\nits output:\n{res[k][0][-2000:]}")

        report = json.loads([ln for ln in res["infer"][0].splitlines()
                             if ln.startswith("{")][-1])
        need(report["mesh_space"] == 2 and report["ranks"] == 2 and report["frames"] == 4,
             f"infer report {report}")
        worst_level = 0
        with torch.inference_mode():
            for name, hw in shapes.items():
                with Image.open(os.path.join(frames, name)) as img:
                    x = torch.from_numpy(np.asarray(img.convert("RGB"), np.float32)[None]
                                         / 255.0).to(dev)
                want = np.clip(m2trans_apply(model, x, cfg, ComputePolicy())[0].cpu().numpy()
                               * 255.0 + 0.5, 0, 255).astype(np.int32)
                with Image.open(os.path.join(out, name)) as img:
                    got = np.asarray(img, np.int32)
                need(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
                worst_level = max(worst_level, int(np.abs(got - want).max()))
        need(worst_level <= 1,
             f"infer --mesh-space 2 PNGs differ from one device's by {worst_level} levels")

        train_out = res["train"][0]
        need("## parameters equal on all 2 ranks ##" in train_out
             and train_out.count("## device:") == 1,
             f"train CLI mesh_data 2 output:\n{train_out[-2000:]}")
        exps = os.listdir(os.path.join(tmp, "exp"))
        need(len(exps) == 1, f"experiment dirs {exps}")
        exp = os.path.join(tmp, "exp", exps[0])
        models = sorted(os.listdir(os.path.join(exp, "models")))
        need(models == ["model_x4_1.pt"], f"checkpoints {models}")
        with open(os.path.join(exp, "log.txt")) as f:
            log = f.read()
        need(log.count("Epoch:1, ") == 2 and "[CCA-US-X4], PSNR/SSIM: " in log,
             "train CLI mesh_data 2: log.txt lacks the loss or PSNR lines")
        ranks_line = [ln for ln in train_out.splitlines() if ln.startswith("## 2 ranks")]
    print(f"phase 18 infer CLI under torch.distributed.run, 2 ranks, --mesh-space 2 --f32, "
          f"4 frames (3x 128x128, 1x 100x76): PNGs within {worst_level} level(s) of the "
          f"single-device f32 forward; report {json.dumps(report)}")
    print(f"phase 19 train CLI under torch.distributed.run, mesh_data 2, x4 bf16, 1 epoch "
          f"of 2 steps + validation: rank 0 alone wrote the tree ({models[0]}, log.txt), "
          f"{ranks_line[0] if ranks_line else ''}, parameters equal on both ranks; the two "
          f"CLIs side by side in {cli_s:.1f} s; phases 18-19 in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"sharded_forward": ranks[0]["launches"], "ddp_step": ranks[0]["train_launches"],
            "sharded_ms": [r["ms"] for r in ranks],
            "sharded_device_ms": [r["device_ms"] for r in ranks]}


GRID = (2, 2)                 # (data, space) ranks of phase 20
GRID_FRAMES = (2, 512, 512)   # a batch of two single-frame-cell frames, LR
GRID_F32_FRAMES = (2, 256, 256)
GRID_F32_ATOL = 1e-5


def data_space_rank(rank, n, grid):
    """One of ``n`` ranks that share the card under gloo as a (data, space)
    ``grid`` (phase 20): the flagship forward of a bf16 + kernels batch with
    ``batch_axis="data"`` (its launches, event and device time) against the
    single-device forward of the whole batch on this rank, then f32;
    returns what it found."""
    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans, m2trans_apply
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused
    from m2trans_tpu_torch.parallel import mesh as mesh_lib
    from m2trans_tpu_torch.parallel.spatial import spatial_sharded_forward

    dev = mesh_lib.init_from_env("cuda")
    cfg = load_config(os.path.join(ROOT, CONFIG))
    model = init_m2trans(cfg, seed=0, device=dev)
    mesh = mesh_lib.data_space_mesh(*grid)
    kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    counters = (cftm_branch, ff_conv, tail_band_fused)
    out = {"at": (mesh.data.rank, mesh.space.rank), "shared": mesh_lib.shared_card_note()}

    def sharded(x, policy):
        return spatial_sharded_forward(model, x, cfg, mesh=mesh, policy=policy,
                                       batch_axis="data")

    with torch.inference_mode():
        x = seeded_frame(GRID_FRAMES, 20).to(dev)
        single = m2trans_apply(model, x, cfg, kern)
        for f in counters:
            f.launches = 0
        y = sharded(x, kern)
        torch.cuda.synchronize()
        out["launches"] = [f.launches for f in counters]
        out["shape"] = tuple(y.shape)
        out["finite"] = bool(torch.isfinite(y.float()).all())
        out["err"] = errs(y, single)
        out["ms"] = time_ms(lambda: sharded(x, kern), n=5, warm=1)
        out["single_ms"] = time_ms(lambda: m2trans_apply(model, x, cfg, kern), n=5, warm=1)
        out["device_ms"], out["copy_ms"] = device_ms(lambda: sharded(x, kern), n=3, warm=1,
                                                     copies=True)
        x32 = seeded_frame(GRID_F32_FRAMES, 21).to(dev)
        y32 = sharded(x32, ComputePolicy())
        out["f32_err"] = errs(y32, m2trans_apply(model, x32, cfg, ComputePolicy()))
        out["f32_shape"] = tuple(y32.shape)
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "m2trans_tpu"))
    return out


def data_space_phase() -> dict:
    """Phase 20: the flagship forward over a 2 x 2 (data, space) mesh of 4
    ranks sharing the card under gloo, a batch of 2 x 512x512 split over the
    data rows and each image's rows over its row's 2 ranks, held on every
    rank against the single-device forward (bf16 with the kernels; f32 at 2
    x 256x256). Returns rank 0's launches for the kernels line."""
    from m2trans_tpu_torch.parallel.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(data_space_rank, GRID[0] * GRID[1], (GRID,), timeout_s=400,
                      group_timeout_s=300)
    b, h, w = GRID_FRAMES
    for r, res in enumerate(ranks):
        need(res["loaded"] == [], f"rank {r} loaded {res['loaded']}")
        need(res["at"] == divmod(r, GRID[1]) and res["shared"],
             f"rank {r} at {res['at']}, {res['shared']!r}")
        need(res["launches"] == [32, 8, 1],
             f"rank {r}: 2-D mesh forward launched {res['launches']}, want 32 K1, 8 K3, 1 K2")
        need(res["finite"] and res["shape"] == (b, 4 * h, 4 * w, 3),
             f"rank {r}: 2-D mesh output {res['shape']}, finite {res['finite']}")
        need(res["err"][0] < FWD_TOL[0] and res["err"][1] < FWD_TOL[1],
             f"rank {r}: 2-D mesh vs single-device bf16 max/mean {res['err']}")
        need(res["f32_err"][0] <= GRID_F32_ATOL
             and res["f32_shape"] == (GRID_F32_FRAMES[0], 4 * GRID_F32_FRAMES[1],
                                      4 * GRID_F32_FRAMES[2], 3),
             f"rank {r}: f32 2-D mesh vs single-device max {res['f32_err'][0]}")
    print(f"phase 20 2-D (data, space) mesh {GRID[0]}x{GRID[1]}, flagship x4 forward, "
          f"batch {b}x{h}x{w} bf16 + kernels, {ranks[0]['shared']}: launches a rank "
          + " / ".join(str(r["launches"]) for r in ranks) + "; vs single-device max/mean "
          + " / ".join(f"{r['err'][0]:.3g}/{r['err'][1]:.3g}" for r in ranks)
          + f"; f32 (TF32 off) {GRID_F32_FRAMES[0]}x{GRID_F32_FRAMES[1]}x"
          f"{GRID_F32_FRAMES[2]} max " + " / ".join(f"{r['f32_err'][0]:.3g}" for r in ranks)
          + "; event ms a batch, 2-D mesh vs single-device "
          + " / ".join(f"{r['ms']:.3f} vs {r['single_ms']:.3f}" for r in ranks)
          + ", device ms " + " / ".join(f"{fmt_ms(r['device_ms'])} (memory copies "
                                        f"{fmt_ms(r['copy_ms'])})" for r in ranks)
          + f"; phase 20 in {time.perf_counter() - t0:.1f} s")
    return {"launches": ranks[0]["launches"]}


# the kernels' names in a trace (csrc/), by kernel
TRACE_KERNELS = {"K1": ("cftm_branch_w16_kernel", "cftm_branch_w64_kernel",
                        "cftm_branch_c256_kernel"),
                 "K1b": ("cftm_bwd_attn_win_kernel", "cftm_bwd_attn_c256_kernel",
                         "cftm_bwd_proj_kernel"),
                 "K2": ("tail_band_kernel",), "K2b": ("tail_band_bwd_kernel",),
                 "K3": ("ff_conv_kernel",)}


class PanelWriter:
    """A recording TensorBoard writer (the GPU machine has no
    ``tensorboardX``) that holds each train panel's SR third against the
    kernel forward of the batch just stepped, made when the panel arrives."""

    def __init__(self):
        self.images, self.scalars = [], []
        self.trainer, self.batch, self.sr_checked = None, None, 0

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def add_image(self, tag, img, step, dataformats="CHW"):
        import numpy as np
        import torch

        from m2trans_tpu_torch.models.m2trans import m2trans_apply, policy_from_config

        self.images.append((tag, step, dataformats, img.shape, img.dtype))
        if tag.startswith("Train/"):
            t = self.trainer
            with torch.no_grad():
                lr1 = torch.from_numpy(self.batch[0][:1]).to(t.device)
                sr = m2trans_apply(t.model, lr1, t.cfg, policy_from_config(t.cfg))
            want = np.clip(sr[0].float().cpu().numpy() / t.cfg.rgb_range * 255.0,
                           0, 255).astype(np.uint8)
            w = img.shape[1] // 3
            d = np.abs(img[:, w:2 * w].astype(np.int32) - want.astype(np.int32))
            need(d.max() == 0, f"train panel's SR third differs from the kernel forward "
                 f"of its frame by up to {d.max()} levels")
            self.sr_checked += 1


def trainer_phase(dev, tcfg, work) -> None:
    """Phase 21: the ``Trainer`` in this process with the default
    ``native_loader`` (the C++ loader) on a synthetic US1K tree, one epoch
    of 12 steps of the flagship bf16 + kernels, replayed from a CUDA graph,
    with ``profile_dir`` (the trace of steps 6-10, replays, must name K1's,
    K1b's, K2's, K2b's and K3's kernels)
    and a recording writer (one train panel of 384x1152x3 uint8 whose SR
    third is the kernel forward of its frame, one eval panel), then the
    complexity report."""
    import numpy as np
    import yaml

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch_bwd
    from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_bwd
    from m2trans_tpu_torch.runtime import NativeTrainLoader
    from m2trans_tpu_torch.train.loop import Trainer
    from m2trans_tpu_torch.utils.flops import model_complexity_report

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_us1k_tree(os.path.join(tmp, "data"), np.random.default_rng(21))
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as f:
            ycfg = yaml.safe_load(f)
        prof_dir = os.path.join(tmp, "prof")
        ycfg.update(dtype="bfloat16", use_pallas=True, data_path=os.path.join(tmp, "data"),
                    train_range=[1, 4], data_repeat=8, epochs=1, log_every=4,
                    eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"), threads=2,
                    profile_dir=prof_dir, n_feats=tcfg.n_feats, n_blocks=tcfg.n_blocks)
        yml = os.path.join(tmp, "train.yml")
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        cfg = load_config(yml)
        need(cfg.native_loader and cfg.colors == 3 and cfg.data_augment,
             "the x4 training config no longer selects the C++ loader")
        writer = PanelWriter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer = Trainer(cfg, device=dev, writer=writer)
            loader_kind = type(trainer.train_loader)
            step = trainer.step

            def stepped(it, batch, do_cutout=False):
                writer.batch = batch
                return step(it, batch, do_cutout)

            trainer.step, writer.trainer = stepped, trainer
            cftm_branch_bwd.launches = tail_band_bwd.launches = 0
            trainer.run()
            sys.stdout.log.close()
        steps = trainer.steps_per_epoch
        bwd = (cftm_branch_bwd.launches, tail_band_bwd.launches)
        runner = trainer.train_step.graphed
        need(loader_kind is NativeTrainLoader,
             f"the Trainer's loader is {loader_kind.__name__}, not the C++ loader")
        # the steps replay graphs: the wrappers count each capture's
        # side-stream run and the capture, not the replays
        need(runner is not None and runner.replays == steps >= 12
             and bwd == (64 * runner.captures, 2 * runner.captures),
             f"{steps} steps, graphs {runner and (runner.captures, runner.replays)}, "
             f"launched K1b / K2b {bwd}")
        traces = os.listdir(prof_dir)
        need(traces == ["trace_rank0.json"], f"profile_dir holds {traces}")
        trace_path = os.path.join(prof_dir, traces[0])
        trace_mb = os.path.getsize(trace_path) / 2 ** 20
        with open(trace_path) as f:
            text = f.read()
        missing = [k for names in TRACE_KERNELS.values() for k in names if k not in text]
        need(not missing, f"the profiler trace names no {missing}")
    train_panels = [im for im in writer.images if im[0] == "Train/lr_sr_hr_image"]
    eval_panels = [im for im in writer.images if im[0].startswith("Valid_")]
    need(train_panels == [("Train/lr_sr_hr_image", 0, "HWC", (384, 1152, 3), np.uint8)]
         and writer.sr_checked == 1, f"train panels {train_panels}")
    need(eval_panels == [("Valid_CCA-US/lr_sr_hr_image", 1, "HWC", (128, 288, 3),
                          np.uint8)], f"eval panels {eval_panels}")
    need(len(writer.scalars) == steps // 4 + 2, f"scalars {writer.scalars}")
    report = model_complexity_report(trainer.model, trainer.cfg)
    need(report.startswith("## Flops: ") and report.endswith(
        "GMac-equiv (torch flop_counter, 96x96 input), Params: 3.63 M"),
        f"complexity report {report!r}")
    psnr = [ln for ln in buf.getvalue().splitlines() if "PSNR/SSIM" in ln]
    print(f"phase 21 Trainer x4 bf16 + kernels with the C++ loader "
          f"({loader_kind.__name__}), 1 epoch of {steps} steps (2x96x96 -> 384x384) "
          f"replayed from {runner.captures} CUDA graph(s): K1b / K2b launches in the "
          f"captures {bwd}; profiler trace of steps 6-10 (replays, {trace_mb:.1f} MiB) names "
          + ", ".join(f"{k} ({'/'.join(v)})" for k, v in TRACE_KERNELS.items())
          + f"; panels: train {train_panels[0][1:4]}, its SR third equal to the kernel "
          f"forward of its frame; eval {eval_panels[0][:2]}; scalars {len(writer.scalars)}; "
          f"{psnr[-1].strip() if psnr else ''}; {report}; phase 21 in "
          f"{time.perf_counter() - t0:.1f} s")


def graphed_phase(dev, cfg, serve) -> dict:
    """Phase 22: the serving forward replayed from a CUDA graph per input
    shape (``models/graphed.py``), against the eager forward bit for bit;
    the launches its capture counts; the graph kept across weights loaded in
    place (its operands refreshed) and captured again after parameters are
    replaced; event and device times of eager and replay; phase 6's PNGs, which
    the infer CLI served from graphs, against an eager stream of the same
    frames; ``python -m m2trans_tpu_torch.bench``. Returns the launches
    counted in the captures of the flagship shape."""
    import numpy as np
    import torch
    from PIL import Image

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.graphed import (
        COUNTED,
        GraphedForward,
        serving_forward,
    )
    from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
    from m2trans_tpu_torch.parallel.streaming import StreamingSR
    from m2trans_tpu_torch.train.checkpoint import load_params_any

    kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    model = init_m2trans(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(22)
    xs = {shape: torch.rand(shape, generator=gen).to(dev)
          for shape in ((8, 96, 96, 3), (1, 512, 512, 3), (1, 256, 256, 3))}
    parts, times = [], {}
    launches = None
    with torch.inference_mode():
        for u8 in (False, True):
            gf = GraphedForward(model, cfg, kern, output_u8=u8)
            for shape in ((8, 96, 96, 3), (1, 512, 512, 3)):
                x = xs[shape]
                for f in COUNTED.values():
                    f.launches = 0
                got = gf(x).clone()
                counted = {k: f.launches for k, f in COUNTED.items()}
                want = serving_forward(model, x, cfg, kern, u8)
                need(gf.captures == 1 + (shape[0] == 1), f"captures {gf.captures}")
                need(gf.capture_launches[shape] == {"cftm_branch": 32, "ff_conv": 8,
                                                    "tail_band": 1},
                     f"launches in the capture of {shape}: "
                     f"{gf.capture_launches[shape]}")
                # the side-stream run and the capture; a replay counts none
                need(counted == {k: 2 * n for k, n in gf.capture_launches[shape].items()},
                     f"launches around the first call of {shape}: {counted}")
                need(got.dtype == want.dtype and torch.equal(got, want),
                     f"replay vs eager {shape} u8={u8}: max "
                     f"{errs(got, want)[0]}")
                need(torch.equal(gf(x), want), f"second replay {shape} u8={u8}")
                if shape[0] == 8 and not u8:
                    launches = gf.capture_launches[shape]
                    need(torch.isfinite(got).all().item(), "replay not finite")
            parts.append(f"u8={u8} 8x96x96 and 1x512x512 equal")
        # the f32 policy (TF32 off inside the captured forward)
        gf32 = GraphedForward(model, cfg, ComputePolicy())
        x = xs[(1, 256, 256, 3)]
        got = gf32(x).clone()
        want = serving_forward(model, x, cfg, ComputePolicy(), False)
        f32_max = errs(got, want)[0]
        need(torch.equal(got, want), f"f32 replay vs eager at 1x256x256: max {f32_max}")
        parts.append("f32 1x256x256 equal")
        # weights loaded in place after capture: the graph is kept, its
        # operands refreshed in place; parameters replaced: captured again
        gf = GraphedForward(model, cfg, kern)
        x = xs[(8, 96, 96, 3)]
        before = gf(x).clone()
        model.load_state_dict(init_m2trans(cfg, seed=1, device=dev).state_dict())
        got = gf(x).clone()
        want = serving_forward(model, x, cfg, kern, False)
        need(gf.captures == 1 and gf.refreshes == 1 and torch.equal(got, want)
             and not torch.equal(got, before),
             f"after load_state_dict: captures {gf.captures}, refreshes "
             f"{gf.refreshes}, replay vs fresh eager max {errs(got, want)[0]}")
        model.load_state_dict(init_m2trans(cfg, seed=0, device=dev).state_dict(),
                              assign=True)
        got = gf(x).clone()
        want = serving_forward(model, x, cfg, kern, False)
        need(gf.captures == 2 and torch.equal(got, want),
             f"after load_state_dict(assign=True): captures {gf.captures}, replay "
             f"vs fresh eager max {errs(got, want)[0]}")
        parts.append("kept across load_state_dict in place (operands refreshed), "
                     "recaptured after assign=True, equal to fresh eager")
        # the memory the two graphs of one runner hold: reserved by the
        # allocator before and after their captures, its free cache released
        del gf, gf32
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = [torch.cuda.memory_reserved()]
        gf = GraphedForward(model, cfg, kern)
        for shape in ((8, 96, 96, 3), (1, 512, 512, 3)):
            gf(xs[shape])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        for shape in ((8, 96, 96, 3), (1, 512, 512, 3)):
            x = xs[shape]
            times[shape] = (
                time_ms(lambda: serving_forward(model, x, cfg, kern, False)),
                time_ms(lambda: gf(x)),
                device_ms(lambda: serving_forward(model, x, cfg, kern, False)),
                device_ms(lambda: gf(x)))
    print("phase 22 graphed forward, replay vs eager bit for bit: "
          + "; ".join(parts) + f"; launches in one capture {launches}; ms a "
          "forward (events, median of 20 | device time from the profiler), eager "
          "vs replay: " + "; ".join(
              f"{'x'.join(map(str, k[:3]))} {v[0]:.3f} | {fmt_ms(v[2])} vs "
              f"{v[1]:.3f} | {fmt_ms(v[3])}" for k, v in times.items())
          + f"; memory_reserved MiB before / after capturing 8x96x96 and "
          f"1x512x512 {reserved[0] / 2**20:.1f} / {reserved[1] / 2**20:.1f}")

    # phase 6's PNGs, served by the infer CLI from graphs, against an eager
    # stream of the same frames through the model as the CLI loads it
    pt, frames = os.path.join(serve, "model_x4.pt"), os.path.join(serve, "frames")
    cli_cfg = load_config(os.path.join(ROOT, CONFIG), overrides={"model_path": pt})
    eager = StreamingSR(load_params_any(pt, cli_cfg, device=dev), cli_cfg,
                        depth=1, graphs=False)
    need(eager.graphed is None, "StreamingSR(graphs=False) made a graph")
    names = sorted(os.listdir(frames))
    lr = []
    for name in names:
        with Image.open(os.path.join(frames, name)) as img:
            lr.append(np.asarray(img.convert("RGB"), np.float32)[None] / 255.0)
    for name, sr in zip(names, eager.stream(lr)):
        want = np.clip(sr[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        for depth in (1, 2):
            with Image.open(os.path.join(serve, f"out_{depth}", name)) as img:
                need(np.array_equal(np.asarray(img), want),
                     f"infer --depth {depth} {name}: graphed PNG != eager stream")
    print(f"phase 22 infer CLI (phase 6, graphs, depth 1 and 2): its {len(names)} "
          f"PNGs equal an eager StreamingSR(graphs=False) run's")

    res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    need(res.returncode == 0, f"bench exited {res.returncode}:\n{res.stderr}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    need(line.get("method") == "cuda_graph_slope" and line.get("value", 0) > 0
         and line.get("baseline_mps", 0) > 0, f"bench line {line}")
    print(json.dumps(line))
    return launches


TRAIN_KINDS = ("L1 bf16 + kernels", "f32 (shipped yml)", "recipe (MedCLIP f32)")


def host_ms(fn, labels, n: int = 5) -> dict:
    """Host ms a call of ``fn`` spends in each ``record_function`` label,
    from torch.profiler's CPU view over ``n`` calls (after one warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    got = {ev.key: ev.cpu_time_total / 1e3 / n for ev in prof.key_averages()}
    return {k: got.get(k) for k in labels}


def graphed_train_phase(dev, lr_b, hr_b, work) -> dict:
    """Phase 23: the train step replayed from a CUDA graph
    (``train/graphed.py``) at full width, against the eager step: the x4
    L1 step in bf16 with the kernels (cutmix, cutout and input noise on,
    drawn anew each step outside the graph), the shipped yml's f32 step and
    the recipe's step (MedCLIP at its published width, f32, seeded;
    ``lambda_clip`` 0.01), 3 steps each, losses, parameters and Adam's
    state bit for bit (or, where two eager runs differ, within PERF.md §2's
    bound); the launches a capture counts; event and device ms eager vs
    replay and the host ms of the augmentations and of the device part;
    ``memory_reserved`` around the captures; the Trainer's steps/s with and
    without graphs and the train CLI's; then the eval forward's graphs:
    the eval split into reads, forward and metrics a frame, eager and
    replayed, the capture's cost, a validation after the weights moved,
    and ``python -m m2trans_tpu_torch.test``'s lines against the eager
    evaluation's. Returns the launches counted in the L1 step's capture."""
    import numpy as np
    import torch
    import yaml

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.data.pipeline import create_datasets
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.metrics import fsim, gmsd, sr_eval_metrics
    from m2trans_tpu_torch.models.m2trans import (
        init_m2trans,
        m2trans_apply,
        policy_from_config,
    )
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.train.convert import reference_state_dict
    from m2trans_tpu_torch.train.evaluate import eval_runner, evaluate_all
    from m2trans_tpu_torch.train.graphed import COUNTED, LOSS_NAMES
    from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step

    t0 = time.perf_counter()
    ship = load_config(os.path.join(ROOT, "configs", "M2Trans_x4.yml"))
    aug = dict(cutmix=True, data_add_noise=True)
    mcfg = MedCLIPConfig()
    fn = SemanticLossFn(init_medclip(mcfg, seed=4, device=dev), mcfg,
                        word_tokenizer(mcfg.text.vocab_size))
    trng = np.random.default_rng(23)
    ids = trng.integers(5, mcfg.text.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    ids[1, 31:] = mask[1, 31:] = 0
    caps = {"input_ids": ids, "attention_mask": mask}
    kinds = {TRAIN_KINDS[0]: (ship.replace(dtype="bfloat16", use_pallas=True, **aug), None),
             TRAIN_KINDS[1]: (ship, None),
             TRAIN_KINDS[2]: (ship.replace(dtype="bfloat16", use_pallas=True,
                                           lambda_clip=0.01, **aug), fn)}

    def make(c, f, graphs):
        m = init_m2trans(c, seed=0, device=dev)
        opt = make_optimizer(c, m)
        return m, opt, make_train_step(c, m, opt, f, graphs=graphs)

    def call(st, f, rng):
        return st(lr_b, hr_b, captions=caps if f is not None else None, rng=rng,
                  do_cutout=True)

    def three(c, f, graphs):
        """3 steps from init seed 0: [losses, *parameters, *Adam's state]."""
        m, opt, st = make(c, f, graphs)
        losses = []
        for i in range(3):
            aux = call(st, f, np.random.default_rng(230 + i))
            losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
        torch.cuda.synchronize()
        flat = [torch.stack(losses)] + [p.detach().clone() for p in m.parameters()] + [
            v.clone() for p in m.parameters() if p in opt.state
            for v in opt.state[p].values()]
        return flat, st

    checks, times, capture_launches, reserved = {}, {}, {}, {}
    for name, (c, f) in kinds.items():
        eager, _ = three(c, f, False)
        again, _ = three(c, f, False)
        for g in COUNTED.values():
            g.launches = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        graphed, st = three(c, f, True)
        torch.cuda.empty_cache()
        reserved[name] = (r0, torch.cuda.memory_reserved())
        counted = {k: g.launches for k, g in COUNTED.items()}
        runner = st.graphed
        need(runner is not None and (runner.captures, runner.replays) == (1, 3),
             f"{name}: graphs {runner and (runner.captures, runner.replays)}")
        (launches,) = runner.capture_launches.values()
        k = int(c.use_pallas)
        want = {"cftm_branch": 32 * k, "ff_conv": 8 * k, "tail_band": k,
                "cftm_branch_bwd": 32 * k, "tail_band_bwd": k}
        need(launches == want, f"{name}: a capture counted {launches}, want {want}")
        need(counted == {key: 2 * v for key, v in launches.items()},
             f"{name}: launches around the capture {counted} (the side-stream "
             "step and the capture; a replay counts none)")
        need(all(torch_isfinite(t) for t in graphed), f"{name}: not finite")
        exact = all(torch.equal(a, b) for a, b in zip(eager, again))
        if exact:
            diff = [i for i, (a, b) in enumerate(zip(graphed, eager)) if not torch.equal(a, b)]
            need(not diff, f"{name}: replay differs from eager in {len(diff)} tensors "
                 f"(first {diff[:3]}), eager runs agree")
            checks[name] = "bit for bit"
        else:  # each parameter's update over the 3 steps, replay vs eager
            init = [p.detach() for p in init_m2trans(c, seed=0, device=dev).parameters()]
            worst = max(rel_l2(a - p0, b - p0) for a, b, p0 in zip(
                graphed[1:], eager[1:], init) if bool((b - p0).any()))
            need(worst <= STEP_TOL, f"{name}: two eager runs differ, and the replay's "
                 f"updates are {worst:.3g} from eager's (> {STEP_TOL})")
            checks[name] = f"eager itself not deterministic; updates within rel L2 {worst:.3g}"
        capture_launches[name] = launches
        m, opt, st_e = make(c, f, False)
        m2, opt2, st_g = make(c, f, True)
        rng_e, rng_g = np.random.default_rng(5), np.random.default_rng(5)
        times[name] = {
            "event": (time_ms(lambda: call(st_e, f, rng_e), n=20),
                      time_ms(lambda: call(st_g, f, rng_g), n=20))}
        del m, opt, st_e, m2, opt2, st_g
    # the profiler after every event timing (it slows later launches)
    labels = ("m2t::augment", "m2t::device_step")
    for name, (c, f) in kinds.items():
        m, opt, st_e = make(c, f, False)
        m2, opt2, st_g = make(c, f, True)
        rng_e, rng_g = np.random.default_rng(6), np.random.default_rng(6)
        times[name]["device"] = (profile_call(lambda: call(st_e, f, rng_e)),
                                 profile_call(lambda: call(st_g, f, rng_g)))
        times[name]["host"] = (host_ms(lambda: call(st_e, f, rng_e), labels),
                               host_ms(lambda: call(st_g, f, rng_g), labels))
        del m, opt, st_e, m2, opt2, st_g
    print("phase 23 graphed train step x4 (n_feats 64, 8 blocks), 2x96x96 -> 384x384, "
          "3 steps replay vs eager: " + "; ".join(f"{k} {v}" for k, v in checks.items())
          + f"; launches in one capture {capture_launches[TRAIN_KINDS[0]]} (f32: none); "
          "memory_reserved MiB before / after model, Adam and capture "
          + ", ".join(f"{k} {a / 2**20:.1f} / {b / 2**20:.1f}" for k, (a, b) in reserved.items())
          + "; ms a step, events median of 20 | device (profiler) | kernels, eager vs "
          "replay: " + "; ".join(
              f"{k} {v['event'][0]:.3f} | {fmt_ms(v['device'][0]['ms'])} | "
              f"{v['device'][0]['launches']} vs {v['event'][1]:.3f} | "
              f"{fmt_ms(v['device'][1]['ms'])} | {v['device'][1]['launches']}"
              for k, v in times.items())
          + "; host ms a step (profiler CPU view) augment / device part, eager vs "
          "replay: " + "; ".join(
              f"{k} " + " / ".join(fmt_ms(v['host'][0][lab]) for lab in labels) + " vs "
              + " / ".join(fmt_ms(v['host'][1][lab]) for lab in labels)
              for k, v in times.items()))

    # the Trainer with and without graphs, and the train CLI (graphs)
    steps_s = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_us1k_tree(os.path.join(tmp, "data"), np.random.default_rng(23))
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as fh:
            ycfg = yaml.safe_load(fh)
        ycfg.update(dtype="bfloat16", use_pallas=True, data_path=os.path.join(tmp, "data"),
                    train_range=[1, 4], data_repeat=32, epochs=1, log_every=8,
                    test_every=2, eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"),
                    threads=2)
        yml = os.path.join(tmp, "train.yml")
        with open(yml, "w") as fh:
            yaml.dump(ycfg, fh)

        def rate(text):  # steps/s over the log lines after the first
            secs = [float(ln.rsplit("time: ", 1)[1]) for ln in text.splitlines()
                    if ln.startswith("Epoch:")]
            need(len(secs) == 6, f"train log lines {secs}")
            return 8 * len(secs[1:]) / sum(secs[1:])

        for graphs in (False, True):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer = Trainer(load_config(yml), device=dev, graphs=graphs)
                trainer.run()
                sys.stdout.log.close()
            steps_s[f"Trainer graphs={graphs}"] = rate(buf.getvalue())
        res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.train",
                              "--config", yml], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        need(res.returncode == 0, f"train CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
        steps_s["train CLI (graphs)"] = rate(res.stdout)
    print("phase 23 steps/s (x4 bf16 + kernels, 2x96x96 -> 384x384, C++ loader, the "
          "log lines 2-6 of 8 steps): " + ", ".join(f"{k} {v:.2f}" for k, v in steps_s.items()))

    # the eval forward's graphs: the split a frame, eager and replayed
    eval_shapes = [(128, 128)] * 6 + [(100, 76)] * 2
    out = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_benchmark_tree(os.path.join(tmp, "data"), np.random.default_rng(24),
                             eval_shapes)
        with open(os.path.join(ROOT, CONFIG)) as fh:
            ycfg = yaml.safe_load(fh)
        ycfg.update(data_path=os.path.join(tmp, "data"), eval_sets=["CCA-US"])
        yml = os.path.join(tmp, "test.yml")
        with open(yml, "w") as fh:
            yaml.dump(ycfg, fh)
        model = init_m2trans(load_config(yml), seed=0, device=dev)
        pt = os.path.join(tmp, "model_x4.pt")
        torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
        for dtype in ("float32", "bfloat16"):
            cfg = load_config(yml, overrides={
                "model_path": pt, "dtype": dtype,
                "use_pallas": True if dtype == "bfloat16" else None})
            t1 = time.perf_counter()
            _, sets = create_datasets(cfg, train=False)
            reads = (time.perf_counter() - t1) / len(eval_shapes)
            policy = policy_from_config(cfg)
            runner = eval_runner(model, cfg, policy)
            split = {"reads": reads, "forward eager": [], "forward replay": [],
                     "capture": [], "metrics": []}
            with torch.inference_mode():
                for lr, hr, _ in sets[0]["dataset"]:
                    lr_t, hr_t = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    m2trans_apply(model, lr_t, cfg, policy)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    before = runner.captures
                    sr = runner(lr_t)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    fsim(hr_t, sr, data_range=cfg.rgb_range)
                    gmsd(hr_t, sr, data_range=cfg.rgb_range)
                    m = sr_eval_metrics(sr, hr_t, scale=cfg.scale, colors=cfg.colors,
                                        rgb_range=cfg.rgb_range)
                    float(m["psnr"])
                    t4 = time.perf_counter()
                    split["forward eager"].append(t2 - t1)
                    split["capture" if runner.captures > before else "forward replay"
                          ].append(t3 - t2)
                    split["metrics"].append(t4 - t3)
            for k in ("forward eager", "forward replay", "metrics"):
                split[k] = statistics.median(split[k][1:] or split[k])
            split["capture"] = statistics.mean(split["capture"])
            # whole evaluations: eager, replayed (graphs already captured), and
            # after the weights moved in place (a validation in training: the
            # kept operands refreshed, nothing captured)
            whole = {}
            for label, graphs in (("eager", False), ("replay", True)):
                t1 = time.perf_counter()
                res_eval = evaluate_all(model, cfg, sets, full_metrics=True, graphs=graphs)
                torch.cuda.synchronize()
                whole[label] = (time.perf_counter() - t1) / len(eval_shapes)
                out.setdefault(dtype, {})[label] = res_eval
            need(out[dtype]["eager"] == out[dtype]["replay"],
                 f"eval {dtype}: graphs {out[dtype]['replay']} vs eager {out[dtype]['eager']}")
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0)  # a write in place: the operands are refreshed
            t1 = time.perf_counter()
            evaluate_all(model, cfg, sets, full_metrics=True)
            torch.cuda.synchronize()
            whole["after a weight write (no capture)"] = (
                time.perf_counter() - t1) / len(eval_shapes)
            res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.test", "--config",
                                  yml, "--model_path", pt, "--dtype", dtype], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
            need(res.returncode == 0, f"eval CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
            e = out[dtype]["eager"]["CCA-US"]
            want = (f"[CCA-US-X4] PSNR:{e['psnr']:.2f},SSIM:{e['ssim']:.4f}\n"
                    f"FSIM:{e['fsim']:.4f},GMSD:{e['gmsd']:.4f}\n")
            need(res.stdout == want, f"eval CLI {dtype} (graphs) printed {res.stdout!r}, "
                 f"the eager evaluation {want!r}")
            out[dtype]["split"], out[dtype]["whole"] = split, whole
    print("phase 23 eval x4, 8 frames (6x 128x128, 2x 100x76 LR), FSIM/GMSD, s/frame "
          "(host clock, synchronised): " + "; ".join(
              f"{d} reads {v['split']['reads']:.4f}, forward eager "
              f"{v['split']['forward eager']:.4f} vs replay {v['split']['forward replay']:.4f} "
              f"(a capture {v['split']['capture']:.4f}), metrics {v['split']['metrics']:.4f}; "
              "whole evaluation " + ", ".join(f"{k} {s:.4f}" for k, s in v['whole'].items())
              for d, v in out.items())
          + "; python -m m2trans_tpu_torch.test (graphs) prints the eager evaluation's "
          f"lines; phase 23 in {time.perf_counter() - t0:.1f} s")
    return capture_launches[TRAIN_KINDS[0]]


def graphed_aug_eval_phase(dev, lr_b, hr_b, work) -> dict:
    """Phase 24: the augmentations inside the train step's graph, the
    validation graphs that outlive Adam's updates and the metrics graphs.
    (a) The x4 L1 step in bf16 with the kernels and the recipe's step
    (MedCLIP f32), cutmix, cutout and noise applied inside the graph from
    their packed draws, 8 steps (cutout in the first 6: two graphs), replay
    against eager bit for bit (losses, parameters, Adam's state), how often
    each augmentation fired, and 32 / 8 / 1 / 32 / 1 launches a capture;
    (b) host ms of ``m2t::augment`` (``m2t::wait`` inside it: the staging
    ring waiting for the device) and of the graphed device part, and event
    ms a step; (c) the ``Trainer`` for 3 epochs with ``test_every`` 1 on a
    set of two frame shapes (and its training panel), bf16 with the kernels
    and f32: epochs 2 and 3 capture nothing, each validation equals an
    eager validation of the same weights, the validation's s/frame by
    epoch and split into copy-in, forward and metrics, ``memory_reserved``;
    (d) the metrics graphs' per-frame rows against the eager rows (bit for
    bit, else within 1e-6 relative). Returns the launches counted in the
    L1 step's captures."""
    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.data.augment import draw_augment
    from m2trans_tpu_torch.data.pipeline import create_datasets
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.metrics import frame_metrics
    from m2trans_tpu_torch.models.m2trans import init_m2trans, policy_from_config
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.train.evaluate import eval_runner, evaluate_all, metrics_runner
    from m2trans_tpu_torch.train.graphed import COUNTED, LOSS_NAMES
    from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step
    from m2trans_tpu_torch.utils.staging import HostStager

    t0 = time.perf_counter()
    ship = load_config(os.path.join(ROOT, "configs", "M2Trans_x4.yml"))
    aug = dict(cutmix=True, data_add_noise=True, dtype="bfloat16", use_pallas=True)
    mcfg = MedCLIPConfig()
    fn = SemanticLossFn(init_medclip(mcfg, seed=4, device=dev), mcfg,
                        word_tokenizer(mcfg.text.vocab_size))
    trng = np.random.default_rng(24)
    ids = trng.integers(5, mcfg.text.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    ids[1, 40:] = mask[1, 40:] = 0
    caps = {"input_ids": ids, "attention_mask": mask}
    kinds = {TRAIN_KINDS[0]: (ship.replace(**aug), None),
             TRAIN_KINDS[2]: (ship.replace(lambda_clip=0.01, **aug), fn)}
    cut = int(0.1 * ship.patch_size // ship.scale)
    steps = 8

    def fired(base):  # steps in which cutmix, cutout and the noise fired
        n = {"cutmix": 0, "cutout": 0, "noise": 0}
        for i in range(steps):
            (mix, holes, noise, _), _ = draw_augment(
                np.random.default_rng(base + i), 2, 96, 96, cutmix=True,
                cutout_len=cut if i < 6 else None, noise=True)
            n["cutmix"] += int(mix[..., 0].any())
            n["cutout"] += int(holes is not None and holes[..., 0].any())
            n["noise"] += int(noise[0] != 0)
        return n

    base = next(b for b in range(240, 400, steps) if min(fired(b).values()) > 0)

    def make(c, f, graphs):
        m = init_m2trans(c, seed=0, device=dev)
        opt = make_optimizer(c, m)
        return m, opt, make_train_step(c, m, opt, f, graphs=graphs)

    def run_steps(c, f, graphs):
        m, opt, st = make(c, f, graphs)
        losses = []
        for i in range(steps):
            aux = st(lr_b, hr_b, captions=caps if f is not None else None,
                     rng=np.random.default_rng(base + i), do_cutout=i < 6)
            losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
        torch.cuda.synchronize()
        return [torch.stack(losses)] + [p.detach().clone() for p in m.parameters()] + [
            v.clone() for p in m.parameters() if p in opt.state
            for v in opt.state[p].values()], st

    checks, launches_l1, host, events = {}, None, {}, {}
    labels = ("m2t::augment", "m2t::wait", "m2t::device_step")
    for name, (c, f) in kinds.items():
        eager, _ = run_steps(c, f, False)
        again, _ = run_steps(c, f, False)
        for g in COUNTED.values():
            g.launches = 0
        graphed, st = run_steps(c, f, True)
        counted = {k: g.launches for k, g in COUNTED.items()}
        runner = st.graphed
        need((runner.captures, runner.replays) == (2, steps),
             f"{name}: captures / replays {(runner.captures, runner.replays)}, want "
             f"(2, {steps}): one graph with cutout, one without")
        want = {"cftm_branch": 32, "ff_conv": 8, "tail_band": 1, "cftm_branch_bwd": 32,
                "tail_band_bwd": 1}
        for key, got in runner.capture_launches.items():
            need(got == want, f"{name}: a capture counted {got}, want {want}")
        need(counted == {k: 2 * 2 * v for k, v in want.items()},
             f"{name}: launches around the two captures {counted} (each the "
             "side-stream step and the capture; a replay counts none)")
        need(all(torch_isfinite(t) for t in graphed), f"{name}: not finite")
        if all(torch.equal(a, b) for a, b in zip(eager, again)):
            diff = [i for i, (a, b) in enumerate(zip(graphed, eager)) if not torch.equal(a, b)]
            need(not diff, f"{name}: replay with the augmentations in the graph differs "
                 f"from eager in {len(diff)} tensors (first {diff[:3]})")
            checks[name] = f"bit for bit over {steps} steps"
        else:
            init = [p.detach() for p in init_m2trans(c, seed=0, device=dev).parameters()]
            worst = max(rel_l2(a - p0, b - p0) for a, b, p0 in zip(
                graphed[1:], eager[1:], init) if bool((b - p0).any()))
            need(worst <= STEP_TOL, f"{name}: updates {worst:.3g} from eager's")
            checks[name] = f"eager not deterministic; updates within rel L2 {worst:.3g}"
        if launches_l1 is None:
            launches_l1 = dict(want)
        m, opt, st_g = make(c, f, True)
        rng = np.random.default_rng(7)

        def call():
            return st_g(lr_b, hr_b, captions=caps if f is not None else None, rng=rng,
                        do_cutout=True)

        events[name] = time_ms(call, n=20)
        host[name] = host_ms(call, labels, n=20)
        del m, opt, st_g
    need(host[TRAIN_KINDS[2]]["m2t::device_step"] < 8.0,
         f"the recipe's graphed device part spends {host[TRAIN_KINDS[2]]} host ms "
         "(with pageable copies it spent 14.8-15.8 ms waiting for the previous step)")
    print(f"phase 24 augmentations in the graph (x4, 2x96x96 -> 384x384, {steps} steps, "
          f"cutout in the first 6, draws from seeds {base}..{base + steps - 1}, fired "
          f"{fired(base)}): replay vs eager " + "; ".join(f"{k} {v}" for k, v in checks.items())
          + f"; a capture counts {launches_l1}; host ms a step (profiler CPU view, 20 "
          "steps) augment / of it wait / device part: " + "; ".join(
              f"{k} " + " / ".join(fmt_ms(v[lab]) for lab in labels)
              for k, v in host.items())
          + "; event ms a step (median of 20): " + "; ".join(
              f"{k} {v:.3f}" for k, v in events.items()))

    # (c), (d): validations of a training run, and the metrics graphs
    eval_hr = [(128, 96), (96, 160)]
    lines = []
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        data = os.path.join(tmp, "data")
        write_us1k_tree(data, np.random.default_rng(24), eval_hr=eval_hr[0])
        img = np.random.default_rng(25).integers(0, 256, (*eval_hr[1], 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(data, "benchmark/UI5/HR/b1.jpg"))
        Image.fromarray(img[::4, ::4]).save(os.path.join(data, "benchmark/UI5/LR_bicubic/X4/b1x4.jpg"))
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as fh:
            ycfg = yaml.safe_load(fh)

        class Writer:  # the panels reach the writer; the training panel replays
            def add_image(self, *a, **k):
                pass

            def add_scalar(self, *a, **k):
                pass

        for dtype in ("bfloat16", "float32"):
            ycfg.update(dtype=dtype, use_pallas=dtype == "bfloat16", data_path=data,
                        train_range=[1, 4], data_repeat=8, epochs=3, log_every=4,
                        test_every=1, eval_sets=["CCA-US"], threads=2,
                        log_path=os.path.join(tmp, f"exp_{dtype}"))
            yml = os.path.join(tmp, f"train_{dtype}.yml")
            with open(yml, "w") as fh:
                yaml.dump(ycfg, fh)
            cfg = load_config(yml)
            buf = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            with contextlib.redirect_stdout(buf):
                trainer = Trainer(cfg, device=dev, writer=Writer())
                policy = policy_from_config(cfg)
                fwd, met = eval_runner(trainer.model, cfg, policy), metrics_runner(
                    trainer.model, cfg, False)
                n_frames = len(trainer.eval_sets[0]["dataset"])
                record, validate = [], trainer._validate

                def recorded(epoch):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    validate(epoch)
                    torch.cuda.synchronize()
                    secs = (time.perf_counter() - t1) / n_frames
                    record.append((fwd.captures, met.captures, fwd.refreshes, secs,
                                   trainer.stat_dict["CCA-US"]["psnrs"][-1],
                                   trainer.stat_dict["CCA-US"]["ssims"][-1],
                                   evaluate_all(trainer.model, cfg, trainer.eval_sets,
                                                graphs=False)["CCA-US"]))

                trainer._validate = recorded
                for g in COUNTED.values():
                    g.launches = 0
                trainer.run()
                counted = {k: g.launches for k, g in COUNTED.items()}
                sys.stdout.log.close()
            torch.cuda.synchronize()
            r1 = torch.cuda.memory_reserved()
            need(len(record) == 3, f"{dtype}: {len(record)} validations")
            caps0 = record[0][:2]
            need(all(r[:2] == caps0 for r in record[1:]),
                 f"{dtype}: validations of epochs 2 and 3 captured "
                 f"{[r[:2] for r in record]} (forward, metrics captures after each)")
            need(caps0 == (len(eval_hr) + 1, len(eval_hr)),
                 f"{dtype}: the first validation left {caps0} captures, want "
                 f"{len(eval_hr)} + the panel's shape and {len(eval_hr)}")
            for r in record:
                need((r[4], r[5]) == (r[6]["psnr"], r[6]["ssim"]),
                     f"{dtype}: validation {r[4:6]} vs an eager validation of the "
                     f"same weights {r[6]}")
            k = int(dtype == "bfloat16")
            need(all(v > 0 for v in counted.values()) if k else not any(counted.values()),
                 f"{dtype}: kernel launches in the Trainer's run {counted}")
            val_lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[CCA-US")]
            need(len(val_lines) == 3 and all(
                ln.startswith(f"[CCA-US-X4], PSNR/SSIM: {r[6]['psnr']:.4f}/{r[6]['ssim']:.4f} ")
                for ln, r in zip(val_lines, record)), f"{dtype}: printed {val_lines}")
            # the split a frame, the graphs captured: copy-in, forward, metrics
            model, ds = trainer.model, trainer.eval_sets[0]["dataset"]
            stager, split = HostStager(dev), {"copy-in": [], "forward": [], "metrics": []}
            full = metrics_runner(model, cfg, True)
            worst = 0.0
            with torch.inference_mode():
                for rep in range(3):
                    for lr, hr, _ in ds:
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        lr_t, hr_t = stager.stage([lr, hr])
                        torch.cuda.synchronize()
                        t2 = time.perf_counter()
                        sr = fwd(lr_t)
                        torch.cuda.synchronize()
                        t3 = time.perf_counter()
                        row = met(sr, hr_t)
                        torch.cuda.synchronize()
                        t4 = time.perf_counter()
                        if rep:
                            for key, t in (("copy-in", t2 - t1), ("forward", t3 - t2),
                                           ("metrics", t4 - t3)):
                                split[key].append(t)
                        for runner_m, fm in ((met, False), (full, True)):
                            got = runner_m(sr, hr_t).clone()
                            want = frame_metrics(sr.clone(), hr_t, scale=cfg.scale,
                                                 colors=cfg.colors, rgb_range=cfg.rgb_range,
                                                 full_metrics=fm)
                            if not torch.equal(got, want):
                                rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)
                                             ).max())
                                worst = max(worst, rel)
                        del row
            need(worst <= 1e-6, f"{dtype}: metrics graph vs eager rows differ by "
                 f"{worst:.3g} relative (> 1e-6)")
            need(fwd.eager_calls == 0 and met.eager_calls == 0 and full.eager_calls == 0,
                 f"{dtype}: eager calls {fwd.eager_calls}, {met.eager_calls}, "
                 f"{full.eager_calls}")
            t1 = time.perf_counter()
            create_datasets(cfg, train=False)
            reads = (time.perf_counter() - t1) / n_frames
            lines.append(
                f"{dtype}: validation s/frame epoch 1 (captures) {record[0][3]:.4f}, "
                f"epochs 2 / 3 {record[1][3]:.4f} / {record[2][3]:.4f}; captures after "
                f"each (forward, metrics) {[r[:2] for r in record]}, operand refreshes "
                f"{record[-1][2]}; split s/frame (median, replays) reads at set-up "
                f"{reads:.4f}, " + ", ".join(
                    f"{key} {statistics.median(v):.4f}" for key, v in split.items())
                + "; metrics rows graph vs eager "
                + ("bit for bit" if worst == 0.0 else f"max rel {worst:.3g}")
                + f"; PSNR/SSIM {[r[4:6] for r in record]} = eager; kernel launches in "
                f"the run {counted}; memory_reserved MiB {r0 / 2**20:.1f} -> "
                f"{r1 / 2**20:.1f}")
            del trainer, model, fwd, met, full
    print("phase 24 Trainer x4 3 epochs, test_every 1, CCA-US of 2 shapes (LR 32x24, "
          "24x40), the training panel through the eval runner: " + "; ".join(lines)
          + f"; phase 24 in {time.perf_counter() - t0:.1f} s")
    return launches_l1


def tools_phase() -> dict:
    """Phases 25-30: the measurement tools of ``m2trans_tpu_torch/tools/``
    through their entry points, each at a short setting, each printing its
    JSON line and its seconds: (25) the single-frame latency at 96x96 and
    512x512, 64 frames a size and output; (26) x4 / x3 / x2 at 384x384
    output, one chain pair each; (27) batch 64 at micro-batch 8 and 64;
    (28) the recipe's step at batch 8, 3 replayed steps bit for bit against
    3 eager steps, and the L1 step so at ``--scale 2`` and ``--scale 3``;
    (29) the roofline of the x4 forward and the L1 step;
    (30) the train CLI for one epoch of the whole recipe on 4 training
    images, through the port's tokenizer and a release-format
    ``pytorch_model.bin`` written by ``medclip_release_state_dict``. The
    kernel wrappers' counts are set to 0 just before each tool and read
    just after, and each kernel of the tool's path must have launched (the
    train CLI's launches are its own process's). Returns those counts by
    tool."""
    import math

    from m2trans_tpu_torch.tools import (
        bench_batch64,
        bench_clip_train,
        bench_latency,
        bench_scales,
        roofline,
        train_full_recipe,
    )
    from m2trans_tpu_torch.train.graphed import COUNTED

    def positive(v) -> bool:
        return isinstance(v, (int, float)) and math.isfinite(v) and v > 0

    fwd_want = {"cftm_branch": 32, "ff_conv": 8, "tail_band": 1}
    counts = {}

    def drive(phase, name, tool, args, kernels):
        for f in COUNTED.values():
            f.launches = 0
        t0 = time.perf_counter()
        line = tool.main(args)
        counts[name] = {k: f.launches for k, f in COUNTED.items()}
        need(all(counts[name][k] > 0 for k in kernels),
             f"phase {phase} {name}: launches {counts[name]}, want each of {kernels}")
        need(line.get("device") and line.get("power_limit_w"),
             f"phase {phase} {name}: no card in {line}")
        print(f"phase {phase} {name}: {time.perf_counter() - t0:.1f} s, launches "
              f"{counts[name]}")
        return line

    fwd = ("cftm_branch", "ff_conv", "tail_band")
    lat = drive(25, "bench_latency", bench_latency,
                ["--sizes", "96", "512", "--frames", "64"], fwd)
    for size, entry in lat["sizes"].items():
        for out in ("f32", "u8"):
            e = entry[out]
            need(e["samples"] == 64 and all(positive(e[f"p{q}_ms"]) for q in (50, 90, 99))
                 and e["captures"] == 1 and positive(e["device_ms"]),
                 f"phase 25 {size} {out}: {e}")
        need(positive(entry["device_chain_ms"]), f"phase 25 {size}: {entry}")
    sc = drive(26, "bench_scales", bench_scales, ["--pairs", "1"], fwd)
    for s, entry in sc["scales"].items():
        need(positive(entry["mps"]) and entry["launches"] == fwd_want
             and positive(entry["device_ms"]), f"phase 26 {s}: {entry}")
    b64 = drive(27, "bench_batch64", bench_batch64, ["--micro", "8", "64", "--pairs", "1"],
                fwd)
    for mb, entry in b64["micro_batch"].items():
        chunks = 64 // int(mb)
        need(positive(entry["mps"]) and positive(entry["peak_gib"])
             and entry["launches"] == {k: v * chunks for k, v in fwd_want.items()},
             f"phase 27 micro_batch {mb}: {entry}")
    step = drive(28, "bench_clip_train", bench_clip_train,
                 ["--batches", "8", "--kinds", "recipe-f32", "--pairs", "1"],
                 fwd + ("cftm_branch_bwd", "tail_band_bwd"))
    need(step["replay_vs_eager"] == {"recipe-f32 b8": "bit for bit"},
         f"phase 28: {step['replay_vs_eager']}")
    entry = step["steps"]["recipe-f32 b8"]
    need(positive(entry["ms_queued"]) and positive(entry["device_ms"])
         and all(n == {**fwd_want, "cftm_branch_bwd": 32, "tail_band_bwd": 1}
                 for n in entry["launches_per_capture"]), f"phase 28: {entry}")
    for scale in (2, 3):  # the train step at x2 / x3, HR 384 (LR 192 / 128)
        name = f"bench_clip_train x{scale}"
        step = drive(28, name, bench_clip_train,
                     ["--scale", str(scale), "--batches", "8", "--kinds", "L1",
                      "--pairs", "1"], fwd + ("cftm_branch_bwd", "tail_band_bwd"))
        need(step["metric"] == f"x{scale}_train_step_ms"
             and (step["config"]["scale"], step["config"]["lr_hw"]) == (scale, 384 // scale)
             and step["replay_vs_eager"] == {"L1 b8": "bit for bit"},
             f"phase 28 {name}: {step['metric']}, {step['config']}, "
             f"{step['replay_vs_eager']}")
        entry = step["steps"]["L1 b8"]
        need(positive(entry["ms_queued"]) and positive(entry["device_ms"])
             and all(n == {**fwd_want, "cftm_branch_bwd": 32, "tail_band_bwd": 1}
                     for n in entry["launches_per_capture"]), f"phase 28 {name}: {entry}")
    roof = drive(29, "roofline", roofline, ["--programs", "fwd-x4", "step-L1"],
                 fwd + ("cftm_branch_bwd", "tail_band_bwd"))
    for name, entry in roof["programs"].items():
        need(all(positive(entry[k]) and entry[k] <= 1.0 for k in ("mfu", "hbm_floor_share")),
             f"phase 29 {name}: {entry}")
    full = drive(30, "train_full_recipe", train_full_recipe,
                 ["--epochs", "1", "--n-train", "4"], ())
    need(all(math.isfinite(v) for v in full["train_loss_last_logged_per_epoch"].values())
         and len(full["val_trajectory"]) == 1
         and math.isfinite(full["val_trajectory"][0]["psnr"]), f"phase 30: {full}")
    return counts


SCALES = (2, 3)               # phase 31: the shipped x2 / x3 configurations
SCALE_HR = 384                # their train step's HR side: LR 192 / 128
SCALE_TRAIN_HR = (408, 396)   # US1K training frames, sides multiples of 2 and 3
# eval and validation frames whose HR sides are multiples neither of 2 or 3
# nor of 32 * s: the crop to s x LR and the LR's pad to 32 both act
SCALE_EVAL_HR = ((401, 299), (257, 331))
SCALE_INFER = {"f0.png": (120, 160), "f1.png": (120, 160), "f2.png": (75, 101)}


def start(cmd, log):
    """``cmd`` as a process from the checkout's root, its output in
    ``log``.out / .err."""
    out, err = open(log + ".out", "w"), open(log + ".err", "w")
    return subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err), log, out, err


def finish(started, what, timeout=600) -> str:
    """Wait for a process of :func:`start` and return its output; a process
    still running at ``timeout`` is killed and fails the phase."""
    proc, log, out, err = started
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    out.close()
    err.close()
    with open(log + ".err") as f:
        need(rc == 0, f"{what} exited {rc}:\n{f.read()[-8000:]}")
    with open(log + ".out") as f:
        return f.read()


def scales_phase(dev, work) -> dict:
    """Phase 31: the shipped x2 and x3 configurations at full width
    (``configs/M2Trans_x{2,3}.yml`` and ``_test.yml``: n_feats 64, 8 blocks,
    seeded weights). (a) The train step of the training yml in bf16 with
    the kernels, batch 2 as shipped, LR ``384 // s`` square, cutmix, cutout
    and noise on: 3 replayed steps against 3 eager steps, losses,
    parameters and Adam's state bit for bit (or, where two eager runs
    differ, within PERF.md §2's bound); the launches of a capture equal
    the eager step 1's (32 K1, 8 K3, 1 K2, 32 K1b, 1 K2b); the kernel
    step's gradients against the plain bf16 step's within max(STEP_TOL,
    1.5 e); the shipped f32 yml's step, one, finite, no kernel. (b)
    ``python -m m2trans_tpu_torch.train`` in bf16 with the kernels and the
    augmentations, 2 epochs of 3 steps on a US1K tree with X2 / X3 LR
    folders (the C++ loader), validating on a
    CCA-US set of two frames whose HR sides are no multiple of s: finite
    losses, both validations, each epoch's ``.pt`` loaded back by
    ``load_params_any``. (c) ``python -m m2trans_tpu_torch.test`` with the
    ``_test`` yml and epoch 2's ``.pt`` on the three eval sets of such
    frames: f32 against ``--dtype bfloat16`` within EVAL_TOL, and the
    graphed CLI's lines equal to an eager evaluation's in each dtype. (d)
    ``python -m m2trans_tpu_torch.infer`` on 3 PNGs, one of odd sides:
    outputs s x the input, equal to an eager ``StreamingSR(graphs=False)``
    stream's. The CLIs run as processes beside the in-process checks, so
    the phase times nothing. Returns the launches of a train capture by
    scale."""
    import math

    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from m2trans_tpu_torch import test as eval_cli
    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.data.pipeline import create_datasets
    from m2trans_tpu_torch.models.m2trans import init_m2trans
    from m2trans_tpu_torch.parallel.streaming import StreamingSR
    from m2trans_tpu_torch.train.checkpoint import checkpoint_path, load_params_any
    from m2trans_tpu_torch.train.evaluate import evaluate_all
    from m2trans_tpu_torch.train.graphed import COUNTED, LOSS_NAMES
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    t0 = time.perf_counter()
    fwd_want = {"cftm_branch": 32, "ff_conv": 8, "tail_band": 1}
    step_want = {**fwd_want, "cftm_branch_bwd": 32, "tail_band_bwd": 1}

    def counts():
        return {k: f.launches for k, f in COUNTED.items()}

    def zero():
        for f in COUNTED.values():
            f.launches = 0

    def dump(obj, path):
        with open(path, "w") as f:
            yaml.dump(obj, f)
        return path

    def shipped(s, test=False):
        with open(os.path.join(ROOT, "configs", f"M2Trans_x{s}{'_test' if test else ''}.yml")) as f:
            return yaml.safe_load(f)

    started, lines, capture = [], [], {}
    root = tempfile.mkdtemp(dir=work)
    try:
        # (b) the train CLIs start first and run beside (a)
        train = {}
        for s in SCALES:
            d = os.path.join(root, f"x{s}")
            data = os.path.join(d, "data")
            write_us1k_tree(data, np.random.default_rng(310 + s), hr=SCALE_TRAIN_HR,
                            eval_hr=None, scale=s)
            write_eval_sets(data, np.random.default_rng(320 + s), s, SCALE_EVAL_HR,
                            sets=("UI5",))
            ycfg = shipped(s)
            ycfg.update(dtype="bfloat16", use_pallas=True, cutmix=True, cutout=True,
                        data_add_noise=True, data_path=data, train_range=[1, 4],
                        data_repeat=2, epochs=2, log_every=1, eval_sets=["CCA-US"],
                        log_path=os.path.join(d, "exp"), threads=2)
            yml = dump(ycfg, os.path.join(d, "train.yml"))
            train[s] = start([sys.executable, "-m", "m2trans_tpu_torch.train",
                              "--config", yml], os.path.join(d, "train"))
            started.append(train[s])

        # (a) the train step at full width
        for s in SCALES:
            ship = load_config(os.path.join(ROOT, "configs", f"M2Trans_x{s}.yml"))
            need((ship.scale, ship.n_feats, ship.n_blocks, ship.batch_size, ship.dtype)
                 == (s, 64, 8, 2, "float32"), f"x{s} shipped config {ship}")
            hw = SCALE_HR // s
            gen = torch.Generator().manual_seed(30 + s)
            lr_b = torch.rand(2, hw, hw, 3, generator=gen).to(dev)
            hr_b = torch.rand(2, SCALE_HR, SCALE_HR, 3, generator=gen).to(dev)
            c = ship.replace(dtype="bfloat16", use_pallas=True, cutmix=True,
                             data_add_noise=True)

            def make(cc, graphs):
                m = init_m2trans(cc, seed=0, device=dev)
                opt = make_optimizer(cc, m)
                return m, opt, make_train_step(cc, m, opt, graphs=graphs)

            def run_steps(cc, graphs, n=3):
                """n steps from init seed 0: [losses, *parameters, *Adam's
                state], the step, and the launches of step 1 (eager)."""
                m, opt, st = make(cc, graphs)
                losses, first = [], None
                for i in range(n):
                    aux = st(lr_b, hr_b, rng=np.random.default_rng(310 + i),
                             do_cutout=True)
                    losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
                    if i == 0:
                        torch.cuda.synchronize()
                        first = counts()
                torch.cuda.synchronize()
                flat = [torch.stack(losses)] + [p.detach().clone() for p in m.parameters()] + [
                    v.clone() for p in m.parameters() if p in opt.state
                    for v in opt.state[p].values()]
                return flat, st, first

            zero()
            eager, _, step1 = run_steps(c, False)
            need(step1 == step_want, f"x{s}: eager step 1 launched {step1}, want {step_want}")
            again, _, _ = run_steps(c, False)
            zero()
            graphed, st, _ = run_steps(c, True)
            around = counts()
            runner = st.graphed
            need(runner is not None and (runner.captures, runner.replays) == (1, 3),
                 f"x{s}: graphs {runner and (runner.captures, runner.replays)}")
            (cap,) = runner.capture_launches.values()
            need(cap == step1, f"x{s}: a capture counted {cap}, eager step 1 {step1}")
            need(around == {k: 2 * v for k, v in cap.items()},
                 f"x{s}: launches around the capture {around} (the side-stream step "
                 "and the capture; a replay counts none)")
            need(all(torch_isfinite(t) for t in graphed), f"x{s}: replay not finite")
            if all(torch.equal(a, b) for a, b in zip(eager, again)):
                diff = [i for i, (a, b) in enumerate(zip(graphed, eager))
                        if not torch.equal(a, b)]
                need(not diff, f"x{s}: replay differs from eager in {len(diff)} tensors "
                     f"(first {diff[:3]}), eager runs agree")
                check = "bit for bit"
            else:
                init = [p.detach() for p in init_m2trans(c, seed=0, device=dev).parameters()]
                worst = max(rel_l2(a - p0, b - p0) for a, b, p0 in zip(
                    graphed[1:], eager[1:], init) if bool((b - p0).any()))
                need(worst <= STEP_TOL, f"x{s}: two eager runs differ, and the replay's "
                     f"updates are {worst:.3g} from eager's (> {STEP_TOL})")
                check = f"eager itself not deterministic; updates within rel L2 {worst:.3g}"
            capture[s] = cap
            del eager, again, graphed, st, runner
            grads, loss = {}, {}
            for name, cc in (("kernels", c), ("plain", c.replace(use_pallas=False)),
                             ("f32", c.replace(dtype="float32", use_pallas=False))):
                m, _, st = make(cc, False)
                loss[name] = float(st(lr_b, hr_b, rng=np.random.default_rng(330),
                                      do_cutout=True)["loss"])
                need(math.isfinite(loss[name]), f"x{s} {name}: loss {loss[name]}")
                grads[name] = {n: p.grad for n, p in m.named_parameters() if p.requires_grad}
            worst, worst_name, worst_e = 0.0, "", 0.0
            for name, g in grads["kernels"].items():
                need(g is not None and torch_isfinite(g), f"x{s}: gradient of {name}")
                d = rel_l2(g, grads["plain"][name])
                e = rel_l2(grads["plain"][name], grads["f32"][name])
                need(d <= max(STEP_TOL, 1.5 * e),
                     f"x{s} train step: {name} kernels vs plain bf16 rel L2 {d:.4g} > "
                     f"max({STEP_TOL}, 1.5 * {e:.4g})")
                if d > worst:
                    worst, worst_name, worst_e = d, name, e
            del grads
            zero()
            _, _, st = make(ship, True)
            loss_ship = float(st(lr_b, hr_b)["loss"])
            need(math.isfinite(loss_ship) and not any(counts().values()),
                 f"x{s} shipped f32 step: loss {loss_ship}, launches {counts()}")
            del st
            torch.cuda.empty_cache()
            lines.append(
                f"x{s} train step (2x{hw}x{hw} -> {SCALE_HR}x{SCALE_HR}, bf16 + kernels, "
                f"cutmix / cutout / noise): 3 steps replay vs eager {check}; a capture "
                f"counts {cap} = eager step 1; loss kernels "
                f"{loss['kernels']:.6f} plain bf16 {loss['plain']:.6f} f32 {loss['f32']:.6f}, "
                f"gradients worst rel L2 vs plain bf16 {worst:.4g} ({worst_name}; plain "
                f"bf16 vs f32 {worst_e:.4g}, bound {max(STEP_TOL, 1.5 * worst_e):.4g}); "
                f"the shipped f32 step {loss_ship:.6f}, no kernel")

        # (b) the train CLIs' results; (c), (d) the eval and infer CLIs start
        evals, infers, tests = {}, {}, {}
        for s in SCALES:
            d = os.path.join(root, f"x{s}")
            finish(train[s], f"x{s} train CLI")
            exps = os.listdir(os.path.join(d, "exp"))
            need(len(exps) == 1, f"x{s} experiment dirs {exps}")
            exp = os.path.join(d, "exp", exps[0])
            with open(os.path.join(exp, "log.txt")) as f:
                log = f.read()
            losses = [float(ln.split("loss: ", 1)[1].split(",")[0])
                      for ln in log.splitlines() if ln.startswith("Epoch:")]
            need(len(losses) == 6 and all(math.isfinite(v) for v in losses),
                 f"x{s} train CLI losses {losses}")
            val = [ln for ln in log.splitlines() if ln.startswith(f"[CCA-US-X{s}], PSNR/SSIM: ")]
            need(len(val) == 2, f"x{s} train CLI validations {val}")
            cfg_s = load_config(os.path.join(d, "train.yml"))
            for epoch in (1, 2):
                load_params_any(checkpoint_path(os.path.join(exp, "models"), s, epoch),
                                cfg_s, device=dev)
            pt = checkpoint_path(os.path.join(exp, "models"), s, 2)
            ev = os.path.join(d, "eval")
            write_eval_sets(ev, np.random.default_rng(340 + s), s, SCALE_EVAL_HR)
            ycfg = shipped(s, test=True)
            ycfg.update(data_path=ev, model_path=pt)
            tests[s] = dump(ycfg, os.path.join(d, "test.yml"))
            frames = os.path.join(d, "frames")
            os.makedirs(frames)
            rng = np.random.default_rng(350 + s)
            for name, hw in SCALE_INFER.items():
                Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                    os.path.join(frames, name))
            evals[s] = start([sys.executable, "-m", "m2trans_tpu_torch.test", "--config",
                              tests[s], "--dtype", "bfloat16"], os.path.join(d, "test"))
            infers[s] = start([sys.executable, "-m", "m2trans_tpu_torch.infer", "--config",
                               tests[s], "--input", frames, "--output",
                               os.path.join(d, "sr")], os.path.join(d, "infer"))
            started += [evals[s], infers[s]]
            lines.append(f"x{s} train CLI (bf16 + kernels, the augmentations, C++ loader): "
                         f"2 epochs x 3 steps, losses {losses[0]:.4f} ... {losses[-1]:.4f} "
                         f"finite, model_x{s}_{{1,2}}.pt load back; last: {val[-1].strip()}")

        # (c) f32 in this process through the CLI's main, bf16 from its process;
        # each CLI's lines against an eager evaluation of the same .pt
        for s in SCALES:
            buf = io.StringIO()
            zero()
            with contextlib.redirect_stdout(buf):
                eval_cli.main(["--config", tests[s]])
            need(not any(counts().values()), f"x{s} f32 eval launched {counts()}")
            out = {"float32": buf.getvalue(),
                   "bfloat16": finish(evals[s], f"x{s} eval CLI --dtype bfloat16")}
            cfg = load_config(tests[s])
            model = load_params_any(cfg.model_path, cfg, device=dev)
            _, sets = create_datasets(cfg, train=False)
            need([x["name"] for x in sets] == ["CCA-US", "US-CASE", "US1K_23"]
                 and all(len(x["dataset"]) == len(SCALE_EVAL_HR) for x in sets),
                 f"x{s} eval sets {[(x['name'], len(x['dataset'])) for x in sets]}")
            metrics = {}
            for dtype in out:
                zero()
                eager = evaluate_all(model, load_config(tests[s], overrides={
                    "dtype": dtype, "use_pallas": True if dtype == "bfloat16" else None}),
                    sets, full_metrics=True, graphs=False)
                n = 3 * len(SCALE_EVAL_HR) * int(dtype == "bfloat16")
                need(counts() == {**{k: v * n for k, v in fwd_want.items()},
                                  "cftm_branch_bwd": 0, "tail_band_bwd": 0},
                     f"x{s} eager eval {dtype} launched {counts()}")
                want = "".join(f"[{k}-X{s}] PSNR:{m['psnr']:.2f},SSIM:{m['ssim']:.4f}\n"
                               f"FSIM:{m['fsim']:.4f},GMSD:{m['gmsd']:.4f}\n"
                               for k, m in eager.items())
                need(out[dtype] == want, f"x{s} eval CLI {dtype} (graphs) printed "
                     f"{out[dtype]!r}, an eager evaluation {want!r}")
                metrics[dtype] = eager
            for name, m in metrics["bfloat16"].items():
                for key, val in m.items():
                    tol = EVAL_TOL[0] if key == "psnr" else EVAL_TOL[1]
                    need(abs(val - metrics["float32"][name][key]) <= tol + 1e-9,
                         f"x{s} eval {name} bf16 {key} {val} vs f32 "
                         f"{metrics['float32'][name][key]}: over {tol}")
            lines.append(f"x{s} eval CLI (3 sets x {len(SCALE_EVAL_HR)} frames, HR "
                         f"{SCALE_EVAL_HR}): graphed lines = eager, f32 / bf16 + kernels "
                         + "; ".join(f"{k} {metrics['float32'][k]['psnr']:.4f} / "
                                     f"{metrics['bfloat16'][k]['psnr']:.4f} dB"
                                     for k in metrics["float32"]))
            del model

        # (d) the infer CLI's PNGs against an eager stream of the same frames
        for s in SCALES:
            d = os.path.join(root, f"x{s}")
            report = json.loads(finish(infers[s], f"x{s} infer CLI").strip().splitlines()[-1])
            graphs = report.get("cuda_graphs", {})
            per = graphs.get("launches_per_capture", {})
            shapes = sorted({f"1x{h}x{w}x3" for h, w in SCALE_INFER.values()})
            need(report.get("frames") == len(SCALE_INFER) and graphs.get("captures") == 1
                 and graphs.get("replays") == len(SCALE_INFER)
                 and sorted(per) == shapes and all(v == fwd_want for v in per.values()),
                 f"x{s} infer report {report}")
            cfg = load_config(tests[s])
            eager = StreamingSR(load_params_any(cfg.model_path, cfg, device=dev), cfg,
                                depth=1, graphs=False)
            names = sorted(SCALE_INFER)
            lr = []
            for name in names:
                with Image.open(os.path.join(d, "frames", name)) as img:
                    lr.append(np.asarray(img.convert("RGB"), np.float32)[None] / 255.0)
            for name, sr in zip(names, eager.stream(lr)):
                want = np.clip(sr[0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
                h, w = SCALE_INFER[name]
                with Image.open(os.path.join(d, "sr", name)) as img:
                    got = np.asarray(img)
                need(got.shape == (s * h, s * w, 3), f"x{s} {name}: shape {got.shape}")
                need(np.array_equal(got, want), f"x{s} {name}: graphed PNG != eager stream")
            lines.append(f"x{s} infer CLI: {len(names)} PNGs (LR "
                         + ", ".join(f"{h}x{w}" for h, w in SCALE_INFER.values())
                         + f") -> x{s}, equal to an eager StreamingSR(graphs=False) "
                         f"stream's; p50 {report.get('p50_ms')} ms")
            del eager
    finally:
        for proc, _, out, err in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        shutil.rmtree(root, ignore_errors=True)
    for ln in lines:
        print(f"phase 31 {ln}")
    print(f"phase 31 in {time.perf_counter() - t0:.1f} s")
    return capture


SWIN_BATCH = 6                 # phase 32: the recipe's patches, 2 images x 3
# (map side, channels, heads, shift, blocks) of Swin-tiny's stages at 224
SWIN_STAGES = ((56, 96, 3, 3, 2), (28, 192, 6, 3, 2), (14, 384, 12, 3, 6),
               (7, 768, 24, 0, 2))
# f32 kernels vs plain, every output: max|a - b| <= max(atol, rtol * max|b|)
# (the sums run in another order than cuBLAS's; tests/test_torch_port_cuda.py)
SWIN_TOL = (1e-5, 1e-4)


@contextlib.contextmanager
def plain_swin_attention():
    """MedCLIP's Swin runs the plain version of its window attention, on the
    card too, while the context is open: phase 32's before."""
    from m2trans_tpu_torch.models.medclip import swin
    from m2trans_tpu_torch.ops.kernels.swin_attn import window_attention_plain

    kept = swin.window_attention
    swin.window_attention = window_attention_plain
    try:
        yield
    finally:
        swin.window_attention = kept


def swin_attn_phase(dev) -> dict:
    """Phase 32, MedCLIP's window attention (``csrc/swin_attn.cu``). At each
    stage of the recipe's Swin-tiny (6 patches of 224, f32, seeded
    operands): the kernels against the plain version (output, dq, dk, dv;
    a second run bit for bit); device ms (profiler) of the forward and of
    forward + backward, beside their bound (bytes at 3.35 TB/s or f32 FMAs
    at 67 TFLOP/s, the larger), the plain version's and, as the library
    yardstick only, masked ``scaled_dot_product_attention``'s on windows
    partitioned outside the timing. Then MedCLIP at its published width in
    f32 and bf16, with the kernels and with the plain attention: device ms
    and kernels of the HR-side forward and the SR-side forward + backward;
    and the x2 recipe step (batch 2, LR 192, MedCLIP f32): the kernels'
    launches (36 an eager step, 36 a capture, none a replay), event and
    device ms of a replay, kernels a replay. Returns the kernel report's
    row."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from m2trans_tpu_torch.losses.semantic import (
        SemanticLossFn,
        clip_image_sims,
        clip_text_embed,
        crop_offsets,
        semantic_loss_staged,
    )
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
    from m2trans_tpu_torch.ops.kernels.swin_attn import (
        relative_position_index,
        shift_attn_mask,
        window_attention,
        window_attention_plain,
        window_tokens,
    )
    from m2trans_tpu_torch.tools.bench_clip_train import StepCase
    from m2trans_tpu_torch.utils.roofline import F32_FLOP_PER_S, bound, nbytes, swin_attn_flops

    t0 = time.perf_counter()
    stages, worst = {}, 0.0
    for side, c, heads, shift, _ in SWIN_STAGES:
        gen = torch.Generator().manual_seed(side)
        q, k, v, gout = (torch.randn(SWIN_BATCH, side, side, c, generator=gen).to(dev)
                         for _ in range(4))
        table = torch.randn(169, heads, generator=gen).to(dev)
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def fwd(fn):
            with torch.no_grad():
                return fn(q, k, v, table, heads, 7, shift)

        def fwd_bwd(fn):
            out = fn(*ins, table, heads, 7, shift)
            return [out.detach(), *torch.autograd.grad(out, ins, gout)]

        got, want = fwd_bwd(window_attention), fwd_bwd(window_attention_plain)
        need(all(torch.equal(a, b) for a, b in zip(got, fwd_bwd(window_attention))),
             f"phase 32 {side}x{side}: two runs of the kernels differ")
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            need(err <= max(SWIN_TOL[0], SWIN_TOL[1] * top),
                 f"phase 32 {side}x{side}: {name} kernel vs plain max err {err:.3g} "
                 f"(max {top:.3g})")
            worst = max(worst, err / max(top, 1e-30))

        # the library yardstick, on windows partitioned outside the timing
        n, hd = 49, c // heads
        tok = torch.as_tensor(window_tokens(side, side, 7, shift), device=dev)

        def windows(t):
            t = t.detach().reshape(SWIN_BATCH, side * side, c)[:, tok]
            return t.reshape(-1, n, heads, hd).transpose(1, 2).contiguous()

        rpi = torch.as_tensor(relative_position_index(7), device=dev)
        amask = table[rpi.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)[None]
        if shift:
            m = torch.as_tensor(shift_attn_mask(side, side, 7, shift), device=dev)
            amask = (amask + m[:, None]).repeat(SWIN_BATCH, 1, 1, 1)
        amask = amask.contiguous()
        wq, wk, wv = (windows(t).requires_grad_(True) for t in (q, k, v))
        wg = windows(gout)

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(wq, wk, wv, attn_mask=amask)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(wq, wk, wv, attn_mask=amask)
            torch.autograd.grad(o, [wq, wk, wv], wg)

        ms = {"kernel": (device_ms(lambda: fwd(window_attention)),
                         device_ms(lambda: fwd_bwd(window_attention))),
              "plain": (device_ms(lambda: fwd(window_attention_plain)),
                        device_ms(lambda: fwd_bwd(window_attention_plain))),
              "library": (device_ms(lib_fwd), device_ms(lib_fwd_bwd))}
        b_fwd = bound(nbytes(q, k, v, table, q), swin_attn_flops(q, heads), F32_FLOP_PER_S)
        b_bwd = bound(nbytes(q, k, v, table, gout, q, k, v),
                      swin_attn_flops(q, heads, backward=True), F32_FLOP_PER_S)
        stages[f"{side}x{side}x{c}"] = {
            "heads": heads, "shift": shift,
            "bound_fwd_ms": b_fwd["bound_ms"], "bound_bwd_ms": b_bwd["bound_ms"],
            "bound_by": b_fwd["bound_by"],
            **{f"{who}_fwd_ms": f for who, (f, _) in ms.items()},
            **{f"{who}_bwd_ms": None if None in (f, fb) else fb - f
               for who, (f, fb) in ms.items()}}

    def per_forward(key):  # one Swin-tiny pass: a stage's blocks each
        vals = [stages[f"{s}x{s}x{c}"][key] for s, c, _, _, _ in SWIN_STAGES]
        if None in vals:
            return None
        return sum(v * blocks for v, (_, _, _, _, blocks) in zip(vals, SWIN_STAGES))

    # MedCLIP at its published width, f32 and bf16, kernels and plain
    mcfg = MedCLIPConfig()
    clip = init_medclip(mcfg, seed=4, device=dev)
    fns = {"f32": SemanticLossFn(clip, mcfg, None),
           "bf16": SemanticLossFn(clip, mcfg, None, dtype=torch.bfloat16)}
    rng = np.random.default_rng(32)
    sr, hr = (torch.from_numpy(rng.uniform(0, 1, (2, 384, 384, 3)).astype(np.float32))
              .to(dev) for _ in range(2))
    ids = torch.from_numpy(rng.integers(5, mcfg.text.vocab_size, (2, 64))).to(dev)
    tmask = torch.ones_like(ids)
    offs = crop_offsets(rng, 2, 384, 384, 2, 224)
    parts = {}
    for dname, fn in fns.items():
        with torch.no_grad():
            t_emb = clip_text_embed(fn.model, ids, tmask)
            sim_y = clip_image_sims(fn.model, hr, offs, t_emb)

        def hr_side():
            with torch.no_grad():
                clip_image_sims(fn.model, hr, offs, t_emb)

        def sr_side():
            s = sr.bfloat16().requires_grad_(True)  # the step's sr is bf16
            semantic_loss_staged(fn.model, s, offs, t_emb, sim_y).backward()

        for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_swin_attention)):
            with ctx():
                parts[f"{dname} {label}"] = {"HR fwd": profile_call(hr_side),
                                             "SR fwd+bwd": profile_call(sr_side)}

    # the x2 recipe step, kernels and plain
    case = StepCase("recipe-f32", 2, dev, fns["f32"], hw=192, scale=2)
    steps = {}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_swin_attention)):
        with ctx():
            _, _, eager = case.make(graphs=False)
            n0 = window_attention.launches
            case.call(eager, np.random.default_rng(1))
            torch.cuda.synchronize()
            n1 = window_attention.launches
            del eager
            _, _, step = case.make(graphs=True)
            case.call(step, np.random.default_rng(1))
            torch.cuda.synchronize()
            n2 = window_attention.launches
            ev = time_ms(lambda: case.call(step, np.random.default_rng(2)), n=20)
            n3 = window_attention.launches
            prof = profile_call(lambda: case.call(step, np.random.default_rng(3)), n=5)
            steps[label] = {"launches_eager": n1 - n0, "launches_side_and_capture": n2 - n1,
                            "launches_replays": n3 - n2, "event_ms": ev,
                            "device_ms": prof["ms"], "kernels_a_replay": prof["launches"]}
            del step
    got = steps["kernels"]
    need((got["launches_eager"], got["launches_side_and_capture"], got["launches_replays"])
         == (36, 72, 0), f"phase 32: the x2 recipe step launched the kernels {got}, want "
         "36 eagerly, 36 + 36 around the capture (side-stream step, capture), 0 in replays")
    need(steps["plain"]["launches_eager"] == 0, f"phase 32: plain launched {steps['plain']}")

    medclip_txt = "; ".join(
        f"{k}: " + ", ".join(f"{p} {fmt_ms(v['ms'])} ({v['launches']} kernels)"
                             for p, v in d.items()) for k, d in parts.items())
    print(f"phase 32 Swin window attention (f32, batch {SWIN_BATCH}; device ms kernel | plain | "
          "masked SDPA on pre-partitioned windows, bound): "
          + "; ".join(f"{k} fwd {fmt_ms(v['kernel_fwd_ms'])} | {fmt_ms(v['plain_fwd_ms'])} | "
                      f"{fmt_ms(v['library_fwd_ms'])}, {v['bound_fwd_ms']:.4f}; bwd "
                      f"{fmt_ms(v['kernel_bwd_ms'])} | {fmt_ms(v['plain_bwd_ms'])} | "
                      f"{fmt_ms(v['library_bwd_ms'])}, {v['bound_bwd_ms']:.4f}"
                      for k, v in stages.items())
          + f"; worst err / max {worst:.3g}; MedCLIP (2 x 384^2, 3 patches) by part: "
          + medclip_txt + "; x2 recipe step (batch 2, MedCLIP f32): "
          + "; ".join(f"{k} {json.dumps(v)}" for k, v in steps.items())
          + f"; phase 32 in {time.perf_counter() - t0:.1f} s")
    return {"name": "swin_attn", "route": "cuda", "source": "m2trans_tpu_torch/csrc/swin_attn.cu",
            "replaces": None, "launches": got["launches_eager"],
            "launches_train_graph_capture_x2": got["launches_side_and_capture"] // 2,
            "max_rel_err": worst, "bound_ms": per_forward("bound_fwd_ms"),
            "bound_by": next(iter(stages.values()))["bound_by"],
            "device_ms": per_forward("kernel_fwd_ms"),
            "device_ms_bwd": per_forward("kernel_bwd_ms"),
            "bound_ms_bwd": per_forward("bound_bwd_ms"),
            "plain_ms": per_forward("plain_fwd_ms"), "plain_ms_bwd": per_forward("plain_bwd_ms"),
            "library_ms": per_forward("library_fwd_ms"),
            "library_ms_bwd": per_forward("library_bwd_ms"),
            "by_stage": stages, "medclip_parts": {k: {p: v["ms"] for p, v in d.items()}
                                                  for k, d in parts.items()},
            "x2_recipe_step": steps}


def run() -> dict:
    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import (
        ComputePolicy,
        init_m2trans,
        m2trans_apply,
    )
    from m2trans_tpu_torch import runtime
    from m2trans_tpu_torch.models import m2trans as port_model
    from m2trans_tpu_torch.ops.kernels import build, relayout
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv, ff_conv_plain
    from m2trans_tpu_torch.ops.kernels.halo_attn import (
        cftm_branch,
        cftm_branch_bwd,
        cftm_branch_bwd_variant,
        cftm_branch_plain,
        cftm_branch_plain_vjp,
        cftm_branch_variant,
        halo_attention_qkv,
        halo_attention_qkv_plain,
    )
    from m2trans_tpu_torch.ops.kernels.tail_band import (
        tail_band_bwd,
        tail_band_fused,
        tail_band_plain,
        tail_band_plain_vjp,
    )
    from m2trans_tpu_torch.train.convert import reference_state_dict
    from m2trans_tpu_torch.utils.roofline import (
        add_bounds,
        bound,
        branch_flops,
        nbytes,
        tail_flops,
    )

    need_no_reference_package()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.cuda.set_device(0)

    # 2. build the kernels and the C++ loader from the checkout's sources
    t0 = time.perf_counter()
    lib_path = build.build()
    build.lib()
    t1 = time.perf_counter()
    loader_path = runtime.build()
    runtime.lib()
    print(f"phase 2 built {os.path.relpath(lib_path, ROOT)} in {t1 - t0:.1f} s (nvcc "
          f"{build.build_seconds} s), the C++ loader "
          f"{os.path.relpath(loader_path, ROOT)} in {time.perf_counter() - t1:.1f} s")

    # 3. K1 vs its plain version at the slice shapes and at the single-frame
    # StreamingSR shape (more windows than the card holds at once), and at a
    # base width the bodies of width 16 do not take (the general body)
    k1_err, parts = 0.0, []
    for levels, bsz, hw, cb in ((0, 8, 96, 16), (1, 8, 96, 16), (2, 8, 96, 16),
                                (0, 1, 512, 16), (1, 1, 512, 16), (2, 1, 512, 16),
                                (0, 2, 32, 32), (1, 2, 32, 32)):
        args, add = branch_case(levels, bsz=bsz, hw=hw, cb=cb, seed=levels)
        for x_add in (None, add):
            got = cftm_branch(*args, x_add=x_add, levels=levels)
            want = cftm_branch_plain(*args, x_add=x_add, levels=levels)
            torch.cuda.synchronize()
            mx, mean = errs(got, want)
            need(torch.isfinite(got.float()).all().item(), "K1 output not finite")
            need(mx < K1_TOL[0] and mean < K1_TOL[1],
                 f"K1 L={levels} {bsz}x{hw}x{hw}x{cb} add={x_add is not None}: "
                 f"max {mx} mean {mean}")
            k1_err = max(k1_err, mx)
            parts.append(f"L{levels}{'' if bsz == 8 else f' {bsz}x{hw}x{hw}x{cb}'}"
                         f"{'+add' if x_add is not None else ''} "
                         f"max {mx:.3g} mean {mean:.3g}")
    k1_variant = {levels: cftm_branch_variant(16, levels) for levels in (0, 1, 2)}
    need(list(k1_variant.values()) == ["w16_warp", "w64_warpgroup", "c256_cluster4"]
         and cftm_branch_variant(32, 0) == cftm_branch_variant(32, 1) == "general",
         f"K1 bodies by shape: {k1_variant}, width 32 "
         f"{cftm_branch_variant(32, 0)}/{cftm_branch_variant(32, 1)}")
    resident = [build.lib().m2t_cftm_branch_resident(i) for i in range(3)]
    need(min(resident) > 0, f"K1 occupancy query failed: {resident}")
    print("phase 3 K1 cftm_branch vs plain (bf16, 8x96x96x16, 1x512x512x16 and, "
          "on the general body, 2x32x32x32): " + "; ".join(parts)
          + "; bodies launched L0/L1/L2 " + "/".join(k1_variant[i] for i in range(3))
          + f"; windows (L2: clusters) resident at once {resident}")

    # 4. K2 vs its plain version: the x4 slice shape, the single-frame
    # shape, frames that are no multiple of its 8x16 tile in either
    # direction, and x2 / x3
    k2_err, parts = 0.0, []
    for scale, shp in ((4, (8, 96, 96)), (4, (1, 512, 512)), (4, (2, 100, 76)),
                       (2, (2, 48, 40)), (3, (2, 32, 24)), (3, (1, 50, 37)),
                       (2, (1, 7, 5))):
        ops = tail_case(scale, *shp, seed=scale)
        got = tail_band_fused(*ops, scale=scale, rgb_range=1.0)
        want = tail_band_plain(*ops, scale=scale, rgb_range=1.0)
        torch.cuda.synchronize()
        mx, _ = errs(got, want)
        need(torch.isfinite(got.float()).all().item(), "K2 output not finite")
        need(mx < K2_TOL, f"K2 x{scale} {shp}: max {mx}")
        k2_err = max(k2_err, mx)
        parts.append(f"x{scale} {shp} max {mx:.3g}")
    print("phase 4 K2 tail_band vs plain (bf16, nf 64): " + "; ".join(parts))

    # 5. the flagship forward through the model's entry point; phases 5-7
    # serve, under inference mode as the serving path runs
    cfg = load_config(os.path.join(ROOT, CONFIG))
    need((cfg.scale, cfg.n_feats, cfg.n_blocks) == (4, 64, 8), "flagship config")
    dev = torch.device("cuda")
    model = init_m2trans(cfg, seed=0, device=dev)
    x = torch.rand(8, 96, 96, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
        plain = ComputePolicy(dtype=torch.bfloat16, use_kernels=False)
        cftm_branch.launches = ff_conv.launches = tail_band_fused.launches = 0
        y = model(x, kern)
        torch.cuda.synchronize()
        launches = {"cftm_branch": cftm_branch.launches,
                    "ff_conv": ff_conv.launches,
                    "tail_band": tail_band_fused.launches}
        need(launches == {"cftm_branch": 32, "ff_conv": 8, "tail_band": 1},
             f"flagship forward launched {launches}, want 32 K1, 8 K3 and 1 K2")
        need(tuple(y.shape) == (8, 384, 384, 3), f"output shape {tuple(y.shape)}")
        need(torch.isfinite(y.float()).all().item(), "output not finite")
        yp = m2trans_apply(model, x, cfg, plain)
        yf = m2trans_apply(model, x, cfg, ComputePolicy())
        mx, mean = errs(y, yp)
        need(mx < FWD_TOL[0] and mean < FWD_TOL[1],
             f"forward kernels vs plain bf16: max {mx} mean {mean}")
        mx32, mean32 = errs(y, yf)
        need(mean32 < F32_MEAN_TOL, f"forward kernels vs f32: mean {mean32}")
        print(f"phase 5 flagship x4 forward 8x96x96 bf16: launches {launches}; "
              f"vs plain bf16 max {mx:.3g} mean {mean:.3g}; vs f32 (TF32 off) "
              f"max {mx32:.3g} mean {mean32:.3g}")

        # 6. the serving CLI on frames, with a reference-format .pt
        import numpy as np

        work = os.path.join(ROOT, "build", "chip_smoke")
        os.makedirs(work, exist_ok=True)
        # kept for phase 22, which holds the PNGs to an eager stream
        serve = os.path.join(work, "serve")
        shutil.rmtree(serve, ignore_errors=True)
        pt = os.path.join(serve, "model_x4.pt")
        frames = os.path.join(serve, "frames")
        os.makedirs(frames)
        torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
        rng = np.random.default_rng(0)
        shapes = {"f0.png": (96, 96), "f1.png": (96, 96), "f2.png": (96, 96),
                  "f3.png": (100, 76)}
        from PIL import Image

        for name, hw in shapes.items():
            Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                os.path.join(frames, name))
        # the CLI replays a graph per frame shape: the warm-up captures
        # 96x96, the stream 100x76; phase 22 holds the PNGs to an eager run
        cmd = [sys.executable, "-m", "m2trans_tpu_torch.infer", "--config",
               CONFIG, "--model_path", pt, "--input", frames]
        reports = {}
        for depth in (1, 2):  # each frame waited for / two frames in flight
            res = subprocess.run(cmd + ["--output", os.path.join(serve, f"out_{depth}"),
                                        "--depth", str(depth)], cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
            need(res.returncode == 0,
                 f"infer --depth {depth} exited {res.returncode}:\n{res.stderr}")
            reports[depth] = report = json.loads(res.stdout.strip().splitlines()[-1])
            need(report.get("frames") == 4, f"report {report}")
            graphs = report.get("cuda_graphs", {})
            per_capture = graphs.get("launches_per_capture", {})
            need(graphs.get("captures") == 1 and graphs.get("replays") == 4
                 and sorted(per_capture) == ["1x100x76x3", "1x96x96x3"]
                 and all(n == {"cftm_branch": 32, "ff_conv": 8, "tail_band": 1}
                         for n in per_capture.values()),
                 f"infer --depth {depth} report {report}")
            for name, (h, w) in shapes.items():
                with Image.open(os.path.join(serve, f"out_{depth}", name)) as img:
                    size = (img.height, img.width, len(img.getbands()))
                need(size == (4 * h, 4 * w, 3), f"{name}: shape {size}")
        print(f"phase 6 infer CLI (a CUDA graph per frame shape): 4 frames (3x 96x96, "
              f"1x 100x76) -> x4 PNGs; p50 / p99 ms at depth 1 "
              f"{reports[1]['p50_ms']} / {reports[1]['p99_ms']}, depth 2 "
              f"{reports[2]['p50_ms']} / {reports[2]['p99_ms']}, fps {reports[1]['fps']}"
              f" / {reports[2]['fps']}; report at depth 2 {json.dumps(reports[2])}")

        # 7. times, CUDA events, median of 20 after warm-up
        k1_ms, k1_plain_ms, k1_bound, k1_dev = {}, {}, {}, {}
        for levels in (0, 1, 2):
            args, add = branch_case(levels, seed=levels)
            x_add = None if levels == 0 else add
            k1_bound[levels] = bound(nbytes(*args, x_add, args[0]),
                                     branch_flops(args[0], levels))
            k1_ms[levels] = time_ms(lambda: cftm_branch(*args, x_add=x_add, levels=levels))
            k1_plain_ms[levels] = time_ms(
                lambda: cftm_branch_plain(*args, x_add=x_add, levels=levels))
        ops = tail_case(4, 8, 96, 96, seed=4)
        k2_ms = time_ms(lambda: tail_band_fused(*ops, scale=4, rgb_range=1.0))
        k2_plain_ms = time_ms(lambda: tail_band_plain(*ops, scale=4, rgb_range=1.0))
        k2_bound = bound(nbytes(*ops) + 2 * 8 * 96 * 96 * 48, tail_flops(ops[0], 4))
        ops_frame = tail_case(4, 1, 512, 512, seed=5)
        fwd_ms = time_ms(lambda: model(x, kern))
        # the same forward with the ff conv as its plain composition (cuDNN
        # conv, bias add, residual add), K1 and K2 still the kernels
        port_model.ff_conv = ff_conv_plain
        try:
            fwd_no_k3_ms = time_ms(lambda: model(x, kern))
        finally:
            port_model.ff_conv = ff_conv
        fwd_ms2 = time_ms(lambda: model(x, kern))
        fwd_plain_ms = time_ms(lambda: m2trans_apply(model, x, cfg, plain))
        # the profiler comes after every event timing of this phase: once it
        # has run, launches from this process cost the host more
        for levels in (0, 1, 2):
            args, add = branch_case(levels, seed=levels)
            x_add = None if levels == 0 else add
            k1_dev[levels] = device_ms(
                lambda: cftm_branch(*args, x_add=x_add, levels=levels))
        k1_frame_dev = {}
        for levels in (0, 1):  # the single-frame shape, per window
            args, add = branch_case(levels, bsz=1, hw=512, seed=levels)
            x_add = None if levels == 0 else add
            k1_frame_dev[levels] = device_ms(
                lambda: cftm_branch(*args, x_add=x_add, levels=levels))
        k2_dev = device_ms(lambda: tail_band_fused(*ops, scale=4, rgb_range=1.0))
        k2_frame_dev = device_ms(
            lambda: tail_band_fused(*ops_frame, scale=4, rgb_range=1.0))
        k2_small_dev = {}
        for scale, shp in ((2, (8, 96, 96)), (3, (8, 96, 96))):
            ops_s = tail_case(scale, *shp, seed=scale)
            k2_small_dev[scale] = device_ms(
                lambda: tail_band_fused(*ops_s, scale=scale, rgb_range=1.0))
        fwd_split = profile_split(lambda: model(x, kern))
        mp = 8 * 384 * 384 / 1e6
        print(f"phase 7 times (ms, median of 20): K1 L0/L1/L2 "
              f"{k1_ms[0]:.4f}/{k1_ms[1]:.4f}/{k1_ms[2]:.4f} vs plain "
              f"{k1_plain_ms[0]:.4f}/{k1_plain_ms[1]:.4f}/{k1_plain_ms[2]:.4f}, "
              f"device time from the profiler "
              + "/".join(fmt_ms(k1_dev[i]) for i in range(3)) + ", bound "
              + "/".join(f"{k1_bound[i]['bound_ms']:.5f}" for i in range(3))
              + ", at 1x512x512x16 L0/L1 "
              + "/".join(fmt_ms(k1_frame_dev[i]) for i in range(2))
              + f"; K2 x4 {k2_ms:.4f} vs plain {k2_plain_ms:.4f}, device time "
              f"{fmt_ms(k2_dev)} (bound {k2_bound['bound_ms']:.5f}), at 1x512x512x64 "
              f"{fmt_ms(k2_frame_dev)}, x2 / x3 at 8x96x96x64 "
              f"{fmt_ms(k2_small_dev[2])} / {fmt_ms(k2_small_dev[3])}; forward b8 96x96 "
              f"kernels {fwd_ms:.3f} ms ({mp / fwd_ms * 1e3:.1f} MP/s), with the ff "
              f"conv plain {fwd_no_k3_ms:.3f} ms, kernels again {fwd_ms2:.3f} ms, vs "
              f"plain {fwd_plain_ms:.3f} ms ({mp / fwd_plain_ms * 1e3:.1f} MP/s); "
              f"device time of one kernel forward by kind: {fwd_split}")

    # 8. K1b vs its plain VJP at the training shapes (batch 2 x 96x96), at
    # the single-frame shape and at base width 32 (the general body); a
    # second run must give the same bits (fixed-order sums, no atomics)
    k1b_err, parts = 0.0, []
    for levels, bsz, hw, cb in ((0, 2, 96, 16), (1, 2, 96, 16), (2, 2, 96, 16),
                                (0, 1, 512, 16), (1, 1, 512, 16), (2, 1, 512, 16),
                                (0, 2, 32, 32), (1, 2, 32, 32)):
        args, add = branch_case(levels, bsz=bsz, hw=hw, cb=cb, seed=10 + levels)
        gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
            levels)).bfloat16().cuda()
        for x_add in (None, add):
            got = cftm_branch_bwd(*args, gout, x_add=x_add, levels=levels)
            again = cftm_branch_bwd(*args, gout, x_add=x_add, levels=levels)
            want = cftm_branch_plain_vjp(*args, gout, x_add=x_add, levels=levels)
            torch.cuda.synchronize()
            what = f"K1b L={levels} {bsz}x{hw}x{hw}x{cb} add={x_add is not None}"
            mx = grad_errs(got, want, what)
            need(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
                 f"{what}: two runs differ")
            k1b_err = max(k1b_err, mx)
            parts.append(f"L{levels}{'' if bsz == 2 and cb == 16 else f' {bsz}x{hw}x{hw}x{cb}'}"
                         f"{'+add' if x_add is not None else ''} max {mx:.3g}")
    k1b_variant = {levels: cftm_branch_bwd_variant(16, levels) for levels in (0, 1, 2)}
    need(list(k1b_variant.values()) == ["w16_group", "w64_group", "c256_cluster4"]
         and cftm_branch_bwd_variant(32, 0) == cftm_branch_bwd_variant(32, 1) == "general",
         f"K1b bodies by shape: {k1b_variant}")
    print("phase 8 K1b cftm_branch_bwd vs plain VJP (bf16, 2x96x96x16, 1x512x512x16 "
          "and, on the general body, 2x32x32x32; dx dx_add ds dt dw drel_h drel_w "
          "within max(2e-3, 2e-2 max|b|), a second run bit-identical): "
          + "; ".join(parts) + "; bodies launched L0/L1/L2 "
          + "/".join(k1b_variant[i] for i in range(3)))

    # 9. K2b vs its plain VJP: the x4 training shape, and x2 / x3
    k2b_err, parts = 0.0, []
    for scale, shp in ((4, (2, 96, 96)), (4, (2, 100, 76)), (2, (2, 48, 40)),
                       (3, (2, 32, 24))):
        ops, g = tail_case(scale, *shp, seed=20 + scale, with_grad=True)
        got = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
        again = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
        want = tail_band_plain_vjp(*ops, g, scale=scale, rgb_range=1.0)
        torch.cuda.synchronize()
        mx = grad_errs(got, want, f"K2b x{scale}")
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"K2b x{scale}: two runs differ")
        k2b_err = max(k2b_err, mx)
        parts.append(f"x{scale} {shp} max {mx:.3g}")
    print("phase 9 K2b tail_band_bwd vs plain VJP (bf16, nf 64, all ten "
          "operand gradients within max(2e-3, 2e-2 max|b|), a second run "
          "bit-identical): " + "; ".join(parts))

    # 10. the flagship bf16 train step of the training loop, as the train
    # CLI runs it (make_train_step: policy_from_config, L1, backward, Adam)
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    tcfg = cfg.replace(dtype="bfloat16", use_pallas=True)
    gen = torch.Generator().manual_seed(2)
    lr_b = torch.rand(2, 96, 96, 3, generator=gen).to(dev)
    hr_b = torch.rand(2, 384, 384, 3, generator=gen).to(dev)

    def train_model(c):  # eager: its launches are counted a step
        m = init_m2trans(c, seed=0, device=dev)
        return m, make_train_step(c, m, make_optimizer(c, m), graphs=False)

    def step_grads(m):  # the step's gradients, still in place after Adam
        return {n: p.grad for n, p in m.named_parameters() if p.requires_grad}

    model_t, step = train_model(tcfg)
    counters = (cftm_branch, ff_conv, tail_band_fused, cftm_branch_bwd,
                tail_band_bwd)
    for f in counters:
        f.launches = 0
    loss_k = float(step(lr_b, hr_b)["loss"])
    torch.cuda.synchronize()
    train_launches = {f.__name__: f.launches for f in counters}
    need(train_launches == {"cftm_branch": 32, "ff_conv": 8, "tail_band_fused": 1,
                            "cftm_branch_bwd": 32, "tail_band_bwd": 1},
         f"train step launched {train_launches}, want 32 + 8 + 1 forward and "
         "32 + 1 backward")
    grads_k = step_grads(model_t)
    for name, gr in grads_k.items():
        need(gr is not None and torch_isfinite(gr), f"gradient of {name} not finite")
    ref = {}
    for name, c in (("plain", tcfg.replace(use_pallas=False)),
                    ("f32", cfg.replace(dtype="float32", use_pallas=False))):
        m, st = train_model(c)
        ref[name] = (float(st(lr_b, hr_b)["loss"]), step_grads(m))
    (loss_p, grads_p), (loss_f, grads_f) = ref["plain"], ref["f32"]
    worst, worst_name, worst_e = 0.0, "", 0.0
    for name in grads_k:
        d = rel_l2(grads_k[name], grads_p[name])
        e = rel_l2(grads_p[name], grads_f[name])
        need(d <= max(STEP_TOL, 1.5 * e),
             f"train step: {name} kernels vs plain bf16 rel L2 {d:.4g} > "
             f"max({STEP_TOL}, 1.5 * {e:.4g})")
        if d > worst:
            worst, worst_name, worst_e = d, name, e
    losses = [loss_k] + [float(step(lr_b, hr_b)["loss"]) for _ in range(10)]
    need(losses[-1] < losses[0], f"L1 after 10 Adam steps {losses[-1]} not below "
         f"the first step's {losses[0]}")
    print(f"phase 10 flagship x4 train step (make_train_step) 2x96x96 bf16: launches "
          f"{train_launches}; L1 kernels {loss_k:.6f} plain bf16 {loss_p:.6f} "
          f"f32 {loss_f:.6f}; gradients finite, worst rel L2 vs plain bf16 "
          f"{worst:.4g} ({worst_name}; plain bf16 vs f32 {worst_e:.4g}, bound "
          f"{max(STEP_TOL, 1.5 * worst_e):.4g}); L1 over 10 Adam steps {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}")

    # 11. the training CLI on a synthetic US1K tree, then --resume
    import numpy as np
    import yaml

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_us1k_tree(os.path.join(tmp, "data"), np.random.default_rng(3))
        with open(os.path.join(ROOT, "configs", "M2Trans_x4.yml")) as f:
            ycfg = yaml.safe_load(f)
        ycfg.update(dtype="bfloat16", use_pallas=True, data_path=os.path.join(tmp, "data"),
                    train_range=[1, 4], data_repeat=2, epochs=2, log_every=1,
                    eval_sets=["CCA-US"], log_path=os.path.join(tmp, "exp"),
                    threads=2)
        yml = os.path.join(tmp, "train.yml")
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.train",
                              "--config", yml], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        need(res.returncode == 0, f"train CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
        exps = os.listdir(os.path.join(tmp, "exp"))
        need(len(exps) == 1, f"experiment dirs {exps}")
        exp = os.path.join(tmp, "exp", exps[0])
        with open(os.path.join(exp, "log.txt")) as f:
            log = f.read()
        need("Epoch:2, 6/6, loss: " in log, "train CLI log has no loss lines")
        need(log.count("[CCA-US-X4], PSNR/SSIM: ") == 2,
             "train CLI log has no PSNR/SSIM lines")
        keys = {"epoch", "model_state_dict", "optimizer_state_dict",
                "scheduler_state_dict", "stat_dict"}
        for epoch in (1, 2):
            ck = torch.load(os.path.join(exp, "models", f"model_x4_{epoch}.pt"),
                            weights_only=True)
            need(set(ck) == keys and ck["epoch"] == epoch,
                 f"checkpoint of epoch {epoch}: {sorted(ck)}")
        ycfg["epochs"] = 3
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.train",
                              "--config", yml, "--resume", exp], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        need(res.returncode == 0, f"train CLI --resume exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
        need("## resume training from epoch 3. ##" in res.stdout
             and os.path.exists(os.path.join(exp, "models", "model_x4_3.pt")),
             "train CLI --resume did not continue at epoch 3")
        psnr = [ln for ln in log.splitlines() if "PSNR/SSIM" in ln][-1]
    print(f"phase 11 train CLI x4 bf16: 2 epochs x 3 steps (2x96x96 -> 384x384) "
          f"+ validation in {cli_s:.1f} s, checkpoints model_x4_{{1,2}}.pt with "
          f"the reference keys, --resume -> epoch 3; last: {psnr.strip()}")

    kern = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    plain = ComputePolicy(dtype=torch.bfloat16, use_kernels=False)

    # 12. K3 vs its plain version: the slice shape, a frame with edge tiles
    # and the single-frame shape (2048 tiles, not a multiple of the grid)
    k3_err, parts = 0.0, []
    for shp in ((8, 96, 96, 64), (2, 104, 88, 64), (1, 512, 512, 64)):
        ops = ff_case(shp, seed=shp[1])
        got, want = ff_conv(*ops), ff_conv_plain(*ops)
        torch.cuda.synchronize()
        need(torch_isfinite(got), "K3 output not finite")
        mx, _ = errs(got, want)
        tol = max(K3_ATOL, K3_RTOL * float(want.float().abs().max()))
        need(mx <= tol, f"K3 {shp}: max {mx} > {tol}")
        k3_err = max(k3_err, mx)
        parts.append(f"{shp} max {mx:.3g} (bound {tol:.3g})")
    print("phase 12 K3 ff_conv vs plain (bf16): " + "; ".join(parts))

    # 13. K1n vs its plain version, then the standalone ops that reach it
    k1n_err, parts = 0.0, []
    for levels in (0, 1, 2):
        (xs, w, rel_h, rel_w, _, _), _ = branch_case(levels, seed=30 + levels)
        got = halo_attention_qkv(xs, w, rel_h, rel_w, levels=levels)
        want = halo_attention_qkv_plain(xs, w, rel_h, rel_w, levels=levels)
        torch.cuda.synchronize()
        mx, mean = errs(got, want)
        need(torch_isfinite(got), "K1n output not finite")
        need(mx < K1_TOL[0] and mean < K1_TOL[1],
             f"K1n L={levels}: max {mx} mean {mean}")
        k1n_err = max(k1n_err, mx)
        parts.append(f"L{levels} max {mx:.3g} mean {mean:.3g}")
    with torch.inference_mode():
        blk = model.body[0]
        gen = torch.Generator().manual_seed(13)
        z16 = torch.randn(8, 92, 100, 16, generator=gen).to(dev)  # not 8-aligned
        zb = torch.randn(8, 96, 96, 64, generator=gen).to(dev)
        halo_attention_qkv.launches = 0
        outs = [(port_model.tblock_apply(blk.attn1, z16, policy=kern),
                 port_model.tblock_apply(blk.attn1, z16, policy=plain))]
        fused = port_model.make_branch_fn(blk, kern)
        unfused = port_model.make_branch_fn(blk, plain)
        for k, (name, levels) in enumerate(port_model._BRANCHES):
            zk = zb[..., 16 * k:16 * (k + 1)]
            outs.append((fused(name, zk, levels), unfused(name, zk, levels)))
        torch.cuda.synchronize()
        k1n_launches = halo_attention_qkv.launches
    need(k1n_launches == 5, f"tblock_apply + 4 branches launched K1n "
         f"{k1n_launches} times, want 5")
    need(tuple(outs[0][0].shape) == (8, 92, 100, 16), "tblock_apply crop")
    worst = 0.0
    for got, want in outs:
        mx, mean = errs(got, want)
        need(mx < K1_TOL[0] and mean < K1_TOL[1],
             f"K1n through tblock_apply / make_branch_fn: max {mx} mean {mean}")
        worst = max(worst, mx)
    print("phase 13 K1n halo_attention_qkv vs plain (bf16, 8x96x96x16): "
          + "; ".join(parts) + f"; tblock_apply (8x92x100x16, padded to 96x104) "
          f"and make_branch_fn's 4 branches: {k1n_launches} launches, vs the "
          f"unfused bf16 ops max {worst:.3g}")

    # 14. K4: the four relayouts at g = 8, bit for bit, and their round trips
    gen = torch.Generator().manual_seed(14)
    xb = torch.randn(8, 96, 96, 16, generator=gen).bfloat16().cuda()
    xc = torch.randn(8, 96, 96, 64, generator=gen).bfloat16().cuda()
    k4_err = 0.0
    for fn, pl, src in (
            (relayout.pack_batch, relayout.pack_batch_plain, xb),
            (relayout.unpack_batch, relayout.unpack_batch_plain,
             relayout.pack_batch_plain(xb, 8).contiguous()),
            (relayout.pack_body, relayout.pack_body_plain, xc),
            (relayout.unpack_body, relayout.unpack_body_plain,
             relayout.pack_body_plain(xc, 8).contiguous())):
        got, want = fn(src, 8), pl(src, 8)
        torch.cuda.synchronize()
        k4_err = max(k4_err, errs(got, want)[0])
        need(got.shape == want.shape and torch.equal(got, want),
             f"K4 {fn.__name__} differs from its plain version")
    relayout.relayout.launches = 0
    need(torch.equal(relayout.unpack_batch(relayout.pack_batch(xb, 8), 8), xb)
         and torch.equal(relayout.unpack_body(relayout.pack_body(xc, 8), 8), xc),
         "K4 round trip is not the identity")
    need(relayout.pack_batch(xb, 1) is xb, "pack_batch(g=1) must return x")
    torch.cuda.synchronize()
    k4_launches = relayout.relayout.launches
    need(k4_launches == 4, f"the round trips launched K4 {k4_launches} times, want 4")
    print(f"phase 14 K4 relayouts (bf16, g=8; pack/unpack_batch 8x96x96x16, "
          f"pack/unpack_body 8x96x96x64): equal to plain bit for bit; round "
          f"trips are the identity, {k4_launches} launches")

    # 15. the eval CLI on a synthetic benchmark tree, f32 and bf16 + kernels
    from m2trans_tpu_torch import test as eval_cli

    eval_shapes = [(96, 96), (96, 96), (96, 96), (100, 76)]
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        write_benchmark_tree(os.path.join(tmp, "data"), np.random.default_rng(15),
                             eval_shapes)
        pt = os.path.join(tmp, "model_x4.pt")
        torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
        with open(os.path.join(ROOT, CONFIG)) as f:
            ycfg = yaml.safe_load(f)
        ycfg.update(data_path=os.path.join(tmp, "data"), eval_sets=["CCA-US"])
        yml = os.path.join(tmp, "test.yml")
        with open(yml, "w") as f:
            yaml.dump(ycfg, f)
        base = ["--config", yml, "--model_path", pt]
        counters = (cftm_branch, ff_conv, tail_band_fused)

        def eval_run(extra):
            for f in counters:
                f.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                eval_cli.main(base + extra)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / len(eval_shapes)
            return (parse_eval(buf.getvalue()), buf.getvalue(),
                    {f.__name__: f.launches for f in counters}, secs)

        eval_run(["--dtype", "bfloat16"])  # warm-up: cuDNN, FFT plans, filters
        m_f32, _, l_f32, s_f32 = eval_run([])
        m_bf, out_bf, eval_launches, s_bf = eval_run(["--dtype", "bfloat16"])
        m_bk, _, _, _ = eval_run(["--bucket", "32"])
        # the CLI replays a graph a frame shape: the wrappers count the
        # side-stream run and the capture of each shape, not the replays
        n = 2 * len(set(eval_shapes))
        need(l_f32 == {"cftm_branch": 0, "ff_conv": 0, "tail_band_fused": 0},
             f"the f32 eval launched kernels: {l_f32}")
        need(eval_launches == {"cftm_branch": 32 * n, "ff_conv": 8 * n,
                               "tail_band_fused": n},
             f"the bf16 eval launched {eval_launches}, want {32 * n} K1, "
             f"{8 * n} K3, {n} K2 (two forwards a shape)")
        for key, val in m_bf.items():
            tol = EVAL_TOL[0] if key == "psnr" else EVAL_TOL[1]
            need(abs(val - m_f32[key]) <= tol + 1e-9,
                 f"eval bf16 {key} {val} vs f32 {m_f32[key]}: over {tol}")
        need(abs(m_bk["psnr"] - m_f32["psnr"]) <= BUCKET_TOL + 1e-9,
             f"eval --bucket 32 PSNR {m_bk['psnr']} vs exact {m_f32['psnr']}")
        res = subprocess.run([sys.executable, "-m", "m2trans_tpu_torch.test", *base,
                              "--dtype", "bfloat16"], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        need(res.returncode == 0, f"eval CLI exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
        need(res.stdout == out_bf, f"python -m m2trans_tpu_torch.test printed "
             f"{res.stdout!r}, in process {out_bf!r}")
    print(f"phase 15 eval CLI x4 (a CUDA graph a frame shape), 4 frames (3x 96x96, "
          f"1x 100x76 LR), FSIM/GMSD: "
          f"f32 {m_f32} ({s_f32:.3f} s/frame); bf16 + kernels {m_bf} "
          f"({s_bf:.3f} s/frame), launches {eval_launches}; --bucket 32 f32 "
          f"{m_bk}; python -m prints the same lines")

    # 7 (training). K1b / K2b and the flagship train step, timed
    k1b_ms, k1b_plain_ms, k1b_bound = {}, {}, {}
    for levels in (0, 1, 2):
        args, add = branch_case(levels, bsz=2, seed=10 + levels)
        x_add = None if levels == 0 else add
        gout = torch.randn(args[0].shape).bfloat16().cuda()
        # reads the forward's operands and the cotangent, writes a gradient
        # for each operand; twice the forward's products
        k1b_bound[levels] = bound(2 * nbytes(*args, x_add) + nbytes(gout),
                                  2 * branch_flops(args[0], levels))
        k1b_ms[levels] = time_ms(lambda: cftm_branch_bwd(
            *args, gout, x_add=x_add, levels=levels))
        k1b_plain_ms[levels] = time_ms(lambda: cftm_branch_plain_vjp(
            *args, gout, x_add=x_add, levels=levels))
    ops, g = tail_case(4, 2, 96, 96, seed=24, with_grad=True)
    k2b_ms = time_ms(lambda: tail_band_bwd(*ops, g, scale=4, rgb_range=1.0))
    k2b_plain_ms = time_ms(lambda: tail_band_plain_vjp(*ops, g, scale=4, rgb_range=1.0))
    k2b_bound = bound(2 * nbytes(*ops) + nbytes(g), 2 * tail_flops(ops[0], 4))
    step_ms = {}
    for name, c in (("kernels", tcfg), ("plain", tcfg.replace(use_pallas=False))):
        m = init_m2trans(c, seed=0, device=dev)
        st = make_train_step(c, m, make_optimizer(c, m), graphs=False)
        step_ms[name] = time_ms(lambda: st(lr_b, hr_b), n=10)
    # the profiler after every event timing: once it has run, launches from
    # this process cost the host more
    k1b_dev = {}
    for levels in (0, 1, 2):
        args, add = branch_case(levels, bsz=2, seed=10 + levels)
        x_add = None if levels == 0 else add
        gout = torch.randn(args[0].shape).bfloat16().cuda()
        k1b_dev[levels] = device_ms(lambda: cftm_branch_bwd(
            *args, gout, x_add=x_add, levels=levels))
    k2b_dev = device_ms(lambda: tail_band_bwd(*ops, g, scale=4, rgb_range=1.0))
    k2b_small_dev = {}
    for scale in (2, 3):
        ops_s, g_s = tail_case(scale, 2, 96, 96, seed=24 + scale, with_grad=True)
        k2b_small_dev[scale] = device_ms(
            lambda: tail_band_bwd(*ops_s, g_s, scale=scale, rgb_range=1.0))
    split = profile_split(lambda: step(lr_b, hr_b))
    print(f"phase 7 training times (ms, median of 20; steps of 10): K1b L0/L1/L2 "
          f"{k1b_ms[0]:.4f}/{k1b_ms[1]:.4f}/{k1b_ms[2]:.4f} vs plain VJP "
          f"{k1b_plain_ms[0]:.4f}/{k1b_plain_ms[1]:.4f}/{k1b_plain_ms[2]:.4f}, "
          f"device time of a launch group from the profiler "
          + "/".join(fmt_ms(k1b_dev[i]) for i in range(3)) + ", bound "
          + "/".join(f"{k1b_bound[i]['bound_ms']:.5f}" for i in range(3))
          + f"; K2b x4 {k2b_ms:.4f} vs plain VJP {k2b_plain_ms:.4f}, device time "
          f"{fmt_ms(k2b_dev)} (both passes and the reductions; bound "
          f"{k2b_bound['bound_ms']:.5f}), x2 / x3 at 2x96x96x64 "
          f"{fmt_ms(k2b_small_dev[2])} / {fmt_ms(k2b_small_dev[3])}; train step b2 "
          f"96x96 kernels {step_ms['kernels']:.3f} vs plain bf16 "
          f"{step_ms['plain']:.3f}; device time of one kernel step by kind: {split}")

    # 16. times of K3, K1n and K4 (CUDA events, median of 20, kernel and
    # comparison in one call), and their device time from the profiler
    with torch.inference_mode():
        ops3 = ff_case((8, 96, 96, 64), seed=96)
        oc3, x3, w3, b3 = ops3
        w3_oihw = w3.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def cudnn_ff():  # one convolution call and the residual add
            y = torch.nn.functional.conv2d(oc3.permute(0, 3, 1, 2), w3_oihw, b3,
                                           padding=1)
            return y.permute(0, 2, 3, 1) + x3

        mx, _ = errs(cudnn_ff(), ff_conv_plain(*ops3))
        need(mx <= max(K3_ATOL, K3_RTOL * 8), f"the cuDNN yardstick differs: {mx}")
        k3_ms = time_ms(lambda: ff_conv(*ops3))
        k3_plain_ms = time_ms(lambda: ff_conv_plain(*ops3))
        k3_lib_ms = time_ms(cudnn_ff)
        k3_dev = [device_ms(f) for f in (lambda: ff_conv(*ops3),
                                         lambda: ff_conv_plain(*ops3), cudnn_ff)]
        k3_bound = bound(nbytes(*ops3, oc3), 2.0 * 9 * 64 * 64 * oc3.numel() / 64)

        k1n_ms, k1n_plain_ms, k1n_dev, k1n_bound = {}, {}, {}, {}
        for levels in (0, 1, 2):
            (xs, w, rel_h, rel_w, _, _), _ = branch_case(levels, seed=30 + levels)
            k1n_ms[levels] = time_ms(
                lambda: halo_attention_qkv(xs, w, rel_h, rel_w, levels=levels))
            k1n_plain_ms[levels] = time_ms(
                lambda: halo_attention_qkv_plain(xs, w, rel_h, rel_w, levels=levels))
            k1n_dev[levels] = device_ms(
                lambda: halo_attention_qkv(xs, w, rel_h, rel_w, levels=levels))
            k1n_bound[levels] = bound(nbytes(xs, xs, w, rel_h, rel_w),
                                      branch_flops(xs, levels))

        k4 = {}
        for name, fn, src, perm in (
                ("pack_batch", relayout.pack_batch, xb, relayout.pack_batch_plain),
                ("pack_body", relayout.pack_body, xc, relayout.pack_body_plain),
                ("unpack_body", relayout.unpack_body,
                 relayout.pack_body_plain(xc, 8).contiguous(),
                 relayout.unpack_body_plain)):
            k4[name] = (time_ms(lambda: fn(src, 8)),
                        time_ms(lambda: perm(src, 8).contiguous()),
                        device_ms(lambda: fn(src, 8)),
                        device_ms(lambda: perm(src, 8).contiguous()),
                        bound(2 * nbytes(src), 0.0))
    print(f"phase 16 times (ms, events median of 20 | device time from the "
          f"profiler): K3 8x96x96x64 {k3_ms:.4f} | {fmt_ms(k3_dev[0])} vs plain "
          f"{k3_plain_ms:.4f} | {fmt_ms(k3_dev[1])} vs one cuDNN conv + add "
          f"{k3_lib_ms:.4f} | {fmt_ms(k3_dev[2])}, bound {k3_bound['bound_ms']:.4f} "
          f"({k3_bound['bound_by']}); K1n L0/L1/L2 "
          + "/".join(f"{k1n_ms[i]:.4f}" for i in range(3)) + " | "
          + "/".join(fmt_ms(k1n_dev[i]) for i in range(3)) + " vs plain "
          + "/".join(f"{k1n_plain_ms[i]:.4f}" for i in range(3)) + ", bound "
          + "/".join(f"{k1n_bound[i]['bound_ms']:.4f}" for i in range(3)) + "; K4 "
          + "; ".join(f"{k} {v[0]:.4f} | {fmt_ms(v[2])} vs permute().contiguous() "
                      f"{v[1]:.4f} | {fmt_ms(v[3])}, bound {v[4]['bound_ms']:.4f}"
                      for k, v in k4.items()))

    # 17. the recipe's step with the MedCLIP semantic loss
    semantic_step_phase(dev, tcfg, lr_b, hr_b, loss_k, train_launches, work)

    # 18, 19. the sharded forward and data parallelism (two ranks on the card)
    par = parallel_phases(dev, model, cfg, lr_b, hr_b, grads_k, grads_p, grads_f, work)

    # 20. the 2-D (data, space) mesh (four ranks on the card)
    grid = data_space_phase()

    # 21. the Trainer with the C++ loader, a profiler trace, the panels and
    # the complexity report (the profiler last: a process that has run it
    # launches more slowly)
    trainer_phase(dev, tcfg, work)

    # 22. the serving forward replayed from a CUDA graph a frame shape, the
    # infer CLI with graphs, the bench (the launch counts are set to 0 just
    # before each capture and read just after)
    graph_launches = graphed_phase(dev, cfg, serve)

    # 23. the train step replayed from a CUDA graph (L1, the shipped f32 and
    # the recipe's), the Trainer and the train CLI with graphs, the eval
    # forward's graphs and the eval split (the launch counts are set to 0
    # just before each capture and read just after)
    train_graph_launches = graphed_train_phase(dev, lr_b, hr_b, work)

    # 24. the augmentations inside the train step's graph, validations that
    # replay across Adam's updates, the metrics graphs (the launch counts
    # set to 0 just before each graphed run and read just after)
    graphed_aug_eval_phase(dev, lr_b, hr_b, work)

    # 25-30. the measurement tools of m2trans_tpu_torch/tools/ at short
    # settings (the launch counts set to 0 just before each and read just
    # after)
    tools_phase()

    # 31. the shipped x2 and x3 configurations at full width: the train
    # step, the train, eval and infer CLIs (the launch counts set to 0 just
    # before each counted run and read just after)
    scale_launches = scales_phase(dev, work)

    # 32. MedCLIP's Swin window attention: the kernels at the stage shapes,
    # MedCLIP's parts and the x2 recipe step, kernels against plain
    swin_row = swin_attn_phase(dev)

    need_no_reference_package()

    def per_cftm(t):  # one CFTM's 4 branch launches: L0, L1, L2, L2
        return t[0] + t[1] + 2 * t[2]

    def cftm_bound(b):
        return add_bounds(b[0], b[1], b[2], b[2])

    pallas = "m2trans_tpu/ops/pallas/"
    csrc = "m2trans_tpu_torch/csrc/"
    k4_ms, k4_plain_ms = (sum(v[i] for v in k4.values()) for i in (0, 1))
    return {"kernels": [
        {"name": "cftm_branch", "route": "cuda", "source": csrc + "cftm_branch.cu",
         "replaces": pallas + "halo_attn.py:267",
         "launches": launches["cftm_branch"], "max_abs_err": k1_err,
         "ms": per_cftm(k1_ms), "plain_ms": per_cftm(k1_plain_ms),
         **cftm_bound(k1_bound), "library_ms": None,
         "device_ms": None if None in k1_dev.values() else per_cftm(k1_dev),
         "device_ms_by_level": k1_dev, "variant_by_level": k1_variant,
         "bound_ms_by_level": {i: k1_bound[i]["bound_ms"] for i in range(3)},
         "bound_by_by_level": {i: k1_bound[i]["bound_by"] for i in range(3)},
         "device_ms_1x512x512_by_level": k1_frame_dev,
         "resident_by_level": dict(enumerate(resident)),
         "launches_sharded_forward_per_rank": par["sharded_forward"][0],
         "launches_2d_mesh_per_rank": grid["launches"][0],
         "launches_graph_capture": graph_launches["cftm_branch"],
         "launches_train_graph_capture": train_graph_launches["cftm_branch"],
         "launches_train_graph_capture_x2": scale_launches[2]["cftm_branch"],
         "launches_train_graph_capture_x3": scale_launches[3]["cftm_branch"],
         "launches_ddp_step_per_rank": par["ddp_step"][0]},
        {"name": "tail_band", "route": "cuda", "source": csrc + "tail_band.cu",
         "replaces": pallas + "tail_band.py:118",
         "launches": launches["tail_band"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, **k2_bound, "library_ms": None,
         "device_ms": k2_dev, "device_ms_1x512x512": k2_frame_dev,
         "launches_sharded_forward_per_rank": par["sharded_forward"][2],
         "launches_2d_mesh_per_rank": grid["launches"][2],
         "launches_graph_capture": graph_launches["tail_band"],
         "launches_train_graph_capture": train_graph_launches["tail_band"],
         "launches_train_graph_capture_x2": scale_launches[2]["tail_band"],
         "launches_train_graph_capture_x3": scale_launches[3]["tail_band"],
         "launches_ddp_step_per_rank": par["ddp_step"][2]},
        {"name": "cftm_branch_bwd", "route": "cuda",
         "source": csrc + "cftm_branch_bwd.cu",
         "replaces": pallas + "halo_attn.py:1053",
         "launches": train_launches["cftm_branch_bwd"], "max_abs_err": k1b_err,
         "ms": per_cftm(k1b_ms), "plain_ms": per_cftm(k1b_plain_ms),
         **cftm_bound(k1b_bound), "library_ms": None,
         "device_ms": None if None in k1b_dev.values() else per_cftm(k1b_dev),
         "device_ms_by_level": k1b_dev, "variant_by_level": k1b_variant,
         "bound_ms_by_level": {i: k1b_bound[i]["bound_ms"] for i in range(3)},
         "launches_train_graph_capture": train_graph_launches["cftm_branch_bwd"],
         "launches_train_graph_capture_x2": scale_launches[2]["cftm_branch_bwd"],
         "launches_train_graph_capture_x3": scale_launches[3]["cftm_branch_bwd"],
         "launches_ddp_step_per_rank": par["ddp_step"][3]},
        {"name": "tail_band_bwd", "route": "cuda", "source": csrc + "tail_band_bwd.cu",
         "replaces": pallas + "tail_band.py:438",
         "launches": train_launches["tail_band_bwd"], "max_abs_err": k2b_err,
         "ms": k2b_ms, "plain_ms": k2b_plain_ms, **k2b_bound, "library_ms": None,
         "device_ms": k2b_dev,
         "device_ms_by_level": {"x4": k2b_dev, "x2": k2b_small_dev[2],
                                "x3": k2b_small_dev[3]},
         "variant_by_level": {f"x{sc}": f"{sc * sc} roles, one a phase block"
                              for sc in (2, 3, 4)},
         "launches_train_graph_capture": train_graph_launches["tail_band_bwd"],
         "launches_train_graph_capture_x2": scale_launches[2]["tail_band_bwd"],
         "launches_train_graph_capture_x3": scale_launches[3]["tail_band_bwd"],
         "launches_ddp_step_per_rank": par["ddp_step"][4]},
        {"name": "ff_conv", "route": "cuda", "source": csrc + "ff_conv.cu",
         "replaces": pallas + "ff_pair.py:60",
         "launches": launches["ff_conv"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, **k3_bound, "library_ms": k3_lib_ms,
         "device_ms": k3_dev[0], "library_device_ms": k3_dev[2],
         "launches_sharded_forward_per_rank": par["sharded_forward"][1],
         "launches_2d_mesh_per_rank": grid["launches"][1],
         "launches_graph_capture": graph_launches["ff_conv"],
         "launches_train_graph_capture": train_graph_launches["ff_conv"],
         "launches_train_graph_capture_x2": scale_launches[2]["ff_conv"],
         "launches_train_graph_capture_x3": scale_launches[3]["ff_conv"],
         "launches_ddp_step_per_rank": par["ddp_step"][1]},
        {"name": "halo_attn_qkv", "route": "cuda", "source": csrc + "cftm_branch.cu",
         "replaces": pallas + "halo_attn.py:253",
         "launches": k1n_launches, "max_abs_err": k1n_err,
         "ms": per_cftm(k1n_ms), "plain_ms": per_cftm(k1n_plain_ms),
         **cftm_bound(k1n_bound), "library_ms": None},
        # the three relayouts timed in phase 16, summed; its yardstick is
        # permute().contiguous(), which is also its plain version
        {"name": "relayout", "route": "cuda", "source": csrc + "relayout.cu",
         "replaces": pallas + "halo_attn_packed.py:338",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         **add_bounds(*(v[4] for v in k4.values())), "library_ms": k4_plain_ms},
        swin_row]}


def main() -> int:
    # one card: the first visible device, for this process and the CLI's
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    # a process that faults (this one, a CLI, a rank) prints its Python stack
    faulthandler.enable()
    os.environ["PYTHONFAULTHANDLER"] = "1"
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} devices visible, "
              "want 1", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "m2trans_tpu_torch")):
        print("chip_smoke: m2trans_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        kernels = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
