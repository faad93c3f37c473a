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
times the kernels, the forward and the train step with CUDA events. Every
phase prints one line and the first failure exits non-zero. The line
before the last is the JSON kernel report (K1's, K1b's and K1n's numbers
are one CFTM's four launches, levels 0, 1, 2, 2; ``bound_ms`` is the larger
of bytes / 3.35 TB/s and operations / 989 TFLOP/s, counted from the
operands of this run), the last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or the
``m2trans_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, data sheet


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
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errs(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def device_ms(fn, n: int = 20, warm: int = 3):
    """Device time of one call of ``fn``: the sum over its kernels from
    torch.profiler (CUPTI) over ``n`` calls, so host launch overhead and the
    gaps between kernels are left out; None where the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            total += ev.cuda_time_total if us is None else us
    return total / 1e3 / n if total else None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def nbytes(*tensors) -> int:
    """Bytes of the operands, each counted once (a channel slice counts its
    own elements)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 tensor-core peak."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def add_bounds(*bs) -> dict:
    """The bound of several launches in a row (their sum); bound_by is that
    of the largest share."""
    top = max(bs, key=lambda b: b["bound_ms"])
    return {"bound_ms": sum(b["bound_ms"] for b in bs), "bound_by": top["bound_by"]}


def branch_flops(x, levels: int) -> float:
    """Operations of one wavelet branch on x (B, H, W, cb): the qkv
    projection, 2 * 3C^2 per coarse pixel, and q k^T and P v over the 100
    keys of each query, 2 * 2 * 100 * C per coarse pixel."""
    bsz, h, w, cb = x.shape
    c, n = cb * 4 ** levels, bsz * h * w // 4 ** levels
    return n * (6.0 * c * c + 400.0 * c)


def tail_flops(y, scale: int) -> float:
    """Operations of the tail on y (B, H, W, nf): the 1x1 stages and the 3x3
    conv to 3 channels at the output resolution."""
    n, nf = y.shape[0] * y.shape[1] * y.shape[2], y.shape[3]
    if scale == 4:
        stages = 2.0 * n * nf * 4 * nf + 2.0 * 4 * n * nf * 4 * nf
    else:
        stages = 2.0 * n * nf * nf * scale * scale
    return stages + 2.0 * scale * scale * n * 9 * nf * 3


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


def write_benchmark_tree(root, rng, shapes):
    """Synthetic CCA-US (benchmark/UI5) tree for the x4 eval CLI: smooth HR
    frames of the LR ``shapes`` times 4 (sums of random sinusoids plus a
    little noise), LR x4 by striding, written as JPEGs with Pillow."""
    import numpy as np
    from PIL import Image

    hr_dir = os.path.join(root, "benchmark/UI5/HR")
    lr_dir = os.path.join(root, "benchmark/UI5/LR_bicubic/X4")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:4 * h, 0:4 * w].astype(np.float64)
        img = np.zeros((4 * h, 4 * w, 3))
        for _ in range(6):
            fy, fx = rng.uniform(0.005, 0.08, 2)
            img += rng.uniform(0.2, 1.0, 3) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.28))[..., None]
        img = (img - img.min()) / (img.max() - img.min())
        u8 = np.clip(img * 255 + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(os.path.join(hr_dir, f"e{i}.jpg"), quality=95)
        Image.fromarray(u8[::4, ::4]).save(os.path.join(lr_dir, f"e{i}x4.jpg"),
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
    NHWC body tensor, as the model passes it."""
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


def write_us1k_tree(root, rng, n=3, hr=(400, 392), eval_hr=(128, 96)):
    """Synthetic US1K tree for the x4 training CLI: n HR PNGs of ``hr``
    (at least a 384x384 patch) with LR x4 by striding, and one CCA-US
    (benchmark/UI5) pair, written with Pillow."""
    import numpy as np
    from PIL import Image

    dirs = {k: os.path.join(root, v) for k, v in (
        ("hr", "US1K/US1K_train_HR"), ("lr", "US1K/US1K_train_LR_bicubic/X4"),
        ("bhr", "benchmark/UI5/HR"), ("blr", "benchmark/UI5/LR_bicubic/X4"))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (*hr, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(dirs["hr"], f"{i:04d}.png"))
        Image.fromarray(img[::4, ::4]).save(os.path.join(dirs["lr"], f"{i:04d}x4.png"))
    img = rng.integers(0, 256, (*eval_hr, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(dirs["bhr"], "b0.jpg"))
    Image.fromarray(img[::4, ::4]).save(os.path.join(dirs["blr"], "b0x4.jpg"))


def profile_split(fn) -> str:
    """Device time of one call of ``fn`` by kind of kernel, from
    torch.profiler (CUPTI); "not measured" where it records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"K1": 0.0, "K1b": 0.0, "K2": 0.0, "K2b": 0.0, "K3": 0.0,
             "reduce": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops; their device time is their kernels'
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        k = ev.key
        kind = ("K1b" if "cftm_bwd" in k else "K1" if "cftm_branch_kernel" in k
                else "K2b" if "tail_band_bwd_kernel" in k
                else "K2" if "tail_band_kernel" in k
                else "K3" if "ff_conv_kernel" in k
                else "reduce" if "reduce_rows_kernel" in k else "other")
        kinds[kind] += us / 1e3
    total = sum(kinds.values())
    if total == 0:
        return "not measured (the profiler recorded no device time)"
    return ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items()) + \
        f"; total {total:.3f} ms"


def run() -> dict:
    import torch

    from m2trans_tpu_torch.config import load_config
    from m2trans_tpu_torch.models.m2trans import (
        ComputePolicy,
        init_m2trans,
        m2trans_apply,
    )
    from m2trans_tpu_torch.models import m2trans as port_model
    from m2trans_tpu_torch.ops.kernels import build, relayout
    from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv, ff_conv_plain
    from m2trans_tpu_torch.ops.kernels.halo_attn import (
        cftm_branch,
        cftm_branch_bwd,
        cftm_branch_plain,
        cftm_branch_plain_vjp,
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

    # 2. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    lib_path = build.build()
    build.lib()
    print(f"phase 2 built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds} s)")

    # 3. K1 vs its plain version at the slice shapes
    k1_err, parts = 0.0, []
    for levels in (0, 1, 2):
        args, add = branch_case(levels, seed=levels)
        for x_add in (None, add):
            got = cftm_branch(*args, x_add=x_add, levels=levels)
            want = cftm_branch_plain(*args, x_add=x_add, levels=levels)
            torch.cuda.synchronize()
            mx, mean = errs(got, want)
            need(torch.isfinite(got.float()).all().item(), "K1 output not finite")
            need(mx < K1_TOL[0] and mean < K1_TOL[1],
                 f"K1 L={levels} add={x_add is not None}: max {mx} mean {mean}")
            k1_err = max(k1_err, mx)
            parts.append(f"L{levels}{'+add' if x_add is not None else ''} "
                         f"max {mx:.3g} mean {mean:.3g}")
    print("phase 3 K1 cftm_branch vs plain (bf16, 8x96x96x16): " + "; ".join(parts))

    # 4. K2 vs its plain version: the x4 slice shape, and x2 / x3
    k2_err, parts = 0.0, []
    for scale, shp in ((4, (8, 96, 96)), (2, (2, 48, 40)), (3, (2, 32, 24))):
        ops = tail_case(scale, *shp, seed=scale)
        got = tail_band_fused(*ops, scale=scale, rgb_range=1.0)
        want = tail_band_plain(*ops, scale=scale, rgb_range=1.0)
        torch.cuda.synchronize()
        mx, _ = errs(got, want)
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
        with tempfile.TemporaryDirectory(dir=work) as tmp:
            pt = os.path.join(tmp, "model_x4.pt")
            torch.save({"model_state_dict": reference_state_dict(model, True)}, pt)
            frames, out = os.path.join(tmp, "frames"), os.path.join(tmp, "out")
            os.makedirs(frames)
            rng = np.random.default_rng(0)
            shapes = {"f0.png": (96, 96), "f1.png": (96, 96), "f2.png": (96, 96),
                      "f3.png": (100, 76)}
            from PIL import Image

            for name, hw in shapes.items():
                Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                    os.path.join(frames, name))
            cmd = [sys.executable, "-m", "m2trans_tpu_torch.infer", "--config",
                   CONFIG, "--model_path", pt, "--input", frames, "--output", out]
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                 timeout=600)
            need(res.returncode == 0, f"infer exited {res.returncode}:\n{res.stderr}")
            report = json.loads(res.stdout.strip().splitlines()[-1])
            for name, (h, w) in shapes.items():
                with Image.open(os.path.join(out, name)) as img:
                    size = (img.height, img.width, len(img.getbands()))
                need(size == (4 * h, 4 * w, 3), f"{name}: shape {size}")
            need(report.get("frames") == 4, f"report {report}")
            need(report["kernel_launches"] == {"cftm_branch": 32 * 4,
                                               "ff_conv": 8 * 4, "tail_band": 4},
                 f"infer kernel launches {report['kernel_launches']}")
        print(f"phase 6 infer CLI: 4 frames (3x 96x96, 1x 100x76) -> x4 PNGs; "
              f"report {json.dumps(report)}")

        # 7. times, CUDA events, median of 20 after warm-up
        k1_ms, k1_plain_ms, k1_bound = {}, {}, {}
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
        fwd_split = profile_split(lambda: model(x, kern))
        mp = 8 * 384 * 384 / 1e6
        print(f"phase 7 times (ms, median of 20): K1 L0/L1/L2 "
              f"{k1_ms[0]:.4f}/{k1_ms[1]:.4f}/{k1_ms[2]:.4f} vs plain "
              f"{k1_plain_ms[0]:.4f}/{k1_plain_ms[1]:.4f}/{k1_plain_ms[2]:.4f}; "
              f"K2 x4 {k2_ms:.4f} vs plain {k2_plain_ms:.4f}; forward b8 96x96 "
              f"kernels {fwd_ms:.3f} ms ({mp / fwd_ms * 1e3:.1f} MP/s), with the ff "
              f"conv plain {fwd_no_k3_ms:.3f} ms, kernels again {fwd_ms2:.3f} ms, vs "
              f"plain {fwd_plain_ms:.3f} ms ({mp / fwd_plain_ms * 1e3:.1f} MP/s); "
              f"device time of one kernel forward by kind: {fwd_split}")

    # 8. K1b vs its plain VJP at the training shapes (batch 2 x 96x96)
    k1b_err, parts = 0.0, []
    for levels in (0, 1, 2):
        args, add = branch_case(levels, bsz=2, seed=10 + levels)
        gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
            levels)).bfloat16().cuda()
        for x_add in (None, add):
            got = cftm_branch_bwd(*args, gout, x_add=x_add, levels=levels)
            want = cftm_branch_plain_vjp(*args, gout, x_add=x_add, levels=levels)
            torch.cuda.synchronize()
            mx = grad_errs(got, want, f"K1b L={levels} add={x_add is not None}")
            k1b_err = max(k1b_err, mx)
            parts.append(f"L{levels}{'+add' if x_add is not None else ''} max {mx:.3g}")
    print("phase 8 K1b cftm_branch_bwd vs plain VJP (bf16, 2x96x96x16, "
          "dx dx_add ds dt dw drel_h drel_w within max(2e-3, 2e-2 max|b|)): "
          + "; ".join(parts))

    # 9. K2b vs its plain VJP: the x4 training shape, and x2 / x3
    k2b_err, parts = 0.0, []
    for scale, shp in ((4, (2, 96, 96)), (2, (2, 48, 40)), (3, (2, 32, 24))):
        ops, g = tail_case(scale, *shp, seed=20 + scale, with_grad=True)
        got = tail_band_bwd(*ops, g, scale=scale, rgb_range=1.0)
        want = tail_band_plain_vjp(*ops, g, scale=scale, rgb_range=1.0)
        torch.cuda.synchronize()
        mx = grad_errs(got, want, f"K2b x{scale}")
        k2b_err = max(k2b_err, mx)
        parts.append(f"x{scale} {shp} max {mx:.3g}")
    print("phase 9 K2b tail_band_bwd vs plain VJP (bf16, nf 64, all ten "
          "operand gradients within max(2e-3, 2e-2 max|b|)): " + "; ".join(parts))

    # 10. the flagship bf16 train step of the training loop, as the train
    # CLI runs it (make_train_step: policy_from_config, L1, backward, Adam)
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    tcfg = cfg.replace(dtype="bfloat16", use_pallas=True)
    gen = torch.Generator().manual_seed(2)
    lr_b = torch.rand(2, 96, 96, 3, generator=gen).to(dev)
    hr_b = torch.rand(2, 384, 384, 3, generator=gen).to(dev)

    def train_model(c):
        m = init_m2trans(c, seed=0, device=dev)
        return m, make_train_step(c, m, make_optimizer(c, m))

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

    # 12. K3 vs its plain version: the slice shape and a frame with edge tiles
    k3_err, parts = 0.0, []
    for shp in ((8, 96, 96, 64), (2, 104, 88, 64)):
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
        n = len(eval_shapes)
        need(l_f32 == {"cftm_branch": 0, "ff_conv": 0, "tail_band_fused": 0},
             f"the f32 eval launched kernels: {l_f32}")
        need(eval_launches == {"cftm_branch": 32 * n, "ff_conv": 8 * n,
                               "tail_band_fused": n},
             f"the bf16 eval launched {eval_launches}, want {32 * n} K1, "
             f"{8 * n} K3, {n} K2")
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
    print(f"phase 15 eval CLI x4, 4 frames (3x 96x96, 1x 100x76 LR), FSIM/GMSD: "
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
        st = make_train_step(c, m, make_optimizer(c, m))
        step_ms[name] = time_ms(lambda: st(lr_b, hr_b), n=10)
    split = profile_split(lambda: step(lr_b, hr_b))
    print(f"phase 7 training times (ms, median of 20; steps of 10): K1b L0/L1/L2 "
          f"{k1b_ms[0]:.4f}/{k1b_ms[1]:.4f}/{k1b_ms[2]:.4f} vs plain VJP "
          f"{k1b_plain_ms[0]:.4f}/{k1b_plain_ms[1]:.4f}/{k1b_plain_ms[2]:.4f}; "
          f"K2b x4 {k2b_ms:.4f} vs plain VJP {k2b_plain_ms:.4f}; train step b2 "
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
         **cftm_bound(k1_bound), "library_ms": None},
        {"name": "tail_band", "route": "cuda", "source": csrc + "tail_band.cu",
         "replaces": pallas + "tail_band.py:118",
         "launches": launches["tail_band"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, **k2_bound, "library_ms": None},
        {"name": "cftm_branch_bwd", "route": "cuda",
         "source": csrc + "cftm_branch_bwd.cu",
         "replaces": pallas + "halo_attn.py:1053",
         "launches": train_launches["cftm_branch_bwd"], "max_abs_err": k1b_err,
         "ms": per_cftm(k1b_ms), "plain_ms": per_cftm(k1b_plain_ms),
         **cftm_bound(k1b_bound), "library_ms": None},
        {"name": "tail_band_bwd", "route": "cuda", "source": csrc + "tail_band_bwd.cu",
         "replaces": pallas + "tail_band.py:438",
         "launches": train_launches["tail_band_bwd"], "max_abs_err": k2b_err,
         "ms": k2b_ms, "plain_ms": k2b_plain_ms, **k2b_bound, "library_ms": None},
        {"name": "ff_conv", "route": "cuda", "source": csrc + "ff_conv.cu",
         "replaces": pallas + "ff_pair.py:60",
         "launches": launches["ff_conv"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, **k3_bound, "library_ms": k3_lib_ms},
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
         **add_bounds(*(v[4] for v in k4.values())), "library_ms": k4_plain_ms}]}


def main() -> int:
    # one card: the first visible device, for this process and the CLI's
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
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
