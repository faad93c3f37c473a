#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``m2trans_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes of the x4 serving and training paths, drives
the flagship forward (x4, n_feats 64, 8 blocks, seeded weights, batch 8 x
96x96 bf16) and the serving CLI ``python -m m2trans_tpu_torch.infer``, a
flagship bf16 train step (batch 2 x 96x96 -> 384x384) and the training
CLI ``python -m m2trans_tpu_torch.train`` on a synthetic US1K tree, and
times the kernels, the forward and the train step with CUDA events. Every
phase prints one line and the first failure exits non-zero. The line
before the last is the JSON kernel report (K1's and K1b's ``ms`` are one
CFTM's four launches, levels 0, 1, 2, 2), the last
``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or the
``m2trans_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

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
    kinds = {"K1": 0.0, "K1b": 0.0, "K2": 0.0, "K2b": 0.0, "reduce": 0.0,
             "other": 0.0}
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
    from m2trans_tpu_torch.ops.kernels import build
    from m2trans_tpu_torch.ops.kernels.halo_attn import (
        cftm_branch,
        cftm_branch_bwd,
        cftm_branch_plain,
        cftm_branch_plain_vjp,
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
        cftm_branch.launches = 0
        tail_band_fused.launches = 0
        y = model(x, kern)
        torch.cuda.synchronize()
        launches = {"cftm_branch": cftm_branch.launches,
                    "tail_band": tail_band_fused.launches}
        need(launches == {"cftm_branch": 32, "tail_band": 1},
             f"flagship forward launched {launches}, want 32 K1 and 1 K2")
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
            need(report["kernel_launches"] == {"cftm_branch": 32 * 4, "tail_band": 4},
                 f"infer kernel launches {report['kernel_launches']}")
        print(f"phase 6 infer CLI: 4 frames (3x 96x96, 1x 100x76) -> x4 PNGs; "
              f"report {json.dumps(report)}")

        # 7. times, CUDA events, median of 20 after warm-up
        k1_ms, k1_plain_ms = {}, {}
        for levels in (0, 1, 2):
            args, add = branch_case(levels, seed=levels)
            x_add = None if levels == 0 else add
            k1_ms[levels] = time_ms(lambda: cftm_branch(*args, x_add=x_add, levels=levels))
            k1_plain_ms[levels] = time_ms(
                lambda: cftm_branch_plain(*args, x_add=x_add, levels=levels))
        ops = tail_case(4, 8, 96, 96, seed=4)
        k2_ms = time_ms(lambda: tail_band_fused(*ops, scale=4, rgb_range=1.0))
        k2_plain_ms = time_ms(lambda: tail_band_plain(*ops, scale=4, rgb_range=1.0))
        fwd_ms = time_ms(lambda: model(x, kern))
        fwd_plain_ms = time_ms(lambda: m2trans_apply(model, x, cfg, plain))
        mp = 8 * 384 * 384 / 1e6
        print(f"phase 7 times (ms, median of 20): K1 L0/L1/L2 "
              f"{k1_ms[0]:.4f}/{k1_ms[1]:.4f}/{k1_ms[2]:.4f} vs plain "
              f"{k1_plain_ms[0]:.4f}/{k1_plain_ms[1]:.4f}/{k1_plain_ms[2]:.4f}; "
              f"K2 x4 {k2_ms:.4f} vs plain {k2_plain_ms:.4f}; forward b8 96x96 "
              f"kernels {fwd_ms:.3f} ms ({mp / fwd_ms * 1e3:.1f} MP/s) vs plain "
              f"{fwd_plain_ms:.3f} ms ({mp / fwd_plain_ms * 1e3:.1f} MP/s)")

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
    counters = (cftm_branch, tail_band_fused, cftm_branch_bwd, tail_band_bwd)
    for f in counters:
        f.launches = 0
    loss_k = float(step(lr_b, hr_b)["loss"])
    torch.cuda.synchronize()
    train_launches = {f.__name__: f.launches for f in counters}
    need(train_launches == {"cftm_branch": 32, "tail_band_fused": 1,
                            "cftm_branch_bwd": 32, "tail_band_bwd": 1},
         f"train step launched {train_launches}, want 32 + 1 forward and "
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

    # 7 (training). K1b / K2b and the flagship train step, timed
    k1b_ms, k1b_plain_ms = {}, {}
    for levels in (0, 1, 2):
        args, add = branch_case(levels, bsz=2, seed=10 + levels)
        x_add = None if levels == 0 else add
        gout = torch.randn(args[0].shape).bfloat16().cuda()
        k1b_ms[levels] = time_ms(lambda: cftm_branch_bwd(
            *args, gout, x_add=x_add, levels=levels))
        k1b_plain_ms[levels] = time_ms(lambda: cftm_branch_plain_vjp(
            *args, gout, x_add=x_add, levels=levels))
    ops, g = tail_case(4, 2, 96, 96, seed=24, with_grad=True)
    k2b_ms = time_ms(lambda: tail_band_bwd(*ops, g, scale=4, rgb_range=1.0))
    k2b_plain_ms = time_ms(lambda: tail_band_plain_vjp(*ops, g, scale=4, rgb_range=1.0))
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

    need_no_reference_package()

    def per_cftm(t):  # one CFTM's 4 branch launches: L0, L1, L2, L2
        return t[0] + t[1] + 2 * t[2]

    return {"kernels": [
        {"name": "cftm_branch", "route": "cuda",
         "source": "m2trans_tpu_torch/csrc/cftm_branch.cu",
         "replaces": "m2trans_tpu/ops/pallas/halo_attn.py:267",
         "launches": launches["cftm_branch"], "max_abs_err": k1_err,
         "ms": per_cftm(k1_ms), "plain_ms": per_cftm(k1_plain_ms)},
        {"name": "tail_band", "route": "cuda",
         "source": "m2trans_tpu_torch/csrc/tail_band.cu",
         "replaces": "m2trans_tpu/ops/pallas/tail_band.py:118",
         "launches": launches["tail_band"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "cftm_branch_bwd", "route": "cuda",
         "source": "m2trans_tpu_torch/csrc/cftm_branch_bwd.cu",
         "replaces": "m2trans_tpu/ops/pallas/halo_attn.py:1053",
         "launches": train_launches["cftm_branch_bwd"], "max_abs_err": k1b_err,
         "ms": per_cftm(k1b_ms), "plain_ms": per_cftm(k1b_plain_ms)},
        {"name": "tail_band_bwd", "route": "cuda",
         "source": "m2trans_tpu_torch/csrc/tail_band_bwd.cu",
         "replaces": "m2trans_tpu/ops/pallas/tail_band.py:438",
         "launches": train_launches["tail_band_bwd"], "max_abs_err": k2b_err,
         "ms": k2b_ms, "plain_ms": k2b_plain_ms}]}


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
