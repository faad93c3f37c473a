#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``m2trans_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes of the x4 serving path, drives the flagship
forward (x4, n_feats 64, 8 blocks, seeded weights, batch 8 x 96x96 bf16)
and the serving CLI ``python -m m2trans_tpu_torch.infer``, and times the
kernels and the forward with CUDA events. Every phase prints one line and
the first failure exits non-zero. The line before the last is the JSON
kernel report (K1's ``ms`` is one CFTM's four launches, levels 0, 1, 2,
2), the last ``{"ok": true, "device": {...}}``.

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


def tail_case(scale, bsz, h, w, nf=64, seed=0):
    """K2 operands: random tail weights with PyTorch's init bounds and a
    unit-normal body output."""
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
    return tail_band_operands(p, y, scale=scale)


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
        cftm_branch_plain,
    )
    from m2trans_tpu_torch.ops.kernels.tail_band import (
        tail_band_fused,
        tail_band_plain,
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

    # 5. the flagship forward through the model's entry point
    cfg = load_config(os.path.join(ROOT, CONFIG))
    need((cfg.scale, cfg.n_feats, cfg.n_blocks) == (4, 64, 8), "flagship config")
    dev = torch.device("cuda")
    model = init_m2trans(cfg, seed=0, device=dev)
    x = torch.rand(8, 96, 96, 3, generator=torch.Generator().manual_seed(1)).to(dev)
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
         "ms": k2_ms, "plain_ms": k2_plain_ms}]}


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
