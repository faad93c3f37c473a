"""Where K3's and K1's (C = 256) device time goes, by ablation on the card.

    python3 -m m2trans_tpu_torch.tools.kernel_ablation

There is no hardware profiler on every machine that has the card, so each
kernel is rebuilt with a part compiled out (``-DM2T_FF_ABLATE=bits`` for
``csrc/ff_conv.cu``, ``-DM2T_K1_STOP=n`` for ``csrc/cftm_branch.cu``) and
timed with ``torch.profiler`` at the serving shapes (8 x 96 x 96 x 64 for
K3; 8 x 96 x 96 x 16 at L = 2 for K1, and 1 x 512 x 512). The ablated
builds compute wrong results by design; only their device times are read.
Prints the card's name and power limit, then one line per variant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from m2trans_tpu_torch.ops.kernels import build

FF_VARIANTS = {0: "whole kernel", 1: "no products", 2: "no window copies",
               4: "no x loads, no out stores", 6: "products only",
               5: "window copies only", 3: "x loads and out stores only"}
K1_STEPS = {1: "the launch alone", 2: "z and zc formed", 3: "projection", 4: "partial logits",
            5: "cluster sum + softmax", 6: "P v", 0: "whole kernel"}


def device_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Device time of one call of ``fn`` (sum over its kernels, CUPTI)."""
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
    return total / 1e3 / n


def build_variants(tmp: Path, source: str, macro: str, values) -> dict:
    """One shared library of ``source`` per macro value, built side by side."""
    nvcc = build._nvcc()
    libs, procs = {}, []
    for v in values:
        out = tmp / f"{Path(source).stem}_{macro}_{v}.so"
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, f"-D{macro}={v}", "-shared", "-o", str(out),
             str(build.CSRC / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        libs[v] = out
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    return {v: ctypes.CDLL(str(path)) for v, path in libs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print("K1 C = 256 body: clusters of 4 CTAs resident at once:",
          build.lib().m2t_cftm_branch_clusters())
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        tmp = Path(tmp)
        ff = build_variants(tmp, "ff_conv.cu", "M2T_FF_ABLATE", FF_VARIANTS)
        k1 = build_variants(tmp, "cftm_branch.cu", "M2T_K1_STOP", K1_STEPS)

        for shape in ((8, 96, 96, 64), (1, 512, 512, 64)):
            c = shape[-1]
            oc = torch.randn(shape, generator=gen).bfloat16().cuda()
            x = torch.randn(shape, generator=gen).bfloat16().cuda()
            w = (torch.randn(3, 3, c, c, generator=gen) * 0.04).bfloat16().cuda()
            b = torch.randn(c, generator=gen).bfloat16().cuda()
            out = torch.empty_like(oc)
            for bits, what in FF_VARIANTS.items():
                fn = ff[bits].m2t_ff_conv
                fn.argtypes = build.SIGNATURES["m2t_ff_conv"]

                def call():
                    build.check(fn(oc.data_ptr(), x.data_ptr(), w.data_ptr(),
                                   b.data_ptr(), out.data_ptr(), *shape, stream),
                                "ff_conv")

                print(f"K3 {shape} {what}: {device_ms(call):.4f} ms")

        for bsz, hw in ((8, 96), (1, 512)):
            body = torch.randn(bsz, hw, hw, 64, generator=gen).bfloat16().cuda()
            xs = body[..., 16:32]
            add = torch.randn(bsz, hw, hw, 16, generator=gen).bfloat16().cuda()
            w = (torch.randn(256, 768, generator=gen) / 16).bfloat16().cuda()
            rel_h = torch.randn(10, 128, generator=gen).cuda()
            rel_w = torch.randn(10, 128, generator=gen).cuda()
            s = (torch.rand(bsz, 16, generator=gen) + 0.5).cuda()
            t = (torch.randn(bsz, 16, generator=gen) * 0.2).cuda()
            out = torch.empty_like(add)
            for step, what in K1_STEPS.items():
                fn = k1[step].m2t_cftm_branch
                fn.argtypes = build.SIGNATURES["m2t_cftm_branch"]

                def call():
                    build.check(fn(
                        xs.data_ptr(), add.data_ptr(), s.data_ptr(), t.data_ptr(),
                        w.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                        out.data_ptr(), bsz, hw, hw, 16, 2, *xs.stride()[:3],
                        *add.stride()[:3], 0.5, stream), "cftm_branch")

                print(f"K1 L=2 {bsz}x{hw}x{hw}x16 through {what}: "
                      f"{device_ms(call):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
