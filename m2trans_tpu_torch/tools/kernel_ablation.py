"""Where the kernels' device time goes, by ablation on the card.

    python3 -m m2trans_tpu_torch.tools.kernel_ablation [k1] [k2] [k3]

There is no hardware profiler on every machine that has the card, so each
kernel is rebuilt with a part compiled out and timed with ``torch.profiler``
at the serving shapes (8 x 96 x 96 and the single frame 1 x 512 x 512):

- K2 (``csrc/tail_band.cu``, ``-DM2T_K2_ABLATE=bits``): the launch alone,
  GELU as the identity, no stage products, no contraction with w3, no
  gather, and everything but the y loads, barriers and stores off;
- K1 (``csrc/cftm_branch.cu`` with ``csrc/cftm_window.cuh``,
  ``-DM2T_K1_STOP=n``), every body of base width 16 (L = 0 a window to a
  warp, L = 1 to four warps, L = 2 to a cluster): cumulative through the
  launch, z and zc, the projection, the logits, the softmax, ``P v``;
- K3 (``csrc/ff_conv.cu``, ``-DM2T_FF_ABLATE=bits``): products, window
  copies, x loads and stores, alone and left out.

With no argument all three run. The ablated builds compute wrong results by
design; only their device times are read. Prints the card's name and power
limit, then one line per variant.
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
K1_STEPS = {1: "the launch alone", 2: "z and zc formed", 3: "projection",
            4: "(partial) logits", 5: "(cluster sum +) softmax", 6: "P v",
            0: "whole kernel"}
K2_VARIANTS = {0: "whole kernel", 1: "the launch alone", 2: "GELU as the identity",
               4: "no stage products", 8: "no contraction with w3 (no T)",
               16: "no gather", 30: "y loads, barriers and stores only"}


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


def tail_operands(gen, scale, bsz, h, w, nf=64):
    """K2's ten operands with random values of the right size."""
    cp = scale * scale * nf
    cp0 = 4 * nf if scale == 4 else cp

    def bf(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).bfloat16().cuda()

    def f32(*shape):
        return torch.rand(*shape, generator=gen).cuda()

    return (bf(bsz, h, w, nf), bf(nf, cp0, std=nf ** -0.5), bf(cp0, std=0.1),
            bf(nf, 4 * nf if scale == 4 else cp0, std=nf ** -0.5),
            bf(4 * nf if scale == 4 else cp0, std=0.1), bf(3, 3, nf, 3, std=0.04),
            f32(bsz, h + 2, cp), f32(bsz, h + 2, cp), f32(bsz, w + 2, cp),
            f32(bsz, w + 2, cp))


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv) or {"k3", "k1", "k2"}
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print("K1 at base width 16, windows resident at once at L = 0 / L = 1 and "
          "clusters of 4 CTAs at L = 2:",
          [build.lib().m2t_cftm_branch_resident(i) for i in range(3)])
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        tmp = Path(tmp)
        ff = build_variants(tmp, "ff_conv.cu", "M2T_FF_ABLATE",
                            FF_VARIANTS if "k3" in only else {})
        k1 = build_variants(tmp, "cftm_branch.cu", "M2T_K1_STOP",
                            K1_STEPS if "k1" in only else {})
        k2 = build_variants(tmp, "tail_band.cu", "M2T_K2_ABLATE",
                            K2_VARIANTS if "k2" in only else {})

        for bsz, hw in ((8, 96), (1, 512)):
            ops = tail_operands(gen, 4, bsz, hw, hw)
            out = torch.empty(bsz, hw, hw, 48, dtype=torch.bfloat16, device="cuda")
            for bits, what in K2_VARIANTS.items():
                if bits not in k2:
                    continue
                fn = k2[bits].m2t_tail_band
                fn.argtypes = build.SIGNATURES["m2t_tail_band"]

                def call():
                    build.check(fn(*(t.data_ptr() for t in ops), out.data_ptr(),
                                   bsz, hw, hw, 64, 4, 1.0, stream), "tail_band")

                print(f"K2 x4 {bsz}x{hw}x{hw}x64 {what}: {device_ms(call):.4f} ms")

        for shape in ((8, 96, 96, 64), (1, 512, 512, 64)):
            if not ff:
                break
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

        for levels, bsz, hw in ((0, 8, 96), (1, 8, 96), (2, 8, 96), (0, 1, 512),
                                (1, 1, 512), (2, 1, 512)):
            if not k1:
                break
            c = 16 * 4 ** levels
            body = torch.randn(bsz, hw, hw, 64, generator=gen).bfloat16().cuda()
            xs = body[..., 16:32]
            add = torch.randn(bsz, hw, hw, 16, generator=gen).bfloat16().cuda()
            w = (torch.randn(c, 3 * c, generator=gen) * c ** -0.5).bfloat16().cuda()
            rel_h = torch.randn(10, c // 2, generator=gen).cuda()
            rel_w = torch.randn(10, c // 2, generator=gen).cuda()
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
                        out.data_ptr(), bsz, hw, hw, 16, levels, *xs.stride()[:3],
                        *add.stride()[:3], 0.5, stream), "cftm_branch")

                print(f"K1 L={levels} {bsz}x{hw}x{hw}x16 through {what}: "
                      f"{device_ms(call):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
