"""Where the kernels' device time goes, by ablation on the card.

    python3 -m m2trans_tpu_torch.tools.kernel_ablation [k1] [k2] [k3] [k1b] [k2b]

There is no hardware profiler on every machine that has the card, so each
kernel is rebuilt with a part compiled out and timed with ``torch.profiler``
at the serving shapes (8 x 96 x 96 and the single frame 1 x 512 x 512; the
backward kernels at the training shape 2 x 96 x 96):

- K2 (``csrc/tail_band.cu``, ``-DM2T_K2_ABLATE=bits``): the launch alone,
  GELU as the identity, no stage products, no contraction with w3, no
  gather, and everything but the y loads, barriers and stores off;
- K1 (``csrc/cftm_branch.cu`` with ``csrc/cftm_window.cuh``,
  ``-DM2T_K1_STOP=n``), every body of base width 16 (L = 0 a window to a
  warp, L = 1 to four warps, L = 2 to a cluster): cumulative through the
  launch, z and zc, the projection, the logits, the softmax, ``P v``;
- K3 (``csrc/ff_conv.cu``, ``-DM2T_FF_ABLATE=bits``): products, window
  copies, x loads and stores, alone and left out;
- K1b (``csrc/cftm_branch_bwd*.cu``, ``-DM2T_K1B_STOP=n``), L = 0, 1, 2 at base
  width 16: cumulative through the launches alone, the recompute to P, dO,
  dP, dS, dq, the whole of kernel (a) (dv, dk, rel-pos partials), kernel (b)
  up to its gather, the whole of kernel (b), and with the reduction;
- K2b (``csrc/tail_band_bwd.cu``, ``-DM2T_K2B_ABLATE=bits``), x4: the
  recompute, dw3, the conv adjoint, the stage-1 products, the stage-0
  transposes, the reductions and the first pass, each left out.

With no argument all five run. The ablated builds compute wrong results by
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
K1B_STEPS = {1: "the launches alone", 2: "recompute to P", 3: "dO",
             4: "dP", 5: "dS", 6: "dq", 7: "kernel (a) whole (dv, dk, drel)",
             8: "kernel (b)'s gather", 9: "kernel (b) whole (no reduction)",
             0: "whole group"}
K2B_VARIANTS = {0: "whole group", 64: "no first pass", 96: "second pass alone",
                97: "second pass, no recompute", 98: "second pass, no dw3",
                100: "second pass, no conv adjoint",
                104: "second pass, no stage-1 products",
                112: "second pass, no stage-0 transposes",
                127: "second pass: tile load, gm halo and stores only"}
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
    """One shared library of ``source`` (several sources: separated by
    blanks) per macro value, built side by side."""
    nvcc = build._nvcc()
    libs, procs = {}, []
    sources = source.split()
    for v in values:
        out = tmp / f"{Path(sources[0]).stem}_{macro}_{v}.so"
        procs.append(subprocess.Popen(
            # -Bsymbolic: calls between a variant's own sources stay inside it
            # though the whole library, loaded beside it, has the same names
            [nvcc, *build.NVCC_FLAGS, f"-D{macro}={v}", "-shared", "-Xlinker",
             "-Bsymbolic", "-o", str(out),
             *(str(build.CSRC / src) for src in sources)], stdout=subprocess.PIPE,
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
    only = set(sys.argv[1:] if argv is None else argv) or {"k3", "k1", "k2",
                                                           "k1b", "k2b"}
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
    # a variant built from one source finds the other sources' entry points
    # (K2's kernel, the reduction) in the whole library
    ctypes.CDLL(str(build.build()), mode=ctypes.RTLD_GLOBAL)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        tmp = Path(tmp)
        ff = build_variants(tmp, "ff_conv.cu", "M2T_FF_ABLATE",
                            FF_VARIANTS if "k3" in only else {})
        k1 = build_variants(tmp, "cftm_branch.cu", "M2T_K1_STOP",
                            K1_STEPS if "k1" in only else {})
        k2 = build_variants(tmp, "tail_band.cu", "M2T_K2_ABLATE",
                            K2_VARIANTS if "k2" in only else {})
        k1b = build_variants(tmp, "cftm_branch_bwd.cu cftm_branch_bwd_attn.cu "
                             "cftm_branch_bwd_general.cu", "M2T_K1B_STOP",
                             K1B_STEPS if "k1b" in only else {})
        k2b = build_variants(tmp, "tail_band_bwd.cu", "M2T_K2B_ABLATE",
                             K2B_VARIANTS if "k2b" in only else {})

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

        from m2trans_tpu_torch.ops.kernels import halo_attn, tail_band

        for levels in (0, 1, 2):
            if not k1b:
                break
            c = 16 * 4 ** levels
            body = torch.randn(2, 96, 96, 64, generator=gen).bfloat16().cuda()
            xs = body[..., 16:32]
            add = torch.randn(2, 96, 96, 16, generator=gen).bfloat16().cuda()
            gout = torch.randn(2, 96, 96, 16, generator=gen).bfloat16().cuda()
            w = (torch.randn(c, 3 * c, generator=gen) * c ** -0.5).bfloat16().cuda()
            rel_h = torch.randn(10, c // 2, generator=gen).cuda()
            rel_w = torch.randn(10, c // 2, generator=gen).cuda()
            s = (torch.rand(2, 16, generator=gen) + 0.5).cuda()
            t = (torch.randn(2, 16, generator=gen) * 0.2).cuda()
            for step, what in K1B_STEPS.items():
                lib = k1b[step]
                lib.m2t_cftm_branch_bwd.argtypes = build.SIGNATURES["m2t_cftm_branch_bwd"]

                def call():
                    halo_attn._bwd_launch(lib, xs, w, rel_h, rel_w, s, t, gout,
                                          add, 0.5, levels)

                print(f"K1b L={levels} 2x96x96x16 through {what}: "
                      f"{device_ms(call):.4f} ms")

        if k2b:
            ops = tail_operands(gen, 4, 2, 96, 96)
            g = torch.randn(2, 96, 96, 48, generator=gen).bfloat16().cuda()
            for bits, what in K2B_VARIANTS.items():
                lib = k2b[bits]
                lib.m2t_tail_band_bwd.argtypes = build.SIGNATURES["m2t_tail_band_bwd"]

                def call():
                    tail_band._bwd_launch(lib, *ops, g, 4, 1.0)

                print(f"K2b x4 2x96x96x64 {what}: {device_ms(call):.4f} ms "
                      "(the fills of the outputs included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
