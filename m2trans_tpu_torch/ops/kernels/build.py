"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are ``m2trans_tpu_torch/csrc/*.cu`` (with the ``*.cuh``
headers they share), compiled at first use, one nvcc process per source,
all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <tmp>/<source>.o csrc/<source>.cu

then linked by ``nvcc -shared`` into
``<build dir>/libm2t_kernels_<hash>.so``,

into ``m2trans_tpu_torch/build/``, beside the sources it is built from: in
a checkout a directory that ``.gitignore``'s ``build/`` rule covers, in an
installed copy a directory of that installation alone. The library has a
plain C interface, so it builds in seconds; nothing includes PyTorch's
headers. Its name carries a hash of the sources, so an edited source is
rebuilt.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero
code. There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# argtypes of every C entry point (csrc/*.cu)
SIGNATURES = {
    "m2t_cftm_branch": [P, P, P, P, P, P, P, P,   # x xadd s t w relh relw out
                        I, I, I, I, I,             # B H W Cb levels
                        LL, LL, LL, LL, LL, LL,    # x / xadd strides b, h, w
                        F, P],                     # r, stream
    "m2t_cftm_branch_smem": [I],
    "m2t_cftm_branch_variant": [I, I],             # Cb levels
    "m2t_cftm_branch_resident": [I],               # levels (base width 16)
    "m2t_halo_attn_qkv": [P, P, P, P, P,          # x w relh relw out
                          I, I, I, I, I,           # B H W Cb levels
                          LL, LL, LL, P],          # x strides b, h, w; stream
    "m2t_cftm_branch_bwd": [P, P, P, P, P, P, P, P,  # x xadd s t w relh relw gout
                            P, P, P, P, P, P,        # dq dk dv drel_part dw_part st_part
                            P, P, P, P, P,           # dx dxadd dw drel st
                            I, I, I, I, I,           # B H W Cb levels
                            LL, LL, LL, LL, LL, LL,  # x / xadd strides b, h, w
                            F, P],                   # r, stream
    "m2t_cftm_branch_bwd_smem": [I, I, I],           # Cb levels which
    "m2t_cftm_branch_bwd_variant": [I, I],           # Cb levels
    "m2t_reduce_batched": [P, I, I, LL, P, P],       # part nbatch n len out stream
    "m2t_tail_band": [P, P, P, P, P, P,            # y w0 b0 w1 b1 w3
                      P, P, P, P, P,               # lc rc top bot out
                      I, I, I, I, I, F, P],        # B H W nf scale rgb stream
    "m2t_tail_band_smem": [I, I],                  # nf scale
    "m2t_tail_band_tile": [I],                     # 0 rows, 1 columns
    "m2t_tail_band_bwd": [P, P, P, P, P, P,        # y w0 b0 w1 b1 w3
                          P, P, P, P, P,           # lc rc top bot g
                          P, P, P, P, P,           # gm partA partB part3 dy_part
                          P, P, P, P, P, P, P, P,  # dy outA outB dw3 dlc drc dtop dbot
                          I, I, I, I, I, F, P],    # B H W nf scale rgb stream
    "m2t_tail_band_bwd_blocks": [I],               # scale
    "m2t_tail_band_bwd_smem": [I, I],
    "m2t_ff_conv": [P, P, P, P, P,                 # oc x w b out
                    I, I, I, I, P],                # B H W C stream
    "m2t_ff_conv_smem": [I],
    "m2t_in_stats": [P, P, P, I, LL, I, F, P],    # x part st B HW C eps stream
    "m2t_in_stats_part_floats": [I, LL, I],        # B HW C
    "m2t_relayout": [P, P, I, I, I, I, I, I, I, P],  # src dst B H W g nb cb pack stream
    "m2t_mark": [I, P],                            # which stream
    "m2t_swin_attn": [P, P, P, P, P,               # q k v table out
                      I, I, I, I, I, I,            # B H W C heads shift
                      F, I, P],                    # scale is_bf16 stream
    "m2t_swin_attn_bwd": [P, P, P, P, P,           # q k v table gout
                          P, P, P,                 # dq dk dv
                          I, I, I, I, I, I,        # B H W C heads shift
                          F, I, P],                # scale is_bf16 stream
    "m2t_hat_wattn": [P, P, P, LL, P, P,          # q k v pixel-stride table out
                      I, I, I, I, I, I, F, P],     # B H W C heads shift scale stream
    "m2t_hat_oca": [P, P, P, LL, P, P,            # q k v pixel-stride table out
                    I, I, I, I, I, F, P],          # B H W C heads scale stream
    "m2t_ss2d_scan": [P, P, P, P, P, P, P, P,     # x xdbl dtw dtb A Ds part y
                      I, I, I, I, I, P],           # B H W D R stream
    "m2t_row_norm": [P, P, P, P, P, P, P,         # x other scale gamma beta xout out
                     LL, I, I, F, P],              # rows C gated eps stream
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run of this process, if any


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from m2trans_tpu_torch/csrc at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libm2t_kernels_{h.hexdigest()[:16]}.so"


def sources():
    return sorted(CSRC.glob("*.cu"))


def _run_all(cmds):
    """Run the commands side by side; raise on the first that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources if their library is not built yet; return its
    path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp_{out.stem}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [tmp / f"{src.stem}.o" for src in sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
              for s, o in zip(sources(), objs)])
    lib_tmp = tmp / out.name
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
               *map(str, objs)]])
    os.replace(lib_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = dll
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
