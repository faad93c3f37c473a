"""The C++ training loader (``loader.cc``), bound with ctypes; port of
m2trans_tpu/runtime.

``loader.cc`` is the port's own copy of the JAX package's loader, with the
same sampling, so for one npy cache, seed and epoch both packages yield the
same batches, bit for bit. It is compiled at first use,

    g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cc -o <so>

into ``m2trans_tpu_torch/build/`` (where ``ops/kernels/build.py`` puts the
CUDA kernels) as ``libm2t_loader_<hash>.so``, named by a hash of the source
and the flags, so an edited source is rebuilt; nothing is written beside
the source. The library has a plain C interface and builds in seconds. A
failed build raises with g++'s output: there is no fallback for it. A cache
the loader cannot index (an LR image smaller than the patch, HR and LR
channels that differ, anything but uint8 C-order arrays, a file shorter
than its header says) raises
:class:`LoaderRejected`, on which ``data/pipeline.py::create_datasets``
uses the Python loader, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from m2trans_tpu_torch.ops.kernels.build import BUILD_DIR
from m2trans_tpu_torch.utils.spans import LOADER_EPOCH, LOADER_NEXT, span

SRC = Path(__file__).resolve().parent / "loader.cc"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


class LoaderRejected(ValueError):
    """The npy cache is one the C++ loader cannot index."""


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libm2t_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``loader.cc`` if its library is not built yet; return the
    library's path. Raises ``RuntimeError`` with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"tmp_{out.stem}_{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the port's C++ loader is built from "
                           f"{SRC} at first use") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed building the C++ loader:\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded loader library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            dll.loader_create.restype = ctypes.c_void_p
            dll.loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64]
            dll.loader_start_epoch.restype = ctypes.c_int
            dll.loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
            dll.loader_next.restype = ctypes.c_int
            dll.loader_next.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
            dll.loader_destroy.restype = None
            dll.loader_destroy.argtypes = [ctypes.c_void_p]
            dll.loader_channels.restype = ctypes.c_int
            dll.loader_channels.argtypes = [ctypes.c_void_p]
            _lib = dll
    return _lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeTrainLoader:
    """The training loader backed by the C++ thread pool (the JAX
    package's ``NativeTrainLoader``): yields ``(lr, hr)`` float32 NHWC numpy
    batches, ``n_images * repeat // batch_size`` of them an epoch; each
    ``__iter__`` is the next epoch, deterministic per (seed, epoch). Takes
    the uint8 npy cache of the ``colors == 3`` path. In a profiler trace an
    epoch's start is the span ``m2t::loader.epoch`` and each batch, its wait
    for the workers included, ``m2t::loader.next`` (``utils/spans.py``)."""

    def __init__(self, hr_npy: Sequence[str], lr_npy: Sequence[str], *,
                 patch_size: int, scale: int, batch_size: int, repeat: int = 5,
                 num_workers: int = 8, seed: int = 33):
        dll = lib()
        n = len(hr_npy)
        hr_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in hr_npy])
        lr_arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in lr_npy])
        self._handle = dll.loader_create(hr_arr, lr_arr, n, patch_size, scale,
                                         batch_size, num_workers, seed)
        if not self._handle:
            raise LoaderRejected(
                "the C++ loader cannot index this npy cache (it takes whole "
                "uint8 C-order arrays whose LR images hold the patch and whose "
                "HR and LR channels agree)")
        self._lib = dll
        self.patch = patch_size
        self.scale = scale
        self.batch = batch_size
        self.repeat = repeat
        self.channels = dll.loader_channels(self._handle)
        self.epoch = 0
        self.n_images = n

    def __len__(self) -> int:
        return self.n_images * self.repeat // self.batch

    def __iter__(self):
        with span(LOADER_EPOCH, self.epoch):
            steps = self._lib.loader_start_epoch(self._handle, self.epoch, self.repeat)
        self.epoch += 1
        lp = self.patch // self.scale
        for b in range(steps):
            with span(LOADER_NEXT, b):
                lr = np.empty((self.batch, lp, lp, self.channels), np.float32)
                hr = np.empty((self.batch, self.patch, self.patch, self.channels),
                              np.float32)
                rc = self._lib.loader_next(self._handle, b, _floats(lr), _floats(hr))
            if rc == -2:
                raise RuntimeError("C++ loader: no batch within 5 minutes "
                                   "(a worker failed?)")
            if rc != 0:
                raise RuntimeError("C++ loader aborted")
            yield lr, hr

    def close(self) -> None:
        """Stop the worker threads and unmap the cache."""
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
