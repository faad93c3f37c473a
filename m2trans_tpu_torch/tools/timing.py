"""Timing on the card, shared by ``python -m m2trans_tpu_torch.bench``, the
measurement tools of ``m2trans_tpu_torch/tools/`` and ``chip_smoke.py``.

- :func:`card`: the card's name and power limit as ``nvidia-smi`` gives them.
- :func:`median_slope`, :func:`graph_seconds_per_step`: the chain method.
  A step's output feeds the next step's input; chains of two lengths are
  timed with CUDA events and the slope between them is the time a step,
  start-up and the final wait left out.
- :func:`events`: CUDA events around single calls, median.
- :func:`host`: host ms a call spends in ``record_function`` labels.
- :func:`device_ms`, :func:`device_split`: device time from
  ``torch.profiler`` (CUPTI), the sum of the kernels of a call, so launch
  overhead and the gaps between kernels are left out; by kind of kernel in
  the split. A process that has run the profiler launches more slowly
  afterwards, so a tool profiles last.

Nothing here imports the rest of the package: ``tools/step_host.py`` loads
this file by its path to measure another checkout.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict, Optional, Sequence, Tuple

GRAPH_N = (4, 36)    # chain lengths of a timed pair
GRAPH_PAIRS = 5


def card(device) -> dict:
    """The card's name, and its power limit in W as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives it; on the
    CPU ``{"device": "cpu", "power_limit_w": None}``."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    limit = res.stdout.strip().splitlines()[0].rsplit(",", 1)[1]
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": float(limit.strip().split()[0])}


def median_slope(run: Callable[[int], float], ns: Tuple[int, int], pairs: int) -> float:
    """Median of ``(run(n2) - run(n1)) / (n2 - n1)`` over ``pairs`` pairs."""
    n1, n2 = ns
    slopes = []
    for _ in range(pairs):
        t1 = run(n1)
        t2 = run(n2)
        slopes.append((t2 - t1) / (n2 - n1))
    return statistics.median(slopes)


def graph_seconds_per_step(step, x0, ns: Tuple[int, int] = GRAPH_N,
                           pairs: int = GRAPH_PAIRS) -> float:
    """CUDA-event seconds a step of the chain ``x <- step(x)`` from ``x0``
    (a step that replays a graph, or any other), median slope over
    ``pairs`` pairs of chains of ``ns`` steps, after one warm step."""
    import torch

    def run(n):
        x = x0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            x = step(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    run(1)  # captures
    return median_slope(run, ns, pairs)


def events(fn, n: int = 20, warm: int = 3) -> float:
    """Median of ``n`` CUDA-event timings (ms) of one call of ``fn`` after
    ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host(fn, labels: Sequence[str], n: int = 20) -> Dict[str, Optional[float]]:
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


def is_device_work(ev) -> bool:
    """A profiler event that is device work: a kernel, copy or memset, not
    a host op and not the device-side span of a ``record_function`` range
    (``Optimizer.step#Adam.step``, ``m2t::device_step``), which would count
    the kernels inside it twice."""
    import torch

    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


def _device_events(fn, n: int, warm: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if is_device_work(ev):
            us = getattr(ev, "device_time_total", None)
            yield ev.key, (ev.cuda_time_total if us is None else us)


def device_ms(fn, n: int = 20, warm: int = 3, copies: bool = False):
    """Device time of one call of ``fn``: the sum over its kernels from
    torch.profiler (CUPTI) over ``n`` calls, so host launch overhead and the
    gaps between kernels are left out; None where the profiler records no
    device time. With ``copies``: (that, the part of it in memory copies)."""
    total = copy = 0.0
    for key, us in _device_events(fn, n, warm):
        total += us
        copy += us if "memcpy" in key.lower() else 0.0
    if not total:
        return (None, None) if copies else None
    return (total / 1e3 / n, copy / 1e3 / n) if copies else total / 1e3 / n


SPLIT_KINDS = ("K1 w16", "K1 w64", "K1 c256", "K1 general", "K1b win16", "K1b win64",
               "K1b c256", "K1b proj", "K1b general", "K2", "K2b", "K3", "reduce", "other")


def kernel_kind(name: str) -> str:
    """The kind of a kernel, by its name. "K1 w16" and "K1 w64" are the
    window bodies of csrc/cftm_window.cuh (L = 0 and L = 1 at base width
    16), "K1 c256" the cluster body (L = 2), "K1 general" the body of every
    other width. K1b's kernels: "K1b win16" / "K1b win64" its window body at
    L = 0 / L = 1, "K1b c256" its cluster body, "K1b proj" its second kernel
    (all levels), "K1b general" the body of other widths; "reduce" is the
    tree reduction of K1b's and K2b's partials. In a train step "K2" is two
    launches of K2's kernel: the forward, and K2b's first pass (the clip
    mask), which runs the same kernel; "K2b" is its second pass."""
    k = name
    return ("K1b win16" if "cftm_bwd_attn_win_kernel<16>" in k
            else "K1b win64" if "cftm_bwd_attn_win_kernel" in k
            else "K1b c256" if "cftm_bwd_attn_c256_kernel" in k
            else "K1b general" if "_general_kernel" in k
            else "K1b proj" if "cftm_bwd_proj_kernel" in k
            else "K1 c256" if "cftm_branch_c256_kernel" in k
            else "K1 w16" if "cftm_branch_w16_kernel" in k
            else "K1 w64" if "cftm_branch_w64_kernel" in k
            else "K1 general" if "cftm_branch_kernel" in k
            else "K2b" if "tail_band_bwd_kernel" in k
            else "K2" if "tail_band_kernel" in k
            else "K3" if "ff_conv_kernel" in k
            else "reduce" if "reduce_tree_kernel" in k else "other")


def device_split(fn, n: int = 1, warm: int = 1) -> Optional[Dict[str, float]]:
    """Device ms of one call of ``fn`` by :func:`kernel_kind`, from
    torch.profiler over ``n`` calls after ``warm``; None where it records
    no device time."""
    kinds = dict.fromkeys(SPLIT_KINDS, 0.0)
    for key, us in _device_events(fn, n, warm):
        kinds[kernel_kind(key)] += us / 1e3 / n
    return kinds if sum(kinds.values()) else None


def peak_gib(device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in GiB since the last
    ``reset_peak_memory_stats``; None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def report(line: dict, out: Optional[str] = None) -> None:
    """Print a tool's result as one JSON line (the last of its output) and,
    with ``out``, write it to that file too."""
    import json

    text = json.dumps(line)
    if out:
        with open(out, "w") as fh:
            fh.write(text + "\n")
    print(text, flush=True)
