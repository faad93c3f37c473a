"""The card's name and power limit, and the table that names a kernel's
kind from its symbol.

Frozen copies of ``m2trans_tpu_torch/tools/timing.py::card``,
``kernel_kind`` and ``is_device_work`` at commit 462c782, so that a later
change to the port (a renamed kernel, a new kind) cannot move the
yardstick. A new kernel's kind is added here by a benchmark change only.
"""

from __future__ import annotations

import subprocess


def card() -> dict:
    """The card's name as ``torch.cuda.get_device_name`` gives it and its
    power limit in W as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (None where nvidia-smi fails)."""
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        limit = res.stdout.strip().splitlines()[0].rsplit(",", 1)[1]
        out["power_limit_w"] = float(limit.strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return out


KINDS = ("K1 w16", "K1 w64", "K1 c256", "K1 general", "K1b win16", "K1b win64",
         "K1b c256", "K1b proj", "K1b general", "K2", "K2b", "K3", "reduce", "other")

K1 = ("K1 w16", "K1 w64", "K1 c256", "K1 general")
K1B = ("K1b win16", "K1b win64", "K1b c256", "K1b proj", "K1b general")


def kernel_kind(name: str) -> str:
    """The kind of a kernel, by its symbol. "K1 w16" / "K1 w64" are K1's
    window bodies at L = 0 / L = 1 (base width 16), "K1 c256" its cluster
    body (L = 2), "K1 general" the body of other widths; K1b's: "K1b win16"
    / "K1b win64" / "K1b c256" its attention VJP bodies, "K1b proj" its
    projection VJP, "K1b general" other widths; "reduce" the tree reduction
    of K1b's and K2b's partials; "K2" the tail (in a train step also K2b's
    first pass, the same kernel); "K2b" its VJP's second pass; "K3" the
    feed-forward conv; "other" everything else."""
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


def is_copy(name: str) -> bool:
    """A host<->device or device<->device copy, by the profiler's name."""
    return "memcpy" in name.lower()


def is_memset(name: str) -> bool:
    return "memset" in name.lower()
