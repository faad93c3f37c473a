"""The general drivers. A traffic mix names one (``"driver"``); the driver
reads the mix's parameters and the configuration's sizes, sets the
program up, runs the window, and checks what the window produced against
the plain reference. ``run(ctx)`` returns what ``run.py`` prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    config: Dict[str, Any]     # the configuration's file
    traffic: Dict[str, Any]    # the traffic mix's file
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    scratch: Optional[str] = None  # where the run may write (under TMPDIR)
    marks: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note that a phase of set-up ended now (printed on standard
        error, so a slow set-up shows where it went)."""
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def scratch_dir(self) -> str:
        if self.scratch is None:
            import tempfile

            self.scratch = tempfile.mkdtemp(prefix="h100bench_")
        os.makedirs(self.scratch, exist_ok=True)
        return self.scratch


def span(on: bool, name: str):
    """A host span of the harness in the trace (nothing when not tracing)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (reservoir sampling: one draw an item, no copy of the item)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List[Tuple[int, Any]] = []

    def offer(self, key: int, item: Any) -> None:
        if len(self.items) < self.k:
            self.items.append((key, item))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (key, item)
        self.seen += 1


def port_config(config: Dict[str, Any], **extra):
    """The port's ``Config`` of a configuration file: its ``model`` sizes,
    its ``training`` keys as shipped and its ``port`` knobs, then
    ``extra``."""
    from m2trans_tpu_torch.config import Config

    keys = {**config["model"], **config.get("training", {}), **config.get("port", {}),
            **extra}
    return Config(**{k: (tuple(v) if isinstance(v, list) and k == "train_range" else v)
                     for k, v in keys.items()})


def settle() -> None:
    """The end of set-up: collect the garbage set-up left and freeze what
    survives, so that the window's collections do not walk the model, the
    weights and the program's set-up objects again (as in a server that
    has run for a while)."""
    import gc

    gc.collect()
    gc.freeze()


def memory_peak(device: str) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def free_device(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
