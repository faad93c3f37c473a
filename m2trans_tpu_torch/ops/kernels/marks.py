"""Device marks: an empty named kernel launched between two stages of the
train step (``csrc/marks.cu``).

The step's device part is one CUDA graph (``train/graphed.py``), which host
spans cannot split. A mark launched from the step is captured with it, so
each replay shows the mark's kernel (``m2t_mark_<name>``) in a profiler
trace, in capture order on the one stream: the kernels between a
``*_begin`` and its ``*_end`` mark are that stage's. ``train/loop.py``'s
step marks the semantic loss's forward (the constant stage, and the SR-side
loss), its backward through the SR-side encoder, and ``optimizer.step()``.

On the CPU a mark does nothing.
"""

from __future__ import annotations

import torch

from m2trans_tpu_torch.ops.kernels import build

SEMANTIC_FWD_BEGIN = "semantic_fwd_begin"
SEMANTIC_FWD_END = "semantic_fwd_end"
SEMANTIC_BWD_BEGIN = "semantic_bwd_begin"
SEMANTIC_BWD_END = "semantic_bwd_end"
OPTIMIZER_BEGIN = "optimizer_begin"
OPTIMIZER_END = "optimizer_end"

# in the order of m2t_mark's `which`
MARKS = (SEMANTIC_FWD_BEGIN, SEMANTIC_FWD_END, SEMANTIC_BWD_BEGIN, SEMANTIC_BWD_END,
         OPTIMIZER_BEGIN, OPTIMIZER_END)
_WHICH = {name: i for i, name in enumerate(MARKS)}


def kernel_name(name: str) -> str:
    """The mark's kernel as a trace names it."""
    return f"m2t_mark_{name}"


def mark(name: str, device: torch.device) -> None:
    """Launch mark ``name`` on ``device``'s current stream (nothing on the
    CPU)."""
    which = _WHICH[name]
    if device.type != "cuda":
        return
    build.check(build.lib().m2t_mark(which, build.stream_ptr(device)), f"mark {name}")
