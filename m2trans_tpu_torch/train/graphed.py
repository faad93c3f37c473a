"""The train step as one CUDA graph per batch layout; the port's
counterpart of ``jax.jit`` of the JAX train step (m2trans_tpu/train/loop.py:87).

The JAX package compiles the whole step (augmentation, the semantic loss's
constant stage, ``value_and_grad``, the optax update) into one executable
with donated buffers. Run eagerly, the port's step is about 1,400 launches
from Python (about 3,200 with the MedCLIP loss), and on the card the host,
not the device, bounds it. :class:`GraphedTrainStep` captures the device
part of the step, ``step_fn`` of ``train/loop.py::make_train_step``: the
semantic loss's constant stage under ``no_grad``, the forward, L1 (+ the
SR-side semantic loss), ``backward()`` and ``optimizer.step()``, into one
``torch.cuda.CUDAGraph`` per key: the shapes and dtypes of the inputs, and
which are present (the sample mask; the crop offsets and tokens, that is
the semantic loss on; cutmix, cutout and the noise, the JAX step's static
``do_cutout`` among them); all graphs share one memory pool.

The graph also holds the augmentations (cutmix, cutout, the noise's add),
applied to the batch from their draws in the fixed layout of
``data/augment.py``, as the JAX step applies them inside its ``jax.jit``.
What stays outside, run before each replay: the draws on the host
generator, the noise's normal draw (a replay does not reseed a
generator), and the copies into the static inputs: the LR and HR batch,
the sample mask, the packed draws and the normal, the crop offsets as
(n, B) int64 and the token ids as int64 device tensors. The caller stages
the host arrays through page-locked buffers (``utils/staging.py``), so no
copy makes the host wait for the previous step; a capture refuses a copy
from pageable host memory, so none happens inside it.

Capture, on a key's first call:

1. the static inputs are made from that call's inputs;
2. every parameter and the optimizer's state are snapshotted, one step runs
   on a side stream, so that everything built at first use is built
   outside the capture (K1b's scratch, ``ops.on_device``'s constants,
   cuBLAS and cuDNN state, Adam's lazily made state), and the snapshot is
   copied back in place, pointers kept (state Adam had not made yet is
   zeroed: moments and step 0, as Adam makes it);
3. ``step_fn`` sets every gradient to None before its backward, so the
   captured backward makes the gradients in the graph's pool.

The first replay then equals one eager step from the same state. The
optimizer must be capturable with tensor learning rates
(``train/loop.py::make_optimizer`` on a CUDA model); ``set_lr`` fills the
tensor, so a per-epoch LR reaches the replays, and the eager CUDA step runs
the same optimizer, so graph and eager agree bit for bit.

After each replay the parameters' version counters are bumped: a replay
writes them in place without autograd seeing it, and the no-grad operand
caches (``models/numerics.py::prepared``) and the serving graphs
(``models/graphed.py``) key by ``param_key``, pointer and version. Each
parameter's ``.grad`` is the replayed graph's gradient. The losses come
back as a copy: the static output is overwritten by the next replay.

Every graph is dropped, and the next call captures again into a new pool,
when the storage of a parameter or of the optimizer's state moves
(``load_state_dict`` into the optimizer, a model moved). There is no
fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from m2trans_tpu_torch.models.graphed import counting
from m2trans_tpu_torch.models.served import SERVED
from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch_bwd
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_bwd

# the train step's kernel wrappers and their launch counters: M2Trans's
# forward's and the two backward kernels
COUNTED = {**SERVED["M2Trans"].counted, "cftm_branch_bwd": cftm_branch_bwd,
           "tail_band_bwd": tail_band_bwd}

LOSS_NAMES = ("loss", "l1", "clip")


def _layout(x):
    """The static part of an input: shapes and dtypes, and which parts are
    present."""
    if x is None or torch.is_tensor(x):
        return None if x is None else (tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple((k, _layout(x[k])) for k in sorted(x))
    return (type(x).__name__, tuple(_layout(v) for v in x))


def _clone(x):
    """A copy of an input (tensors, None, and tuples or dicts of them)."""
    if x is None or torch.is_tensor(x):
        return None if x is None else x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    items = [_clone(v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def _tensors(x) -> List[torch.Tensor]:
    """An input's tensors, in a fixed order."""
    if x is None or torch.is_tensor(x):
        return [] if x is None else [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    return [t for v in x for t in _tensors(v)]


class _Entry:
    """One captured key: the static inputs, the graph, the static output
    and the gradients the captured backward made."""

    def __init__(self, inputs, graph, out: torch.Tensor, grads: List[torch.Tensor]):
        self.inputs, self.graph, self.out, self.grads = inputs, graph, out, grads


class GraphedTrainStep:
    """``step_fn`` replayed from a CUDA graph per key.

    Args:
      step_fn: ``(lr, hr, sample_mask, offsets, tokens, aug) -> (3,)
        tensor`` of loss, L1 and clip: the device part of a train step,
        ending in ``optimizer.step()``; every input but ``lr`` and ``hr``
        may be None, ``offsets`` and ``aug`` are tuples whose fields may be
        None, ``tokens`` a dict of tensors.
      params: the parameters the optimizer updates.
      optimizer: capturable, every group's ``lr`` a tensor.

    ``captures`` and ``replays`` count what it did; ``capture_launches``
    holds, for each key, the kernel wrappers' launches during the capture
    itself (the side-stream step before it excluded): the kernels each
    replay runs.
    """

    def __init__(self, step_fn: Callable[..., torch.Tensor],
                 params: Sequence[torch.nn.Parameter], optimizer: torch.optim.Optimizer):
        self.step_fn, self.params, self.optimizer = step_fn, list(params), optimizer
        self._pool = None
        self._graphs: Dict[tuple, _Entry] = {}
        self._ptrs: Optional[tuple] = None
        self._grads_of: Optional[tuple] = None
        self.captures = self.replays = 0
        self.capture_launches: Dict[tuple, Dict[str, int]] = {}

    def _pointers(self) -> tuple:
        """Storage of every parameter, of the optimizer's state and LRs."""
        state = [v for st in self.optimizer.state.values() for v in st.values()
                 if torch.is_tensor(v)]
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        return tuple(t.data_ptr() if torch.is_tensor(t) else None
                     for t in [*self.params, *state, *lrs])

    def _check_optimizer(self) -> None:
        for g in self.optimizer.param_groups:
            if not (g.get("capturable") and torch.is_tensor(g["lr"])):
                raise ValueError(
                    "GraphedTrainStep needs a capturable optimizer whose learning "
                    "rates are tensors (train/loop.py::make_optimizer on a CUDA "
                    "model); a float LR would be baked into the graph")

    def _snapshot(self):
        params = [p.detach().clone() for p in self.params]
        state = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                 for p, st in self.optimizer.state.items()}
        return params, state

    @torch.no_grad()
    def _restore(self, snap) -> None:
        """Copy the snapshot back in place; state made since is zeroed."""
        params, state = snap
        for p, v in zip(self.params, params):
            p.copy_(v)
        for p, st in self.optimizer.state.items():
            old = state.get(p)
            for k, v in st.items():
                if torch.is_tensor(v):
                    if old is None:
                        v.zero_()
                    else:
                        v.copy_(old[k])

    def _capture(self, key: tuple, args: tuple) -> _Entry:
        self._check_optimizer()
        inputs = _clone(args)
        snap = self._snapshot()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step_fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        self._restore(snap)
        del snap
        if not self._graphs:  # no graph uses the old pool (models/graphed.py)
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with counting(COUNTED) as launches, torch.cuda.graph(graph, pool=self._pool):
            out = self.step_fn(*inputs)
        self.capture_launches[key] = launches
        self.captures += 1
        return _Entry(inputs, graph, out, [p.grad for p in self.params])

    def __call__(self, lr: torch.Tensor, hr: torch.Tensor,
                 sample_mask: Optional[torch.Tensor] = None, offsets=None,
                 tokens: Optional[Dict] = None, aug=None) -> torch.Tensor:
        """One step: the inputs (device tensors, see ``step_fn``) copied into
        the key's static inputs, the graph replayed; returns loss, L1 and
        clip, (3,)."""
        args = (lr, hr, sample_mask, offsets, tokens, aug)
        key = _layout(args)
        if self._graphs and self._pointers() != self._ptrs:
            self._graphs.clear()
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, args)
            self._ptrs = self._pointers()
            self._grads_of = key
        for dst, src in zip(_tensors(entry.inputs), _tensors(args)):
            dst.copy_(src)
        entry.graph.replay()
        self.replays += 1
        torch.autograd.graph.increment_version(self.params)
        if self._grads_of != key:
            for p, g in zip(self.params, entry.grads):
                p.grad = g
            self._grads_of = key
        return entry.out.clone()
