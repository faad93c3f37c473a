"""Process groups, rank placement and the ``space`` mesh of the port; the
counterpart of the ``jax.sharding.Mesh`` that m2trans_tpu/parallel/spatial.py
and the JAX training loop build over their devices.

A run over several ranks is one process a rank, started by
``python -m torch.distributed.run --nproc_per_node N ...`` (which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the store's address) or, in the
tests and ``chip_smoke.py``, by :func:`run_ranks`. :func:`init_from_env`
places a rank on ``cuda:(LOCAL_RANK % device_count)`` (or the CPU when asked
for) and creates the default group: NCCL where every rank has a card of its
own, gloo where ranks share a card or run on the CPU. Every group is created
with a finite timeout, so a rank that dies fails the others instead of
hanging them.

Under gloo with CUDA tensors the collectives of :class:`SpaceMesh` stage
through host memory (gloo's point-to-point and its CUDA paths are not relied
on); bf16 travels as its bit pattern in an fp16 view.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0  # the CLIs' group timeout


def launch_hint(n: int, module: str = "m2trans_tpu_torch.infer") -> str:
    return (f"launch {n} ranks with python -m torch.distributed.run "
            f"--nproc_per_node {n} -m {module} ...")


def world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> Optional[str]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def init_from_env(device: str = "cuda") -> torch.device:
    """This rank's device, and the default group where ``WORLD_SIZE`` > 1
    (launched by ``torch.distributed.run``). ``device`` is ``cuda`` or
    ``cpu``; a CUDA rank without a card raises."""
    kind = torch.device(device).type
    n = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if n > 1 and not dist.is_initialized():
        local_n = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
        own_card = kind == "cuda" and local_n <= torch.cuda.device_count()
        dist.init_process_group(
            "nccl" if own_card else "gloo", init_method="env://",
            rank=int(os.environ["RANK"]), world_size=n,
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return dev


def shared_card_note() -> str:
    """'' or a note that the ranks share one card under gloo."""
    rank, n = world()
    if n > 1 and backend() == "gloo" and torch.cuda.is_available() \
            and n > torch.cuda.device_count():
        return (f"{n} ranks share {torch.cuda.device_count()} card(s) under gloo")
    return ""


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it travels: on the host under gloo, bf16 bits as fp16
    (gloo has no int16; a gather copies bytes, so the view is exact)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.float16)
    return t.cpu() if _staged(t) else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device, non_blocking=False)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group (a new tensor on ``t``'s device)."""
    w = t.detach().clone().contiguous()
    w = w.cpu() if _staged(w) else w
    dist.all_reduce(w, group=group)
    return w.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor on ``t``'s device)."""
    w = t.detach().clone().contiguous()
    w = w.cpu() if _staged(w) else w
    dist.broadcast(w, src)
    return w.to(t.device)


@dataclasses.dataclass(frozen=True)
class SpaceMesh:
    """The ranks that shard one frame by rows: ``n`` of them, this rank's
    index ``rank`` among them (-1 where it is not one of them), and their
    group (None: the default group)."""

    n: int
    rank: int
    group: Any = None

    def all_gather(self, t: torch.Tensor, keep=None) -> List[Optional[torch.Tensor]]:
        """Every member's ``t`` (equal shapes), in rank order; with ``keep``
        (member indices) the others are None and, staged, never copied back
        to the device. Without a process group (one rank) it is ``[t]``; a
        group of one still runs the collective."""
        if backend() is None:
            return [t]
        w = _wire(t)
        out = [torch.empty_like(w) for _ in range(self.n)]
        dist.all_gather(out, w, group=self.group)
        return [_unwire(o, t) if keep is None or j in keep else None
                for j, o in enumerate(out)]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if backend() is None else all_reduce_sum(t, self.group)


_SUBGROUPS: Dict[tuple, Any] = {}  # member ranks -> their process group


def _group(ranks: tuple):
    """The process group of ``ranks`` (the default group when they are the
    whole world), created once. ``dist.new_group`` is collective: every rank
    of the world must ask for the same groups in the same order."""
    if len(ranks) == world()[1]:
        return None
    if ranks not in _SUBGROUPS:
        _SUBGROUPS[ranks] = dist.new_group(list(ranks))
    return _SUBGROUPS[ranks]


def space_mesh(n: Optional[int] = None) -> SpaceMesh:
    """The mesh of the first ``n`` ranks of the default group (all of them
    by default). ``n`` = 1 needs no group. A smaller ``n`` creates a
    subgroup, which every rank must ask for in the same order."""
    rank, size = world()
    n = size if n is None else n
    if n < 1 or n > size:
        raise ValueError(f"a space mesh of {n} ranks needs a world of at least "
                         f"{n} ranks, this one has {size}: {launch_hint(n)}")
    if n == 1:
        return SpaceMesh(1, 0 if rank == 0 else -1)
    return SpaceMesh(n, rank if rank < n else -1, _group(tuple(range(n))))


@dataclasses.dataclass(frozen=True)
class DataSpaceMesh:
    """A 2-D (data, space) mesh (the JAX ``Mesh`` of
    ``devices.reshape(n_data, n_space)`` with axes ("data", "space")): rank
    ``r`` sits at (``r // n_space``, ``r % n_space``). ``space`` is the
    :class:`SpaceMesh` of this rank's data row, the ranks that shard one
    image by rows; ``data`` its column, whose ``rank`` is this rank's data
    index and ``n`` the data count. A rank outside the mesh has index -1 in
    both."""

    space: SpaceMesh
    data: SpaceMesh


def data_space_mesh(n_data: int, n_space: int) -> DataSpaceMesh:
    """The (data, space) mesh over the first ``n_data * n_space`` ranks of
    the default group. Every rank creates every row group and every column
    group, in one fixed order, so every rank must call it alike."""
    rank, size = world()
    n = n_data * n_space
    if n_data < 1 or n_space < 1 or n > size:
        raise ValueError(f"a ({n_data}, {n_space}) data x space mesh needs a "
                         f"world of at least {n} ranks, this one has {size}: "
                         f"{launch_hint(n)}")
    rows = [tuple(range(d * n_space, (d + 1) * n_space)) for d in range(n_data)]
    cols = [tuple(range(s, n, n_space)) for s in range(n_space)]
    groups = {ranks: _group(ranks) for ranks in rows + cols}
    if rank >= n:
        return DataSpaceMesh(SpaceMesh(n_space, -1), SpaceMesh(n_data, -1))
    d, s = divmod(rank, n_space)
    return DataSpaceMesh(SpaceMesh(n_space, s, groups[rows[d]]),
                         SpaceMesh(n_data, d, groups[cols[s]]))


# ---------------------------------------------------------------------------
# local ranks for the tests and the smoke run
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, n, store_path, args, group_timeout_s, out):
    try:
        torch.set_num_threads(1)  # n ranks share the host's cores
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(n))
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        try:
            out.put((rank, True, fn(rank, n, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent reports it with the rank
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, n: int, args: Sequence = (), *,
              timeout_s: float = 120.0, group_timeout_s: float = 60.0) -> List[Any]:
    """``fn(rank, n, *args)`` in ``n`` fresh processes joined by a gloo
    group (a ``FileStore`` in a temporary directory, no TCP port); returns
    the results in rank order. ``fn`` must be importable by name (a
    module-level function of a module that a fresh process can import).
    Raises with the traceback of the first rank that failed (the others are
    killed then, as they may wait for it in a collective), or when the ranks
    have not all answered within ``timeout_s``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="m2t_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, os.path.join(tmp, "store"), tuple(args),
                                   group_timeout_s, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        results, failed = {}, {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < n and not failed:
                left = deadline - time.monotonic()
                try:
                    rank, ok, val = out.get(timeout=max(left, 0.01))
                except queue_lib.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    raise TimeoutError(
                        f"run_ranks: {n - len(results)} of {n} ranks gave no "
                        f"result within {timeout_s:.0f} s (exited without one: "
                        f"{dead})") from None
                (results if ok else failed)[rank] = val
        finally:
            for p in procs:
                p.join(timeout=0 if failed else 10)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        raise RuntimeError("run_ranks: " + "\n".join(
            f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
    return [results[r] for r in range(n)]
