"""Input pipeline: dataset factory + threaded, prefetching train loader;
port of m2trans_tpu/data/pipeline.py.

``create_datasets(cfg) -> (train_loader, [{'name', 'dataset'}, ...])`` with
eval-set names CCA-US -> benchmark/UI5, US-CASE -> benchmark/US15,
US1K_23 -> benchmark/US1K_23 under ``cfg.data_path`` (reference
datas/utils.py:7-53). The loader is the JAX package's threaded numpy
loader with the same per-batch numpy RNG, so its batches equal the JAX
loader's. The JAX package's C++ loader (m2trans_tpu/runtime) is not ported
yet: ``native_loader`` is not read here.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.benchmark import BenchmarkDataset
from m2trans_tpu_torch.data.us1k import US1KDataset

EVAL_SET_DIRS = {
    "CCA-US": "benchmark/UI5",
    "US-CASE": "benchmark/US15",
    "US1K_23": "benchmark/US1K_23",
}


class TrainLoader:
    """Shuffled, threaded, prefetching batch iterator over a US1KDataset."""

    def __init__(
        self,
        dataset: US1KDataset,
        batch_size: int,
        *,
        num_workers: int = 8,
        seed: int = 33,
        prefetch: int = 4,
        include_tail: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        # reference drop_last=False equivalent (datas/utils.py:22): keep
        # the ragged tail batch by padding it to batch_size (wrapped
        # sample indices) and yielding a per-sample validity mask; batches
        # become (lr, hr, mask) 3-tuples so the trainer can mask the loss
        self.include_tail = include_tail

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.include_tail:
            return -(-n // self.batch_size)
        return n // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        epoch = self.epoch
        order_rng = np.random.default_rng((self.seed, epoch))
        order = order_rng.permutation(n)
        tail_valid = self.batch_size
        if self.include_tail:
            rag = n % self.batch_size
            if rag:
                tail_valid = rag
                order = np.concatenate(
                    [order, order[: self.batch_size - rag]])
        else:
            order = order[: len(self) * self.batch_size]
        batches = order.reshape(-1, self.batch_size)
        self.epoch += 1
        include_tail = self.include_tail

        def with_mask(b, batch):
            if not include_tail:
                return batch
            valid = tail_valid if b == len(batches) - 1 else self.batch_size
            mask = (np.arange(self.batch_size) < valid).astype(np.float32)
            return batch + (mask,)

        # Producers gate on the consumer position (like runtime/loader.cc):
        # a worker may claim batch b only while b < consumed + prefetch, so
        # at most `prefetch` undelivered batches are buffered — host memory
        # stays bounded when producers outpace the train step. The per-batch
        # RNG is derived from the batch index (not the worker id), so crops
        # are deterministic run-to-run regardless of thread scheduling.
        stop = threading.Event()
        state = {"next": 0, "consumed": 0}
        cv = threading.Condition()
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        errors: List[BaseException] = []

        def worker():
            while True:
                with cv:
                    while (not stop.is_set()
                           and state["next"] < len(batches)
                           and state["next"]
                           >= state["consumed"] + self.prefetch):
                        cv.wait(timeout=60.0)
                    b = state["next"]
                    if stop.is_set() or b >= len(batches):
                        return
                    state["next"] = b + 1
                try:
                    rng = np.random.default_rng((self.seed, epoch, b))
                    lrs, hrs = [], []
                    for idx in batches[b]:
                        lr, hr = self.dataset.get(int(idx), rng)
                        lrs.append(lr)
                        hrs.append(hr)
                    batch = (np.stack(lrs), np.stack(hrs))
                except BaseException as e:  # surface in the consumer
                    with cv:
                        errors.append(e)
                        cv.notify_all()
                    return
                with cv:
                    results[b] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            for b in range(len(batches)):
                with cv:
                    waited = 0.0
                    while b not in results:
                        if errors:
                            raise errors[0]
                        cv.wait(timeout=60.0)
                        waited += 60.0
                        if waited >= 600.0:  # hangs must surface as errors
                            raise RuntimeError(
                                f"TrainLoader: batch {b} not produced "
                                f"within {waited:.0f}s")
                    batch = results.pop(b)
                    state["consumed"] = b + 1
                    cv.notify_all()
                yield with_mask(b, batch)
        finally:
            with cv:
                stop.set()
                cv.notify_all()


def create_datasets(
    cfg: Config, *, train: bool = True
) -> Tuple[Optional[TrainLoader], List[Dict]]:
    """Reference-parity factory. Returns (train_loader_or_None, eval_sets)
    where each eval set is {'name': str, 'dataset': BenchmarkDataset}."""
    train_loader = None
    if train:
        if cfg.training_dataset != "us1k":
            raise NotImplementedError(
                f"=== dataset [{cfg.training_dataset}] is not found ===")
        ds = US1KDataset(
            os.path.join(cfg.data_path, "US1K/US1K_train_HR"),
            os.path.join(cfg.data_path, "US1K/US1K_train_LR_bicubic"),
            os.path.join(cfg.data_path, "us1k_cache"),
            train=True,
            augment=bool(cfg.data_augment),
            scale=cfg.scale,
            colors=cfg.colors,
            patch_size=cfg.patch_size,
            repeat=cfg.data_repeat,
            start_idx=int(cfg.train_range[0]),
            end_idx=int(cfg.train_range[1]),
        )
        train_loader = TrainLoader(ds, cfg.batch_size,
                                   num_workers=cfg.threads, seed=cfg.seed,
                                   include_tail=cfg.faithful_tail_batch)

    eval_sets = []
    for name in cfg.eval_sets or []:
        if name not in EVAL_SET_DIRS:
            raise ValueError(f"unknown eval set {name}")
        root = os.path.join(cfg.data_path, EVAL_SET_DIRS[name])
        ds = BenchmarkDataset(
            os.path.join(root, "HR"),
            os.path.join(root, "LR_bicubic"),
            scale=cfg.scale,
            colors=cfg.colors,
        )
        eval_sets.append({"name": name, "dataset": ds})
    return train_loader, eval_sets
