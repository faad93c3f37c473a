"""Benchmark evaluation datasets (CCA-US / US-CASE / US1K_23); port of
m2trans_tpu/data/benchmark.py, reading images with Pillow.

Same contract as the reference (datas/benchmark.py): all HR/LR pairs loaded
into RAM at init; ``.jpg`` LR postfix except US1K_23 (``.png``); each item
is (lr, hr cropped to lr*scale, image name) as NHWC float32 in [0,1].
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from m2trans_tpu_torch.data.color_np import rgb2ycbcr_uint8
from m2trans_tpu_torch.data.images import read_rgb


class BenchmarkDataset:
    def __init__(self, hr_folder: str, lr_folder: str, *, scale: int = 2,
                 colors: int = 3):
        self.scale = scale
        self.colors = colors
        self.names: List[str] = []
        self.lr_images: List[np.ndarray] = []
        self.hr_images: List[np.ndarray] = []

        is_us1k23 = "US1K_23" in hr_folder
        for tag in sorted(os.listdir(hr_folder)):
            base, _ = os.path.splitext(tag)
            lr_name = f"{base}x{scale}{'.png' if is_us1k23 else '.jpg'}"
            hr = read_rgb(os.path.join(hr_folder, tag))
            lr = read_rgb(os.path.join(lr_folder, f"X{scale}", lr_name))
            if colors == 1:
                hr = rgb2ycbcr_uint8(hr)[:, :, 0:1]
                lr = rgb2ycbcr_uint8(lr)[:, :, 0:1]
            self.names.append(tag)
            self.hr_images.append(hr)
            self.lr_images.append(lr)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        lr = self.lr_images[idx]
        hr = self.hr_images[idx]
        lh, lw = lr.shape[0], lr.shape[1]
        hr = hr[: lh * self.scale, : lw * self.scale, :]
        return (
            np.asarray(lr, np.float32)[None] / 255.0,
            np.asarray(hr, np.float32)[None] / 255.0,
            self.names[idx],
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, str]]:
        for i in range(len(self)):
            yield self[i]
