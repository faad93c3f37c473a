"""US1K / MMUS1K paired HR/LR-bicubic training dataset; port of
m2trans_tpu/data/us1k.py, reading images with Pillow.

Same on-disk contract as the reference (datas/us1k.py): HR images
``%04d.png``, LR images ``X{s}/%04dx{s}.png``; a one-time ``.npy`` cache
under ``<cache>/us1k_{hr,lr_x{s}}/{rgb,ycbcr}/`` (the JAX package's cache,
file for file); ``__len__`` is ``n_images * repeat``. Samples are NHWC
float32 in [0, 1], cropped and flipped on the host from a memory map.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from m2trans_tpu_torch.data.color_np import rgb2ycbcr_uint8
from m2trans_tpu_torch.data.images import read_rgb


def crop_patch(
    lr: np.ndarray,
    hr: np.ndarray,
    patch_size: int,
    scale: int,
    rng: np.random.Generator,
    augment: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random aligned LR/HR crop + random hflip/vflip/rot90
    (reference datas/us1k.py:16-36). Returns HWC float32 in [0,1]."""
    lr_h, lr_w = lr.shape[0], lr.shape[1]
    lp = patch_size // scale
    lx = int(rng.integers(0, lr_w - lp + 1))
    ly = int(rng.integers(0, lr_h - lp + 1))
    hx, hy = lx * scale, ly * scale
    lr_p = lr[ly:ly + lp, lx:lx + lp, :]
    hr_p = hr[hy:hy + patch_size, hx:hx + patch_size, :]
    if augment:
        if rng.random() > 0.5:
            lr_p, hr_p = lr_p[:, ::-1, :], hr_p[:, ::-1, :]
        if rng.random() > 0.5:
            lr_p, hr_p = lr_p[::-1, :, :], hr_p[::-1, :, :]
        if rng.random() > 0.5:
            lr_p, hr_p = lr_p.transpose(1, 0, 2), hr_p.transpose(1, 0, 2)
    return (np.ascontiguousarray(lr_p, np.float32) / 255.0,
            np.ascontiguousarray(hr_p, np.float32) / 255.0)


class US1KDataset:
    def __init__(
        self,
        hr_folder: str,
        lr_folder: str,
        cache_folder: str,
        *,
        train: bool = True,
        augment: bool = True,
        scale: int = 2,
        colors: int = 3,
        patch_size: int = 96,
        repeat: int = 5,
        start_idx: Optional[int] = None,
        end_idx: Optional[int] = None,
    ):
        self.scale = scale
        self.colors = colors
        self.patch_size = patch_size
        self.repeat = repeat
        self.train = train
        self.augment = augment

        if start_idx is None:
            start_idx, end_idx = (1, 1001) if train else (801, 901)
        self.indices = list(range(start_idx, end_idx))

        color_tag = "ycbcr" if colors == 1 else "rgb"
        hr_dir = os.path.join(cache_folder, "us1k_hr", color_tag)
        lr_dir = os.path.join(cache_folder, f"us1k_lr_x{scale}", color_tag)
        os.makedirs(hr_dir, exist_ok=True)
        os.makedirs(lr_dir, exist_ok=True)

        self.hr_npy, self.lr_npy = [], []
        for i in self.indices:
            idx = str(i).zfill(4)
            hr_png = os.path.join(hr_folder, f"{idx}.png")
            lr_png = os.path.join(lr_folder, f"X{scale}", f"{idx}x{scale}.png")
            hr_npy = os.path.join(hr_dir, f"{idx}.npy")
            lr_npy = os.path.join(lr_dir, f"{idx}x{scale}.npy")
            if not os.path.exists(hr_npy):
                self._convert(hr_png, hr_npy)
            if not os.path.exists(lr_npy):
                self._convert(lr_png, lr_npy)
            self.hr_npy.append(hr_npy)
            self.lr_npy.append(lr_npy)
        self.n_images = len(self.hr_npy)

    def _convert(self, png: str, npy: str) -> None:
        img = read_rgb(png)
        if self.colors == 1:
            img = rgb2ycbcr_uint8(img)[:, :, 0:1]
        np.save(npy, img)

    def __len__(self) -> int:
        return self.n_images * self.repeat if self.train else self.n_images

    def get(self, idx: int, rng: np.random.Generator):
        idx = idx % self.n_images
        hr = np.load(self.hr_npy[idx], mmap_mode="r")
        lr = np.load(self.lr_npy[idx], mmap_mode="r")
        if self.train:
            return crop_patch(lr, hr, self.patch_size, self.scale, rng,
                              self.augment)
        return (np.asarray(lr, np.float32) / 255.0,
                np.asarray(hr, np.float32) / 255.0)
