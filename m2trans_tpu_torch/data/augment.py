"""Batched augmentations (cutmix, cutout, input noise); port of
m2trans_tpu/data/augment.py.

Each augmentation is a *draw* on a host numpy ``Generator`` and an *apply*
on the device tensors. The draws give Python integers (boxes, permutations)
and floats, so applying them is slicing and copies on the device with no
device-to-host copy, and the same draws can be fed to the JAX package's
box and mask functions. Semantics of the reference (utils.py:16-108,
train.py:177-181), not its RNG stream:

  * cutmix (utils.py:36-71): per half-batch (the whole batch when B = 1),
    with p = 0.5, ``n_patch`` ~ U{1..4} boxes, each pasted from a shuffled
    copy of the half as the previous box left it (the JAX ``fori_loop``
    carry) into LR, and the x``scale`` box into HR; box area ratio
    lam ~ clip(Beta(alpha, alpha), 0.1, 0.3), side = dim * sqrt(lam),
    centred at a uniform pixel, clipped to the frame; the HR box is the
    *clipped* LR box times the scale (utils.py:49);
  * cutout (utils.py:74-108): per half-batch, with p = 0.5, zero
    ``n_holes`` ~ U{1..9} squares of side ``length`` in LR;
  * input noise (the reference's ``data_add_noise``, utils.py:187-189):
    with p = 0.5, add N(0, 1) * std, std ~ U[-0.01, 0.01] for the batch; the
    normal draw runs on the tensor's device from a seed drawn on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

MAX_PATCHES = 4  # reference n_patch in [1, 5)
MAX_HOLES = 9  # reference n_holes in [1, 10)

Box = Tuple[int, int, int, int]  # y1, y2, x1, x2


def clipped_box(h: int, w: int, cy: int, cx: int, cut_h: int, cut_w: int) -> Box:
    """Box of cut_h x cut_w centred at (cy, cx), clipped to the frame
    (reference rand_bbox, utils.py:16-33)."""
    return (int(np.clip(cy - cut_h // 2, 0, h)), int(np.clip(cy + cut_h // 2, 0, h)),
            int(np.clip(cx - cut_w // 2, 0, w)), int(np.clip(cx + cut_w // 2, 0, w)))


def halves(b: int) -> List[Tuple[int, int]]:
    """The batch rows each draw covers: two halves for b > 1, else one."""
    return [(0, b // 2), (b // 2, b)] if b > 1 else [(0, b)]


def cutmix_draw(rng: np.random.Generator, b: int, lh: int, lw: int, *,
                alpha: float = 1.0) -> List[Tuple[int, int, list]]:
    """Per half: (lo, hi, [(permutation of the half, clipped LR box), ...]),
    the list empty when the half is left as it is."""
    draws = []
    for lo, hi in halves(b):
        patches = []
        if rng.uniform() < 0.5:
            for _ in range(int(rng.integers(1, MAX_PATCHES + 1))):
                perm = [int(i) for i in rng.permutation(hi - lo)]
                cut = np.sqrt(np.clip(rng.beta(alpha, alpha), 0.1, 0.3))
                cut_h, cut_w = int(lh * cut), int(lw * cut)
                cy, cx = int(rng.integers(0, lh)), int(rng.integers(0, lw))
                patches.append((perm, clipped_box(lh, lw, cy, cx, cut_h, cut_w)))
        draws.append((lo, hi, patches))
    return draws


def _paste(img: torch.Tensor, perm: List[int], y1: int, y2: int, x1: int, x2: int):
    """img[:, box] = img[perm][:, box], in place (img is a half's view)."""
    img[:, y1:y2, x1:x2] = torch.stack([img[i, y1:y2, x1:x2] for i in perm])


def cutmix_apply(lr: torch.Tensor, hr: torch.Tensor, draws, scale: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale-consistent CutMix of (LR, HR) NHWC batches by ``draws``; new
    tensors, the inputs are left as they are."""
    lr, hr = lr.clone(), hr.clone()
    for lo, hi, patches in draws:
        for perm, (y1, y2, x1, x2) in patches:
            if y2 > y1 and x2 > x1:
                _paste(lr[lo:hi], perm, y1, y2, x1, x2)
                _paste(hr[lo:hi], perm, y1 * scale, y2 * scale, x1 * scale, x2 * scale)
    return lr, hr


def cutout_draw(rng: np.random.Generator, b: int, h: int, w: int, length: int
                ) -> List[Tuple[int, int, List[Box]]]:
    """Per half: (lo, hi, [clipped hole boxes]), empty when not applied."""
    draws = []
    for lo, hi in halves(b):
        holes = []
        if rng.uniform() < 0.5:
            for _ in range(int(rng.integers(1, MAX_HOLES + 1))):
                cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
                holes.append(clipped_box(h, w, cy, cx, length, length))
        draws.append((lo, hi, holes))
    return draws


def cutout_apply(img: torch.Tensor, draws) -> torch.Tensor:
    """Zero the drawn squares of an NHWC batch (a new tensor)."""
    img = img.clone()
    for lo, hi, holes in draws:
        for y1, y2, x1, x2 in holes:
            img[lo:hi, y1:y2, x1:x2] = 0
    return img


def noise_draw(rng: np.random.Generator, std_range=(-0.01, 0.01)
               ) -> Optional[Tuple[float, int]]:
    """With p = 0.5, (std, seed of the normal draw); else None."""
    if rng.uniform() >= 0.5:
        return None
    return float(rng.uniform(*std_range)), int(rng.integers(0, 2 ** 63 - 1))


def gaussian_noise(img: torch.Tensor, std: float, seed: int) -> torch.Tensor:
    """img + std * N(0, 1), the normal drawn on img's device from ``seed``."""
    gen = torch.Generator(device=img.device).manual_seed(seed)
    return img + std * torch.randn(img.shape, generator=gen, device=img.device,
                                   dtype=img.dtype)
