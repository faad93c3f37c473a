"""Batched augmentations (cutmix, cutout, input noise); port of
m2trans_tpu/data/augment.py.

Each augmentation is a *draw* on a host numpy ``Generator`` and an *apply*
on the device tensors. The draws give Python integers (boxes,
permutations) and floats; :func:`draw_augment` packs them into arrays of a
fixed layout for a batch size (:class:`Augment`), so the applies take
device tensors of fixed shapes and build every box mask from an iota, as
the JAX ``_coords_mask`` does inside the jitted step: the applies run
inside the train step's device part, and so inside its CUDA graph
(``train/graphed.py``), with no device-to-host copy. Semantics of the
reference (utils.py:16-108, train.py:177-181), not its RNG stream:

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
    normal draw runs on the batch's device from a seed drawn on the host
    (:func:`normal_draw`, eager, outside a captured step: a graph's replay
    does not reseed a generator).

The packed layout for a batch of ``b`` (int64 unless said):

  * ``mix`` (MAX_PATCHES, b, 6): slot i, row r: (active, y1, y2, x1, x2,
    source row). Slot i of a half is that half's i-th patch: its rows share
    the clipped LR box, and each row's source is its half's permutation
    offset to the batch (``lo + perm[r - lo]``). A row of an inactive slot
    (the half not applied, or i >= n_patch) is inactive with an empty box
    and itself as source. The two halves touch disjoint rows, so slot i of
    both is one gather and one select over the batch, and halves of
    unequal size (b = 5: 2 and 3 rows) need no padding;
  * ``holes`` (MAX_HOLES, b, 5): (active, y1, y2, x1, x2) a hole a row;
  * ``noise`` (2,) f32: (applied, std).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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


def noise_draw(rng: np.random.Generator, std_range=(-0.01, 0.01)
               ) -> Optional[Tuple[float, int]]:
    """With p = 0.5, (std, seed of the normal draw); else None."""
    if rng.uniform() >= 0.5:
        return None
    return float(rng.uniform(*std_range)), int(rng.integers(0, 2 ** 63 - 1))


# ---------------------------------------------------------------------------
# the fixed layout
# ---------------------------------------------------------------------------


def pack_cutmix(draws, b: int) -> np.ndarray:
    """:func:`cutmix_draw`'s draws as the (MAX_PATCHES, b, 6) ``mix``."""
    out = np.zeros((MAX_PATCHES, b, 6), np.int64)
    out[..., 5] = np.arange(b)
    for lo, hi, patches in draws:
        for i, (perm, box) in enumerate(patches):
            out[i, lo:hi, 0] = 1
            out[i, lo:hi, 1:5] = box
            out[i, lo:hi, 5] = lo + np.asarray(perm, np.int64)
    return out


def pack_cutout(draws, b: int) -> np.ndarray:
    """:func:`cutout_draw`'s draws as the (MAX_HOLES, b, 5) ``holes``."""
    out = np.zeros((MAX_HOLES, b, 5), np.int64)
    for lo, hi, boxes in draws:
        for i, box in enumerate(boxes):
            out[i, lo:hi, 0] = 1
            out[i, lo:hi, 1:5] = box
    return out


def pack_noise(draw: Optional[Tuple[float, int]]) -> np.ndarray:
    """:func:`noise_draw`'s draw as the (2,) f32 ``noise``."""
    return np.array([0.0, 0.0] if draw is None else [1.0, draw[0]], np.float32)


class Augment(NamedTuple):
    """A step's augmentations in the fixed layout (module docstring); a
    field is None where that augmentation is off. ``normal`` is the noise's
    N(0, 1) draw, the LR batch's shape (stale where ``noise`` is not
    applied: the select then leaves the batch as it is)."""

    mix: Optional[object] = None
    holes: Optional[object] = None
    noise: Optional[object] = None
    normal: Optional[torch.Tensor] = None


def draw_augment(rng: np.random.Generator, b: int, lh: int, lw: int, *,
                 cutmix: bool, cutout_len: Optional[int], noise: bool
                 ) -> Tuple[Augment, Optional[int]]:
    """The step's draws, in the step's order (cutmix, cutout where
    ``cutout_len`` is given, noise), packed as numpy arrays (``normal``
    None), and the seed of the noise's normal draw (None when the noise is
    off or not applied)."""
    mix = pack_cutmix(cutmix_draw(rng, b, lh, lw), b) if cutmix else None
    holes = (pack_cutout(cutout_draw(rng, b, lh, lw, cutout_len), b)
             if cutout_len is not None else None)
    packed = seed = None
    if noise:
        draw = noise_draw(rng)
        packed = pack_noise(draw)
        seed = None if draw is None else draw[1]
    return Augment(mix, holes, packed), seed


# ---------------------------------------------------------------------------
# the applies (device tensors, fixed shapes)
# ---------------------------------------------------------------------------


def box_masks(boxes: torch.Tensor, h: int, w: int, scale: int = 1) -> torch.Tensor:
    """(n, b, >= 5) rows of (active, y1, y2, x1, x2, ...) -> (n, b, h, w)
    bool masks of the boxes times ``scale``: ``rows >= y1 & rows < y2 &
    cols >= x1 & cols < x2`` from an iota (JAX ``_coords_mask``)."""
    rows = torch.arange(h, device=boxes.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=boxes.device).view(1, 1, 1, w)
    y1, y2, x1, x2 = (boxes[..., k, None, None] * scale for k in range(1, 5))
    return ((boxes[..., 0, None, None] != 0) & (rows >= y1) & (rows < y2)
            & (cols >= x1) & (cols < x2))


def cutmix_apply(lr: torch.Tensor, hr: torch.Tensor, mix: torch.Tensor, scale: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale-consistent CutMix of (LR, HR) NHWC batches by the packed
    ``mix``: slot after slot, the boxes' pixels taken from the source rows
    of the state the last slot left; new tensors."""
    _, lh, lw, _ = lr.shape
    m_lr = box_masks(mix, lh, lw)[..., None]
    m_hr = box_masks(mix, lh * scale, lw * scale, scale)[..., None]
    for i in range(mix.shape[0]):
        src = mix[i, :, 5]
        lr = torch.where(m_lr[i], lr.index_select(0, src), lr)
        hr = torch.where(m_hr[i], hr.index_select(0, src), hr)
    return lr, hr


def cutout_apply(img: torch.Tensor, holes: torch.Tensor) -> torch.Tensor:
    """Zero the packed ``holes`` of an NHWC batch (a select, so the zeros
    are +0 whatever the pixel); a new tensor."""
    cut = box_masks(holes, img.shape[1], img.shape[2]).any(dim=0)
    return torch.where(cut[..., None], 0.0, img)


def normal_draw(out: torch.Tensor, seed: int,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) drawn on its device from ``seed`` (``gen``,
    a generator of that device, is reseeded; a fresh one by default)."""
    gen = torch.Generator(device=out.device) if gen is None else gen
    gen.manual_seed(seed)
    return torch.randn(out.shape, generator=gen, out=out)


def noise_apply(img: torch.Tensor, noise: torch.Tensor, normal: torch.Tensor
                ) -> torch.Tensor:
    """``img + std * normal`` where the packed ``noise`` is applied, else
    ``img`` (a select, so the batch is left bit for bit)."""
    return torch.where(noise[0] != 0, img + noise[1] * normal, img)


def augment_apply(lr: torch.Tensor, hr: torch.Tensor, aug: Augment, scale: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every augmentation of ``aug`` (device tensors) in the step's order:
    cutmix, cutout, noise (JAX loop.py:90-100)."""
    if aug.mix is not None:
        lr, hr = cutmix_apply(lr, hr, aug.mix, scale)
    if aug.holes is not None:
        lr = cutout_apply(lr, aug.holes)
    if aug.noise is not None:
        lr = noise_apply(lr, aug.noise, aug.normal)
    return lr, hr
