"""The training loader's stage, checked by itself.

The reference trains on the batches the program's loader handed to the
step (its crops are drawn by the C++ loader's own generator, which the
reference does not reproduce). So each batch is checked on its own: every
HR patch must be a patch of one of the phantoms the harness wrote, at a
position that is a multiple of the scale, under one of the eight flips
and transposes of a square, and its LR patch the same crop of that
phantom's LR image under the same transform, value for value (the cache
holds uint8; the loader hands out value / 255).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _dihedral(a: np.ndarray):
    """The eight flips / transposes of the first two axes of ``a``."""
    for t in (False, True):
        b = a.transpose(1, 0, *range(2, a.ndim)) if t else a
        for f0 in (False, True):
            for f1 in (False, True):
                c = b[::-1] if f0 else b
                yield c[:, ::-1] if f1 else c


def unmatched(batches: Sequence, hr_imgs: np.ndarray, lr_imgs: np.ndarray,
              scale: int) -> int:
    """How many (LR, HR) items of ``batches`` are no such crop of
    ``hr_imgs`` (N, H, W, C) / ``lr_imgs`` (N, H/s, W/s, C), uint8."""
    bad = 0
    n, h, w, _ = hr_imgs.shape
    for lr_b, hr_b in batches:
        for lr_p, hr_p in zip(lr_b, hr_b):
            hr_u8 = np.rint(np.asarray(hr_p) * 255.0).astype(np.uint8)
            lr_u8 = np.rint(np.asarray(lr_p) * 255.0).astype(np.uint8)
            ps, lp = hr_u8.shape[0], lr_u8.shape[0]
            found = False
            for cand_hr, cand_lr in zip(_dihedral(hr_u8), _dihedral(lr_u8)):
                probe = cand_hr[0, :8, 0]
                ys = np.arange(0, h - ps + 1, scale)
                xs = np.arange(0, w - ps + 1, scale)
                rows = hr_imgs[:, ys[:, None, None], xs[None, :, None] + np.arange(8), 0]
                hits = np.argwhere((rows == probe).all(axis=-1))
                for k, iy, ix in hits:
                    y, x = ys[iy], xs[ix]
                    if (np.array_equal(hr_imgs[k, y:y + ps, x:x + ps], cand_hr)
                            and np.array_equal(lr_imgs[k, y // scale:y // scale + lp,
                                                       x // scale:x // scale + lp], cand_lr)):
                        found = True
                        break
                if found:
                    break
            bad += not found
    return bad
