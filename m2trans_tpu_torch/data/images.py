"""Image files through Pillow (the GPU machine has no imageio)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def read_rgb(path: str) -> np.ndarray:
    """HWC uint8 RGB, as ``imageio.imread(path, mode="RGB")``."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def write_image(path: str, img: np.ndarray) -> None:
    Image.fromarray(img).save(path)
