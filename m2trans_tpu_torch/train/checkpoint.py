"""Checkpoint loading of the port; counterpart of
m2trans_tpu/train/checkpoint.py ``load_params_any`` for reference ``.pt``
files. Orbax directories (the JAX package's own format) are not read here:
orbax is a JAX library.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import M2Trans
from m2trans_tpu_torch.train.convert import load_reference_state_dict


def load_params_any(path: Optional[str], cfg: Config,
                    device: Optional[torch.device] = None) -> M2Trans:
    """A model from a reference ``.pt``: the full training dict
    (``{'model_state_dict': ...}``) or a bare state dict."""
    if path is None:
        raise ValueError("model_path is not set")
    if os.path.isdir(path) or not path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: only reference .pt checkpoints are read by the torch "
            "port; orbax checkpoint directories are not ported yet")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    with torch.device("meta"):
        model = M2Trans(cfg)
    model = model.to_empty(device=device or "cpu")
    return load_reference_state_dict(model, sd)
