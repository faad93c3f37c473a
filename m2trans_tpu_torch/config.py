"""Typed configuration of the port; counterpart of m2trans_tpu/config.py.

The same flat YAML surface (``configs/*.yml``) and the same field set and
defaults, read with yaml into the port's own dataclass, so the port
loads nothing of the JAX package. A CPU test parses every file of
``configs/`` with both loaders and compares the results field by field.
Unknown keys are kept in ``extras`` with a warning.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class Config:
    """Flat config mirroring the reference's flat YAML."""

    # model
    model: str = "M2Trans"
    scale: int = 4
    rgb_range: float = 1.0
    colors: int = 3
    n_feats: int = 64
    num_heads: int = 4  # present in YAML; the network uses 1 per TBlock
    n_blocks: int = 8
    pretrain: Optional[str] = None

    # training (read for surface parity; training is not ported yet)
    patch_size: int = 384
    batch_size: int = 2
    data_repeat: int = 5
    data_augment: int = 1
    data_add_noise: bool = False
    cutout: bool = False
    cutmix: bool = False
    epochs: int = 200
    lr: float = 1e-4
    eta_min: float = 1e-6
    gamma: float = 0.5
    log_every: int = 200
    test_every: int = 1
    log_path: str = "./experiments"
    log_name: Optional[str] = None
    lambda_l1: float = 1.0
    lambda_clip: float = 0.01

    # hardware
    gpu_ids: Optional[List[int]] = None
    threads: int = 8
    save_image: bool = False

    # data
    data_path: str = "../SR_datasets/"
    training_dataset: str = "us1k"
    eval_sets: List[str] = field(
        default_factory=lambda: ["CCA-US", "US-CASE", "US1K_23"])

    # test-only
    model_path: Optional[str] = None

    # knobs of the JAX package (the port reads ``dtype`` and ``use_pallas``,
    # which turns its CUDA kernels on in bf16)
    seed: int = 33
    dtype: str = "float32"
    use_pallas: bool = False
    mesh_data: int = 1
    mesh_space: int = 1
    captions_path: Optional[str] = None
    medclip_path: Optional[str] = None
    medclip_tiny: bool = False
    medclip_dtype: str = "float32"
    native_loader: bool = True
    profile_dir: Optional[str] = None
    faithful_clip: bool = False
    faithful_tail_batch: bool = False
    train_range: tuple = (1, 1001)
    resume: Optional[str] = None
    config: Optional[str] = None  # the yaml path itself

    extras: Dict[str, Any] = field(default_factory=dict)

    # fixed architecture constants (reference M2Trans_network.py:23,37)
    block_size: int = 8
    halo_size: int = 1
    window_sizes: tuple = (8, 16, 32)

    @property
    def pad_multiple(self) -> int:
        """LCM of window_sizes: input H, W are padded to this before the
        body."""
        m = self.window_sizes[0]
        for w in self.window_sizes[1:]:
            m = m * w // math.gcd(m, w)
        return m

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a reference-style flat YAML into a Config: YAML values over the
    defaults, then the non-None ``overrides`` (CLI flags) over YAML."""
    raw: Dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            raw.update(yaml.safe_load(f) or {})
        raw["config"] = path
    if overrides:
        raw.update({k: v for k, v in overrides.items() if v is not None})

    known = {k: v for k, v in raw.items() if k in _FIELD_NAMES}
    extras = {k: v for k, v in raw.items() if k not in _FIELD_NAMES}
    if extras:
        warnings.warn(f"config: unknown keys kept in extras: {sorted(extras)}")
    cfg = Config(**known, extras=extras) if "extras" not in known else Config(**known)

    if cfg.scale not in (2, 3, 4):
        raise ValueError(f"scale must be 2, 3 or 4, got {cfg.scale}")
    if cfg.n_feats % 4 != 0:
        raise ValueError("n_feats must be divisible by 4 (channel chunking)")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {cfg.dtype}")
    return cfg
