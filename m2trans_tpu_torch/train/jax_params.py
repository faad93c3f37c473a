"""JAX params pytree <-> the port's model, for holding the port against the
JAX package with the same weights.

Built on the port's own numpy converter
(:mod:`m2trans_tpu_torch.train.convert`); like every module of the port it
imports nothing of the JAX package. The pytree is plain dicts and lists of
arrays, so the tests hand it over without either package importing the
other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import M2Trans
from m2trans_tpu_torch.train.convert import (
    load_reference_state_dict,
    params_to_torch_state_dict,
    reference_state_dict,
    torch_state_dict_to_params,
)


def module_from_params(params: Dict[str, Any], cfg: Config,
                       device: Optional[torch.device] = None) -> M2Trans:
    """JAX params pytree (numpy or jax arrays) -> a port model."""
    with torch.device("meta"):
        model = M2Trans(cfg)
    model = model.to_empty(device=device or "cpu")
    return load_reference_state_dict(
        model, params_to_torch_state_dict(params, cfg, module_prefix=False))


def params_from_module(model: M2Trans, cfg: Config) -> Dict[str, Any]:
    """Port model -> JAX params pytree of numpy arrays."""
    sd = {k: v.numpy() for k, v in reference_state_dict(model).items()}
    return torch_state_dict_to_params(sd, cfg)
