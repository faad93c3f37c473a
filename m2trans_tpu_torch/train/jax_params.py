"""JAX params pytree <-> the port's model, for holding the port against the
JAX package with the same weights.

Built on the JAX package's numpy-only converter
(``m2trans_tpu.train.convert``, which loads no jax), imported as it is.
This is the one module of the port that imports the JAX package; the
serving path (``infer``, ``parallel.streaming``, ``train.checkpoint``) and
``chip_smoke.py`` do not import it, and a test checks that.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from m2trans_tpu.train.convert import (
    params_to_torch_state_dict,
    torch_state_dict_to_params,
)
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import M2Trans
from m2trans_tpu_torch.train.convert import (
    load_reference_state_dict,
    reference_state_dict,
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
