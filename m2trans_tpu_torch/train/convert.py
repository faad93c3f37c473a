"""Weight bridge of the port; counterpart of m2trans_tpu/train/convert.py.

The port's modules carry the reference's state_dict keys, so the reference
format is the port's own: a reference ``.pt`` (with or without the
DataParallel ``module.`` prefix) loads with ``strict=True``. The JAX params
pytree crosses over in :mod:`m2trans_tpu_torch.train.jax_params`, which
the serving path does not import.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from m2trans_tpu_torch.models.m2trans import M2Trans


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def load_reference_state_dict(model: M2Trans, sd: Dict[str, Any]) -> M2Trans:
    """Load a reference-keyed state dict (tensors or numpy arrays, with or
    without the ``module.`` prefix) into ``model``, strictly."""
    dev = next(model.parameters()).device
    sd = {k: torch.as_tensor(np.array(v) if not torch.is_tensor(v) else v,
                             dtype=torch.float32).to(dev)
          for k, v in strip_module_prefix(sd).items()}
    model.load_state_dict(sd, strict=True)
    return model


def reference_state_dict(model: M2Trans, module_prefix: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """The model's weights as a reference-format state dict on the CPU."""
    pre = "module." if module_prefix else ""
    return {pre + k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
