"""Plain PyTorch ops of the port (NHWC), one module per JAX twin in
m2trans_tpu/ops/."""

from __future__ import annotations

import torch

_ON_DEVICE = {}  # (helper, args, device) -> its array on that device


def on_device(build, *args, device) -> torch.Tensor:
    """``build(*args)``, a constant array of a host helper (an interpolation
    matrix, an index table), as a tensor on ``device``, built and copied once
    per (helper, args, device): later calls make no host-to-device copy. A
    plain tensor even when first built under inference mode, so it can enter
    a product that autograd records later."""
    key = (build.__qualname__, args, str(device))
    if key not in _ON_DEVICE:
        with torch.inference_mode(False):
            _ON_DEVICE[key] = torch.as_tensor(build(*args), device=device)
    return _ON_DEVICE[key]
