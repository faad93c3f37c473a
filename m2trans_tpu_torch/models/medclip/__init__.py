"""MedCLIP (Swin-tiny vision + Bio_ClinicalBERT text) of the port; the
encoders the semantic loss runs (m2trans_tpu/models/medclip/)."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn


class ParamTree(nn.Module):
    """A nested dict of arrays (lists for repeated blocks, None for an
    absent part) as a module of frozen parameters, in the JAX package's
    param layout: dict keys and list indices become submodule names, so the
    state_dict keys are the tree's paths ("stages.0.blocks.1.attn.q_w") and
    ``p["attn"]["q_w"]`` reads as the JAX code does. Linear weights are
    (in, out), as there."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if val is None:
                continue
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                t = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val))
                self.register_parameter(key, nn.Parameter(t.detach().clone(),
                                                          requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


def layer_norm(x: torch.Tensor, p: ParamTree, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32, cast back to x's dtype (the JAX
    encoders' ``_layer_norm``)."""
    return nn.functional.layer_norm(x.float(), (x.shape[-1],), p["g"].float(),
                                    p["b"].float(), eps).to(x.dtype)


def normal_(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    """N(0, std) drawn on the CPU from ``gen`` (so a seed gives the same
    weights on every device)."""
    return torch.randn(shape, generator=gen) * std
