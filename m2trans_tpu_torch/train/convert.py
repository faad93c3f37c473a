"""Weight bridge of the port; counterpart of m2trans_tpu/train/convert.py.

The port's modules carry the reference's state_dict keys, so the reference
format is the port's own: a reference ``.pt`` (with or without the
DataParallel ``module.`` prefix) loads with ``strict=True``.

:func:`torch_state_dict_to_params` and :func:`params_to_torch_state_dict`
map a reference state dict to the JAX package's NHWC / HWIO params pytree
and back, in numpy alone; they are the port's own copy of that package's
converter (nothing of it is imported), and
:mod:`m2trans_tpu_torch.train.jax_params` builds a model from such a
pytree. Layout rules: conv weight OIHW <-> HWIO; the qkv 1x1 conv
(3C, C, 1, 1) <-> (1, 1, C, 3C), q|k|v order kept; rel_h (1, win, 1, c/2)
and rel_w (1, 1, win, c/2) <-> (win, c/2); the frozen sub_mean / add_mean
convs are carried through, so a round trip gives back every reference key.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import M2Trans

Params = Dict[str, Any]
_ATTN = ("attn1", "attn2", "attn3", "attn4")


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


def _to_np(t) -> np.ndarray:
    return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()


def _hwio(t) -> np.ndarray:
    return np.ascontiguousarray(_to_np(t).transpose(2, 3, 1, 0))


def _oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _tail_keys(scale: int):
    """(pytree name, state-dict index, has a bias) of the tail's convs."""
    if scale == 4:
        return (("c0", 0, True), ("c1", 3, True), ("c2", 6, False))
    return (("c0", 0, True), ("c1", 3, False))


def torch_state_dict_to_params(sd: Dict[str, Any], cfg: Config, *,
                               load_tail: bool = True) -> Params:
    """Reference state dict (tensors or numpy arrays) -> the JAX package's
    params pytree of numpy arrays. Raises KeyError on a missing key;
    ``load_tail=False`` leaves the tail out (an x2 backbone seeding an x4
    model)."""
    sd = strip_module_prefix(sd)
    params: Params = {}
    for name in ("sub_mean", "add_mean", "head"):
        params[name] = {"w": _hwio(sd[f"{name}.weight"]),
                        "b": _to_np(sd[f"{name}.bias"])}
    body = []
    while f"body.{len(body)}.feed_forward.0.weight" in sd:
        pre = f"body.{len(body)}"
        blk: Params = {}
        for a in _ATTN:
            rel_h = _to_np(sd[f"{pre}.{a}.rel_h"])  # (1, win, 1, c/2)
            rel_w = _to_np(sd[f"{pre}.{a}.rel_w"])  # (1, 1, win, c/2)
            blk[a] = {"qkv_w": _hwio(sd[f"{pre}.{a}.qkv_conv.weight"]),
                      "rel_h": rel_h.reshape(rel_h.shape[1], rel_h.shape[3]),
                      "rel_w": rel_w.reshape(rel_w.shape[2], rel_w.shape[3])}
        blk["ff"] = {"w": _hwio(sd[f"{pre}.feed_forward.0.weight"]),
                     "b": _to_np(sd[f"{pre}.feed_forward.0.bias"])}
        body.append(blk)
    if len(body) != cfg.n_blocks:
        raise KeyError(f"checkpoint has {len(body)} body blocks, config wants "
                       f"{cfg.n_blocks}")
    params["body"] = body
    if load_tail:
        params["tail"] = {}
        for name, idx, bias in _tail_keys(cfg.scale):
            params["tail"][name] = {"w": _hwio(sd[f"tail.{idx}.weight"])}
            if bias:
                params["tail"][name]["b"] = _to_np(sd[f"tail.{idx}.bias"])
    return params


def params_to_torch_state_dict(params: Params, cfg: Config,
                               module_prefix: bool = True) -> Dict[str, Any]:
    """The JAX package's params pytree -> a reference-keyed state dict of
    numpy arrays."""
    sd: Dict[str, Any] = {}
    for name in ("sub_mean", "add_mean", "head"):
        sd[f"{name}.weight"] = _oihw(params[name]["w"])
        sd[f"{name}.bias"] = np.asarray(params[name]["b"])
    for i, blk in enumerate(params["body"]):
        for a in _ATTN:
            win, c2 = np.asarray(blk[a]["rel_h"]).shape
            sd[f"body.{i}.{a}.qkv_conv.weight"] = _oihw(blk[a]["qkv_w"])
            sd[f"body.{i}.{a}.rel_h"] = np.asarray(
                blk[a]["rel_h"]).reshape(1, win, 1, c2)
            sd[f"body.{i}.{a}.rel_w"] = np.asarray(
                blk[a]["rel_w"]).reshape(1, 1, win, c2)
        sd[f"body.{i}.feed_forward.0.weight"] = _oihw(blk["ff"]["w"])
        sd[f"body.{i}.feed_forward.0.bias"] = np.asarray(blk["ff"]["b"])
    for name, idx, bias in _tail_keys(cfg.scale):
        sd[f"tail.{idx}.weight"] = _oihw(params["tail"][name]["w"])
        if bias:
            sd[f"tail.{idx}.bias"] = np.asarray(params["tail"][name]["b"])
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return sd
