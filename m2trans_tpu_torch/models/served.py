"""The models the port serves, one entry each, keyed by the config's
``model``. Serving (``parallel/streaming.py``), its graphs
(``models/graphed.py``), the infer CLI and the checkpoint loader ask this
table (:func:`by_name`, :func:`of`) and name no model: adding one is its
module and an entry in :data:`SERVED`."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.hat import HAT, hat_apply, load_hat_state_dict
from m2trans_tpu_torch.models.m2trans import M2Trans, m2trans_apply_microbatched
from m2trans_tpu_torch.models.mambair import MambaIR, load_mambair_state_dict, mambair_apply
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.models.sr_blocks import release_params
from m2trans_tpu_torch.ops.kernels.ff_conv import ff_conv
from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch
from m2trans_tpu_torch.ops.kernels.hat_attn import overlap_attention, window_attention_16
from m2trans_tpu_torch.ops.kernels.in_stats import in_stats_affine
from m2trans_tpu_torch.ops.kernels.row_norm import row_norm
from m2trans_tpu_torch.ops.kernels.ss2d_scan import ss2d_scan
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_fused
from m2trans_tpu_torch.train.convert import load_reference_state_dict


@dataclasses.dataclass(frozen=True)
class ServedModel:
    """What serving needs of one model: its module class, named as the
    config's ``model``; ``forward(model, x, cfg, policy, output_u8)``, (B,
    H, W, colors) f32 in [0, 1] -> (B, H*s, W*s, 3) in the policy's dtype,
    clamped to [0, 1] by the model's own rule and always for ``output_u8``;
    the kernel wrappers, by name, whose ``launches`` it moves; whether its
    frames may be sharded by rows (``parallel/spatial.py``); ``load(path,
    cfg, device)`` from a checkpoint file."""

    model_class: type
    forward: Callable[[nn.Module, torch.Tensor, Config, ComputePolicy, bool], torch.Tensor]
    counted: Dict[str, Callable]
    row_sharded: bool
    load: Callable[[str, Config, Optional[torch.device]], nn.Module]


def _m2trans_forward(model, x, cfg, policy, output_u8):
    return m2trans_apply_microbatched(model, x, cfg, policy)  # clamped by the model


def _load_m2trans(path, cfg, device):
    """A reference ``.pt``: the full training dict (``{'model_state_dict':
    ...}``) or a bare state dict."""
    if os.path.isdir(path) or not path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the torch port reads reference .pt checkpoints only; it "
            "does not read orbax checkpoint directories (orbax is a JAX "
            "library). Write a .pt from one with the JAX package's converter: "
            "python convert_checkpoint.py --config <yml> --input <orbax dir> "
            "--output <file>.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    with torch.device("meta"):
        model = M2Trans(cfg)
    return load_reference_state_dict(model.to_empty(device=device or "cpu"), sd)


def _hat_forward(model, x, cfg, policy, output_u8):
    y = hat_apply(model, x, cfg, policy)  # not clamped, as released
    return y.clamp(0.0, 1.0) if output_u8 else y


def _load_hat(path, cfg, device):
    """A released ``.pth``: ``params_ema``, else ``params``, else a bare
    state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = HAT(cfg)
    return load_hat_state_dict(model.to_empty(device=device or "cpu"), release_params(ckpt))


def _mambair_forward(model, x, cfg, policy, output_u8):
    y = mambair_apply(model, x, cfg, policy)  # not clamped, as released
    return y.clamp(0.0, 1.0) if output_u8 else y


def _load_mambair(path, cfg, device):
    """A released ``.pth``: ``params``, else ``params_ema``, else a bare
    state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = MambaIR(cfg)
    return load_mambair_state_dict(model.to_empty(device=device or "cpu"),
                                   release_params(ckpt, ("params", "params_ema")))


SERVED: Dict[str, ServedModel] = {
    "M2Trans": ServedModel(
        M2Trans, _m2trans_forward,
        {"cftm_branch": cftm_branch, "ff_conv": ff_conv, "tail_band": tail_band_fused,
         "in_stats": in_stats_affine},
        row_sharded=True, load=_load_m2trans),
    # 36 SW-MSA + 6 OCA launches a forward at HAT_SRx4's depth, and 86
    # LayerNorms (two a block, the stem's and the body's)
    "HAT": ServedModel(
        HAT, _hat_forward,
        {"hat_wattn": window_attention_16, "hat_oca": overlap_attention,
         "row_norm": row_norm},
        row_sharded=False, load=_load_hat),
    # 36 scan launches a forward at MambaIR_SRx4's depth (one an SS2D), and
    # 110 LayerNorms (three a block, the stem's and the body's)
    "MambaIR": ServedModel(
        MambaIR, _mambair_forward, {"ss2d_scan": ss2d_scan, "row_norm": row_norm},
        row_sharded=False, load=_load_mambair),
}


def by_name(name: str) -> ServedModel:
    """The entry of a config's ``model``; raises for one not served."""
    if name not in SERVED:
        raise ValueError(f"model {name!r}: the port serves {', '.join(sorted(SERVED))}")
    return SERVED[name]


def of(model: nn.Module) -> ServedModel:
    """The entry whose ``model_class`` ``model`` is."""
    for entry in SERVED.values():
        if isinstance(model, entry.model_class):
            return entry
    raise TypeError(f"{type(model).__name__} is not a served model; the port serves "
                    f"{', '.join(sorted(SERVED))}")
