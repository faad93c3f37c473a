"""Checkpoints of the port; counterpart of m2trans_tpu/train/checkpoint.py.

The training state is saved in the reference's own format
(train.py:342-349, SURVEY.md:318-319): one ``torch.save`` dict
``{epoch, model_state_dict, optimizer_state_dict, scheduler_state_dict,
stat_dict}`` per epoch at ``<models>/model_x{scale}_{epoch}.pt``, with the
reference's state-dict keys, so both packages' ``load_params_any`` read
it. The optimizer's state is written as the reference's plain Adam writes
it (a float ``lr``, ``capturable`` False, ``step`` on the host), whether
the optimizer that wrote it is the capturable CUDA one with a tensor LR
(``train/loop.py::make_optimizer``) or the CPU one, and it loads into
either (:func:`load_optimizer_state`). ``--resume`` restores the newest epoch, as the reference's
glob-by-epoch logic (train.py:92-108). Orbax directories, the JAX
package's own format, are not read here: orbax is a JAX library.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import M2Trans
from m2trans_tpu_torch.train.convert import (
    load_reference_state_dict,
    reference_state_dict,
)


def load_params_any(path: Optional[str], cfg: Config,
                    device: Optional[torch.device] = None) -> M2Trans:
    """A model from a reference ``.pt``: the full training dict
    (``{'model_state_dict': ...}``) or a bare state dict."""
    if path is None:
        raise ValueError("model_path is not set")
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
    model = model.to_empty(device=device or "cpu")
    return load_reference_state_dict(model, sd)


def checkpoint_path(models_path: str, scale: int, epoch: int) -> str:
    return os.path.join(models_path, f"model_x{scale}_{epoch}.pt")


def optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` in the reference's form: every group's
    ``lr`` a float and ``capturable`` False, every ``step`` a host f32
    scalar, as a plain Adam writes them."""
    sd = optimizer.state_dict()  # its state dicts are the optimizer's own
    sd["state"] = {k: dict(st) for k, st in sd["state"].items()}
    for g in sd["param_groups"]:
        g["lr"] = float(g["lr"])
        g["capturable"] = False
    for st in sd["state"].values():
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].detach().to("cpu", torch.float32)
    return sd


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    """Load ``sd`` (:func:`optimizer_state`'s form, or a capturable
    optimizer's) into ``optimizer``, which keeps its own ``capturable``
    flag and its LR tensors (filled with the saved LRs): a CUDA graph of the
    step reads the same tensor after a load."""
    own = [(g.get("capturable", False), g["lr"]) for g in optimizer.param_groups]
    groups = [dict(saved, capturable=cap)
              for saved, (cap, _) in zip(sd["param_groups"], own)]
    optimizer.load_state_dict({"state": sd["state"], "param_groups": groups})
    for g, (_, lr) in zip(optimizer.param_groups, own):
        if torch.is_tensor(lr):
            lr.fill_(float(g["lr"]))
            g["lr"] = lr


def save_state(models_path: str, epoch: int, scale: int, model: M2Trans,
               optimizer: torch.optim.Optimizer,
               scheduler_state: Dict[str, Any], stat_dict: Dict) -> str:
    """Write the epoch's training state; returns its path."""
    path = checkpoint_path(models_path, scale, epoch)
    torch.save({"epoch": epoch,
                "model_state_dict": reference_state_dict(model),
                "optimizer_state_dict": optimizer_state(optimizer),
                "scheduler_state_dict": scheduler_state,
                "stat_dict": stat_dict}, path)
    return path


def latest_epoch(models_path: str, scale: int) -> Optional[int]:
    pat = re.compile(rf"model_x{scale}_(\d+)\.pt$")
    epochs = [int(m.group(1)) for f in os.listdir(models_path)
              if (m := pat.match(f))] if os.path.isdir(models_path) else []
    return max(epochs) if epochs else None


def restore_latest(models_path: str, scale: int, model: M2Trans,
                   optimizer: torch.optim.Optimizer
                   ) -> Optional[Tuple[int, Dict]]:
    """Load the newest epoch's state into ``model`` and ``optimizer``;
    returns (epoch, stat_dict), or None where there is no checkpoint."""
    epoch = latest_epoch(models_path, scale)
    if epoch is None:
        return None
    ckpt = torch.load(checkpoint_path(models_path, scale, epoch),
                      map_location="cpu", weights_only=True)
    load_reference_state_dict(model, ckpt["model_state_dict"])
    load_optimizer_state(optimizer, ckpt["optimizer_state_dict"])
    return ckpt["epoch"], ckpt["stat_dict"]
