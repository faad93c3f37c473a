"""HAT (Hybrid Attention Transformer) x4 in PyTorch, the port's second
served model.

Chen et al., "Activating More Pixels in Image Super-Resolution
Transformer", CVPR 2023 (arXiv:2205.04437), github.com/XPixelGroup/HAT,
``hat/archs/hat_arch.py`` with ``options/test/HAT_SRx4.yml``. The JAX
package has no HAT; this module is not a port of anything in it.

The modules carry the released state-dict names (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.*``,
``layers.{i}.residual_group.overlap_attn.*``, ``layers.{i}.conv``,
``norm``, ``conv_after_body``, ``conv_before_upsample.0``,
``upsample.{0,2}``, ``conv_last`` and the index buffers
``relative_position_index_SA`` / ``_OCA``), so a released ``.pth``
(``params_ema``) loads with :func:`load_hat_state_dict`. They hold
parameters only: the forward is :func:`hat_apply` on NHWC tensors.

The forward, as published at test time: reflect-pad the frame to a multiple
of the window (``hat_model.py::pre_process``), subtract the RGB mean, 3x3
``conv_first``, LayerNorm, ``n_blocks`` residual hybrid attention groups,
LayerNorm, ``conv_after_body`` plus the ``conv_first`` residual, 3x3 conv
with LeakyReLU(0.01), two x [3x3 conv to 4x, PixelShuffle(2)], 3x3
``conv_last``, add the mean back, crop. A group: ``depth`` hybrid attention
blocks (HAB; shift 0 in even blocks, window / 2 in odd ones), the
overlapping cross-attention block (OCAB), a 3x3 conv, the group's input
added. A HAB: x + SW-MSA(LN(x)) + conv_scale * CAB(LN(x)), then x +
MLP(LN(x)); CAB is conv 3x3 C -> C / compress_ratio, GELU, conv 3x3 back,
times the sigmoid channel attention of its per-image channel means
(squeeze C -> C / squeeze_factor -> C). An OCAB: x + proj(OCA(LN(x))), then x
+ MLP(LN(x)). The attentions: :mod:`m2trans_tpu_torch.ops.kernels.hat_attn`.
The stem, the CAB, the pixel-shuffle tail and the checkpoint helpers are
:mod:`m2trans_tpu_torch.models.sr_blocks`'s, shared with MambaIR.

Numerics (``ComputePolicy``): f32 is the parity path (TF32 off, the
attentions' plain versions); bf16 keeps activations and weights in bf16
(weights laid out once and kept on the modules, ``models/numerics.py``'s
kept operands) and, with ``use_kernels``, runs the attentions
and the LayerNorms through their kernel wrappers (CUDA kernels for CUDA
tensors, the plain versions for CPU tensors); ``norm2`` takes in the
residual sum before it (``models/sr_blocks.py::layer_norm``). Forward
only: HAT is served, not trained, by the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.numerics import ComputePolicy, f32_parity, policy_from_config
from m2trans_tpu_torch.models.sr_blocks import (
    CAB,
    RGB_MEAN,
    PatchEmbed,
    add_pixelshuffle_tail,
    cab_apply,
    conv,
    layer_norm,
    linear,
    normalised_input,
    release_state_dict,
    rgb_mean,
    tail_apply,
)
from m2trans_tpu_torch.ops.kernels import hat_attn
from m2trans_tpu_torch.ops.kernels.swin_attn import relative_position_index, window_attention_plain
from m2trans_tpu_torch.ops.pad import pad_to_multiple

__all__ = ["HAT", "HATSizes", "hat_apply", "init_hat", "load_hat_state_dict",
           "release_state_dict"]
RELEASED_NAMES = {"window_size": "window"}  # the yml's name -> HATSizes'


@dataclasses.dataclass(frozen=True)
class HATSizes:
    """HAT's sizes. ``Config`` carries ``n_feats`` (embed_dim), ``n_blocks``
    (residual groups), ``num_heads`` and ``scale``; the rest ride in
    ``Config.extras`` under the released yml's names (defaults: HAT_SRx4)."""

    scale: int = 4
    embed_dim: int = 180
    groups: int = 6
    depth: int = 6           # HABs a group (the yml's ``depths``, all equal)
    heads: int = 6
    window: int = 16
    overlap_ratio: float = 0.5
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    mlp_ratio: float = 2.0
    num_feat: int = 64
    img_range: float = 1.0
    rgb_mean: Tuple[float, float, float] = RGB_MEAN
    colors: int = 3

    @property
    def key_window(self) -> int:
        return int(self.window * self.overlap_ratio) + self.window

    @classmethod
    def from_config(cls, cfg: Config) -> "HATSizes":
        ex: Dict[str, Any] = dict(cfg.extras)
        depths = ex.pop("depths", [6] * cfg.n_blocks)
        heads = ex.pop("num_heads", cfg.num_heads)
        embed = ex.pop("embed_dim", cfg.n_feats)
        checks = {
            "depths": len(depths) == cfg.n_blocks and len(set(depths)) == 1,
            "num_heads": isinstance(heads, int) or len(set(heads)) == 1,
            "embed_dim": embed == cfg.n_feats,
            "upsampler": ex.pop("upsampler", "pixelshuffle") == "pixelshuffle",
            "resi_connection": ex.pop("resi_connection", "1conv") == "1conv",
            "ape": not ex.pop("ape", False),
            "scale": cfg.scale in (2, 4),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise ValueError(f"HAT: the port serves HAT with equal depths and heads in every "
                             f"group, embed_dim = n_feats, the pixelshuffle upsampler, 1conv "
                             f"residual connections, no absolute position embedding and "
                             f"scale 2 or 4; these keys disagree: {bad}")
        if not isinstance(heads, int):
            heads = heads[0]
        ex = {RELEASED_NAMES.get(k, k): v for k, v in ex.items()}
        keys = {f.name for f in dataclasses.fields(cls)}
        known = {k: (tuple(v) if k == "rgb_mean" else v) for k, v in ex.items() if k in keys}
        return cls(scale=cfg.scale, embed_dim=cfg.n_feats, groups=cfg.n_blocks,
                   depth=depths[0], heads=heads, colors=cfg.colors, **known)


# ---------------------------------------------------------------------------
# Modules (parameter holders with the released names)
# ---------------------------------------------------------------------------


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class HAB(nn.Module):
    def __init__(self, s: HATSizes, shift: int):
        super().__init__()
        dim = s.embed_dim
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _WindowAttention(dim, s.window, s.heads)
        self.conv_block = CAB(dim, s.compress_ratio, s.squeeze_factor)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * s.mlp_ratio))


class OCAB(nn.Module):
    def __init__(self, s: HATSizes):
        super().__init__()
        dim = s.embed_dim
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((s.window + s.key_window - 1) ** 2, s.heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * s.mlp_ratio))


class _AttenBlocks(nn.Module):
    def __init__(self, s: HATSizes):
        super().__init__()
        self.blocks = nn.ModuleList(
            [HAB(s, 0 if j % 2 == 0 else s.window // 2) for j in range(s.depth)])
        self.overlap_attn = OCAB(s)


class RHAG(nn.Module):
    def __init__(self, s: HATSizes):
        super().__init__()
        self.residual_group = _AttenBlocks(s)
        self.conv = nn.Conv2d(s.embed_dim, s.embed_dim, 3, 1, 1)


def released_index_buffers(window: int, key_window: int) -> Dict[str, np.ndarray]:
    """The two index buffers a released state dict carries, as
    ``calculate_rpi_sa`` / ``calculate_rpi_oca`` make them."""
    return {"relative_position_index_SA": relative_position_index(window),
            "relative_position_index_OCA": hat_attn.released_oca_index(window, key_window)}


class HAT(nn.Module):
    """The released module tree; ``forward`` is :func:`hat_apply`."""

    def __init__(self, cfg: Config):
        super().__init__()
        s = HATSizes.from_config(cfg)
        self.cfg, self.sizes = cfg, s
        dim, nf = s.embed_dim, s.num_feat
        self.conv_first = nn.Conv2d(s.colors, dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(dim)
        self.layers = nn.ModuleList([RHAG(s) for _ in range(s.groups)])
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = nn.Conv2d(dim, dim, 3, 1, 1)
        add_pixelshuffle_tail(self, dim, nf, s.scale)
        for name, idx in released_index_buffers(s.window, s.key_window).items():
            self.register_buffer(name, torch.tensor(idx))

    def forward(self, x: torch.Tensor, policy: Optional[ComputePolicy] = None) -> torch.Tensor:
        return hat_apply(self, x, self.cfg, policy)


@torch.no_grad()
def init_hat(cfg: Config, seed: int = 0, device="cpu") -> HAT:
    """A HAT with HAT's ``_init_weights`` from ``seed``: every Linear and both
    bias tables trunc-normal(0.02) (Linear biases 0), LayerNorms 1 / 0,
    convolutions PyTorch's default U(+-1/sqrt(fan in))."""
    gen = torch.Generator().manual_seed(seed)
    model = HAT(cfg)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.trunc_normal_(mod.weight, std=0.02, generator=gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            nn.init.uniform_(mod.weight, -bound, bound, generator=gen)
            nn.init.uniform_(mod.bias, -bound, bound, generator=gen)
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            nn.init.trunc_normal_(p, std=0.02, generator=gen)
    return model.to(device)


def load_hat_state_dict(model: HAT, sd: Dict[str, Any]) -> HAT:
    """Load a released state dict (``params_ema`` / ``params`` already
    taken out; with or without a ``module.`` prefix) into ``model``,
    strictly. The index buffers it carries are checked against the port's
    own rules, which are what the kernels use."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    s = model.sizes
    for name, want in released_index_buffers(s.window, s.key_window).items():
        got = sd.get(name)
        if got is None or not np.array_equal(np.asarray(torch.as_tensor(got).cpu()), want):
            raise ValueError(f"HAT state dict: {name} is not the index of window {s.window} "
                             f"and key window {s.key_window}")
        sd[name] = torch.tensor(want)
    dev = next(model.parameters()).device
    sd = {k: torch.as_tensor(v).to(dev) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mlp(mlp: _Mlp, x: torch.Tensor, dtype) -> torch.Tensor:
    return linear(mlp.fc2, F.gelu(linear(mlp.fc1, x, dtype)), dtype)


def _qkv(mod: nn.Module, x: torch.Tensor, dtype):
    qkv = linear(mod.qkv, x, dtype)
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def hab_apply(blk: HAB, x: torch.Tensor, s: HATSizes, policy: ComputePolicy) -> torch.Tensor:
    dt = policy.dtype
    xn = layer_norm(blk.norm1, x, policy)
    q, k, v = _qkv(blk.attn, xn, dt)
    table = blk.attn.relative_position_bias_table
    if policy.kernels:
        a = hat_attn.window_attention_16(q, k, v, table, s.heads, blk.shift, window=s.window)
    else:
        a = window_attention_plain(q, k, v, table, s.heads, s.window, blk.shift)
    x, xn = layer_norm(blk.norm2, x + linear(blk.attn.proj, a, dt), policy,
                       add=cab_apply(blk.conv_block, xn, dt, s.conv_scale))
    return x + _mlp(blk.mlp, xn, dt)


def ocab_apply(blk: OCAB, x: torch.Tensor, s: HATSizes, policy: ComputePolicy) -> torch.Tensor:
    dt = policy.dtype
    q, k, v = _qkv(blk, layer_norm(blk.norm1, x, policy), dt)
    attend = (hat_attn.overlap_attention if policy.kernels
              else hat_attn.overlap_attention_plain)
    a = attend(q, k, v, blk.relative_position_bias_table, s.heads, s.window, s.key_window)
    x, xn = layer_norm(blk.norm2, x, policy, add=linear(blk.proj, a, dt))
    return x + _mlp(blk.mlp, xn, dt)


def rhag_apply(grp: RHAG, x: torch.Tensor, s: HATSizes, policy: ComputePolicy) -> torch.Tensor:
    y = x
    for blk in grp.residual_group.blocks:
        y = hab_apply(blk, y, s, policy)
    y = ocab_apply(grp.residual_group.overlap_attn, y, s, policy)
    return conv(grp.conv, y, policy.dtype) + x


def hat_apply(model: HAT, x: torch.Tensor, cfg: Config,
              policy: Optional[ComputePolicy] = None) -> torch.Tensor:
    """(B, H, W, colors) f32 in [0, 1] -> (B, H*scale, W*scale, 3) in the
    policy's dtype (not clamped: HAT's forward is not; its test script
    clamps when it writes an image)."""
    if policy is None:
        policy = policy_from_config(cfg)
    s, dt = model.sizes, policy.dtype
    with f32_parity(policy):
        h, w = x.shape[1], x.shape[2]
        mean = rgb_mean(s.rgb_mean, x.device)
        x = normalised_input(pad_to_multiple(x.float(), s.window), mean, s.img_range, dt)
        feat = conv(model.conv_first, x, dt)
        y = layer_norm(model.patch_embed.norm, feat, policy)
        for grp in model.layers:
            y = rhag_apply(grp, y, s, policy)
        y = conv(model.conv_after_body, layer_norm(model.norm, y, policy), dt) + feat
        y = tail_apply(model, y, mean, s.img_range, dt)
        return y[:, :h * s.scale, :w * s.scale, :]
