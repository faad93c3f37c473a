"""MambaIR x4 in PyTorch, the port's third served model.

Guo et al., "MambaIR: A Simple Baseline for Image Restoration with
State-Space Model", ECCV 2024 (arXiv:2402.15648), github.com/csguoh/MambaIR,
``basicsr/archs/mambair_arch.py`` with ``options/test/test_MambaIR_SR_x4.yml``.
The JAX package has no MambaIR; this module is not a port of anything in it.

The modules carry the released state-dict names (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{ln_1,
self_attention.{in_proj, conv2d, x_proj_weight, dt_projs_weight,
dt_projs_bias, A_logs, Ds, out_norm, out_proj}, skip_scale,
conv_blk.cab.{0, 2, 3.attention.1, 3.attention.3}, ln_2, skip_scale2}``,
``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``upsample.{0, 2}``, ``conv_last``), so a
released ``.pth`` (``params``, else ``params_ema``) loads with
:func:`load_mambair_state_dict`. They hold parameters only: the forward is
:func:`mambair_apply` on NHWC tensors.

The forward, as released (``pixelshuffle`` upsampler, ``1conv`` residual
connections): subtract the RGB mean, 3x3 ``conv_first``, LayerNorm,
``n_blocks`` residual state-space groups, LayerNorm, ``conv_after_body``
plus the ``conv_first`` output, then HAT's pixel-shuffle tail
(``models/sr_blocks.py``) and the mean added back. A group (RSSG): ``depth``
VSSBlocks, a 3x3 conv, the group's input added. A VSSBlock on tokens u:

    x = u * skip_scale + SS2D(LN_1(u))
    out = x * skip_scale2 + CAB(LN_2(x))

(CAB: HAT's without ``conv_scale``). SS2D, with d_inner = mlp_ratio * C,
R = ceil(C / 16) and N = d_state:

    [x, z] = in_proj(h)                         C -> 2 d_inner, no bias
    x = SiLU(dwconv3x3(x))                      with bias
    [dt_k, B_k, C_k] = x_proj_k(x)              d_inner -> R + 2N, k = 0..3
    y = the four-way selective scan (``ops/kernels/ss2d_scan.py``)
    out = out_proj(LN_out(y) * SiLU(z))         d_inner -> C, no bias

``x_proj`` acts on each token alone, so it is one product over the map
(d_inner -> 4 (R + 2N), the four directions' weights stacked), never over
four permuted copies; ``dt_proj`` (R -> d_inner a direction) and the
softplus are inside the scan.

Numerics (``ComputePolicy``): f32 is the parity path (TF32 off, the scan's
plain version). bf16 keeps weights in bf16 (kept operands) and rounds every
activation between ops to bf16: the LayerNorms' outputs, x and z, the
depthwise conv's SiLU, the projections dt / B / C, the scan's output y, the
gate, each product's output and the residual sums. It does not round
inside the scan: delta (softplus of dt_proj), the state h and the sum of
the four directions are f32, and y is rounded once, after that sum. The
scan's tables (dt_proj's weight and bias, A = -exp(A_log), D) stay f32. With
``use_kernels`` the scan and the LayerNorms run through their kernel
wrappers (the CUDA kernels for CUDA tensors, the plain versions for CPU
tensors); ``ln_2`` takes in the scaled residual sum before it and
``out_norm`` the gate after it (``models/sr_blocks.py::layer_norm``).
Forward only: MambaIR is served, not trained, by the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.numerics import (
    ComputePolicy,
    f32_parity,
    policy_from_config,
    prepared,
)
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
    rgb_mean,
    tail_apply,
)
from m2trans_tpu_torch.ops.kernels.ss2d_scan import DIRECTIONS, ss2d_scan, ss2d_scan_plain


@dataclasses.dataclass(frozen=True)
class MambaIRSizes:
    """MambaIR's sizes. ``Config`` carries ``n_feats`` (embed_dim),
    ``n_blocks`` (residual groups) and ``scale``; the rest ride in
    ``Config.extras`` under the released yml's names (defaults:
    test_MambaIR_SR_x4)."""

    scale: int = 4
    embed_dim: int = 180
    groups: int = 6
    depth: int = 6            # VSSBlocks a group (the yml's ``depths``, all equal)
    d_state: int = 16
    mlp_ratio: float = 2.0    # SS2D's expand
    compress_ratio: int = 3
    squeeze_factor: int = 30
    num_feat: int = 64
    img_range: float = 1.0
    rgb_mean: Tuple[float, float, float] = RGB_MEAN
    colors: int = 3

    @property
    def d_inner(self) -> int:
        return int(self.mlp_ratio * self.embed_dim)

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.embed_dim / 16)

    @classmethod
    def from_config(cls, cfg: Config) -> "MambaIRSizes":
        ex: Dict[str, Any] = dict(cfg.extras)
        depths = ex.pop("depths", [6] * cfg.n_blocks)
        embed = ex.pop("embed_dim", cfg.n_feats)
        checks = {
            "depths": len(depths) == cfg.n_blocks and len(set(depths)) == 1,
            "embed_dim": embed == cfg.n_feats,
            "upsampler": ex.pop("upsampler", "pixelshuffle") == "pixelshuffle",
            "resi_connection": ex.pop("resi_connection", "1conv") == "1conv",
            "scale": cfg.scale in (2, 4),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise ValueError(f"MambaIR: the port serves MambaIR with equal depths in every "
                             f"group, embed_dim = n_feats, the pixelshuffle upsampler, 1conv "
                             f"residual connections and scale 2 or 4; these keys disagree: "
                             f"{bad}")
        keys = {f.name for f in dataclasses.fields(cls)}
        known = {k: (tuple(v) if k == "rgb_mean" else v) for k, v in ex.items() if k in keys}
        return cls(scale=cfg.scale, embed_dim=cfg.n_feats, groups=cfg.n_blocks,
                   depth=depths[0], colors=cfg.colors, **known)


# ---------------------------------------------------------------------------
# Modules (parameter holders with the released names)
# ---------------------------------------------------------------------------


class SS2D(nn.Module):
    def __init__(self, s: MambaIRSizes):
        super().__init__()
        c, d, r, n = s.embed_dim, s.d_inner, s.dt_rank, s.d_state
        self.in_proj = nn.Linear(c, 2 * d, bias=False)
        self.conv2d = nn.Conv2d(d, d, 3, 1, 1, groups=d)
        self.x_proj_weight = nn.Parameter(torch.empty(DIRECTIONS, r + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.empty(DIRECTIONS, d, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(DIRECTIONS, d))
        self.A_logs = nn.Parameter(torch.empty(DIRECTIONS * d, n))
        self.Ds = nn.Parameter(torch.empty(DIRECTIONS * d))
        self.out_norm = nn.LayerNorm(d)
        self.out_proj = nn.Linear(d, c, bias=False)


class VSSBlock(nn.Module):
    def __init__(self, s: MambaIRSizes):
        super().__init__()
        dim = s.embed_dim
        self.ln_1 = nn.LayerNorm(dim)
        self.self_attention = SS2D(s)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.conv_blk = CAB(dim, s.compress_ratio, s.squeeze_factor)
        self.ln_2 = nn.LayerNorm(dim)
        self.skip_scale2 = nn.Parameter(torch.ones(dim))


class _BasicLayer(nn.Module):
    def __init__(self, s: MambaIRSizes):
        super().__init__()
        self.blocks = nn.ModuleList([VSSBlock(s) for _ in range(s.depth)])


class RSSG(nn.Module):
    def __init__(self, s: MambaIRSizes):
        super().__init__()
        self.residual_group = _BasicLayer(s)
        self.conv = nn.Conv2d(s.embed_dim, s.embed_dim, 3, 1, 1)


class MambaIR(nn.Module):
    """The released module tree; ``forward`` is :func:`mambair_apply`."""

    def __init__(self, cfg: Config):
        super().__init__()
        s = MambaIRSizes.from_config(cfg)
        self.cfg, self.sizes = cfg, s
        dim = s.embed_dim
        self.conv_first = nn.Conv2d(s.colors, dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(dim)
        self.layers = nn.ModuleList([RSSG(s) for _ in range(s.groups)])
        self.norm = nn.LayerNorm(dim)
        self.conv_after_body = nn.Conv2d(dim, dim, 3, 1, 1)
        add_pixelshuffle_tail(self, dim, s.num_feat, s.scale, s.colors)

    def forward(self, x: torch.Tensor, policy: Optional[ComputePolicy] = None) -> torch.Tensor:
        return mambair_apply(self, x, self.cfg, policy)


@torch.no_grad()
def init_mambair(cfg: Config, seed: int = 0, device="cpu") -> MambaIR:
    """A MambaIR with the release's init from ``seed``: ``in_proj`` and
    ``out_proj`` trunc-normal(0.02), LayerNorms 1 / 0, convolutions and
    ``x_proj_weight`` PyTorch's default U(+-1/sqrt(fan in)) (the stacked
    x_proj Linears are parameters, not Linears, when ``_init_weights``
    runs), ``dt_projs_weight`` U(+-R^-1/2), ``dt_projs_bias`` the inverse
    softplus of exp(U(log 1e-3, log 0.1)) floored at 1e-4, ``A_logs`` log(1..N)
    in every channel, ``Ds`` and the skip scales 1."""
    gen = torch.Generator().manual_seed(seed)
    model = MambaIR(cfg)
    s = model.sizes
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.trunc_normal_(mod.weight, std=0.02, generator=gen)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            nn.init.uniform_(mod.weight, -bound, bound, generator=gen)
            nn.init.uniform_(mod.bias, -bound, bound, generator=gen)
        elif isinstance(mod, SS2D):
            nn.init.uniform_(mod.x_proj_weight, -s.d_inner ** -0.5, s.d_inner ** -0.5,
                             generator=gen)
            nn.init.uniform_(mod.dt_projs_weight, -s.dt_rank ** -0.5, s.dt_rank ** -0.5,
                             generator=gen)
            u = torch.rand(mod.dt_projs_bias.shape, generator=gen)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            dt = dt.clamp(min=1e-4)
            mod.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            mod.A_logs.copy_(torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32))
                             .expand_as(mod.A_logs))
            nn.init.ones_(mod.Ds)
    return model.to(device)


def load_mambair_state_dict(model: MambaIR, sd: Dict[str, Any]) -> MambaIR:
    """Load a released state dict (``params`` / ``params_ema`` already
    taken out; with or without a ``module.`` prefix) into ``model``,
    strictly."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    dev = next(model.parameters()).device
    model.load_state_dict({k: torch.as_tensor(v).to(dev) for k, v in sd.items()}, strict=True)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _scan_tables(mod: SS2D):
    """The scan's f32 tables: dt_proj's weight (4, D, R) and bias (4, D), A
    = -exp(A_log) (4, D, N) (kept on the module), D (4, D)."""
    d = mod.dt_projs_bias.shape[-1]
    (a,) = prepared(mod, "A", torch.float32, (mod.A_logs,),
                    lambda al: (-torch.exp(al.float()).view(DIRECTIONS, d, -1),))
    return mod.dt_projs_weight, mod.dt_projs_bias, a, mod.Ds.view(DIRECTIONS, d)


def ss2d_apply(mod: SS2D, h: torch.Tensor, policy: ComputePolicy) -> torch.Tensor:
    """SS2D (module docstring) of the normed tokens ``h`` (B, H, W, C)."""
    dt = policy.dtype
    d = mod.out_norm.normalized_shape[0]
    w = mod.in_proj.weight
    if w.dtype == dt:
        wx, wz, wp = w[:d], w[d:], mod.x_proj_weight.reshape(-1, d)
    else:
        wx, wz, wp = prepared(mod, "proj", dt, (w, mod.x_proj_weight),
                              lambda w, p: (w[:d], w[d:], p.reshape(-1, d)))
    x = F.silu(conv(mod.conv2d, F.linear(h, wx), dt)).contiguous()
    z = F.linear(h, wz)
    xdbl = F.linear(x, wp)  # (B, H, W, 4 (R + 2N)): every direction's projections
    scan = ss2d_scan if policy.kernels else ss2d_scan_plain
    y = scan(x, xdbl, *_scan_tables(mod))
    return linear(mod.out_proj, layer_norm(mod.out_norm, y, policy, gate=z), dt)


def _skip(blk: VSSBlock, dtype):
    if blk.skip_scale.dtype == dtype:
        return blk.skip_scale, blk.skip_scale2
    return prepared(blk, "skip", dtype, (blk.skip_scale, blk.skip_scale2), lambda a, b: (a, b))


def vss_apply(blk: VSSBlock, u: torch.Tensor, policy: ComputePolicy) -> torch.Tensor:
    dt = policy.dtype
    s1, s2 = _skip(blk, dt)
    x, xn = layer_norm(blk.ln_2, u, policy, scale=s1,
                       add=ss2d_apply(blk.self_attention, layer_norm(blk.ln_1, u, policy), policy))
    return x * s2 + cab_apply(blk.conv_blk, xn, dt)


def rssg_apply(grp: RSSG, x: torch.Tensor, policy: ComputePolicy) -> torch.Tensor:
    y = x
    for blk in grp.residual_group.blocks:
        y = vss_apply(blk, y, policy)
    return conv(grp.conv, y, policy.dtype) + x


def mambair_apply(model: MambaIR, x: torch.Tensor, cfg: Config,
                  policy: Optional[ComputePolicy] = None) -> torch.Tensor:
    """(B, H, W, colors) f32 in [0, 1] -> (B, H*scale, W*scale, colors) in
    the policy's dtype (not clamped: MambaIR's forward is not)."""
    if policy is None:
        policy = policy_from_config(cfg)
    s, dt = model.sizes, policy.dtype
    with f32_parity(policy):
        mean = rgb_mean(s.rgb_mean, x.device)
        feat = conv(model.conv_first, normalised_input(x, mean, s.img_range, dt), dt)
        y = layer_norm(model.patch_embed.norm, feat, policy)
        for grp in model.layers:
            y = rssg_apply(grp, y, policy)
        y = conv(model.conv_after_body, layer_norm(model.norm, y, policy), dt) + feat
        return tail_apply(model, y, mean, s.img_range, dt)
