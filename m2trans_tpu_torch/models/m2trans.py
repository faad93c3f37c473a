"""M2Trans in PyTorch; port of m2trans_tpu/models/m2trans.py.

Architecture (reference models/M2Trans_network.py): reflect pad to a
multiple of 32 -> head 3x3 reflect conv -> n_blocks x CFTM -> global
residual -> pixel-shuffle tail -> clamp [0, rgb_range] -> crop.

The modules carry the reference's state_dict keys (``head.*``,
``body.{i}.attn{k}.qkv_conv/rel_h/rel_w``, ``body.{i}.feed_forward.0.*``,
``tail.{0,3,6}.*``, the frozen ``sub_mean``/``add_mean``), so a reference
``.pt`` loads with ``load_state_dict(strict=True)``. They hold parameters
only: the forward is the function :func:`m2trans_apply` on NHWC tensors.

Numerics (``models/numerics.py::ComputePolicy``):
  * f32 parity: the plain composition of ``cftm_apply`` and the
    conv -> shuffle tail, TF32 off for matmul and cuDNN (the analogue of
    ``Precision.HIGHEST``);
  * bf16: the structure of the JAX ``_cftm_apply_fused`` — head conv, the
    global residual and the depth-to-space are plain torch; each CFTM takes
    its IN statistics (one ``in_stats_affine`` call, two launches, when no
    gradient flows; plain torch under autograd), runs its 4 branches through
    K1 at levels 0/1/2/2 and its feed-forward conv, bias and module residual
    through K3, and the tail runs through K2 (32 + 8 + 1 launches and 16 of
    the statistics for an 8-block serving forward). With ``use_kernels`` the
    kernel wrappers run (plain versions on CPU tensors); without, the plain
    versions run on any device.

The forward is differentiable in both modes: in bf16 with kernels the
backward runs K1b and K2b (32 + 1 launch groups for an 8-block model) and
K3's plain VJP. The standalone ``tblock_apply`` and ``make_branch_fn`` take
K1n, the bare wavelet branch, in bf16 with kernels.
Serving callers enter ``torch.inference_mode()`` themselves.

The cascade average z_k = (xn_k + o_{k-1}) / 2 enters K1 as its x_add
input with r = 0.5 and the instance-norm affine halved: in f32,
x*(s/2) + t/2 + o/2 equals ((x*s + t) + o)/2 exactly (every scaling is a
power of two), so unlike the JAX fused path's ``0.5/s`` fold this adds no
rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.numerics import (
    ComputePolicy,
    f32_parity,
    policy_from_config,
    prepared,
)
from m2trans_tpu_torch.ops.conv import conv2d, gelu_exact
from m2trans_tpu_torch.ops.halo_attention import halo_attention
from m2trans_tpu_torch.ops.kernels.ff_conv import (
    ff_conv,
    ff_conv_plain,
    ff_weight_hwio_view,
)
from m2trans_tpu_torch.ops.kernels.halo_attn import (
    cftm_branch,
    cftm_branch_plain,
    halo_attention_qkv,
)
from m2trans_tpu_torch.ops.kernels.in_stats import in_stats_affine, in_stats_affine_plain
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_apply
from m2trans_tpu_torch.ops.norm import instance_norm
from m2trans_tpu_torch.ops.pad import pad_to_multiple
from m2trans_tpu_torch.ops.pixel_shuffle import pixel_shuffle_fast, ps_weight_perm
from m2trans_tpu_torch.ops.wavelet import haar_dwt, haar_iwt


# ---------------------------------------------------------------------------
# Modules (parameter holders with the reference's keys)
# ---------------------------------------------------------------------------


class TBlock(nn.Module):
    """Halo-attention block parameters (reference TBlock, live config)."""

    def __init__(self, ch: int, block: int = 8, halo: int = 1):
        super().__init__()
        win = block + 2 * halo
        self.rel_h = nn.Parameter(torch.empty(1, win, 1, ch // 2))
        self.rel_w = nn.Parameter(torch.empty(1, 1, win, ch // 2))
        self.qkv_conv = nn.Conv2d(ch, 3 * ch, kernel_size=1, bias=False)


class CFTM(nn.Module):
    """Coarse-to-fine module parameters (reference CFTM, norm=True)."""

    def __init__(self, nf: int):
        super().__init__()
        self.attn1 = TBlock(nf // 4)
        self.attn2 = TBlock(nf)
        self.attn3 = TBlock(nf * 4)
        self.attn4 = TBlock(nf * 4)
        self.feed_forward = nn.Sequential(
            nn.Conv2d(nf, nf, kernel_size=3, padding=1))


class M2Trans(nn.Module):
    """Reference module tree; ``forward`` is :func:`m2trans_apply` with
    the config's policy (NHWC in, NHWC out)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        nf, s = cfg.n_feats, cfg.scale
        self.sub_mean = nn.Conv2d(3, 3, kernel_size=1)
        self.add_mean = nn.Conv2d(3, 3, kernel_size=1)
        for ms in (self.sub_mean, self.add_mean):
            ms.requires_grad_(False)  # frozen in the reference
        self.head = nn.Conv2d(cfg.colors, nf, kernel_size=3, padding=1)
        self.body = nn.ModuleList([CFTM(nf) for _ in range(cfg.n_blocks)])
        if s == 4:
            self.tail = nn.Sequential(
                nn.Conv2d(nf, nf * 4, 1), nn.PixelShuffle(2), nn.GELU(),
                nn.Conv2d(nf, nf * 4, 1), nn.PixelShuffle(2), nn.GELU(),
                nn.Conv2d(nf, 3, 3, padding=1, bias=False))
        else:
            self.tail = nn.Sequential(
                nn.Conv2d(nf, nf * s * s, 1), nn.PixelShuffle(s), nn.GELU(),
                nn.Conv2d(nf, 3, 3, padding=1, bias=False))

    def tail_params(self):
        """The tail as tail_phase's params dict (OIHW weights)."""
        t = self.tail
        if self.cfg.scale == 4:
            return {"c0": {"w": t[0].weight, "b": t[0].bias},
                    "c1": {"w": t[3].weight, "b": t[3].bias},
                    "c2": {"w": t[6].weight}}
        return {"c0": {"w": t[0].weight, "b": t[0].bias},
                "c1": {"w": t[3].weight}}

    def forward(self, x: torch.Tensor,
                policy: Optional[ComputePolicy] = None) -> torch.Tensor:
        return m2trans_apply(self, x, self.cfg, policy)


def trainable_mask(model: M2Trans):
    """Parameter name -> trainable; sub_mean/add_mean are frozen
    (requires_grad False in the reference)."""
    return {name: p.requires_grad for name, p in model.named_parameters()}


def param_count(model: M2Trans, trainable_only: bool = False) -> int:
    return sum(p.numel() for p in model.parameters()
               if p.requires_grad or not trainable_only)


# ---------------------------------------------------------------------------
# Seeded init (PyTorch's distributions, as init_m2trans of the JAX package)
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_m2trans(cfg: Config, seed: int = 0,
                 device: Optional[torch.device] = None) -> M2Trans:
    """A model with PyTorch's init distributions, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so one seed gives the same
    weights on every device), then moved to ``device``:
    conv weight and bias U(+-1/sqrt(fan_in)); qkv N(0, sqrt(2/(3ch)));
    rel_h, rel_w N(0, 1); the MeanShift convs fixed."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        model = M2Trans(cfg)
    model = model.to_empty(device="cpu")

    def uniform_(p, bound):
        p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)

    qkv = set()
    for mod in model.modules():
        if isinstance(mod, TBlock):
            ch = mod.qkv_conv.in_channels
            mod.qkv_conv.weight.copy_(torch.randn(
                mod.qkv_conv.weight.shape, generator=gen) * math.sqrt(2.0 / (3 * ch)))
            mod.rel_h.copy_(torch.randn(mod.rel_h.shape, generator=gen))
            mod.rel_w.copy_(torch.randn(mod.rel_w.shape, generator=gen))
            qkv.add(mod.qkv_conv)
        elif isinstance(mod, nn.Conv2d) and mod not in qkv:
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            uniform_(mod.weight, math.sqrt(1.0 / fan_in))
            if mod.bias is not None:
                uniform_(mod.bias, math.sqrt(1.0 / fan_in))
    mean = torch.tensor([0.4488, 0.4371, 0.4040])
    for ms, sign in ((model.sub_mean, -1.0), (model.add_mean, 1.0)):
        ms.weight.copy_(torch.eye(3).reshape(3, 3, 1, 1))
        ms.bias.copy_(sign * cfg.rgb_range * mean)
    return model.to(device) if device is not None else model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _qkv_w(tb: TBlock, dtype) -> torch.Tensor:
    """(3C, C, 1, 1) qkv conv -> (C, 3C) matmul weight, q|k|v columns."""
    return prepared(tb, "qkv", dtype, (tb.qkv_conv.weight,),
                    lambda w: (w.reshape(w.shape[0], w.shape[1]).t(),))[0]


def _ff_wb(blk: CFTM, dtype):
    """The feed-forward conv's (3, 3, C_in, C_out) weight and its bias in
    ``dtype``, K3's operands."""
    ff = blk.feed_forward[0]
    return prepared(blk, "ff", dtype, (ff.weight, ff.bias),
                    lambda w, b: (ff_weight_hwio_view(w), b))


def _rel(tb: TBlock):
    win, c2 = tb.rel_h.shape[1], tb.rel_h.shape[3]
    return (tb.rel_h.reshape(win, c2).float().contiguous(),
            tb.rel_w.reshape(win, c2).float().contiguous())


def tblock_apply(tb: TBlock, x: torch.Tensor, *, block: int = 8,
                 halo: int = 1, policy: ComputePolicy = ComputePolicy()
                 ) -> torch.Tensor:
    """Halo-attention block: qkv 1x1 conv, halo attention. H and W are
    reflect-padded to a multiple of ``block`` and the result cropped back
    (never triggered inside the model, whose frames are 32-aligned at
    every pyramid level). In bf16 with kernels it is one K1n launch."""
    h, w = x.shape[1], x.shape[2]
    x = pad_to_multiple(x, block)
    rel_h, rel_w = _rel(tb)
    if policy.kernels:
        out = halo_attention_qkv(x.to(policy.dtype), _qkv_w(tb, policy.dtype),
                                 rel_h, rel_w, block=block, halo=halo)
    else:
        qkv = conv2d(x, tb.qkv_conv.weight, padding="valid", dtype=policy.dtype)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
        out = halo_attention(q, k, v, rel_h, rel_w, block=block, halo=halo)
    return out[:, :h, :w]


def make_branch_fn(blk: CFTM, policy: ComputePolicy, *, block: int = 8,
                   halo: int = 1):
    """Returns branch(name, z, levels) computing one CFTM wavelet branch,
    DWT^levels -> halo attention -> IWT^levels: one K1n launch in bf16 with
    kernels, plain torch otherwise. The f32 forward and the f32 spatially
    sharded forward use it; no bf16 model path reaches K1n (the bf16 forwards,
    sharded or not, run their branches through K1)."""

    def branch(name, z, levels):
        tb = getattr(blk, name)
        if policy.kernels:
            rel_h, rel_w = _rel(tb)
            return halo_attention_qkv(z.to(policy.dtype), _qkv_w(tb, policy.dtype),
                                      rel_h, rel_w, levels=levels, block=block,
                                      halo=halo)
        out = z
        for _ in range(levels):
            out = haar_dwt(out)
        out = tblock_apply(tb, out, block=block, halo=halo, policy=policy)
        for _ in range(levels):
            out = haar_iwt(out)
        return out

    return branch


# a CFTM's four branches: the TBlock and its Haar DWT levels
BRANCHES = (("attn1", 0), ("attn2", 1), ("attn3", 2), ("attn4", 2))


def cftm_apply(blk: CFTM, x: torch.Tensor, *, policy: ComputePolicy,
               block: int = 8, halo: int = 1) -> torch.Tensor:
    """Coarse-to-Fine Transformer Module (reference CFTM.forward)."""
    if policy.dtype == torch.bfloat16:
        return _cftm_apply_fused(blk, x, policy=policy, block=block, halo=halo)
    branch = make_branch_fn(blk, policy, block=block, halo=halo)
    xs = torch.chunk(instance_norm(x), 4, dim=-1)
    outs, prev = [], None
    for (name, levels), xk in zip(BRANCHES, xs):
        if prev is not None:
            xk = (xk + prev) * 0.5
        prev = branch(name, xk, levels) + xk
        outs.append(prev)
    ff = blk.feed_forward[0]
    return conv2d(torch.cat(outs, dim=-1), ff.weight, ff.bias,
                  padding="zeros") + x


def _cftm_apply_fused(blk: CFTM, x: torch.Tensor, *, policy: ComputePolicy,
                      block: int, halo: int) -> torch.Tensor:
    """bf16 CFTM: IN statistics, each branch one K1 call (affine, cascade
    add, DWT, qkv, attention, IWT, residual), then the ff conv, its bias and
    the module residual as one K3 call. The statistics are one
    ``in_stats_affine`` call when no gradient flows to ``x``; under autograd
    they are its plain version, whose backward is torch's."""
    branch = cftm_branch if policy.use_kernels else cftm_branch_plain
    ff = ff_conv if policy.use_kernels else ff_conv_plain
    x = x.to(policy.dtype)
    cb = x.shape[-1] // 4
    if policy.use_kernels and not (torch.is_grad_enabled() and x.requires_grad):
        st = in_stats_affine(x)
    else:
        st = in_stats_affine_plain(x)
    # branches 1-3 halved already; unbind, not indexing, so that the
    # backward gathers the branches' ds, dt in one stack each
    ss, ts = (v.unbind(0) for v in st.unbind(0))
    outs, prev = [], None
    for k, (name, levels) in enumerate(BRANCHES):
        tb = getattr(blk, name)
        sk, tk = ss[k], ts[k]
        rel_h, rel_w = _rel(tb)
        prev = branch(x[..., k * cb:(k + 1) * cb], _qkv_w(tb, policy.dtype),
                      rel_h, rel_w, sk, tk, x_add=prev, r=0.5, levels=levels,
                      block=block, halo=halo)
        outs.append(prev)
    return ff(torch.cat(outs, dim=-1), x, *_ff_wb(blk, policy.dtype))


def branch_identity(blk: CFTM, name: str, z: torch.Tensor, levels: int, *,
                    s: float, policy: ComputePolicy, block: int = 8,
                    halo: int = 1) -> torch.Tensor:
    """One bf16 CFTM branch with the identity affine, ``B(z*s) + z*s``: one
    K1 call with s, t = 0 and no cascade input (its plain version without
    kernels). The spatially sharded forward normalizes outside K1."""
    tb = getattr(blk, name)
    branch = cftm_branch if policy.use_kernels else cftm_branch_plain
    bsz, cb = z.shape[0], z.shape[-1]
    st = torch.zeros((2, bsz, cb), dtype=torch.float32, device=z.device)
    st[0] = s
    rel_h, rel_w = _rel(tb)
    return branch(z.to(policy.dtype), _qkv_w(tb, policy.dtype), rel_h, rel_w,
                  st[0], st[1], levels=levels, block=block, halo=halo)


def ff_residual(blk: CFTM, oc: torch.Tensor, x: torch.Tensor,
                policy: ComputePolicy) -> torch.Tensor:
    """bf16 feed-forward conv of ``oc`` (zero padded), its bias and the
    residual ``+ x``: one K3 call (its plain version without kernels)."""
    ff = ff_conv if policy.use_kernels else ff_conv_plain
    return ff(oc, x.to(policy.dtype), *_ff_wb(blk, policy.dtype))


_PS_PERM = {}  # (channels, r, device) -> the permutation on that device


def _ps_perm(channels: int, r: int, device) -> torch.Tensor:
    """``ps_weight_perm(channels, r)`` on ``device``, built and copied once:
    the f32 forward makes no host-to-device copy after its first call."""
    key = (channels, r, str(device))
    if key not in _PS_PERM:
        # a plain tensor even when first built while serving: an inference
        # tensor could not index a weight that autograd tracks later
        with torch.inference_mode(False):
            _PS_PERM[key] = torch.as_tensor(ps_weight_perm(channels, r), device=device)
    return _PS_PERM[key]


def _conv_ps_gelu(x, w, b, r):
    """1x1 conv -> PixelShuffle(r) -> GELU as conv with output channels in
    depth-to-space order -> GELU -> fast shuffle (bit-identical order)."""
    perm = _ps_perm(w.shape[0] // (r * r), r, w.device)
    y = conv2d(x, w[perm], b[perm], padding="valid")
    return pixel_shuffle_fast(gelu_exact(y), r)


def tail_apply(p, x: torch.Tensor, *, scale: int, policy: ComputePolicy,
               rgb_range: float = 1.0) -> torch.Tensor:
    """Pixel-shuffle tail. bf16: the phase-plane K2 (already clamped);
    f32: the conv -> shuffle composition of the reference."""
    if policy.dtype == torch.bfloat16:
        return tail_band_apply(p, x, scale=scale, rgb_range=rgb_range,
                               dtype=policy.dtype, use_kernel=policy.use_kernels)
    if scale == 4:
        x = _conv_ps_gelu(x, p["c0"]["w"], p["c0"]["b"], 2)
        x = _conv_ps_gelu(x, p["c1"]["w"], p["c1"]["b"], 2)
        return conv2d(x, p["c2"]["w"], padding="reflect")
    x = _conv_ps_gelu(x, p["c0"]["w"], p["c0"]["b"], scale)
    return conv2d(x, p["c1"]["w"], padding="reflect")


def m2trans_apply(model: M2Trans, x: torch.Tensor, cfg: Config,
                  policy: Optional[ComputePolicy] = None) -> torch.Tensor:
    """Full forward: (B, H, W, colors) in [0, rgb_range] ->
    (B, H*scale, W*scale, 3), in the policy's dtype."""
    if policy is None:
        policy = policy_from_config(cfg)
    with f32_parity(policy):
        h, w = x.shape[1], x.shape[2]
        x = pad_to_multiple(x, cfg.pad_multiple).to(policy.dtype)
        res = conv2d(x, model.head.weight, model.head.bias, padding="reflect",
                     dtype=policy.dtype)
        y = res
        for blk in model.body:
            y = cftm_apply(blk, y, policy=policy, block=cfg.block_size,
                           halo=cfg.halo_size)
        y = tail_apply(model.tail_params(), res + y, scale=cfg.scale,
                       policy=policy, rgb_range=cfg.rgb_range)
        y = torch.clamp(y, 0.0, cfg.rgb_range)
        return y[:, : h * cfg.scale, : w * cfg.scale, :]


MICRO_BATCH = 8


def m2trans_apply_microbatched(model: M2Trans, x: torch.Tensor, cfg: Config,
                               policy: Optional[ComputePolicy] = None,
                               micro_batch: int = MICRO_BATCH) -> torch.Tensor:
    """:func:`m2trans_apply` over chunks of ``micro_batch`` images (the JAX
    package's serving batch; not re-tuned for the card yet)."""
    b = x.shape[0]
    if b <= micro_batch or b % micro_batch:
        return m2trans_apply(model, x, cfg, policy)
    return torch.cat([m2trans_apply(model, xc, cfg, policy)
                      for xc in torch.split(x, micro_batch)], dim=0)
