"""M2Trans in plain PyTorch, NCHW, from a reference-format state dict.

The network of eezkni/M2Trans (``models/M2Trans_network.py``), written
anew for the benchmark and holding nothing of the port: reflect pad to a
multiple of 32 (bottom / right) -> head 3x3 reflect conv -> ``n_blocks`` x
CFTM -> global residual -> pixel-shuffle tail -> clamp to [0, rgb_range] ->
crop. A CFTM: instance norm (no affine, biased variance, eps 1e-5), four
channel quarters through halo-attention branches at Haar levels 0 / 1 / 2
/ 2, each quarter after the first averaged with the previous branch's
output first, each branch's input added to its output; the four outputs
concatenated, a 3x3 zero-padded conv with bias, the module's input added.
A branch: orthonormal 2x2 Haar DWT ``levels`` times (subbands [LL, HL, LH,
HH] as channel groups), a 1x1 qkv conv without bias, single-head attention
of each 8x8 block over its zero-padded 10x10 neighbourhood with ``rel_h``
added to the first half of the key channels by key row and ``rel_w`` to
the second half by key column, q scaled by C^-1/2, then the inverse DWT.
The frozen ``sub_mean`` / ``add_mean`` are in the state dict and unused.

Every product's operands go through a :class:`~.precision.Precision`
(f32 for the reference, fp8 for the control).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.precision import F32, Precision

BLOCK, HALO, PAD_MULTIPLE = 8, 1, 32
BRANCHES = (("attn1", 0), ("attn2", 1), ("attn3", 2), ("attn4", 2))


def param_shapes(model: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the reference state dict of
    the configuration's ``model`` sizes. ``init``: "conv" (U(+-1/sqrt(fan
    in)), PyTorch's default), "qkv" (N(0, sqrt(2 / (3C)))), "rel" (N(0, 1)),
    "mean" (the fixed MeanShift convs)."""
    nf, s, colors = model["n_feats"], model["scale"], model["colors"]
    yield "sub_mean.weight", (3, 3, 1, 1), "mean"
    yield "sub_mean.bias", (3,), "mean"
    yield "add_mean.weight", (3, 3, 1, 1), "mean"
    yield "add_mean.bias", (3,), "mean"
    yield "head.weight", (nf, colors, 3, 3), "conv"
    yield "head.bias", (nf,), "conv"
    for i in range(model["n_blocks"]):
        for name, ch in (("attn1", nf // 4), ("attn2", nf), ("attn3", 4 * nf),
                         ("attn4", 4 * nf)):
            base = f"body.{i}.{name}"
            yield f"{base}.rel_h", (1, BLOCK + 2 * HALO, 1, ch // 2), "rel"
            yield f"{base}.rel_w", (1, 1, BLOCK + 2 * HALO, ch // 2), "rel"
            yield f"{base}.qkv_conv.weight", (3 * ch, ch, 1, 1), "qkv"
        yield f"body.{i}.feed_forward.0.weight", (nf, nf, 3, 3), "conv"
        yield f"body.{i}.feed_forward.0.bias", (nf,), "conv"
    if s == 4:
        yield "tail.0.weight", (4 * nf, nf, 1, 1), "conv"
        yield "tail.0.bias", (4 * nf,), "conv"
        yield "tail.3.weight", (4 * nf, nf, 1, 1), "conv"
        yield "tail.3.bias", (4 * nf,), "conv"
        yield "tail.6.weight", (3, nf, 3, 3), "conv"
    else:
        yield "tail.0.weight", (nf * s * s, nf, 1, 1), "conv"
        yield "tail.0.bias", (nf * s * s,), "conv"
        yield "tail.3.weight", (3, nf, 3, 3), "conv"


FROZEN = ("sub_mean.weight", "sub_mean.bias", "add_mean.weight", "add_mean.bias")


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    m = torch.remainder(i, 2 * (n - 1))
    return torch.where(m >= n, 2 * (n - 1) - m, m)


def reflect_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """numpy's 'reflect' padding of the last two axes of NCHW ``x`` (edge
    not repeated; keeps reflecting where a pad is wider than the frame)."""
    if top or bottom:
        x = x.index_select(2, _reflect_index(x.shape[2], top, bottom, x.device))
    if left or right:
        x = x.index_select(3, _reflect_index(x.shape[3], left, right, x.device))
    return x


def conv(x, w, b=None, *, pad: str, prec: Precision):
    """``pad``: 'reflect' (explicit reflect pad, then valid), 'zeros' or
    'valid'."""
    k = w.shape[-1] // 2
    if pad == "reflect" and k:
        x = reflect_pad(x, k, k, k, k)
    y = prec.out(F.conv2d(prec(x), prec(w), padding=k if pad == "zeros" else 0))
    return y if b is None else y + b[None, :, None, None]


def dwt(x: torch.Tensor) -> torch.Tensor:
    a, b = x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2]
    c, d = x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]
    return torch.cat([(a + b + c + d) * 0.5, (-a - b + c + d) * 0.5,
                      (-a + b - c + d) * 0.5, (a - b - c + d) * 0.5], dim=1)


def iwt(x: torch.Tensor) -> torch.Tensor:
    bsz, c4, h, w = x.shape
    ll, hl, lh, hh = torch.split(x, c4 // 4, dim=1)
    out = x.new_empty(bsz, c4 // 4, 2 * h, 2 * w)
    out[:, :, 0::2, 0::2] = (ll - hl - lh + hh) * 0.5
    out[:, :, 1::2, 0::2] = (ll - hl + lh - hh) * 0.5
    out[:, :, 0::2, 1::2] = (ll + hl - lh - hh) * 0.5
    out[:, :, 1::2, 1::2] = (ll + hl + lh + hh) * 0.5
    return out


def halo_block(sd: Dict[str, torch.Tensor], base: str, z: torch.Tensor,
               prec: Precision) -> torch.Tensor:
    bsz, c, h, w = z.shape
    win = BLOCK + 2 * HALO
    qkv = conv(z, sd[f"{base}.qkv_conv.weight"], pad="valid", prec=prec)
    q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
    nb, mb = h // BLOCK, w // BLOCK
    qb = q.reshape(bsz, c, nb, BLOCK, mb, BLOCK).permute(0, 2, 4, 3, 5, 1)
    qb = qb.reshape(bsz, nb, mb, BLOCK * BLOCK, c) * c ** -0.5

    def windows(t):
        t = F.pad(t, (HALO, HALO, HALO, HALO))
        return t.unfold(2, win, BLOCK).unfold(3, win, BLOCK).permute(0, 2, 3, 4, 5, 1)

    kw = windows(k)  # (B, nb, mb, key row, key col, C)
    rel_h = sd[f"{base}.rel_h"].reshape(win, c // 2)
    rel_w = sd[f"{base}.rel_w"].reshape(win, c // 2)
    kw = torch.cat([kw[..., :c // 2] + rel_h[:, None, :],
                    kw[..., c // 2:] + rel_w[None, :, :]], dim=-1)
    kw = kw.reshape(bsz, nb, mb, win * win, c)
    vw = windows(v).reshape(bsz, nb, mb, win * win, c)
    attn = prec.out(torch.einsum("bnmqc,bnmkc->bnmqk", prec(qb), prec(kw))).softmax(dim=-1)
    out = prec.out(torch.einsum("bnmqk,bnmkc->bnmqc", prec(attn), prec(vw)))
    out = out.reshape(bsz, nb, mb, BLOCK, BLOCK, c).permute(0, 5, 1, 3, 2, 4)
    return out.reshape(bsz, c, h, w)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def cftm(sd, i: int, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    quarters = torch.chunk(instance_norm(x), 4, dim=1)
    outs, prev = [], None
    for (name, levels), xk in zip(BRANCHES, quarters):
        if prev is not None:
            xk = (xk + prev) * 0.5
        z = xk
        for _ in range(levels):
            z = dwt(z)
        z = halo_block(sd, f"body.{i}.{name}", z, prec)
        for _ in range(levels):
            z = iwt(z)
        prev = z + xk
        outs.append(prev)
    ff = f"body.{i}.feed_forward.0"
    return conv(torch.cat(outs, dim=1), sd[f"{ff}.weight"], sd[f"{ff}.bias"],
                pad="zeros", prec=prec) + x


def tail(sd, y: torch.Tensor, scale: int, prec: Precision) -> torch.Tensor:
    stages = ((("tail.0", 2), ("tail.3", 2)) if scale == 4 else (("tail.0", scale),))
    for name, r in stages:
        y = conv(y, sd[f"{name}.weight"], sd[f"{name}.bias"], pad="valid", prec=prec)
        y = F.gelu(F.pixel_shuffle(y, r), approximate="none")
    last = "tail.6" if scale == 4 else "tail.3"
    return conv(y, sd[f"{last}.weight"], pad="reflect", prec=prec)


def forward(sd: Dict[str, torch.Tensor], lr_nhwc: torch.Tensor, model: dict,
            prec: Precision = F32) -> torch.Tensor:
    """(B, H, W, colors) f32 in [0, rgb_range] -> (B, H*s, W*s, 3) f32."""
    s, rng = model["scale"], float(model["rgb_range"])
    x = lr_nhwc.permute(0, 3, 1, 2).float()
    h, w = x.shape[2], x.shape[3]
    x = reflect_pad(x, 0, -h % PAD_MULTIPLE, 0, -w % PAD_MULTIPLE)
    res = conv(x, sd["head.weight"], sd["head.bias"], pad="reflect", prec=prec)
    y = res
    for i in range(model["n_blocks"]):
        y = cftm(sd, i, y, prec)
    y = torch.clamp(tail(sd, res + y, s, prec), 0.0, rng)
    return y[:, :, :h * s, :w * s].permute(0, 2, 3, 1)


def served(y: torch.Tensor, out: str) -> torch.Tensor:
    """A forward's output as a server hands it out: f32, or u8 levels
    ``round(y * 255)``."""
    return torch.round(y * 255.0).to(torch.uint8) if out == "u8" else y
