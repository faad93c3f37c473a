"""HAT in plain PyTorch, NCHW and token sequences as released, from a
released-layout state dict.

The network of XPixelGroup/HAT (``hat/archs/hat_arch.py``, ``HAT`` with
``upsampler='pixelshuffle'``, ``resi_connection='1conv'``) and its test-time
padding (``hat/models/hat_model.py``: ``pre_process`` / ``post_process``),
written anew for the benchmark and holding nothing of the port:

    F.pad(reflect) of the frame to a multiple of the window (bottom /
    right) -> (x - mean) * img_range -> conv_first -> tokens -> LayerNorm
    -> n_blocks x RHAG -> LayerNorm -> conv_after_body + conv_first's output
    -> conv 3x3 + LeakyReLU(0.01) -> log2(scale) x [conv 3x3 to 4 num_feat,
    PixelShuffle(2)] -> conv_last -> / img_range + mean -> crop.

An RHAG: ``depth`` HABs (shift 0 in even blocks, window / 2 in odd ones),
an OCAB, the tokens back to a map, a 3x3 conv, the group's input added. A
HAB: shortcut + proj(W-MSA / SW-MSA) (torch.roll, window_partition, the
head split, q * hd^-0.5, q k^T + the relative position bias of the (2w-1)^2
table by the Swin index, + the -100 mask of calculate_mask, softmax, P v,
window_reverse, roll back) + conv_scale * CAB (conv 3x3 C -> C / compress,
GELU, conv 3x3 back, times the sigmoid of the squeeze 1x1 convs of its
global average pool), then x + MLP(LN(x)). An OCAB: the query windows of q;
k and v concatenated and cut by F.unfold (kernel key_window, stride window,
zero padding (key_window - window) / 2), the bias of the (window +
key_window - 1)^2 table by calculate_rpi_oca's index (negative entries wrap
in PyTorch indexing, as in the release), softmax, P v, window_reverse,
proj, + shortcut, then x + MLP(LN(x)). The qkv and output projections act
on each token alone, so they are applied to the map rather than to the
windows. No clamp: the release's forward has none.

Every product's operands go through a :class:`~.precision.Precision`
(f32 for the reference, fp8 for the control). ``drop_path_rate`` is
inactive at inference and ``img_size`` unused without ``ape``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.precision import F32, Precision

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def sizes(model: dict) -> dict:
    """HAT's sizes from a configuration's ``model`` (defaults: HAT_SRx4)."""
    window = model.get("window_size", 16)
    return {"scale": model["scale"], "dim": model["n_feats"], "groups": model["n_blocks"],
            "depth": model.get("depths", [6] * model["n_blocks"])[0],
            "heads": model["num_heads"], "window": window,
            "key_window": int(window * model.get("overlap_ratio", 0.5)) + window,
            "compress": model.get("compress_ratio", 3),
            "squeeze": model.get("squeeze_factor", 30),
            "conv_scale": model.get("conv_scale", 0.01),
            "hidden": int(model["n_feats"] * model.get("mlp_ratio", 2.0)),
            "num_feat": model.get("num_feat", 64), "img_range": model.get("img_range", 1.0),
            "mean": tuple(model.get("rgb_mean", RGB_MEAN)), "colors": model.get("colors", 3)}


def param_shapes(model: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the released state dict of the
    configuration's ``model`` sizes. ``init`` (HAT's ``_init_weights``):
    "trunc" (trunc-normal 0.02: Linear weights and the bias tables),
    "zeros" (Linear biases, LayerNorm biases), "ones" (LayerNorm weights),
    "conv" (PyTorch's default U(+-1/sqrt(fan in)), weight and bias), "index"
    (the two relative position index buffers)."""
    s = sizes(model)
    d, nf, w, kw = s["dim"], s["num_feat"], s["window"], s["key_window"]

    def conv(name, cin, cout, k):
        yield f"{name}.weight", (cout, cin, k, k), "conv"
        yield f"{name}.bias", (cout,), "conv"

    def linear(name, cin, cout):
        yield f"{name}.weight", (cout, cin), "trunc"
        yield f"{name}.bias", (cout,), "zeros"

    def norm(name):
        yield f"{name}.weight", (d,), "ones"
        yield f"{name}.bias", (d,), "zeros"

    yield "relative_position_index_SA", (w * w, w * w), "index"
    yield "relative_position_index_OCA", (w * w, kw * kw), "index"
    yield from conv("conv_first", s["colors"], d, 3)
    yield from norm("patch_embed.norm")
    for i in range(s["groups"]):
        g = f"layers.{i}.residual_group"
        for j in range(s["depth"]):
            b = f"{g}.blocks.{j}"
            yield from norm(f"{b}.norm1")
            yield f"{b}.attn.relative_position_bias_table", ((2 * w - 1) ** 2, s["heads"]), "trunc"
            yield from linear(f"{b}.attn.qkv", d, 3 * d)
            yield from linear(f"{b}.attn.proj", d, d)
            yield from conv(f"{b}.conv_block.cab.0", d, d // s["compress"], 3)
            yield from conv(f"{b}.conv_block.cab.2", d // s["compress"], d, 3)
            yield from conv(f"{b}.conv_block.cab.3.attention.1", d, d // s["squeeze"], 1)
            yield from conv(f"{b}.conv_block.cab.3.attention.3", d // s["squeeze"], d, 1)
            yield from norm(f"{b}.norm2")
            yield from linear(f"{b}.mlp.fc1", d, s["hidden"])
            yield from linear(f"{b}.mlp.fc2", s["hidden"], d)
        o = f"{g}.overlap_attn"
        yield from norm(f"{o}.norm1")
        yield from linear(f"{o}.qkv", d, 3 * d)
        yield f"{o}.relative_position_bias_table", ((w + kw - 1) ** 2, s["heads"]), "trunc"
        yield from linear(f"{o}.proj", d, d)
        yield from norm(f"{o}.norm2")
        yield from linear(f"{o}.mlp.fc1", d, s["hidden"])
        yield from linear(f"{o}.mlp.fc2", s["hidden"], d)
        yield from conv(f"layers.{i}.conv", d, d, 3)
    yield from norm("norm")
    yield from conv("conv_after_body", d, d, 3)
    yield from conv("conv_before_upsample.0", d, nf, 3)
    for u in range(int(math.log2(s["scale"]))):
        yield from conv(f"upsample.{2 * u}", nf, 4 * nf, 3)
    yield from conv("conv_last", nf, 3, 3)


def rpi_sa(window: int) -> torch.Tensor:
    """``calculate_rpi_sa``: the Swin relative position index."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def rpi_oca(window: int, key_window: int) -> torch.Tensor:
    """``calculate_rpi_oca`` as released (entries may be negative)."""
    def flat(n):
        return torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n),
                                          indexing="ij")).flatten(1)

    rel = (flat(key_window)[:, None, :] - flat(window)[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - key_window + 1
    rel[:, :, 1] += window - key_window + 1
    rel[:, :, 0] *= window + key_window - 1
    return rel.sum(-1)


def calculate_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """(nW, n, n) the SW-MSA mask, from the map's slices."""
    img = torch.zeros(1, h, w, 1)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, window).view(-1, window * window)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def linear(sd, name, x, prec: Precision):
    return prec.out(F.linear(prec(x), prec(sd[f"{name}.weight"]))) + sd[f"{name}.bias"]


def conv(sd, name, x, prec: Precision):
    w = sd[f"{name}.weight"]
    y = prec.out(F.conv2d(prec(x), prec(w), padding=w.shape[-1] // 2))
    return y + sd[f"{name}.bias"][None, :, None, None]


def layer_norm(sd, name, x):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def mlp(sd, name, x, prec):
    return linear(sd, f"{name}.fc2", F.gelu(linear(sd, f"{name}.fc1", x, prec)), prec)


def attention(q, k, v, bias, heads: int, prec: Precision, mask=None):
    """(b_, nq, c) q against (b_, nk, c) k and v, the heads split; ``bias``
    (heads, nq, nk); ``mask`` (nW, nq, nk) or None."""
    b_, nq, c = q.shape
    nk, d = k.shape[1], c // heads
    q = q.reshape(b_, nq, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    k = k.reshape(b_, nk, heads, d).permute(0, 2, 1, 3)
    v = v.reshape(b_, nk, heads, d).permute(0, 2, 1, 3)
    attn = prec.out(prec(q) @ prec(k).transpose(-2, -1)) + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, nq, nk) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, nq, nk)
    attn = attn.softmax(dim=-1)
    return prec.out(prec(attn) @ prec(v)).transpose(1, 2).reshape(b_, nq, c)


def sw_msa(q, k, v, table, heads: int, window: int, shift: int, prec: Precision):
    """W-MSA / SW-MSA of (b, h, w, c) maps q, k, v (the qkv projection of
    the normed map, a per-token product that commutes with the windows):
    roll by -shift, window_partition, attention with the Swin bias (+ the
    mask), window_reverse, roll back; before the output projection."""
    b, h, w, c = q.shape
    if shift:
        q, k, v = (torch.roll(t, (-shift, -shift), (1, 2)) for t in (q, k, v))
    qw, kw, vw = (window_partition(t, window).view(-1, window * window, c) for t in (q, k, v))
    n = window * window
    bias = table[rpi_sa(window).to(q.device).view(-1)].view(n, n, -1).permute(2, 0, 1)
    mask = calculate_mask(h, w, window, shift).to(q.device) if shift else None
    a = window_reverse(attention(qw, kw, vw, bias, heads, prec, mask).view(-1, window, window, c),
                       window, h, w)
    return torch.roll(a, (shift, shift), (1, 2)) if shift else a


def oca(q, k, v, table, heads: int, window: int, key_window: int, prec: Precision):
    """OCA of (b, h, w, c) maps: the query windows of q; k and v
    concatenated on channels and cut by F.unfold (zero padding); attention
    with calculate_rpi_oca's bias; window_reverse; before the output
    projection."""
    b, h, w, c = q.shape
    qw = window_partition(q, window).view(-1, window * window, c)
    kv = F.unfold(torch.cat((k, v), dim=-1).permute(0, 3, 1, 2), kernel_size=(key_window,) * 2,
                  stride=window, padding=(key_window - window) // 2)  # (b, 2c * ow * ow, nW)
    nk, nw = key_window * key_window, kv.shape[-1]
    kv = kv.view(b, 2, c, nk, nw).permute(1, 0, 4, 3, 2).reshape(2, b * nw, nk, c)
    idx = rpi_oca(window, key_window).to(q.device).view(-1)
    bias = table[idx].view(window * window, nk, -1).permute(2, 0, 1)
    a = attention(qw, kv[0], kv[1], bias, heads, prec)
    return window_reverse(a.view(-1, window, window, c), window, h, w)


def hab(sd, name, x, hw, shift, s, prec):
    (h, w), (b, _, c) = hw, x.shape
    shortcut = x
    x = layer_norm(sd, f"{name}.norm1", x).view(b, h, w, c)
    cab = f"{name}.conv_block.cab"
    y = conv(sd, f"{cab}.2", F.gelu(conv(sd, f"{cab}.0", x.permute(0, 3, 1, 2), prec)), prec)
    pooled = y.mean(dim=(2, 3), keepdim=True)
    ca = torch.sigmoid(conv(sd, f"{cab}.3.attention.3",
                            F.relu(conv(sd, f"{cab}.3.attention.1", pooled, prec)), prec))
    conv_x = (y * ca).permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    qkv = linear(sd, f"{name}.attn.qkv", x, prec)
    a = sw_msa(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
               sd[f"{name}.attn.relative_position_bias_table"], s["heads"], s["window"],
               shift, prec)
    a = linear(sd, f"{name}.attn.proj", a, prec).view(b, h * w, c)
    x = shortcut + a + conv_x * s["conv_scale"]
    return x + mlp(sd, f"{name}.mlp", layer_norm(sd, f"{name}.norm2", x), prec)


def ocab(sd, name, x, hw, s, prec):
    (h, w), (b, _, c) = hw, x.shape
    shortcut = x
    x = layer_norm(sd, f"{name}.norm1", x).view(b, h, w, c)
    qkv = linear(sd, f"{name}.qkv", x, prec)
    a = oca(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
            sd[f"{name}.relative_position_bias_table"], s["heads"], s["window"],
            s["key_window"], prec)
    x = linear(sd, f"{name}.proj", a.view(b, h * w, c), prec) + shortcut
    return x + mlp(sd, f"{name}.mlp", layer_norm(sd, f"{name}.norm2", x), prec)


def forward(sd: Dict[str, torch.Tensor], lr_nhwc: torch.Tensor, model: dict,
            prec: Precision = F32) -> torch.Tensor:
    """(B, H, W, colors) f32 in [0, 1] -> (B, H*s, W*s, 3) f32."""
    s = sizes(model)
    ws, scale, rng = s["window"], s["scale"], s["img_range"]
    x = lr_nhwc.permute(0, 3, 1, 2).float()
    h0, w0 = x.shape[2], x.shape[3]
    x = F.pad(x, (0, -w0 % ws, 0, -h0 % ws), "reflect")
    h, w = x.shape[2], x.shape[3]
    mean = torch.tensor(s["mean"], device=x.device).view(1, 3, 1, 1)
    x = conv(sd, "conv_first", (x - mean) * rng, prec)
    t = layer_norm(sd, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    for i in range(s["groups"]):
        g = f"layers.{i}"
        y = t
        for j in range(s["depth"]):
            y = hab(sd, f"{g}.residual_group.blocks.{j}", y, (h, w),
                    0 if j % 2 == 0 else ws // 2, s, prec)
        y = ocab(sd, f"{g}.residual_group.overlap_attn", y, (h, w), s, prec)
        y = conv(sd, f"{g}.conv", y.transpose(1, 2).view(-1, s["dim"], h, w), prec)
        t = y.flatten(2).transpose(1, 2) + t
    t = layer_norm(sd, "norm", t).transpose(1, 2).view(-1, s["dim"], h, w)
    y = conv(sd, "conv_after_body", t, prec) + x
    y = F.leaky_relu(conv(sd, "conv_before_upsample.0", y, prec), 0.01)
    for u in range(int(math.log2(scale))):
        y = F.pixel_shuffle(conv(sd, f"upsample.{2 * u}", y, prec), 2)
    y = conv(sd, "conv_last", y, prec) / rng + mean
    return y[:, :, :h0 * scale, :w0 * scale].permute(0, 2, 3, 1)


@torch.no_grad()
def state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The released state dict of the ``model`` sizes, f32 on ``device``
    (the index buffers int64), from ``seed``: one trunc-normal and one
    uniform draw from one ``torch.Generator``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    specs = list(param_shapes(model))
    trunc = [(n, sh) for n, sh, k in specs if k == "trunc"]
    uni = [(n, sh) for n, sh, k in specs if k == "conv"]
    t = torch.empty(sum(math.prod(sh) for _, sh in trunc), device=device)
    torch.nn.init.trunc_normal_(t, std=0.02, generator=gen)
    u = torch.rand(sum(math.prod(sh) for _, sh in uni), generator=gen, device=device)
    shapes = {n: sh for n, sh, _ in specs}
    sd, at = {}, 0
    for name, shape in trunc:
        sd[name] = t[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
    at = 0
    for name, shape in uni:
        wshape = shapes[name.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / math.sqrt(math.prod(wshape[1:]))
        sd[name] = u[at:at + math.prod(shape)].view(shape).mul(2 * bound).sub_(bound)
        at += math.prod(shape)
    s = sizes(model)
    for name, shape, kind in specs:
        if kind == "zeros":
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            sd[name] = torch.ones(shape, device=device)
    sd["relative_position_index_SA"] = rpi_sa(s["window"]).to(device)
    sd["relative_position_index_OCA"] = rpi_oca(s["window"], s["key_window"]).to(device)
    return {n: sd[n].contiguous() for n, _, _ in specs}


def served(y: torch.Tensor, out: str) -> torch.Tensor:
    """A forward's output as a server hands it out: f32, or u8 levels
    ``round(clamp(y, 0, 1) * 255)``."""
    return torch.round(y.clamp(0, 1) * 255.0).to(torch.uint8) if out == "u8" else y
