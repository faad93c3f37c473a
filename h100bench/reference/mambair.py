"""MambaIR in plain PyTorch, NCHW and token sequences as released, from a
released-layout state dict.

The network of csguoh/MambaIR (``basicsr/archs/mambair_arch.py``,
``MambaIR`` with ``upsampler='pixelshuffle'``, ``resi_connection='1conv'``)
at test time, written anew for the benchmark and holding nothing of the
port:

    (x - mean) * img_range -> conv_first -> tokens -> LayerNorm ->
    n_blocks x RSSG -> LayerNorm -> conv_after_body + conv_first's output
    -> conv 3x3 + LeakyReLU(0.01) -> log2(scale) x [conv 3x3 to 4 num_feat,
    PixelShuffle(2)] -> conv_last -> / img_range + mean.

An RSSG: ``depth`` VSSBlocks, the tokens back to a map, a 3x3 conv, the
group's input added. A VSSBlock: x = u * skip_scale + SS2D(LN_1(u)), then
x * skip_scale2 + CAB(LN_2(x)) (conv 3x3 C -> C / 3, GELU, conv 3x3 back,
times the sigmoid of the squeeze 1x1 convs of its global average pool).
SS2D as released: in_proj (no bias) split into x and z; x through the
depthwise 3x3 conv and SiLU; the cross-scan of ``forward_core`` (the map
flattened row-major, its transpose flattened, ``torch.stack``, both
``torch.flip``-ped, ``torch.cat``: (B, 4, D, L)); x_proj and dt_proj as
``einsum`` over those copies; the selective scan (mamba_ssm's
``selective_scan_fn`` semantics with ``delta_softplus``: delta =
softplus(dt + dt_bias), h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t, y_t =
<C_t, h_t> + D u_t, A = -exp(A_log)); the outputs flipped and transposed
back and summed, ((y_0 + y_2) + y_1) + y_3; LN_out, times SiLU(z),
out_proj (no bias). No clamp: the release's forward has none.

The scan is its recurrence in f32, in chunks of ``CHUNK`` tokens along L
(padded with steps that change nothing): each chunk scanned from a zero
state for its end state, the end states carried across the chunks with the
chunk's total decay exp(A sum(delta)), then each chunk scanned again from
its carried state for y. :func:`scan_loop` is the same recurrence one token
at a time, for the tests.

Every product's operands go through a :class:`~.precision.Precision`
(f32 for the reference, fp8 for the control); ``state_bf16`` rounds the
scan's state to bf16 after every update (the second control).
``drop_path_rate`` is inactive at inference and ``img_size`` unused.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.hat import RGB_MEAN, served  # noqa: F401  (served: the shared hand-out)
from h100bench.reference.precision import F32, Precision

K = 4            # scan directions
CHUNK = 64       # tokens a chunk of the reference's scan
PERTURB = 0.1    # std of the seeded perturbation of A_log, D, the dt bias and the skip scales
IN_PROJ_STD = 0.1  # the release's 0.02, raised (state_dict)
XPROJ_GAIN = 4.0   # times the release's bound of x_proj_weight (state_dict)


def sizes(model: dict) -> dict:
    """MambaIR's sizes from a configuration's ``model`` (defaults:
    test_MambaIR_SR_x4)."""
    dim = model["n_feats"]
    return {"scale": model["scale"], "dim": dim, "groups": model["n_blocks"],
            "depth": model.get("depths", [6] * model["n_blocks"])[0],
            "d_state": model.get("d_state", 16),
            "d_inner": int(model.get("mlp_ratio", 2.0) * dim),
            "dt_rank": math.ceil(dim / 16),
            "compress": model.get("compress_ratio", 3),
            "squeeze": model.get("squeeze_factor", 30),
            "num_feat": model.get("num_feat", 64), "img_range": model.get("img_range", 1.0),
            "mean": tuple(model.get("rgb_mean", RGB_MEAN)), "colors": model.get("colors", 3)}


def param_shapes(model: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the released state dict of the
    configuration's ``model`` sizes. ``init``, as the release initialises:
    "trunc" (trunc-normal 0.02: out_proj), "in_proj" (trunc-normal 0.02 in
    the release), "ones" / "zeros" (LayerNorms), "conv" (PyTorch's default
    U(+-1/sqrt(fan in)), weight and bias), "xproj" (the stacked x_proj
    Linears' default, U(+-1/sqrt(d_inner))), "dtw" (U(+-dt_rank^-1/2)),
    "dtb" (inverse softplus of a log-uniform dt in [1e-3, 0.1], floored at
    1e-4), "alog" (log(1..d_state)), "skip" (ones: D and the skip scales).
    :func:`state_dict` departs from it where it says."""
    s = sizes(model)
    c, d, r, n, nf = s["dim"], s["d_inner"], s["dt_rank"], s["d_state"], s["num_feat"]

    def conv(name, cin, cout, k, groups=1):
        yield f"{name}.weight", (cout, cin // groups, k, k), "conv"
        yield f"{name}.bias", (cout,), "conv"

    def norm(name, dim):
        yield f"{name}.weight", (dim,), "ones"
        yield f"{name}.bias", (dim,), "zeros"

    yield from conv("conv_first", s["colors"], c, 3)
    yield from norm("patch_embed.norm", c)
    for i in range(s["groups"]):
        for j in range(s["depth"]):
            b = f"layers.{i}.residual_group.blocks.{j}"
            yield from norm(f"{b}.ln_1", c)
            a = f"{b}.self_attention"
            yield f"{a}.in_proj.weight", (2 * d, c), "in_proj"
            yield from conv(f"{a}.conv2d", d, d, 3, groups=d)
            yield f"{a}.x_proj_weight", (K, r + 2 * n, d), "xproj"
            yield f"{a}.dt_projs_weight", (K, d, r), "dtw"
            yield f"{a}.dt_projs_bias", (K, d), "dtb"
            yield f"{a}.A_logs", (K * d, n), "alog"
            yield f"{a}.Ds", (K * d,), "skip"
            yield from norm(f"{a}.out_norm", d)
            yield f"{a}.out_proj.weight", (c, d), "trunc"
            yield f"{b}.skip_scale", (c,), "skip"
            cab = f"{b}.conv_blk.cab"
            yield from conv(f"{cab}.0", c, c // s["compress"], 3)
            yield from conv(f"{cab}.2", c // s["compress"], c, 3)
            yield from conv(f"{cab}.3.attention.1", c, c // s["squeeze"], 1)
            yield from conv(f"{cab}.3.attention.3", c // s["squeeze"], c, 1)
            yield from norm(f"{b}.ln_2", c)
            yield f"{b}.skip_scale2", (c,), "skip"
        yield from conv(f"layers.{i}.conv", c, c, 3)
    yield from norm("norm", c)
    yield from conv("conv_after_body", c, c, 3)
    yield from conv("conv_before_upsample.0", c, nf, 3)
    for u in range(int(math.log2(s["scale"]))):
        yield from conv(f"upsample.{2 * u}", nf, 4 * nf, 3)
    yield from conv("conv_last", nf, s["colors"], 3)


@torch.no_grad()
def state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The released state dict of the ``model`` sizes, f32 on ``device``,
    from ``seed`` (one ``torch.Generator``, the draws in the order of
    :func:`param_shapes`): the release's init, with a N(0, 0.1)
    perturbation of A_log, D, the dt bias and the skip scales, so that no
    program can lean on the init's structure (A = -(1..N), D = 1), and two
    scales raised so that the scan carries weight: in_proj trunc-normal 0.1
    (not 0.02) and x_proj_weight U(+-4/sqrt(d_inner)) (not 1/sqrt). With the
    release's scales x is ~0.1, B_k and C_k ~0.06, and the state-space term
    <C, h> is 0.4% of the scan's output (y is nearly sum_k D_k x): at full
    width (one group of three blocks, 2 x 32^2 frames, f32 on the CPU) a
    program that dropped the reversed directions moved the output by 8e-5,
    under bf16's own 6.6e-4, so ``correct`` could not see the scan. With
    these the term is 36-56% of it and that program reads 2.7e-3 (PERF.md)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    shapes = {n: sh for n, sh, _ in param_shapes(model)}
    s = sizes(model)
    sd = {}

    def uniform(shape, bound):
        return torch.rand(shape, generator=gen, device=device).mul_(2 * bound).sub_(bound)

    def noise(shape):
        return torch.randn(shape, generator=gen, device=device) * PERTURB

    for name, shape, kind in param_shapes(model):
        if kind in ("trunc", "in_proj"):
            t = torch.empty(shape, device=device)
            std = IN_PROJ_STD if kind == "in_proj" else 0.02
            sd[name] = torch.nn.init.trunc_normal_(t, std=std, generator=gen)
        elif kind == "conv":
            w = shapes[name.rsplit(".", 1)[0] + ".weight"]
            sd[name] = uniform(shape, 1.0 / math.sqrt(math.prod(w[1:])))
        elif kind == "xproj":
            sd[name] = uniform(shape, XPROJ_GAIN * s["d_inner"] ** -0.5)
        elif kind == "dtw":
            sd[name] = uniform(shape, s["dt_rank"] ** -0.5)
        elif kind == "dtb":
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
            sd[name] = dt + torch.log(-torch.expm1(-dt)) + noise(shape)
        elif kind == "alog":
            a = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32, device=device))
            sd[name] = a.expand(shape) + noise(shape)
        elif kind == "skip":
            sd[name] = 1.0 + noise(shape)
        elif kind == "ones":
            sd[name] = torch.ones(shape, device=device)
        else:
            sd[name] = torch.zeros(shape, device=device)
    return {n: t.contiguous() for n, t in sd.items()}


def conv(sd, name, x, prec: Precision, groups: int = 1):
    w = sd[f"{name}.weight"]
    y = prec.out(F.conv2d(prec(x), prec(w), padding=w.shape[-1] // 2, groups=groups))
    return y + sd[f"{name}.bias"][None, :, None, None]


def layer_norm(sd, name, x):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)


def _round(h, state_bf16: bool):
    return h.bfloat16().float() if state_bf16 else h


def selective_scan(u, delta, a, bs, cs, d, delta_bias, chunk: int = CHUNK,
                   state_bf16: bool = False):
    """``selective_scan_fn(u, delta, A, B, C, D, delta_bias=...,
    delta_softplus=True)`` in f32, chunked along L (module docstring): u,
    delta (b, K * d_inner, L); a (K * d_inner, N); bs, cs (b, K, N, L); d,
    delta_bias (K * d_inner,) -> (b, K * d_inner, L)."""
    b, kd, length = u.shape
    n = a.shape[-1]
    di = kd // K
    delta = F.softplus(delta + delta_bias[:, None])
    if u.device.type == "meta":  # shapes only (operation counts): the recurrence holds no product
        return d[:, None] * u
    nc = -(-length // chunk)
    pad = nc * chunk - length

    def chunks(t):  # (..., L) -> (..., nc, chunk), padded with zeros
        return F.pad(t, (0, pad)).unflatten(-1, (nc, chunk))

    dl = chunks(delta).view(b, K, di, nc, chunk)
    du = chunks(delta * u).view(b, K, di, nc, chunk)
    bc, cc = chunks(bs), chunks(cs)                  # (b, K, N, nc, chunk)
    av = a.view(K, di, n)[None, :, :, :, None]      # (1, K, d, N, 1)

    def step(h, j):                                  # h (b, K, d, N, nc)
        decay = torch.exp(dl[..., j][:, :, :, None, :] * av)
        return _round(decay * h + du[..., j][:, :, :, None, :] * bc[..., j][:, :, None],
                      state_bf16)

    h = u.new_zeros(b, K, di, n, nc)
    for j in range(chunk):
        h = step(h, j)
    total = torch.exp(dl.sum(-1)[:, :, :, None, :] * av)  # each chunk's decay
    start = torch.zeros_like(h)
    carry = h.new_zeros(b, K, di, n)
    for c in range(nc):
        start[..., c] = carry
        carry = _round(total[..., c] * carry + h[..., c], state_bf16)
    h = start
    y = u.new_empty(b, K, di, nc, chunk)
    for j in range(chunk):
        h = step(h, j)
        y[..., j] = (h * cc[..., j][:, :, None]).sum(3)
    y = y.flatten(-2)[..., :length].reshape(b, kd, length)
    return y + d[:, None] * u


def scan_loop(u, delta, a, bs, cs, d, delta_bias):
    """:func:`selective_scan` one token at a time (for the tests)."""
    b, kd, length = u.shape
    delta = F.softplus(delta + delta_bias[:, None])
    bx = bs.repeat_interleave(kd // bs.shape[1], dim=1)  # (b, kd, N, L)
    cx = cs.repeat_interleave(kd // cs.shape[1], dim=1)
    h = u.new_zeros(b, kd, a.shape[-1])
    ys = []
    for t in range(length):
        h = torch.exp(delta[:, :, t, None] * a) * h + (delta[:, :, t] * u[:, :, t])[..., None] * bx[..., t]
        ys.append((h * cx[..., t]).sum(-1))
    return torch.stack(ys, dim=-1) + d[:, None] * u


def ss2d(sd, name, x, prec: Precision, s: dict, state_bf16: bool):
    """SS2D.forward of (B, H, W, C) tokens as released."""
    bsz, h, w, _ = x.shape
    di, r, n, length = s["d_inner"], s["dt_rank"], s["d_state"], h * w
    xz = prec.out(F.linear(prec(x), prec(sd[f"{name}.in_proj.weight"])))
    x, z = xz.chunk(2, dim=-1)
    x = F.silu(conv(sd, f"{name}.conv2d", x.permute(0, 3, 1, 2).contiguous(), prec, groups=di))
    # forward_core: the cross-scan copies
    x_hwwh = torch.stack([x.view(bsz, -1, length),
                          torch.transpose(x, 2, 3).contiguous().view(bsz, -1, length)],
                         dim=1).view(bsz, 2, -1, length)
    xs = torch.cat([x_hwwh, torch.flip(x_hwwh, dims=[-1])], dim=1)  # (B, 4, D, L)
    x_dbl = prec.out(torch.einsum("bkdl,kcd->bkcl", prec(xs),
                                  prec(sd[f"{name}.x_proj_weight"])))
    dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=2)
    dts = prec.out(torch.einsum("bkrl,kdr->bkdl", prec(dts),
                                prec(sd[f"{name}.dt_projs_weight"])))
    out_y = selective_scan(xs.reshape(bsz, -1, length), dts.reshape(bsz, -1, length),
                           -torch.exp(sd[f"{name}.A_logs"]), bs, cs, sd[f"{name}.Ds"],
                           sd[f"{name}.dt_projs_bias"].reshape(-1),
                           state_bf16=state_bf16).view(bsz, K, -1, length)
    inv_y = torch.flip(out_y[:, 2:4], dims=[-1]).view(bsz, 2, -1, length)
    wh_y = torch.transpose(out_y[:, 1].view(bsz, -1, w, h), 2, 3).contiguous().view(bsz, -1, length)
    invwh_y = torch.transpose(inv_y[:, 1].view(bsz, -1, w, h), 2, 3).contiguous().view(
        bsz, -1, length)
    y = out_y[:, 0] + inv_y[:, 0] + wh_y + invwh_y
    y = torch.transpose(y, 1, 2).contiguous().view(bsz, h, w, -1)
    y = layer_norm(sd, f"{name}.out_norm", y) * F.silu(z)
    return prec.out(F.linear(prec(y), prec(sd[f"{name}.out_proj.weight"])))


def vss_block(sd, name, x, s, prec, state_bf16):
    """VSSBlock.forward of (B, H, W, C) tokens."""
    y = x * sd[f"{name}.skip_scale"] + ss2d(sd, f"{name}.self_attention",
                                             layer_norm(sd, f"{name}.ln_1", x), prec, s,
                                             state_bf16)
    cab = f"{name}.conv_blk.cab"
    t = layer_norm(sd, f"{name}.ln_2", y).permute(0, 3, 1, 2).contiguous()
    t = conv(sd, f"{cab}.2", F.gelu(conv(sd, f"{cab}.0", t, prec)), prec)
    ca = torch.sigmoid(conv(sd, f"{cab}.3.attention.3",
                            F.relu(conv(sd, f"{cab}.3.attention.1",
                                        t.mean(dim=(2, 3), keepdim=True), prec)), prec))
    return y * sd[f"{name}.skip_scale2"] + (t * ca).permute(0, 2, 3, 1)


def forward(sd: Dict[str, torch.Tensor], lr_nhwc: torch.Tensor, model: dict,
            prec: Precision = F32, state_bf16: bool = False) -> torch.Tensor:
    """(B, H, W, colors) f32 in [0, 1] -> (B, H*s, W*s, colors) f32."""
    s = sizes(model)
    scale, rng = s["scale"], s["img_range"]
    x = lr_nhwc.permute(0, 3, 1, 2).float()
    h, w = x.shape[2], x.shape[3]
    mean = torch.tensor(s["mean"], device=x.device).view(1, 3, 1, 1)
    x = conv(sd, "conv_first", (x - mean) * rng, prec)
    t = layer_norm(sd, "patch_embed.norm", x.permute(0, 2, 3, 1))
    for i in range(s["groups"]):
        y = t
        for j in range(s["depth"]):
            y = vss_block(sd, f"layers.{i}.residual_group.blocks.{j}", y, s, prec, state_bf16)
        t = conv(sd, f"layers.{i}.conv", y.permute(0, 3, 1, 2), prec).permute(0, 2, 3, 1) + t
    t = layer_norm(sd, "norm", t).permute(0, 3, 1, 2)
    y = conv(sd, "conv_after_body", t, prec) + x
    y = F.leaky_relu(conv(sd, "conv_before_upsample.0", y, prec), 0.01)
    for u in range(int(math.log2(scale))):
        y = F.pixel_shuffle(conv(sd, f"upsample.{2 * u}", y, prec), 2)
    y = conv(sd, "conv_last", y, prec) / rng + mean
    return y.permute(0, 2, 3, 1)
