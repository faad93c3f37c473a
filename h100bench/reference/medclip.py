"""MedCLIP's two encoders in plain PyTorch, from the released
``pytorch_model.bin`` layout; written anew for the benchmark.

- vision: HF ``SwinModel`` (Swin-tiny 224 at the published sizes): a 4x4
  stride-4 patch conv and LayerNorm; stages of blocks, each pre-LN window
  attention (relative position bias; every second block shifted by half a
  window with the -100 region mask, neither where the window covers the
  map) and a GELU MLP; 2x2 patch merging between stages; a final LayerNorm
  and the token mean; then the projection head (no bias) and an L2
  normalisation (medclip's ``encode_image``, fed raw [0, 1] patches as the
  M2Trans loss does).
- text: HF ``BertModel`` (bert-base): word + position + token-type (0)
  embeddings and LayerNorm, post-LN layers with the -10000 padding mask;
  the mean of hidden states 1, 2 and the last, averaged over the real
  tokens; the projection head and an L2 normalisation (medclip v0.0.3's
  text head).

Every product's operands go through a :class:`~.precision.Precision`.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.precision import F32, Precision

VISION, TEXT = "vision_model.model.", "text_model.model."


def param_shapes(cfg: dict) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the release layout at the
    sizes of ``cfg`` (``vision``, ``text``, ``projection_dim``); init is
    "normal", "zeros", "ones" or "logit_scale"."""
    v, t, proj = cfg["vision"], cfg["text"], cfg["projection_dim"]
    e, ps = v["embed_dim"], v["patch_size"]

    def norm(name, n):
        yield f"{name}.weight", (n,), "ones"
        yield f"{name}.bias", (n,), "zeros"

    def linear(name, n_out, n_in, bias=True):
        yield f"{name}.weight", (n_out, n_in), "normal"
        if bias:
            yield f"{name}.bias", (n_out,), "zeros"

    yield f"{VISION}embeddings.patch_embeddings.projection.weight", (e, 3, ps, ps), "normal"
    yield f"{VISION}embeddings.patch_embeddings.projection.bias", (e,), "zeros"
    yield from norm(f"{VISION}embeddings.norm", e)
    dim, nw = e, 2 * v["window_size"] - 1
    for si, depth in enumerate(v["depths"]):
        for di in range(depth):
            base = f"{VISION}encoder.layers.{si}.blocks.{di}"
            yield from norm(f"{base}.layernorm_before", dim)
            yield (f"{base}.attention.self.relative_position_bias_table",
                   (nw * nw, v["num_heads"][si]), "normal")
            for part in ("attention.self.query", "attention.self.key",
                         "attention.self.value", "attention.output.dense"):
                yield from linear(f"{base}.{part}", dim, dim)
            yield from norm(f"{base}.layernorm_after", dim)
            hidden = int(dim * v["mlp_ratio"])
            yield from linear(f"{base}.intermediate.dense", hidden, dim)
            yield from linear(f"{base}.output.dense", dim, hidden)
        if si < len(v["depths"]) - 1:
            ds = f"{VISION}encoder.layers.{si}.downsample"
            yield from linear(f"{ds}.reduction", 2 * dim, 4 * dim, bias=False)
            yield from norm(f"{ds}.norm", 4 * dim)
            dim *= 2
    yield from norm(f"{VISION}layernorm", dim)
    yield from linear("vision_model.projection_head", proj, dim, bias=False)

    h = t["hidden_size"]
    yield f"{TEXT}embeddings.word_embeddings.weight", (t["vocab_size"], h), "normal"
    yield (f"{TEXT}embeddings.position_embeddings.weight",
           (t["max_position_embeddings"], h), "normal")
    yield f"{TEXT}embeddings.token_type_embeddings.weight", (t["type_vocab_size"], h), "normal"
    yield from norm(f"{TEXT}embeddings.LayerNorm", h)
    for i in range(t["num_layers"]):
        base = f"{TEXT}encoder.layer.{i}"
        for part in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            yield from linear(f"{base}.{part}", h, h)
        yield from norm(f"{base}.attention.output.LayerNorm", h)
        yield from linear(f"{base}.intermediate.dense", t["intermediate_size"], h)
        yield from linear(f"{base}.output.dense", h, t["intermediate_size"])
        yield from norm(f"{base}.output.LayerNorm", h)
    yield from linear("text_model.projection_head", proj, h)
    yield "logit_scale", (), "logit_scale"


def _ln(sd, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], eps)


def _lin(sd, name, x, prec, bias=True):
    y = prec.out(prec(x) @ prec(sd[f"{name}.weight"]).t())
    return y + sd[f"{name}.bias"] if bias else y


def _rel_index(w: int, device) -> torch.Tensor:
    r = torch.arange(w, device=device)
    ry, rx = torch.meshgrid(r, r, indexing="ij")
    ry, rx = ry.reshape(-1), rx.reshape(-1)
    dy = ry[:, None] - ry[None, :] + (w - 1)
    dx = rx[:, None] - rx[None, :] + (w - 1)
    return dy * (2 * w - 1) + dx


def _region_mask(h: int, w: int, win: int, shift: int, device) -> torch.Tensor:
    lab = torch.zeros(h, w, dtype=torch.long, device=device)
    cuts = ((0, h - win), (h - win, h - shift), (h - shift, h))
    cuts_w = ((0, w - win), (w - win, w - shift), (w - shift, w))
    n = 0
    for y0, y1 in cuts:
        for x0, x1 in cuts_w:
            lab[y0:y1, x0:x1] = n
            n += 1
    lab = lab.reshape(h // win, win, w // win, win).permute(0, 2, 1, 3).reshape(-1, win * win)
    return (lab[:, :, None] != lab[:, None, :]).float() * -100.0


def encode_image(sd: Dict[str, torch.Tensor], cfg: dict, px: torch.Tensor,
                 prec: Precision = F32) -> torch.Tensor:
    """(N, H, W, 3) NHWC in [0, 1] -> L2-normalised (N, projection_dim)."""
    v = cfg["vision"]
    eps = v["layer_norm_eps"]
    p = VISION
    x = prec.out(F.conv2d(prec(px.permute(0, 3, 1, 2)),
                          prec(sd[f"{p}embeddings.patch_embeddings.projection.weight"]),
                          stride=v["patch_size"]))
    x = x + sd[f"{p}embeddings.patch_embeddings.projection.bias"][None, :, None, None]
    n, c, h, w = x.shape
    x = _ln(sd, f"{p}embeddings.norm", x.flatten(2).transpose(1, 2), eps)
    for si, depth in enumerate(v["depths"]):
        heads = v["num_heads"][si]
        hd = c // heads
        for di in range(depth):
            base = f"{p}encoder.layers.{si}.blocks.{di}"
            win, shift = v["window_size"], (v["window_size"] // 2 if di % 2 else 0)
            if min(h, w) <= win:
                win, shift = min(h, w), 0
            y = _ln(sd, f"{base}.layernorm_before", x, eps).reshape(n, h, w, c)
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            y = y.reshape(n, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(-1, win * win, c)

            def heads_of(name):
                t = _lin(sd, f"{base}.attention.self.{name}", y, prec)
                return t.reshape(-1, win * win, heads, hd).transpose(1, 2)

            q, k, val = heads_of("query"), heads_of("key"), heads_of("value")
            a = prec.out(prec(q) @ prec(k).transpose(-1, -2)) / hd ** 0.5
            table = sd[f"{base}.attention.self.relative_position_bias_table"]
            bias = table[_rel_index(win, x.device).reshape(-1)]
            a = a + bias.reshape(win * win, win * win, heads).permute(2, 0, 1)[None]
            if shift:
                mask = _region_mask(h, w, win, shift, x.device)
                a = (a.reshape(n, mask.shape[0], heads, win * win, win * win)
                     + mask[None, :, None]).reshape(-1, heads, win * win, win * win)
            o = prec.out(prec(a.softmax(dim=-1)) @ prec(val)).transpose(1, 2).reshape(
                -1, win * win, c)
            o = _lin(sd, f"{base}.attention.output.dense", o, prec)
            o = o.reshape(n, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
            o = o.reshape(n, h, w, c)
            if shift:
                o = torch.roll(o, (shift, shift), dims=(1, 2))
            x = x + o.reshape(n, h * w, c)
            m = _ln(sd, f"{base}.layernorm_after", x, eps)
            m = F.gelu(_lin(sd, f"{base}.intermediate.dense", m, prec), approximate="none")
            x = x + _lin(sd, f"{base}.output.dense", m, prec)
        if si < len(v["depths"]) - 1:
            ds = f"{p}encoder.layers.{si}.downsample"
            g = x.reshape(n, h, w, c)
            g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], dim=-1)
            h, w = h // 2, w // 2
            g = _ln(sd, f"{ds}.norm", g.reshape(n, h * w, 4 * c), eps)
            x = _lin(sd, f"{ds}.reduction", g, prec, bias=False)
            c *= 2
    pooled = _ln(sd, f"{p}layernorm", x, eps).mean(dim=1)
    e = _lin(sd, "vision_model.projection_head", pooled, prec, bias=False)
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def encode_text(sd: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                mask: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """Token ids and mask (B, S) -> L2-normalised (B, projection_dim)."""
    t = cfg["text"]
    eps, hsz, heads = t["layer_norm_eps"], t["hidden_size"], t["num_heads"]
    p = TEXT
    b, s = ids.shape
    x = (sd[f"{p}embeddings.word_embeddings.weight"][ids]
         + sd[f"{p}embeddings.position_embeddings.weight"][:s][None]
         + sd[f"{p}embeddings.token_type_embeddings.weight"][0][None, None])
    x = _ln(sd, f"{p}embeddings.LayerNorm", x, eps)
    pad = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    hd = hsz // heads
    hidden = [x]
    for i in range(t["num_layers"]):
        base = f"{p}encoder.layer.{i}"

        def heads_of(name):
            return _lin(sd, f"{base}.attention.self.{name}", x, prec).reshape(
                b, s, heads, hd).transpose(1, 2)

        q, k, v = heads_of("query"), heads_of("key"), heads_of("value")
        a = prec.out(prec(q) @ prec(k).transpose(-1, -2)) / hd ** 0.5 + pad
        ctx = prec.out(prec(a.softmax(dim=-1)) @ prec(v)).transpose(1, 2).reshape(b, s, hsz)
        x = _ln(sd, f"{base}.attention.output.LayerNorm",
                x + _lin(sd, f"{base}.attention.output.dense", ctx, prec), eps)
        f = F.gelu(_lin(sd, f"{base}.intermediate.dense", x, prec), approximate="none")
        x = _ln(sd, f"{base}.output.LayerNorm",
                x + _lin(sd, f"{base}.output.dense", f, prec), eps)
        hidden.append(x)
    mix = (hidden[1] + hidden[2] + hidden[-1]) / 3.0
    m = mask[..., None].float()
    pooled = (mix * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    e = _lin(sd, "text_model.projection_head", pooled, prec)
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def semantic_loss(sd, cfg: dict, sr: torch.Tensor, hr: torch.Tensor,
                  ids: torch.Tensor, mask: torch.Tensor, ys, xs,
                  prec: Precision = F32) -> torch.Tensor:
    """The M2Trans semantic loss as the paper states it (every patch
    averaged, gradients to ``sr``): for each image, patches = its bicubic
    resize to the CLIP size (align_corners=True) and the crops at
    ``(ys[i, b], xs[i, b])``; the loss is the sum over the batch and the
    patches of |sim(sr patch, caption) - sim(hr patch, caption)| divided by
    the number of patches. ``sr`` / ``hr`` (B, H, W, 3) f32."""
    size = cfg["clip_size"]
    n_crops = len(ys)
    t = encode_text(sd, cfg, ids, mask, prec)

    def sims(img):
        x = img.permute(0, 3, 1, 2)
        patches = [F.interpolate(x, (size, size), mode="bicubic", align_corners=True)]
        for i in range(n_crops):
            patches.append(torch.stack([x[b, :, int(ys[i][b]):int(ys[i][b]) + size,
                                          int(xs[i][b]):int(xs[i][b]) + size]
                                        for b in range(x.shape[0])]))
        emb = encode_image(sd, cfg, torch.cat(patches).permute(0, 2, 3, 1), prec)
        return (emb.reshape(n_crops + 1, x.shape[0], -1) * t[None]).sum(-1)

    return (sims(sr) - sims(hr)).abs().sum() / (n_crops + 1)
