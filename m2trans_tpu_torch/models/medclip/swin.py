"""Swin Transformer vision encoder (NHWC); port of
m2trans_tpu/models/medclip/swin.py.

MedCLIP's vision encoder is HF ``SwinModel``
('microsoft/swin-tiny-patch4-window7-224'): a 4x4/4 patch embedding +
LayerNorm, 4 stages of [W-MSA | SW-MSA] blocks with relative position bias
and PatchMerging, a final LayerNorm and a mean-pool pooler. The patch
embedding is a product over 4x4 patches (the conv has stride = kernel), so
no convolution algorithm and no TF32 enters it. LayerNorms, attention
logits and the softmax run in f32; everything else in the parameters'
dtype (bf16 under ``medclip_dtype: bfloat16``), as in the JAX encoder.

Param layout: the JAX package's tree (:class:`ParamTree`); Linear weights
(in, out), the patch embedding HWIO. ``swin_from_torch`` reads the HF /
released key layout, ``swin_to_torch`` writes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from m2trans_tpu_torch.models.medclip import ParamTree, layer_norm, normal_
from m2trans_tpu_torch.ops.kernels.swin_attn import (
    relative_position_index as _relative_position_index,
    shift_attn_mask as _shift_attn_mask,  # noqa: F401 (SW-MSA's mask, by its old name)
    window_attention,
)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5

    @property
    def hidden_size(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def _attention(p, x, heads, window, shift, h, w):
    """Windowed (optionally shifted) MHA over the (B, H, W, C) map x of
    h x w: the q, k, v projections on the image layout, the attention core
    (roll, windows, bias, mask, softmax, P V and back; one kernel each way
    on the card, ``ops/kernels/swin_attn.py``), the o-projection."""
    q, k, v = (x @ p[f"{name}_w"] + p[f"{name}_b"] for name in ("q", "k", "v"))
    out = window_attention(q, k, v, p["rpb_table"], heads, window, shift)
    return out @ p["o_w"] + p["o_b"]


def _mlp(p, x):
    h = nn.functional.gelu(x @ p["fc1_w"] + p["fc1_b"], approximate="none")
    return h @ p["fc2_w"] + p["fc2_b"]


def _patch_merge(p, x, eps):
    """2x2 neighbour concat -> LayerNorm -> Linear(4C->2C, no bias). The
    concat order is HF's: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2),
    (1::2, 1::2) in (row, column)."""
    a = x[:, 0::2, 0::2, :]
    b = x[:, 1::2, 0::2, :]
    c = x[:, 0::2, 1::2, :]
    d = x[:, 1::2, 1::2, :]
    y = layer_norm(torch.cat([a, b, c, d], dim=-1), p["norm"], eps)
    return y @ p["reduction_w"]


class SwinEncoder(ParamTree):
    """The Swin encoder's parameters and its forward: (B, H, W, 3) NHWC ->
    (sequence output (B, tokens, C), pooled (B, C)), the pooled output the
    token mean of the layernormed final features (HF SwinModel pooler)."""

    def __init__(self, cfg: SwinConfig, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        eps = cfg.layer_norm_eps
        b, h, w, c = pixel_values.shape
        ps = cfg.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image {h}x{w} is no multiple of the patch {ps}")
        patches = pixel_values.reshape(b, h // ps, ps, w // ps, ps, c)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, h // ps, w // ps, ps * ps * c)
        pe = self["patch_embed"]
        x = patches @ pe["w"].reshape(ps * ps * c, -1) + pe["b"]
        x = layer_norm(x, self["embed_norm"], eps)

        for si, stage in enumerate(self["stages"]):
            heads = cfg.num_heads[si]
            h, w = x.shape[1], x.shape[2]
            for di, blk in enumerate(stage["blocks"]):
                shift = 0 if di % 2 == 0 else cfg.window_size // 2
                if min(h, w) <= cfg.window_size:
                    shift = 0  # HF behaviour when the window covers the map
                y = layer_norm(x, blk["ln1"], eps)
                x = x + _attention(blk["attn"], y, heads, cfg.window_size, shift, h, w)
                y = layer_norm(x, blk["ln2"], eps)
                x = x + _mlp(blk["mlp"], y)
            if "downsample" in stage:
                x = _patch_merge(stage["downsample"], x, eps)

        x = layer_norm(x, self["final_norm"], eps)
        seq = x.reshape(x.shape[0], -1, x.shape[-1])
        return seq, seq.mean(dim=1)


# ---------------------------------------------------------------------------
# init + torch conversion
# ---------------------------------------------------------------------------


def init_swin(gen: torch.Generator, cfg: SwinConfig) -> Dict[str, Any]:
    """Random param tree (N(0, 0.02) weights, zero biases, unit norms) drawn
    from ``gen``; real use loads converted weights."""
    e = cfg.embed_dim

    def ones(n):
        return {"g": torch.ones(n), "b": torch.zeros(n)}

    tree: Dict[str, Any] = {
        "patch_embed": {
            "w": normal_(gen, (cfg.patch_size, cfg.patch_size, cfg.num_channels, e)),
            "b": torch.zeros(e),
        },
        "embed_norm": ones(e),
    }
    stages: List[Dict[str, Any]] = []
    dim = e
    nw = 2 * cfg.window_size - 1
    for si, depth in enumerate(cfg.depths):
        blocks = []
        for _ in range(depth):
            attn = {}
            for name in ("q", "k", "v", "o"):
                attn[f"{name}_w"] = normal_(gen, (dim, dim))
                attn[f"{name}_b"] = torch.zeros(dim)
            attn["rpb_table"] = normal_(gen, (nw * nw, cfg.num_heads[si]))
            hidden = int(dim * cfg.mlp_ratio)
            blocks.append({
                "ln1": ones(dim), "attn": attn, "ln2": ones(dim),
                "mlp": {"fc1_w": normal_(gen, (dim, hidden)), "fc1_b": torch.zeros(hidden),
                        "fc2_w": normal_(gen, (hidden, dim)), "fc2_b": torch.zeros(dim)},
            })
        stage: Dict[str, Any] = {"blocks": blocks, "downsample": None}
        if si < len(cfg.depths) - 1:
            stage["downsample"] = {"norm": ones(4 * dim),
                                   "reduction_w": normal_(gen, (4 * dim, 2 * dim))}
            dim *= 2
        stages.append(stage)
    tree["stages"] = stages
    tree["final_norm"] = ones(dim)
    return tree


def swin_from_torch(sd: Dict[str, Any], cfg: SwinConfig,
                    prefix: str = "") -> Dict[str, Any]:
    """An HF ``SwinModel`` state dict (optionally nested under ``prefix``,
    e.g. 'vision_model.model.') -> the param tree."""

    def t(name):
        return torch.as_tensor(sd[prefix + name]).detach().cpu()

    def lin(name):
        return {"w": t(f"{name}.weight").t().contiguous(), "b": t(f"{name}.bias")}

    tree: Dict[str, Any] = {
        "patch_embed": {
            "w": t("embeddings.patch_embeddings.projection.weight")
            .permute(2, 3, 1, 0).contiguous(),
            "b": t("embeddings.patch_embeddings.projection.bias"),
        },
        "embed_norm": {"g": t("embeddings.norm.weight"),
                       "b": t("embeddings.norm.bias")},
    }
    stages: List[Dict[str, Any]] = []
    for si, depth in enumerate(cfg.depths):
        blocks = []
        for di in range(depth):
            base = f"encoder.layers.{si}.blocks.{di}"
            attn: Dict[str, Any] = {}
            for ours, theirs in (("q", "attention.self.query"),
                                 ("k", "attention.self.key"),
                                 ("v", "attention.self.value"),
                                 ("o", "attention.output.dense")):
                lin_ = lin(f"{base}.{theirs}")
                attn[f"{ours}_w"] = lin_["w"]
                attn[f"{ours}_b"] = lin_["b"]
            attn["rpb_table"] = t(
                f"{base}.attention.self.relative_position_bias_table")
            fc1 = lin(f"{base}.intermediate.dense")
            fc2 = lin(f"{base}.output.dense")
            blocks.append({
                "ln1": {"g": t(f"{base}.layernorm_before.weight"),
                        "b": t(f"{base}.layernorm_before.bias")},
                "attn": attn,
                "ln2": {"g": t(f"{base}.layernorm_after.weight"),
                        "b": t(f"{base}.layernorm_after.bias")},
                "mlp": {"fc1_w": fc1["w"], "fc1_b": fc1["b"],
                        "fc2_w": fc2["w"], "fc2_b": fc2["b"]},
            })
        stage: Dict[str, Any] = {"blocks": blocks, "downsample": None}
        ds = f"encoder.layers.{si}.downsample"
        if prefix + ds + ".reduction.weight" in sd:
            stage["downsample"] = {
                "norm": {"g": t(f"{ds}.norm.weight"), "b": t(f"{ds}.norm.bias")},
                "reduction_w": t(f"{ds}.reduction.weight").t().contiguous(),
            }
        stages.append(stage)
    tree["stages"] = stages
    tree["final_norm"] = {"g": t("layernorm.weight"), "b": t("layernorm.bias")}
    return tree


def swin_to_torch(enc: SwinEncoder, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`swin_from_torch`: an HF ``SwinModel`` state
    dict (its ``relative_position_index`` buffers included), keys under
    ``prefix``."""
    cfg = enc.cfg
    sd: Dict[str, torch.Tensor] = {}

    def put(name, t):
        sd[prefix + name] = t.detach().cpu().contiguous()

    def lin(name, w, b):
        put(f"{name}.weight", w.t())
        put(f"{name}.bias", b)

    def norm(name, p):
        put(f"{name}.weight", p["g"])
        put(f"{name}.bias", p["b"])

    put("embeddings.patch_embeddings.projection.weight",
        enc["patch_embed"]["w"].permute(3, 2, 0, 1))
    put("embeddings.patch_embeddings.projection.bias", enc["patch_embed"]["b"])
    norm("embeddings.norm", enc["embed_norm"])
    rpi = torch.from_numpy(_relative_position_index(cfg.window_size))
    for si, stage in enumerate(enc["stages"]):
        for di, blk in enumerate(stage["blocks"]):
            base = f"encoder.layers.{si}.blocks.{di}"
            a, m = blk["attn"], blk["mlp"]
            norm(f"{base}.layernorm_before", blk["ln1"])
            put(f"{base}.attention.self.relative_position_bias_table", a["rpb_table"])
            put(f"{base}.attention.self.relative_position_index", rpi)
            for ours, theirs in (("q", "attention.self.query"),
                                 ("k", "attention.self.key"),
                                 ("v", "attention.self.value"),
                                 ("o", "attention.output.dense")):
                lin(f"{base}.{theirs}", a[f"{ours}_w"], a[f"{ours}_b"])
            norm(f"{base}.layernorm_after", blk["ln2"])
            lin(f"{base}.intermediate.dense", m["fc1_w"], m["fc1_b"])
            lin(f"{base}.output.dense", m["fc2_w"], m["fc2_b"])
        if "downsample" in stage:
            ds = f"encoder.layers.{si}.downsample"
            put(f"{ds}.reduction.weight", stage["downsample"]["reduction_w"].t())
            norm(f"{ds}.norm", stage["downsample"]["norm"])
    norm("layernorm", enc["final_norm"])
    return sd
