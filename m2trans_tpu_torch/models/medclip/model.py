"""MedCLIP dual encoder: Swin-tiny vision + Bio_ClinicalBERT text; port of
m2trans_tpu/models/medclip/model.py.

Rebuild of the ``medclip`` package's ``MedCLIPModel(vision_cls=
MedCLIPVisionModelViT)`` that the reference's SemanticLoss instantiates
(reference losses.py:14-15,22-25). Heads per medclip v0.0.3:

  * vision: SwinModel pooler_output -> Linear(768, 512) projection;
  * text: BertModel with every hidden state; hidden states of layers
    [1, 2, last] averaged over the three layers and over tokens
    (mask-weighted by default, see MedCLIPConfig.masked_token_mean), then
    Linear(768, 512);
  * ``encode_image`` / ``encode_text`` L2-normalise their outputs.

Every parameter has ``requires_grad=False``: the semantic loss
differentiates through the encoders to its input, never into them, and no
optimizer sees them. ``load_medclip_torch`` maps the released
``pytorch_model.bin`` (keys ``vision_model.model.*``,
``vision_model.projection_head.*``, ``text_model.model.*``,
``text_model.projection_head.*``, ``logit_scale``);
``medclip_release_state_dict`` writes a model in that layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from m2trans_tpu_torch.models.medclip import ParamTree, normal_
from m2trans_tpu_torch.models.medclip.bert import (
    BertConfig,
    BertEncoder,
    bert_from_torch,
    bert_to_torch,
    init_bert,
)
from m2trans_tpu_torch.models.medclip.swin import (
    SwinConfig,
    SwinEncoder,
    init_swin,
    swin_from_torch,
    swin_to_torch,
)


@dataclasses.dataclass(frozen=True)
class MedCLIPConfig:
    vision: SwinConfig = SwinConfig()
    text: BertConfig = BertConfig()
    projection_dim: int = 512
    # text pooling: 'mixed' (medclip v0.0.3: mean of hidden[1], hidden[2],
    # hidden[-1], then the token mean), 'last4' (mean of the last 4 hidden
    # layers, then the token mean) or 'cls' (the last layer's [CLS] token)
    text_pooling: str = "mixed"
    # the reference tokenizes each caption unpadded (losses.py:64), so its
    # token mean is over real tokens; the batched tokenizer pads to a fixed
    # length, and the mask-weighted mean (default) keeps the embedding
    # independent of the padding. False mirrors the medclip package on
    # batched padded input (padding included in the mean).
    masked_token_mean: bool = True

    @staticmethod
    def tiny() -> "MedCLIPConfig":
        """Small config for tests / smoke training."""
        return MedCLIPConfig(
            vision=SwinConfig(image_size=56, embed_dim=16, depths=(1, 1),
                              num_heads=(2, 4)),
            text=BertConfig(vocab_size=128, hidden_size=32, num_layers=2,
                            num_heads=2, intermediate_size=64,
                            max_position_embeddings=64),
            projection_dim=16,
        )


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class MedCLIP(nn.Module):
    """Both encoders and their projections, from a param tree in the JAX
    package's layout (``vision``, ``vision_proj``, ``text``, ``text_proj``,
    ``logit_scale``)."""

    def __init__(self, cfg: MedCLIPConfig, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.vision = SwinEncoder(cfg.vision, tree["vision"])
        self.vision_proj = ParamTree(tree["vision_proj"])
        self.text = BertEncoder(cfg.text, tree["text"])
        self.text_proj = ParamTree(tree["text_proj"])
        self.logit_scale = nn.Parameter(torch.tensor(float(tree["logit_scale"])),
                                        requires_grad=False)

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> L2-normalised (B, projection_dim). As the
        reference, callers feed raw [0, 1] patches (losses.py:53-69: the
        MedCLIPProcessor's normalisation is bypassed)."""
        _, pooled = self.vision(pixel_values)
        p = self.vision_proj
        return _normalize(pooled @ p["w"] + p["b"])

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                    ) -> torch.Tensor:
        """Token ids + mask (B, S) -> L2-normalised (B, projection_dim)."""
        cfg = self.cfg
        _, hidden = self.text(input_ids, attention_mask)

        def token_mean(mix):
            if not cfg.masked_token_mean:
                return mix.mean(dim=1)  # padding included (medclip package)
            m = attention_mask[..., None].to(mix.dtype)
            return (mix * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)

        if cfg.text_pooling == "mixed":
            pooled = token_mean((hidden[1] + hidden[2] + hidden[-1]) / 3.0)
        elif cfg.text_pooling == "last4":
            k = min(4, len(hidden) - 1)
            pooled = token_mean(sum(hidden[-i] for i in range(1, k + 1)) / k)
        elif cfg.text_pooling == "cls":
            pooled = hidden[-1][:, 0]
        else:
            raise ValueError(f"unknown text_pooling {cfg.text_pooling}")
        p = self.text_proj
        return _normalize(pooled @ p["w"] + p["b"])


def init_medclip(cfg: MedCLIPConfig, seed: int = 0,
                 device: Optional[torch.device] = None) -> MedCLIP:
    """MedCLIP with random weights drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    vision, text = init_swin(gen, cfg.vision), init_bert(gen, cfg.text)
    vdim, tdim, pdim = cfg.vision.hidden_size, cfg.text.hidden_size, cfg.projection_dim
    tree = {
        "vision": vision,
        "vision_proj": {"w": normal_(gen, (vdim, pdim)), "b": torch.zeros(pdim)},
        "text": text,
        "text_proj": {"w": normal_(gen, (tdim, pdim)), "b": torch.zeros(pdim)},
        "logit_scale": torch.tensor(math.log(1 / 0.07)),
    }
    return MedCLIP(cfg, tree).to(device or "cpu")


def load_medclip_torch(path_or_sd, cfg: Optional[MedCLIPConfig] = None,
                       device: Optional[torch.device] = None) -> MedCLIP:
    """The released MedCLIP ``pytorch_model.bin`` (or an in-memory state
    dict of that layout) -> MedCLIP on ``device``. A projection without a
    bias gets a zero one."""
    cfg = cfg or MedCLIPConfig()
    if isinstance(path_or_sd, str):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd

    def proj(name):
        w = torch.as_tensor(sd[f"{name}.weight"]).detach().cpu()
        b = sd.get(f"{name}.bias")
        return {"w": w.t().contiguous(),
                "b": torch.zeros(w.shape[0]) if b is None else torch.as_tensor(b).cpu()}

    tree = {
        "vision": swin_from_torch(sd, cfg.vision, prefix="vision_model.model."),
        "vision_proj": proj("vision_model.projection_head"),
        "text": bert_from_torch(sd, cfg.text, prefix="text_model.model."),
        "text_proj": proj("text_model.projection_head"),
        "logit_scale": sd.get("logit_scale", torch.tensor(math.log(1 / 0.07))),
    }
    return MedCLIP(cfg, tree).to(device or "cpu")


def medclip_release_state_dict(model: MedCLIP) -> Dict[str, torch.Tensor]:
    """``model`` as the released ``pytorch_model.bin`` lays it out, the
    inverse of :func:`load_medclip_torch`: ``vision_model.model.*`` (HF
    ``SwinModel``), ``vision_model.projection_head.weight``,
    ``text_model.model.*`` (HF ``BertModel`` without its pooler),
    ``text_model.projection_head.{weight,bias}`` and ``logit_scale``, CPU
    tensors in the model's dtype. The vision projection has no bias in the
    release: a nonzero one raises."""
    vb = model.vision_proj["b"]
    if bool(vb.any()):
        raise ValueError("the release's vision projection has no bias; this "
                         "model's is nonzero")
    sd = swin_to_torch(model.vision, "vision_model.model.")
    sd.update(bert_to_torch(model.text, "text_model.model."))
    sd["vision_model.projection_head.weight"] = (
        model.vision_proj["w"].detach().t().contiguous().cpu())
    sd["text_model.projection_head.weight"] = (
        model.text_proj["w"].detach().t().contiguous().cpu())
    sd["text_model.projection_head.bias"] = model.text_proj["b"].detach().cpu().clone()
    sd["logit_scale"] = model.logit_scale.detach().cpu().clone()
    return sd
