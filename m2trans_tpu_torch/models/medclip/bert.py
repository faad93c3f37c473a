"""BERT text encoder; port of m2trans_tpu/models/medclip/bert.py.

MedCLIP's text encoder is ``emilyalsentzer/Bio_ClinicalBERT`` (a bert-base
post-LN encoder) via HF ``BertModel``; the MedCLIP text head averages
hidden states over layers and tokens before the projection (model.py).
LayerNorms, attention logits and the softmax run in f32, the rest in the
parameters' dtype, as in the JAX encoder.

Param layout: the JAX package's tree (:class:`ParamTree`); Linear weights
(in, out). ``bert_from_torch`` reads the HF / released key layout,
``bert_to_torch`` writes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from m2trans_tpu_torch.models.medclip import ParamTree, layer_norm, normal_


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class BertEncoder(ParamTree):
    """The BERT encoder's parameters and its forward:
    (input_ids, attention_mask[, token_type_ids]) of shape (B, S) ->
    (last hidden state, the num_layers + 1 hidden states)."""

    def __init__(self, cfg: BertConfig, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        cfg = self.cfg
        eps = cfg.layer_norm_eps
        bsz, seq = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = self["embeddings"]
        emb = (e["word"][input_ids] + e["position"][:seq][None]
               + e["token_type"][token_type_ids])
        x = layer_norm(emb, e["ln"], eps)

        ext_mask = (1.0 - attention_mask.float()) * -10000.0
        ext_mask = ext_mask[:, None, None, :]  # (B, 1, 1, S)

        hd = cfg.hidden_size // cfg.num_heads
        hidden_states = [x]
        for layer in self["layers"]:
            a = layer["attn"]

            def split(t):
                return t.reshape(bsz, seq, cfg.num_heads, hd).transpose(1, 2)

            q = split(x @ a["q_w"] + a["q_b"]) * (hd ** -0.5)
            k = split(x @ a["k_w"] + a["k_b"])
            v = split(x @ a["v_w"] + a["v_b"])
            scores = q.float() @ k.float().transpose(-1, -2) + ext_mask
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            ctx = (probs @ v).transpose(1, 2).reshape(bsz, seq, cfg.hidden_size)
            x = layer_norm(x + (ctx @ a["o_w"] + a["o_b"]), a["ln"], eps)

            f = layer["ffn"]
            h = nn.functional.gelu(x @ f["fc1_w"] + f["fc1_b"], approximate="none")
            x = layer_norm(x + (h @ f["fc2_w"] + f["fc2_b"]), f["ln"], eps)
            hidden_states.append(x)
        return x, hidden_states


def init_bert(gen: torch.Generator, cfg: BertConfig) -> Dict[str, Any]:
    """Random param tree (N(0, 0.02) weights and tables, zero biases, unit
    norms) drawn from ``gen``."""
    h = cfg.hidden_size

    def ones(n):
        return {"g": torch.ones(n), "b": torch.zeros(n)}

    tree: Dict[str, Any] = {
        "embeddings": {
            "word": normal_(gen, (cfg.vocab_size, h)),
            "position": normal_(gen, (cfg.max_position_embeddings, h)),
            "token_type": normal_(gen, (cfg.type_vocab_size, h)),
            "ln": ones(h),
        },
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        attn: Dict[str, Any] = {}
        for name in ("q", "k", "v", "o"):
            attn[f"{name}_w"] = normal_(gen, (h, h))
            attn[f"{name}_b"] = torch.zeros(h)
        attn["ln"] = ones(h)
        tree["layers"].append({
            "attn": attn,
            "ffn": {"fc1_w": normal_(gen, (h, cfg.intermediate_size)),
                    "fc1_b": torch.zeros(cfg.intermediate_size),
                    "fc2_w": normal_(gen, (cfg.intermediate_size, h)),
                    "fc2_b": torch.zeros(h), "ln": ones(h)},
        })
    return tree


def bert_from_torch(sd: Dict[str, Any], cfg: BertConfig,
                    prefix: str = "") -> Dict[str, Any]:
    """An HF ``BertModel`` state dict (optionally nested under ``prefix``,
    e.g. 'text_model.model.') -> the param tree."""

    def t(name):
        return torch.as_tensor(sd[prefix + name]).detach().cpu()

    def lin(name):
        return {"w": t(f"{name}.weight").t().contiguous(), "b": t(f"{name}.bias")}

    tree: Dict[str, Any] = {
        "embeddings": {
            "word": t("embeddings.word_embeddings.weight"),
            "position": t("embeddings.position_embeddings.weight"),
            "token_type": t("embeddings.token_type_embeddings.weight"),
            "ln": {"g": t("embeddings.LayerNorm.weight"),
                   "b": t("embeddings.LayerNorm.bias")},
        },
        "layers": [],
    }
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}"
        attn: Dict[str, Any] = {}
        for ours, theirs in (("q", "attention.self.query"),
                             ("k", "attention.self.key"),
                             ("v", "attention.self.value"),
                             ("o", "attention.output.dense")):
            lin_ = lin(f"{base}.{theirs}")
            attn[f"{ours}_w"] = lin_["w"]
            attn[f"{ours}_b"] = lin_["b"]
        attn["ln"] = {"g": t(f"{base}.attention.output.LayerNorm.weight"),
                      "b": t(f"{base}.attention.output.LayerNorm.bias")}
        fc1 = lin(f"{base}.intermediate.dense")
        fc2 = lin(f"{base}.output.dense")
        tree["layers"].append({
            "attn": attn,
            "ffn": {"fc1_w": fc1["w"], "fc1_b": fc1["b"],
                    "fc2_w": fc2["w"], "fc2_b": fc2["b"],
                    "ln": {"g": t(f"{base}.output.LayerNorm.weight"),
                           "b": t(f"{base}.output.LayerNorm.bias")}},
        })
    return tree


def bert_to_torch(enc: BertEncoder, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`bert_from_torch`: an HF ``BertModel`` state
    dict without the pooler (``add_pooling_layer=False``), keys under
    ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, t):
        sd[prefix + name] = t.detach().cpu().contiguous()

    def lin(name, w, b):
        put(f"{name}.weight", w.t())
        put(f"{name}.bias", b)

    def norm(name, p):
        put(f"{name}.weight", p["g"])
        put(f"{name}.bias", p["b"])

    e = enc["embeddings"]
    put("embeddings.word_embeddings.weight", e["word"])
    put("embeddings.position_embeddings.weight", e["position"])
    put("embeddings.token_type_embeddings.weight", e["token_type"])
    norm("embeddings.LayerNorm", e["ln"])
    for i, layer in enumerate(enc["layers"]):
        base = f"encoder.layer.{i}"
        a, f = layer["attn"], layer["ffn"]
        for ours, theirs in (("q", "attention.self.query"),
                             ("k", "attention.self.key"),
                             ("v", "attention.self.value"),
                             ("o", "attention.output.dense")):
            lin(f"{base}.{theirs}", a[f"{ours}_w"], a[f"{ours}_b"])
        norm(f"{base}.attention.output.LayerNorm", a["ln"])
        lin(f"{base}.intermediate.dense", f["fc1_w"], f["fc1_b"])
        lin(f"{base}.output.dense", f["fc2_w"], f["fc2_b"])
        norm(f"{base}.output.LayerNorm", f["ln"])
    return sd
