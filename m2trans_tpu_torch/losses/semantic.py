"""MedCLIP semantic (image-text) regularisation loss, batched; port of
m2trans_tpu/losses/semantic.py.

Reference semantics (losses.py:18-81, SemanticLoss): per SR/HR pair, a
patch set = [bicubic resize to 224 (align_corners=True)] + (N_patches - 1)
random aligned 224x224 crops; each patch pair and the caption are encoded
with MedCLIP; loss += |x_clip . t - y_clip . t| / N_patches, summed over
the batch (train.py:202-205 loops over samples and accumulates).

The reference has three load-bearing quirks (SURVEY.md §2.2), reproduced
only under ``faithful=True``:
  1. everything under torch.no_grad(): the CLIP term adds a value but no
     gradient (losses.py:63);
  2. the patch loop overwrites x_clip / y_clip, so only the LAST patch
     counts, scaled by 1/N_patches (losses.py:67-79);
  3. encode_text gets token_type_ids (all zeros) instead of input_ids
     (losses.py:64-65): the text embedding is that of a zero token
     sequence, the same for every caption.
The default mode is the paper's intent: differentiable, every patch
averaged, the real token ids.

Staged form (the JAX train step's): d clip / d sr does not flow through
the text encoder or the HR-side vision encoder, so the train step runs the
crop offsets, the text embedding and the HR-side similarities
(:meth:`SemanticLossFn.const_stage_from_params`) outside autograd and only
the SR-side vision encoder (:func:`semantic_loss_staged`) inside it. The
composition equals :func:`semantic_loss`.

Randomness: the crop origins are drawn on the host from a numpy
``Generator`` (:func:`crop_offsets`), so a step makes no device-to-host
copy; every function takes ``offsets=(ys, xs)`` instead, so the same crops
can be fed to the JAX package. The offsets may also be integer tensors on
the images' device, which a captured train step (``train/graphed.py``)
refills before each replay: a crop is not a slice at Python integers but
two products with one-hot selection matrices built on the device
(:func:`_crops_at`), deterministic in both directions.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from m2trans_tpu_torch.models.m2trans import _no_tf32
from m2trans_tpu_torch.models.medclip.model import MedCLIP, MedCLIPConfig
from m2trans_tpu_torch.ops.resize import bicubic_resize

Offsets = Tuple[np.ndarray, np.ndarray]


def crop_offsets(rng: np.random.Generator, bsz: int, h: int, w: int, n: int,
                 size: int) -> Offsets:
    """(n, B) y / x origins of the aligned random crops, uniform over
    [0, h - size) and [0, w - size) — the shared randomness both sides of
    the staged loss must agree on."""
    ys = rng.integers(0, h - size, (n, bsz))
    xs = rng.integers(0, w - size, (n, bsz))
    return ys, xs


def _selection(origins: torch.Tensor, size: int, extent: int, dtype) -> torch.Tensor:
    """(n, B, size, extent) one-hot rows: row r of crop (i, b) selects
    position ``origins[i, b] + r``."""
    dev = origins.device
    want = origins[..., None] + torch.arange(size, device=dev)  # (n, B, size)
    return (want[..., None] == torch.arange(extent, device=dev)).to(dtype)


def _crops_at(x: torch.Tensor, offsets: Offsets, n: int, size: int) -> torch.Tensor:
    """(n*B, size, size, C): the first n crops of every image, crop-major,
    at the given per-image origins (numpy arrays, or integer tensors on x's
    device). Each crop is ``S_y @ x[b] @ S_x^T`` with one-hot selection
    matrices built on the device, so the origins are read by the device,
    not baked in as Python integers, and the backward is two products (a
    gather's would scatter-add overlapping crops with atomics). Every
    output sums one nonzero term, so the values equal slicing's bit for bit
    (TF32 off; x finite, as a clamped SR and an HR image are); so do the
    gradients where at most two crops of an image overlap a pixel (the
    recipe's 3 patches: 2 crops), since two terms add in one order only."""
    ys, xs = ((o if torch.is_tensor(o) else torch.from_numpy(np.array(o, np.int64)))
              .to(x.device)[:n] for o in offsets)
    sel_y = _selection(ys, size, x.shape[1], x.dtype)
    sel_x = _selection(xs, size, x.shape[2], x.dtype)
    with _no_tf32():
        rows = torch.einsum("nbrh,bhwc->nbrwc", sel_y, x)
        crops = torch.einsum("nbsw,nbrwc->nbrsc", sel_x, rows)
    return crops.reshape(n * x.shape[0], size, size, x.shape[3])


def _patches(img: torch.Tensor, offsets: Optional[Offsets], n_patches: int,
             clip_size: int) -> torch.Tensor:
    """[resized] + aligned crops -> (P*B, clip, clip, 3) patch stack."""
    if img.shape[-1] != 3:  # gray -> 3ch repeat (reference losses.py:47-49)
        img = torch.repeat_interleave(img, 3, dim=-1)
    patches = [bicubic_resize(img, (clip_size, clip_size))]
    if n_patches > 1:
        patches.append(_crops_at(img, offsets, n_patches - 1, clip_size))
    return torch.cat(patches, dim=0)


def _n_patches(img: torch.Tensor, n_patches: int, clip_size: int) -> int:
    """The image too small for random crops (the reference would crash on
    torch.randint(dim - 224)): the resized patch only."""
    return 1 if min(img.shape[1], img.shape[2]) <= clip_size else n_patches


def _text(model: MedCLIP, input_ids, attention_mask, faithful, token_type_ids):
    if faithful:  # quirk 3: the "text" is the zero token sequence
        input_ids = (token_type_ids if token_type_ids is not None
                     else torch.zeros_like(input_ids))
    return model.encode_text(input_ids, attention_mask)


def _image_embeddings(model: MedCLIP, stack: torch.Tensor, n: int, bsz: int):
    """Encode a patch stack in the weights' dtype; (n, B, D) in f32."""
    emb = model.encode_image(stack.to(model.vision_proj["w"].dtype))
    return emb.reshape(n, bsz, -1).float()


def semantic_loss(model: MedCLIP, sr: torch.Tensor, hr: torch.Tensor,
                  input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                  offsets: Optional[Offsets] = None,
                  rng: Optional[np.random.Generator] = None, n_patches: int = 3,
                  clip_size: int = 224, faithful: bool = False,
                  token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss in one piece, both images' patches through one vision
    forward; returns the SUM over the batch (the reference's per-sample
    accumulation). The crop origins are ``offsets`` or drawn from ``rng``."""
    bsz = sr.shape[0]
    n_patches = _n_patches(sr, n_patches, clip_size)
    if n_patches > 1 and offsets is None:
        offsets = crop_offsets(rng, bsz, sr.shape[1], sr.shape[2], n_patches - 1,
                               clip_size)
    t = _text(model, input_ids, attention_mask, faithful, token_type_ids).float()
    stack = torch.cat([_patches(sr, offsets, n_patches, clip_size),
                       _patches(hr, offsets, n_patches, clip_size)], dim=0)
    emb = _image_embeddings(model, stack, 2 * n_patches, bsz)
    sim = torch.einsum("pbd,bd->pb", emb, t)
    per_patch = (sim[:n_patches] - sim[n_patches:]).abs()  # (P, B)
    if faithful:
        # quirk 2: only the last patch, scaled 1/N; quirk 1: no gradient
        return (per_patch[-1].sum() / n_patches).detach()
    return per_patch.sum() / n_patches


def clip_text_embed(model: MedCLIP, input_ids, attention_mask, *, faithful=False,
                    token_type_ids=None) -> torch.Tensor:
    """Text-side stage: the caption embedding t (B, D) in f32."""
    return _text(model, input_ids, attention_mask, faithful, token_type_ids).float()


def clip_image_sims(model: MedCLIP, img: torch.Tensor, offsets: Optional[Offsets],
                    t: torch.Tensor, *, n_patches: int = 3, clip_size: int = 224
                    ) -> torch.Tensor:
    """Vision-side stage: per-patch similarities (P, B) in f32."""
    n_patches = _n_patches(img, n_patches, clip_size)
    stack = _patches(img, offsets, n_patches, clip_size)
    emb = _image_embeddings(model, stack, n_patches, img.shape[0])
    return torch.einsum("pbd,bd->pb", emb, t)


def semantic_loss_staged(model: MedCLIP, sr: torch.Tensor, offsets: Optional[Offsets],
                         t: torch.Tensor, sim_y: torch.Tensor, *, n_patches: int = 3,
                         clip_size: int = 224, faithful: bool = False) -> torch.Tensor:
    """Differentiated stage: only the SR-side vision encoder. ``t`` from
    :func:`clip_text_embed`, ``sim_y`` from :func:`clip_image_sims` on hr
    with the same ``offsets``."""
    n_patches = _n_patches(sr, n_patches, clip_size)
    sim_x = clip_image_sims(model, sr, offsets, t, n_patches=n_patches,
                            clip_size=clip_size)
    per_patch = (sim_x - sim_y).abs()  # (P, B)
    if faithful:
        return (per_patch[-1].sum() / n_patches).detach()
    return per_patch.sum() / n_patches


class SemanticLossFn:
    """What the trainer uses: the host-side ``tokenize``, the staged loss
    (``const_stage_from_params`` outside autograd, then
    ``loss_staged_from_params`` on sr) and the loss in one piece
    (``__call__``). With ``dtype`` the encoders run in it (a copy of
    ``model`` cast to it; ``medclip_dtype: bfloat16``)."""

    def __init__(self, model: MedCLIP, mcfg: MedCLIPConfig, tokenizer, *,
                 n_patches: int = 3, clip_size: int = 224, faithful: bool = False,
                 max_length: int = 64, dtype: Optional[torch.dtype] = None):
        if dtype is not None and model.vision_proj["w"].dtype != dtype:
            model = copy.deepcopy(model).to(dtype)
        self.model = model
        self.mcfg = mcfg
        self.tokenizer = tokenizer
        self.n_patches = n_patches
        self.clip_size = clip_size
        self.faithful = faithful
        self.max_length = max_length

    def tokenize(self, captions: List[str]) -> Dict[str, np.ndarray]:
        out = self.tokenizer(captions, return_tensors="np", padding="max_length",
                             truncation=True, max_length=self.max_length)
        return {k: np.asarray(out[k]).astype(np.int32)
                for k in ("input_ids", "attention_mask", "token_type_ids") if k in out}

    def _tokens(self, captions: Dict[str, Any], device):
        """The token arrays (numpy, or tensors already on ``device``) as
        int64 tensors on ``device``."""
        tok = {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
               .to(device).long() for k, v in captions.items()}
        return tok["input_ids"], tok["attention_mask"], tok.get("token_type_ids")

    def draw_offsets(self, rng: np.random.Generator, bsz: int, h: int, w: int
                     ) -> Offsets:
        """The crop origins of a batch of ``bsz`` HR images of h x w: drawn
        from ``rng``, or zeros where the image is too small to crop."""
        n_crops = max(self.n_patches - 1, 0)
        if min(h, w) <= self.clip_size:  # the small-image fallback
            return (np.zeros((n_crops, bsz), np.int64),) * 2
        return crop_offsets(rng, bsz, h, w, n_crops, self.clip_size)

    def const_stage_from_params(self, model: MedCLIP, hr: torch.Tensor,
                                captions: Optional[Dict[str, Any]], *,
                                offsets: Optional[Offsets] = None,
                                rng: Optional[np.random.Generator] = None):
        """What the CLIP loss needs that carries no d/d sr: the crop
        offsets (``offsets``, or drawn from ``rng``), the text embedding and
        the HR-side similarities. The train step runs it under
        ``torch.no_grad()``."""
        if captions is None:
            return None
        if offsets is None:
            offsets = self.draw_offsets(rng or np.random.default_rng(0), *hr.shape[:3])
        ids, mask, tti = self._tokens(captions, hr.device)
        t = clip_text_embed(model, ids, mask, faithful=self.faithful, token_type_ids=tti)
        sim_y = clip_image_sims(model, hr, offsets, t, n_patches=self.n_patches,
                                clip_size=self.clip_size)
        return offsets, t, sim_y

    def loss_staged_from_params(self, model: MedCLIP, sr: torch.Tensor, const
                                ) -> torch.Tensor:
        """Differentiated half of the staged loss."""
        if const is None:
            return torch.zeros((), device=sr.device)
        offsets, t, sim_y = const
        return semantic_loss_staged(model, sr, offsets, t, sim_y,
                                    n_patches=self.n_patches,
                                    clip_size=self.clip_size, faithful=self.faithful)

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor,
                 captions: Optional[Dict[str, Any]], *,
                 offsets: Optional[Offsets] = None,
                 rng: Optional[np.random.Generator] = None) -> torch.Tensor:
        if captions is None:
            return torch.zeros((), device=sr.device)
        ids, mask, tti = self._tokens(captions, sr.device)
        return semantic_loss(self.model, sr, hr, ids, mask, offsets=offsets,
                             rng=rng or np.random.default_rng(0),
                             n_patches=self.n_patches, clip_size=self.clip_size,
                             faithful=self.faithful, token_type_ids=tti)


def make_semantic_loss(cfg, device: Optional[torch.device] = None) -> SemanticLossFn:
    """The loss of a Config: MedCLIP weights and tokenizer from
    ``cfg.medclip_path`` (a directory with ``pytorch_model.bin``,
    ``vocab.txt`` and ``tokenizer_config.json``, the released MedCLIP zip's
    contents). The tokenizer is the port's own
    (``models/medclip/tokenizer.py``), the ids ``AutoTokenizer`` gives."""
    import os

    from m2trans_tpu_torch.models.medclip.model import load_medclip_torch
    from m2trans_tpu_torch.models.medclip.tokenizer import WordPieceTokenizer

    mcfg = MedCLIPConfig.tiny() if cfg.medclip_tiny else MedCLIPConfig()
    tokenizer = WordPieceTokenizer.from_dir(cfg.medclip_path)
    model = load_medclip_torch(os.path.join(cfg.medclip_path, "pytorch_model.bin"),
                               mcfg, device)
    dtype = torch.bfloat16 if cfg.medclip_dtype == "bfloat16" else None
    return SemanticLossFn(model, mcfg, tokenizer, n_patches=3,
                          clip_size=56 if cfg.medclip_tiny else 224,
                          faithful=cfg.faithful_clip, dtype=dtype)
