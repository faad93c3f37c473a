"""Seeded weights in the layouts the releases use, made on the device in a
few large draws from one ``torch.Generator``.

- :func:`m2trans_state_dict`: the M2Trans reference ``state_dict`` (the
  ``.pt`` layout eezkni/M2Trans writes), PyTorch's default init
  distributions: convolutions U(+-1/sqrt(fan in)), qkv N(0, sqrt(2/(3C))),
  ``rel_h`` / ``rel_w`` N(0, 1), the MeanShift convs fixed.
- :func:`medclip_state_dict`: MedCLIP's released ``pytorch_model.bin``
  layout (HF ``SwinModel`` under ``vision_model.model.``, HF ``BertModel``
  under ``text_model.model.``, the projection heads, ``logit_scale``),
  N(0, 0.02) weights and tables, zero biases, unit LayerNorms; the
  released weights are not in the repository.

The same seed gives the same tensors on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.reference import m2trans as ref_m2trans
from h100bench.reference import medclip as ref_medclip

MEAN_RGB = (0.4488, 0.4371, 0.4040)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    return gen


def _carve(flat: torch.Tensor, shapes: List[Tuple[str, Tuple[int, ...]]]):
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


@torch.no_grad()
def m2trans_state_dict(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The reference state dict of the configuration's ``model`` sizes, f32
    on ``device``, from ``seed``: one uniform and one normal draw."""
    gen = _generator(seed, device)
    specs = list(ref_m2trans.param_shapes(model))
    uni = [(n, s) for n, s, k in specs if k == "conv"]
    nrm = [(n, s) for n, s, k in specs if k in ("qkv", "rel")]
    u = torch.rand(sum(math.prod(s) for _, s in uni), generator=gen, device=device)
    g = torch.randn(sum(math.prod(s) for _, s in nrm), generator=gen, device=device)
    sd = {}
    weights = dict(_carve(u, uni))
    for name, shape in uni:
        base = name.rsplit(".", 1)[0]
        wshape = dict(uni)[f"{base}.weight"]
        bound = 1.0 / math.sqrt(wshape[1] * wshape[2] * wshape[3])
        sd[name] = weights[name].mul(2 * bound).sub_(bound)
    normals = _carve(g, nrm)
    for name, shape, kind in specs:
        if kind == "qkv":
            sd[name] = normals[name].mul(math.sqrt(2.0 / (3 * shape[1])))
        elif kind == "rel":
            sd[name] = normals[name]
    mean = torch.tensor(MEAN_RGB, device=device)
    eye = torch.eye(3, device=device).reshape(3, 3, 1, 1)
    rgb = float(model["rgb_range"])
    sd["sub_mean.weight"], sd["sub_mean.bias"] = eye.clone(), -rgb * mean
    sd["add_mean.weight"], sd["add_mean.bias"] = eye.clone(), rgb * mean
    return {n: sd[n].contiguous() for n, _, _ in specs}


@torch.no_grad()
def medclip_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """MedCLIP's release layout at the sizes of ``cfg`` (see
    :func:`h100bench.reference.medclip.param_shapes`), f32 on ``device``:
    one normal draw for every weight and table."""
    gen = _generator(seed ^ 0x5DEECE66D, device)
    specs = list(ref_medclip.param_shapes(cfg))
    nrm = [(n, s) for n, s, k in specs if k == "normal"]
    g = torch.randn(sum(math.prod(s) for _, s in nrm), generator=gen, device=device)
    normals = _carve(g.mul_(0.02), nrm)
    sd = {}
    for name, shape, kind in specs:
        if kind == "normal":
            sd[name] = normals[name]
        elif kind == "ones":
            sd[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "logit_scale":
            sd[name] = torch.tensor(math.log(1 / 0.07), device=device)
    return sd
