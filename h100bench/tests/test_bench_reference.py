"""The plain reference against ``m2trans_tpu_torch``'s plain f32 path on
the CPU at a tiny size (n_feats 16, one block): the forward at x4 and x2,
MedCLIP's two encoders and the semantic loss, and the first train steps
with Adam. The port is only read here, to hold the reference to it."""

import json
import os

import numpy as np
import pytest
import torch

from h100bench.core import weights
from h100bench.reference import compare
from h100bench.reference import m2trans as ref
from h100bench.reference import medclip as ref_clip
from h100bench.reference.train_step import train_steps

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 2 ** 33 + 7


def _config(name):
    with open(os.path.join(DATA, f"{name}.json"), encoding="utf-8") as fh:
        return json.load(fh)


def _port_model(model, sd):
    from m2trans_tpu_torch.config import Config
    from m2trans_tpu_torch.models.m2trans import M2Trans
    from m2trans_tpu_torch.train.convert import load_reference_state_dict

    cfg = Config(**model)
    with torch.device("meta"):
        net = M2Trans(cfg)
    return cfg, load_reference_state_dict(net.to_empty(device="cpu"), sd)


@pytest.mark.parametrize("name", ["tiny-x4", "tiny-x2"])
def test_forward_matches_the_port(name):
    from m2trans_tpu_torch.models.m2trans import ComputePolicy, m2trans_apply

    model = _config(name)["model"]
    sd = weights.m2trans_state_dict(model, SEED, "cpu")
    cfg, net = _port_model(model, sd)
    x = torch.rand(2, 40, 36, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = m2trans_apply(net, x, cfg, ComputePolicy())
        got = ref.forward(sd, x, model)
    assert got.shape == want.shape == (2, 40 * model["scale"], 36 * model["scale"], 3)
    assert (got - want).abs().max() < 2e-6


def _port_clip(mc, sd):
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, load_medclip_torch

    return load_medclip_torch(sd, MedCLIPConfig.tiny())


def test_medclip_matches_the_port():
    from m2trans_tpu_torch.losses.semantic import semantic_loss

    mc = _config("tiny-x2")["medclip"]
    sd = weights.medclip_state_dict(mc, 5, "cpu")
    port = _port_clip(mc, sd)
    gen = torch.Generator().manual_seed(2)
    px = torch.rand(3, 56, 56, 3, generator=gen)
    ids = torch.randint(5, 128, (2, 20), generator=gen)
    mask = torch.ones(2, 20, dtype=torch.long)
    mask[1, 12:] = 0
    sr, hr = torch.rand(2, 80, 72, 3, generator=gen), torch.rand(2, 80, 72, 3, generator=gen)
    ys, xs = np.array([[3, 10], [20, 1]]), np.array([[0, 15], [5, 2]])
    with torch.no_grad():
        assert (port.encode_image(px) - ref_clip.encode_image(sd, mc, px)).abs().max() < 1e-6
        assert (port.encode_text(ids, mask) - ref_clip.encode_text(sd, mc, ids, mask)
                ).abs().max() < 1e-6
        want = semantic_loss(port, sr, hr, ids, mask, offsets=(ys, xs), n_patches=3,
                             clip_size=56)
        got = ref_clip.semantic_loss(sd, mc, sr, hr, ids, mask, ys, xs)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("lambda_clip", [0.0, 0.01])
def test_train_steps_match_the_port(lambda_clip):
    from m2trans_tpu_torch.losses.semantic import SemanticLossFn
    from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig
    from m2trans_tpu_torch.models.m2trans import m2trans_apply
    from m2trans_tpu_torch.train.loop import make_optimizer, make_train_step

    conf = _config("tiny-x2")
    model, mc = conf["model"], conf["medclip"]
    sd = weights.m2trans_state_dict(model, SEED, "cpu")
    cfg, net = _port_model(model, sd)
    cfg = cfg.replace(lambda_clip=lambda_clip, lr=1e-3)
    csd = weights.medclip_state_dict(mc, 5, "cpu")
    fn = SemanticLossFn(_port_clip(mc, csd), MedCLIPConfig.tiny(), None, n_patches=3,
                        clip_size=56) if lambda_clip else None
    step = make_train_step(cfg, net, make_optimizer(cfg, net), fn, graphs=False)
    rng = np.random.default_rng(4)
    batches = [(rng.random((2, 32, 32, 3), np.float32), rng.random((2, 64, 64, 3), np.float32))
               for _ in range(3)]
    ids = rng.integers(5, 128, (2, 12))
    caps = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    draws = np.random.default_rng(9)
    losses = [float(step(torch.from_numpy(a), torch.from_numpy(b), captions=caps,
                         rng=draws)["loss"]) for a, b in batches]
    draws = np.random.default_rng(9)
    offsets = [tuple(draws.integers(0, 64 - 56, (2, 2)) for _ in range(2)) for _ in batches]
    clip = {"sd": csd, "cfg": mc, "offsets": offsets,
            "tokens": [(torch.as_tensor(ids), torch.ones(2, 12, dtype=torch.long))] * 3}
    got = train_steps(sd, model, batches, lr=1e-3, lambda_clip=lambda_clip, clip=clip)
    assert got["losses"] == pytest.approx(losses, rel=1e-4)
    params = dict(net.named_parameters())
    change = {k: params[k].detach() - sd[k] for k in got["change"]}
    with torch.no_grad():
        sr = m2trans_apply(net, torch.from_numpy(batches[0][0]), cfg)
    gaps = compare.train_numbers({"losses": losses, "grad": got["grad"], "change": change,
                                  "sr": sr}, got)
    assert gaps["change_gap"] < 1e-3
    assert gaps["sr_gap"] < 1e-5
