"""The port's TensorBoard panels, profiler traces and complexity report
against the JAX package's, on the CPU.

Tolerances, with their reasons:

* a comparison panel: within 1 uint8 level in every pixel and equal in at
  least 99.9% of them (the two bilinear resizes agree to 1e-5, which moves
  a value across a level boundary only rarely);
* an eval panel: the same, the SR of the two packages agreeing to f32
  summation order;
* the parameter count: equal; the flop count: equal to a closed form of
  the convolutions and window products (integers in a float64).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models.m2trans import param_count as jax_param_count
from m2trans_tpu.train.evaluate import evaluate_dataset as jax_evaluate_dataset
from m2trans_tpu.train.loop import Trainer as JaxTrainer
from m2trans_tpu.train.loop import _comparison_panel as jax_panel
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    init_m2trans,
    m2trans_apply,
    param_count,
    policy_from_config,
)
from m2trans_tpu_torch.train.evaluate import evaluate_dataset
from m2trans_tpu_torch.train.jax_params import module_from_params
from m2trans_tpu_torch.train.loop import Trainer, _comparison_panel
from m2trans_tpu_torch.utils.flops import model_complexity_report, model_flops
from test_torch_port_train import tree_kw, write_tree


class RecordingWriter:
    """What a ``SummaryWriter`` is given: images and scalars by tag."""

    def __init__(self):
        self.images, self.scalars = [], []

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images.append((tag, step, dataformats, np.array(img)))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step, float(value)))

    def image_keys(self):
        return [(tag, step, fmt, img.shape, img.dtype) for tag, step, fmt, img in self.images]


def close_panels(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


# ---------------------------------------------------------------------------
# panels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rgb_range", [1.0, 255.0])
@pytest.mark.parametrize("lr_hw,scale", [((24, 20), 2), ((16, 12), 3), ((12, 10), 4)])
def test_comparison_panel_matches_jax(lr_hw, scale, rgb_range):
    rng = np.random.default_rng(scale)
    hr_hw = (lr_hw[0] * scale, lr_hw[1] * scale)
    lr = (rng.uniform(0, 1, (*lr_hw, 3)) * rgb_range).astype(np.float32)
    sr = (rng.uniform(-0.1, 1.1, (*hr_hw, 3)) * rgb_range).astype(np.float32)
    hr = (rng.uniform(0, 1, (*hr_hw, 3)) * rgb_range).astype(np.float32)
    got = _comparison_panel(lr, sr, hr, rgb_range)
    assert got.shape == (hr_hw[0], 3 * hr_hw[1], 3)
    close_panels(got, jax_panel(lr, sr, hr, rgb_range))


def test_eval_panels_match_jax():
    """Every 20th frame of a set of 41 gives a ``Valid_<tag>`` panel at step
    ``writer_step + n`` in both packages, the same weights on both sides."""
    kw = dict(scale=2, n_feats=8, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(3), JaxConfig(**kw))
    model = module_from_params(params, Config(**kw))
    rng = np.random.default_rng(0)
    frames = []
    for i in range(41):
        lr = rng.uniform(0, 1, (1, 12, 10, 3)).astype(np.float32)
        frames.append((lr, rng.uniform(0, 1, (1, 24, 20, 3)).astype(np.float32),
                       f"{i}.png"))
    got, want = RecordingWriter(), RecordingWriter()
    evaluate_dataset(model, Config(**kw), frames, writer=got, writer_tag="CCA-US",
                     writer_step=3)
    jax_evaluate_dataset(params, JaxConfig(**kw), frames, writer=want,
                         writer_tag="CCA-US", writer_step=3)
    assert [k[:2] for k in got.image_keys()] == [
        ("Valid_CCA-US/lr_sr_hr_image", s) for s in (3, 23, 43)]
    assert got.image_keys() == want.image_keys()
    for (_, _, _, a), (_, _, _, b) in zip(got.images, want.images):
        close_panels(a, b)


# ---------------------------------------------------------------------------
# the Trainer: panels and scalars, and the step after a panel
# ---------------------------------------------------------------------------


def _train(cfg_cls, trainer_cls, kw, writer, **trainer_kw):
    """A trainer of either package, run; the stdout it tees into its log
    is restored."""
    out = sys.stdout
    try:
        trainer = trainer_cls(cfg_cls(**kw), writer=writer, **trainer_kw)
        trainer.run()
        sys.stdout.log.close()
    finally:
        sys.stdout = out
    return trainer


def test_trainer_writes_jax_tags_at_jax_steps(tmp_path, monkeypatch):
    """Two epochs of 3 steps with validation each epoch: the same image tags,
    steps, layouts, shapes and dtypes, and the same scalar tags and steps,
    as the JAX Trainer's."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the trainers tee stdout
    root = write_tree(tmp_path / "data", np.random.default_rng(2))
    kw = tree_kw(root, tmp_path)
    port, ref = RecordingWriter(), RecordingWriter()
    _train(Config, Trainer, dict(kw, log_path=str(tmp_path / "t")), port, device="cpu")
    _train(JaxConfig, JaxTrainer, dict(kw, log_path=str(tmp_path / "j")), ref)
    keys = port.image_keys()
    assert keys == ref.image_keys()
    assert [k[:3] for k in keys] == [
        ("Train/lr_sr_hr_image", 0, "HWC"), ("Valid_CCA-US/lr_sr_hr_image", 1, "HWC"),
        ("Train/lr_sr_hr_image", 0, "HWC"), ("Valid_CCA-US/lr_sr_hr_image", 2, "HWC")]
    assert keys[0][3] == (32, 96, 3) and keys[1][3] == (40, 120, 3)
    assert [s[:2] for s in port.scalars] == [s[:2] for s in ref.scalars]
    assert {s[0] for s in port.scalars} == {"Train/loss", "Valid_CCA-US/PSNR",
                                            "Valid_CCA-US/SSIM"}


class PanelCheckingWriter(RecordingWriter):
    """Also holds each train panel's middle third against the forward of
    the batch just stepped (its first image) by the model as it stands,
    under the training policy, made when the panel arrives."""

    def __init__(self):
        super().__init__()
        self.trainer, self.batch, self.checked = None, None, 0

    def add_image(self, tag, img, step, dataformats="CHW"):
        super().add_image(tag, img, step, dataformats)
        if tag.startswith("Train/"):
            t = self.trainer
            with torch.no_grad():
                sr = m2trans_apply(t.model, torch.from_numpy(self.batch[0][:1]), t.cfg,
                                   policy_from_config(t.cfg))[0].float().numpy()
            want = np.clip(sr / t.cfg.rgb_range * 255.0, 0, 255).astype(np.uint8)
            w = img.shape[1] // 3
            np.testing.assert_array_equal(img[:, w:2 * w], want)
            self.checked += 1


def test_step_after_a_panel_is_unchanged(tmp_path, monkeypatch):
    """The panel's forward (no_grad, bare module) leaves training alone:
    two bf16 epochs with a writer end at the parameters of two epochs
    without, bit for bit; each panel's SR third is the forward of the
    batch's first image by the model after that batch's step."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    root = write_tree(tmp_path / "data", np.random.default_rng(4))
    kw = dict(tree_kw(root, tmp_path), dtype="bfloat16", use_pallas=True)
    writer = PanelCheckingWriter()
    real_step = Trainer.step

    def step(self, it, batch, do_cutout=False):
        writer.trainer, writer.batch = self, batch
        return real_step(self, it, batch, do_cutout)

    monkeypatch.setattr(Trainer, "step", step)
    with_w = _train(Config, Trainer, dict(kw, log_path=str(tmp_path / "a")), writer,
                    device="cpu")
    without = _train(Config, Trainer, dict(kw, log_path=str(tmp_path / "b")), None,
                     device="cpu")
    for (name, a), (_, b) in zip(with_w.model.named_parameters(),
                                 without.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert writer.checked == 2


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("repeat,steps,written", [(8, 12, True), (5, 7, True),
                                                  (3, 4, False)])
def test_profile_dir_traces_steps_6_to_10(tmp_path, monkeypatch, repeat, steps, written):
    """profile_dir on a one-epoch CPU run: 12 steps trace steps 6-10 into
    ``trace_rank0.json``; 7 steps are traced to the epoch's end (the port
    stops the trace there, JAX leaves it running); 4 steps never start the
    profiler and write nothing."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    root = write_tree(tmp_path / "data", np.random.default_rng(5))
    prof = tmp_path / "prof"
    kw = dict(tree_kw(root, tmp_path), epochs=1, data_repeat=repeat, log_every=100,
              profile_dir=str(prof))
    trainer = _train(Config, Trainer, kw, None, device="cpu")
    assert trainer.steps_per_epoch == steps
    trace = prof / "trace_rank0.json"
    assert trace.exists() == written
    if written:
        assert os.listdir(prof) == ["trace_rank0.json"]
        events = json.loads(trace.read_text())["traceEvents"]
        assert any("conv" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# the complexity report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_param_count_matches_jax(scale):
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(scale=scale))
    model = init_m2trans(Config(scale=scale))
    for trainable in (True, False):
        assert param_count(model, trainable) == jax_param_count(params, trainable)


def closed_form_flops(cfg: Config, h: int, w: int) -> int:
    """2 x multiply-adds of one forward at the padded size: the head and ff
    3x3 convs, each branch's qkv 1x1 conv (C -> 3C) and its two window
    products (a query of an 8x8 block against the 100 keys of its 10x10
    halo window, then against the values), the tail's convs."""
    hp, wp = (-(-h // 32) * 32), (-(-w // 32) * 32)
    px, nf, s = hp * wp, cfg.n_feats, cfg.scale
    total = 2 * px * cfg.colors * nf * 9                          # head
    for levels in (0, 1, 2, 2):
        c, n = nf // 4 * 4 ** levels, px // 4 ** levels
        total += 2 * n * c * 3 * c + 2 * 2 * n * 100 * c       # qkv, q k^T, p v
    total = total + (cfg.n_blocks - 1) * (total - 2 * px * cfg.colors * nf * 9)
    total += cfg.n_blocks * 2 * px * nf * nf * 9                 # ff conv
    if s == 4:
        total += 2 * px * nf * 4 * nf + 2 * 4 * px * nf * 4 * nf + 2 * 16 * px * nf * 3 * 9
    else:
        total += 2 * px * nf * nf * s * s + 2 * s * s * px * nf * 3 * 9
    return total


@pytest.mark.parametrize("scale,h,w", [(2, 40, 24), (3, 32, 32), (4, 24, 56)])
def test_model_flops_closed_form(scale, h, w):
    cfg = Config(scale=scale, n_feats=16, n_blocks=2)
    assert model_flops(init_m2trans(cfg), cfg, h, w) == closed_form_flops(cfg, h, w)


def test_complexity_report_line():
    """The JAX line, with the counter named in XLA's place; the default
    input is 384/scale square."""
    cfg = Config(scale=4, n_feats=16, n_blocks=1)
    model = init_m2trans(cfg)
    flops = closed_form_flops(cfg, 96, 96)
    n = param_count(model, trainable_only=True)
    assert model_complexity_report(model, cfg) == (
        f"## Flops: {flops / 1e9:.2f} GMac-equiv (torch flop_counter, 96x96 input), "
        f"Params: {n / 1e6:.2f} M")
