"""The shipped x2 / x3 configurations' paths against the JAX package at x3
(and x4), on the CPU; the x2 cases live beside the x4 ones in
test_torch_port_train.py, test_torch_port_graphed_aug.py and
test_torch_port_eval.py.

* One train step at x3 (LR 16² and 20², 20 no multiple of the pad's 32)
  and x4 (LR 20²), n_feats 16, one block, the same weights and batch in
  both packages: f32 and bf16 with ``use_pallas`` (the kernels' plain
  versions against the Pallas kernels in interpret mode), with the bounds
  of ``test_f32_train_step_matches_jax`` / ``test_bf16_kernel_step_
  matches_jax_pallas``. The JAX step routes by size: the routes it took
  at these sizes are recorded and asserted (the Pallas branch VJP of
  ``_ROUTES`` and the fused band tail), so a change of route shows here.
* The step with cutmix, cutout and noise at x3 (batch 2 and 4) against
  ``jax.value_and_grad`` on the batch that the JAX package's mask
  composition makes from the same draws (the cutout side
  ``int(0.1 * patch_size // scale)`` of JAX's step): loss rtol 1e-5,
  gradients 1e-4 relative L2, as the x2 test.
* ``evaluate_all`` and the eval CLI at x3 on HR frames whose sides are no
  multiple of 3 (the crop to 3 x LR acts) against
  ``m2trans_tpu.train.evaluate`` / the JAX ``test.py``: PSNR, FSIM, GMSD
  equal after the reference's rounding, SSIM within 1e-3 (see
  test_torch_port_eval.py); bf16 within 0.1 dB / 2e-3 of f32, the bound
  the card holds the kernels to.
* ``tools.bench_clip_train --scale 3 --device cpu``: the line names
  ``x3_train_step_ms``, ``config.scale`` 3 and LR ``384 // 3``; the x4
  line keeps its metric name and keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.data import augment as jaug
from m2trans_tpu.losses import l1_loss as jax_l1
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models import policy_from_config as jax_policy
from m2trans_tpu.ops.pallas import halo_attn as jax_halo
from m2trans_tpu.ops.pallas import halo_attn_packed as jax_packed
from m2trans_tpu.ops.pallas import tail_band as jax_tail
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu_torch import test as eval_cli
from m2trans_tpu_torch.config import Config, load_config
from m2trans_tpu_torch.data import augment
from m2trans_tpu_torch.data.pipeline import create_datasets
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.tools import bench_clip_train
from m2trans_tpu_torch.train.checkpoint import load_params_any
from m2trans_tpu_torch.train.convert import reference_state_dict
from m2trans_tpu_torch.train.evaluate import evaluate_all
from m2trans_tpu_torch.train.jax_params import module_from_params
from m2trans_tpu_torch.train.loop import make_train_step

from test_torch_port_eval import (
    _jax_cli_output,
    _jax_results,
    _pair,
    assert_metrics_match,
    parse_lines,
)
from test_torch_port_train import _step_grads, rel_l2

# ---------------------------------------------------------------------------
# one train step at x3 and x4 against JAX's
# ---------------------------------------------------------------------------

# the JAX functions a route of the branch VJP / the bf16 tail goes through
_ROUTES = {
    "branch vjp banded": (jax_halo, "_cascade_bwd_impl"),
    "branch vjp tiled": (jax_halo, "_cascade_bwd_tiled_impl"),
    "branch vjp packed": (jax_packed, "packed_cascade_bwd_impl"),
    "branch vjp packed tiled": (jax_packed, "packed_cascade_bwd_tiled_impl"),
    "branch vjp packed front": (jax_packed, "packed_front_bwd_impl"),
    "tail fused band": (jax_tail, "tail_band_apply"),
}
STEP_CASES = [(3, 16), (3, 20), (4, 20)]  # (scale, LR side)


@pytest.fixture(scope="module", params=STEP_CASES, ids=[f"x{s}-{h}" for s, h in STEP_CASES])
def steps(request):
    """One step on the same weights and batch, f32 and bf16 with the
    kernels, in both packages: {dtype: (jax loss, jax grads, port loss,
    port grads)}, and {dtype: the JAX routes taken}."""
    scale, hw = request.param
    kw = dict(scale=scale, n_feats=16, n_blocks=1, patch_size=scale * hw, batch_size=2)
    params = jax_init(jax.random.PRNGKey(scale), JaxConfig(**kw))
    rng = np.random.default_rng(10 * scale + hw)
    lr_np = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    hr_np = rng.uniform(0, 1, (2, scale * hw, scale * hw, 3)).astype(np.float32)
    out, routes = {}, {}
    for dtype, extra in (("f32", {}), ("bf16", dict(dtype="bfloat16", use_pallas=True))):
        taken = set()
        with pytest.MonkeyPatch.context() as mp:
            for name, (mod, attr) in _ROUTES.items():
                def spy(*a, _f=getattr(mod, attr), _name=name, **k):
                    taken.add(_name)
                    return _f(*a, **k)
                mp.setattr(mod, attr, spy)
            out[dtype] = _step_grads(Config(**kw, **extra), JaxConfig(**kw, **extra),
                                     params, lr_np, hr_np)
        routes[dtype] = taken
    return out, routes


def test_f32_train_step_matches_jax_at_scale(steps):
    """f32: loss 1e-5 relative, every gradient 1e-4 relative L2; JAX's f32
    step runs no Pallas kernel."""
    (jloss, want, loss, got), routes = steps[0]["f32"], steps[1]["f32"]
    assert routes == set()
    assert loss == pytest.approx(jloss, rel=1e-5)
    for name, g in got.items():
        assert rel_l2(g.numpy(), want[name]) < 1e-4, name


def test_bf16_kernel_step_matches_jax_pallas_at_scale(steps):
    """bf16 with use_pallas against JAX's step through its Pallas kernels
    in interpret mode, which at these sizes takes the banded (whole-frame)
    branch VJP and the fused band tail: loss 2e-2 relative, each gradient
    within max(5e-2, 1.5 e) relative L2 of JAX's, e the distance of JAX's
    bf16 gradient from its f32 one, or at least as close to the f32
    gradient as JAX's (test_bf16_kernel_step_matches_jax_pallas says
    why)."""
    (jloss, want, loss, got), routes = steps[0]["bf16"], steps[1]["bf16"]
    assert routes == {"branch vjp banded", "tail fused band"}
    want32 = steps[0]["f32"][1]
    assert loss == pytest.approx(jloss, rel=2e-2)
    for name, g in got.items():
        g = g.float().numpy()
        e = rel_l2(want[name], want32[name])
        assert (rel_l2(g, want[name]) < max(5e-2, 1.5 * e)
                or rel_l2(g, want32[name]) <= e), name


# ---------------------------------------------------------------------------
# cutmix / cutout / noise at x3
# ---------------------------------------------------------------------------

AUG_KW = dict(scale=3, n_feats=16, n_blocks=1, patch_size=60, lr=1e-3)
AUG_LR = 20  # LR side of the x3 step
AUG_CUT = int(0.1 * AUG_KW["patch_size"] // AUG_KW["scale"])  # JAX's cutout side


def _jax_augmented(lr, hr, draws, holes, nd, normal, scale):
    """The batch the JAX package's mask composition makes from the port's
    unpacked draws: ``_coords_mask`` and ``jnp.where`` of the permuted half
    (HR boxes ``scale`` times the LR ones), the keep mask's product for
    cutout, ``img + std * normal``."""
    lh, lw = lr.shape[1:3]
    jl, jh = jnp.asarray(lr.numpy()), jnp.asarray(hr.numpy())
    for lo, hi, patches in draws:
        a, c = jl[lo:hi], jh[lo:hi]
        for perm, (y1, y2, x1, x2) in patches:
            m = jaug._coords_mask(lh, lw, y1, y2, x1, x2)
            mh = jaug._coords_mask(lh * scale, lw * scale, y1 * scale, y2 * scale,
                                   x1 * scale, x2 * scale)
            p = jnp.asarray(perm)
            a = jnp.where(m[None, :, :, None], a[p], a)
            c = jnp.where(mh[None, :, :, None], c[p], c)
        jl, jh = jl.at[lo:hi].set(a), jh.at[lo:hi].set(c)
    for lo, hi, boxes in holes:
        keep = jnp.ones((lh, lw), jnp.bool_)
        for y1, y2, x1, x2 in boxes:
            keep = keep & ~jaug._coords_mask(lh, lw, y1, y2, x1, x2)
        jl = jl.at[lo:hi].set(jl[lo:hi] * keep[None, :, :, None])
    return jl + jnp.float32(nd[0]) * jnp.asarray(normal.numpy()), jh


def _firing_seed(b):
    """The first seed whose draws fire cutmix, cutout and the noise."""
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        mix = augment.cutmix_draw(rng, b, AUG_LR, AUG_LR)
        holes = augment.cutout_draw(rng, b, AUG_LR, AUG_LR, AUG_CUT)
        if any(p for _, _, p in mix) and any(h for _, _, h in holes) \
                and augment.noise_draw(rng) is not None:
            return seed
    raise AssertionError("no seed fires every augmentation")


@pytest.mark.parametrize("b", [2, 4])
def test_x3_step_with_augmentations_matches_jax(b):
    """One f32 x3 step of ``make_train_step`` with cutmix, cutout and the
    noise fired (the port's packed draws, iota masks) against
    ``jax.value_and_grad`` of the JAX loss on JAX's composition of the same
    draws: loss rtol 1e-5, gradients 1e-4 relative L2."""
    kw = dict(AUG_KW, batch_size=b)
    cfg = Config(**kw, cutmix=True, data_add_noise=True)
    jcfg = JaxConfig(**kw)
    params = jax_init(jax.random.PRNGKey(7 + b), jcfg)
    rng = np.random.default_rng(50 + b)
    lr = torch.from_numpy(rng.uniform(0, 1, (b, AUG_LR, AUG_LR, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1, (b, 3 * AUG_LR, 3 * AUG_LR, 3)).astype(np.float32))
    seed = _firing_seed(b)
    draw = np.random.default_rng(seed)
    draws = augment.cutmix_draw(draw, b, AUG_LR, AUG_LR)
    holes = augment.cutout_draw(draw, b, AUG_LR, AUG_LR, AUG_CUT)
    nd = augment.noise_draw(draw)
    normal = augment.normal_draw(torch.empty(lr.shape), nd[1])
    jl, jh = _jax_augmented(lr, hr, draws, holes, nd, normal, 3)
    policy = jax_policy(jcfg, for_training=True)

    def loss_fn(p):
        return jax_l1(jax_apply(p, jl, jcfg, policy=policy), jh) * jcfg.lambda_l1

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                      jcfg, module_prefix=False)
    model = module_from_params(params, cfg)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=0.0)
    aux = make_train_step(cfg, model, opt)(lr, hr, rng=np.random.default_rng(seed),
                                            do_cutout=True)
    assert float(aux["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert rel_l2(p.grad.numpy(), want[name]) < 1e-4, name


# ---------------------------------------------------------------------------
# the eval slice at x3
# ---------------------------------------------------------------------------

EVAL_KW = dict(scale=3, n_feats=16, n_blocks=2)
EVAL_HR = [(73, 50), (61, 101), (73, 50)]  # no side a multiple of 3


@pytest.fixture(scope="module")
def bench3(tmp_path_factory):
    """A CCA-US (benchmark/UI5) tree at x3: smooth HR JPEGs of EVAL_HR, LR
    by striding the largest multiple of 3 of each side (a bicubic LR's
    size); seeded weights as a reference ``.pt`` written by the port, and a
    test yml naming both."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("eval3")
    hr_dir = tmp / "data/benchmark/UI5/HR"
    lr_dir = tmp / "data/benchmark/UI5/LR_bicubic/X3"
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    rng = np.random.default_rng(31)
    for i, (h, w) in enumerate(EVAL_HR):
        x, _ = _pair((1, h, w, 3), seed=int(rng.integers(1 << 30)))
        u8 = (x[0] * 255).astype(np.uint8)
        Image.fromarray(u8).save(hr_dir / f"e{i}.jpg", quality=95)
        Image.fromarray(u8[:h - h % 3:3, :w - w % 3:3]).save(lr_dir / f"e{i}x3.jpg",
                                                             quality=95)
    pt = str(tmp / "model_x3.pt")
    torch.save({"model_state_dict": reference_state_dict(
        init_m2trans(Config(**EVAL_KW), seed=5), module_prefix=True)}, pt)
    yml = str(tmp / "test.yml")
    with open(yml, "w") as f:
        yaml.dump(dict(EVAL_KW, model_path=pt, data_path=str(tmp / "data"),
                       eval_sets=["CCA-US"], dtype="float32"), f)
    return {"yml": yml, "pt": pt}


def test_x3_eval_frames_are_cropped(bench3):
    """The HR frames are cropped to 3 x LR in both packages' datasets."""
    cfg = load_config(bench3["yml"])
    _, sets = create_datasets(cfg, train=False)
    for (lr, hr, _), (h, w) in zip(sets[0]["dataset"], EVAL_HR):
        assert lr.shape[1:3] == (h // 3, w // 3)
        assert hr.shape[1:3] == (3 * (h // 3), 3 * (w // 3)) != (h, w)


@pytest.mark.parametrize("kw", [dict(full_metrics=True),
                                dict(full_metrics=True, bucket=32),
                                dict(full_metrics=False, bucket=16)],
                         ids=["full", "full-bucket32", "bucket16"])
def test_x3_evaluate_all_matches_jax(bench3, kw):
    cfg = load_config(bench3["yml"])
    _, sets = create_datasets(cfg, train=False)
    got = evaluate_all(load_params_any(cfg.model_path, cfg), cfg, sets, **kw)
    want = _jax_results(bench3, **kw)
    assert list(got) == list(want) == ["CCA-US"]
    assert_metrics_match(got["CCA-US"], want["CCA-US"])


def test_x3_evaluate_bf16_close_to_f32(bench3):
    """bf16 (the kernels' plain versions on the CPU) against f32 at x3:
    PSNR within 0.1 dB, SSIM / FSIM / GMSD within 2e-3."""
    cfg = load_config(bench3["yml"])
    _, sets = create_datasets(cfg, train=False)
    model = load_params_any(cfg.model_path, cfg)
    f32 = evaluate_all(model, cfg, sets, full_metrics=True)["CCA-US"]
    bf16 = evaluate_all(model, cfg, sets, full_metrics=True,
                        policy=ComputePolicy(torch.bfloat16, True))["CCA-US"]
    assert abs(bf16["psnr"] - f32["psnr"]) <= 0.1
    for k in ("ssim", "fsim", "gmsd"):
        assert abs(bf16[k] - f32[k]) <= 2e-3


def test_x3_eval_cli_prints_the_reference_lines(bench3, capsys, monkeypatch):
    argv = ["--config", bench3["yml"]]
    eval_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    want = _jax_cli_output(argv, capsys, monkeypatch)
    got_m, want_m = parse_lines(got), parse_lines(want)
    assert list(got_m) == list(want_m) == ["CCA-US-X3"]
    assert_metrics_match(got_m["CCA-US-X3"], want_m["CCA-US-X3"])


# ---------------------------------------------------------------------------
# tools.bench_clip_train --scale
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--n-blocks", "1", "--n-feats", "16", "--kinds", "L1",
        "--batches", "2"]
CONFIG_KEYS = {"scale", "n_feats", "n_blocks", "lr_hw", "dtype", "use_pallas", "cutmix",
               "cutout", "data_add_noise", "lambda_clip", "medclip", "tokens", "pairs",
               "check_steps", "seed"}


def _line(capsys, line):
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    return printed


def test_bench_clip_train_scale_3_cpu(capsys):
    """``--scale 3`` at its default LR side: 128² LR, 384² HR."""
    x3 = _line(capsys, bench_clip_train.main(TINY + ["--scale", "3"]))
    assert x3["metric"] == "x3_train_step_ms"
    assert set(x3["config"]) == CONFIG_KEYS
    assert (x3["config"]["scale"], x3["config"]["lr_hw"]) == (3, 128)
    assert sorted(x3["steps"]) == ["L1 b2"]
    assert all(v is None for v in x3["steps"]["L1 b2"].values())
    x4 = _line(capsys, bench_clip_train.main(TINY + ["--hw", "16"]))
    assert x4["metric"] == "x4_train_step_ms"
    assert set(x4) == set(x3) and set(x4["config"]) == CONFIG_KEYS
    assert (x4["config"]["scale"], x4["config"]["lr_hw"]) == (4, 16)


@pytest.mark.parametrize("scale,hw", [(2, 192), (3, 128), (4, 96)])
def test_bench_clip_train_step_case_at_scale(scale, hw):
    """``StepCase`` at a scale: the Config's scale and the batch's LR / HR
    sides, HR 384 at every scale's default LR side."""
    case = bench_clip_train.StepCase("L1", 1, torch.device("cpu"), hw=hw, n_feats=8,
                                     n_blocks=1, scale=scale)
    assert case.cfg.scale == scale and case.cfg.use_pallas
    assert tuple(case.lr.shape) == (1, hw, hw, 3)
    assert tuple(case.hr.shape) == (1, 384, 384, 3)
