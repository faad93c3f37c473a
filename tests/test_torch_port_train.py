"""The port's training slice against the JAX package, on the CPU.

Small sizes (n_feats 8-16, one block, 32x32 HR patches), the same numpy
inputs and the same weights (through m2trans_tpu_torch.train.jax_params)
on both sides. Tolerances, with their reasons:

* losses, LR schedule, PSNR: 1e-5 relative (f32, summation order only);
* SSIM: 2e-4 absolute. The recipe's SSIM works on Y*255 (values near
  4100), so E[x^2] - mu^2 cancels in f32 and the two filter formulations
  (XLA's conv, the port's shifted slices) differ by up to ~6e-5;
* the data loader: exact (same files, same numpy RNG per batch);
* one f32 train step: loss 1e-5 relative, every gradient 1e-4 relative
  L2 per tensor;
* Adam + cosine LR fed the same gradients: parameters to 1e-6;
* one bf16 step with the kernels' plain versions against the JAX bf16
  step with its Pallas kernels in interpret mode: loss 2e-2 relative,
  gradients 5e-2 relative L2 per tensor, widened to 1.5x JAX's own bf16
  distance from the f32 gradient where that is larger (bf16 rounds at
  other places in the two frameworks; see the test).
"""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.data import create_datasets as jax_create_datasets
from m2trans_tpu.losses import charbonnier_loss as jax_charbonnier
from m2trans_tpu.losses import l1_loss as jax_l1
from m2trans_tpu.metrics import sr_eval_metrics as jax_metrics
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models import policy_from_config as jax_policy
from m2trans_tpu.train.checkpoint import load_params_any as jax_load_params_any
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu.train.loop import make_optimizer as jax_make_optimizer
from m2trans_tpu.train.schedule import cosine_annealing_lr as jax_cosine
from m2trans_tpu_torch.config import Config, load_config
from m2trans_tpu_torch.data.pipeline import create_datasets
from m2trans_tpu_torch.losses.pixel import charbonnier_loss, l1_loss
from m2trans_tpu_torch.metrics.eval_recipe import sr_eval_metrics
from m2trans_tpu_torch.models import m2trans as port_model
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    init_m2trans,
    m2trans_apply,
    param_count,
    trainable_mask,
)
from m2trans_tpu_torch.train import __main__ as train_cli
from m2trans_tpu_torch.train.checkpoint import load_params_any
from m2trans_tpu_torch.train.evaluate import evaluate_dataset
from m2trans_tpu_torch.train.jax_params import module_from_params
from m2trans_tpu_torch.train.loop import (
    Trainer,
    epoch_lr,
    make_optimizer,
    make_train_step,
    set_lr,
)
from m2trans_tpu_torch.train.schedule import cosine_annealing_lr

FROZEN = ("sub_mean.weight", "sub_mean.bias", "add_mean.weight", "add_mean.bias")


def write_tree(root, rng, scale=2, n=3, hr_hw=64, eval_hw=40):
    """US1K tree (n HR PNGs + LR x`scale`) and one CCA-US (UI5) eval pair,
    written with Pillow."""
    hr_dir = root / "US1K/US1K_train_HR"
    lr_dir = root / f"US1K/US1K_train_LR_bicubic/X{scale}"
    bhr, blr = root / "benchmark/UI5/HR", root / f"benchmark/UI5/LR_bicubic/X{scale}"
    for d in (hr_dir, lr_dir, bhr, blr):
        d.mkdir(parents=True)
    for i in range(1, n + 1):
        hr = rng.integers(0, 256, (hr_hw, hr_hw, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_dir / f"{i:04d}.png")
        Image.fromarray(hr[::scale, ::scale]).save(lr_dir / f"{i:04d}x{scale}.png")
    hr = rng.integers(0, 256, (eval_hw, eval_hw, 3), dtype=np.uint8)
    Image.fromarray(hr).save(bhr / "b0.jpg")
    Image.fromarray(hr[::scale, ::scale]).save(blr / f"b0x{scale}.jpg")
    return root


def tree_kw(root, tmp_path):
    return dict(scale=2, n_feats=8, n_blocks=1, patch_size=32, batch_size=2,
                data_repeat=2, epochs=2, lr=1e-3, eta_min=1e-5, log_every=1,
                test_every=1, data_path=str(root), eval_sets=["CCA-US"],
                log_path=str(tmp_path / "experiments"), threads=2,
                train_range=(1, 4), save_image=False, cutmix=False,
                cutout=False, native_loader=False)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# losses, schedule, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["l1", "charbonnier"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    sr, hr = (rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32) for _ in range(2))
    jf, tf = {"l1": (jax_l1, l1_loss),
              "charbonnier": (jax_charbonnier, charbonnier_loss)}[name]
    want = float(jf(jnp.asarray(sr), jnp.asarray(hr)))
    got = float(tf(torch.from_numpy(sr), torch.from_numpy(hr)))
    assert got == pytest.approx(want, rel=1e-5)


def test_cosine_lr_matches_jax():
    for e in range(0, 11):
        kw = dict(base_lr=1e-4, eta_min=1e-6, t_max=10)
        assert cosine_annealing_lr(e, **kw) == pytest.approx(jax_cosine(e, **kw),
                                                             rel=1e-12)
    cfg = Config(epochs=10, lr=1e-4, eta_min=1e-6)
    assert epoch_lr(cfg, 1) == pytest.approx(1e-4) and epoch_lr(cfg, 11) == pytest.approx(1e-6)


@pytest.mark.parametrize("scale,colors", [(2, 3), (4, 3), (3, 1)])
def test_eval_metrics_match_jax(scale, colors):
    rng = np.random.default_rng(scale)
    hr = rng.uniform(0, 1, (1, 48, 40, colors)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, hr.shape), 0, 1).astype(np.float32)
    want = jax_metrics(jnp.asarray(sr), jnp.asarray(hr), scale=scale, colors=colors)
    got = sr_eval_metrics(torch.from_numpy(sr), torch.from_numpy(hr),
                          scale=scale, colors=colors)
    assert float(got["psnr"]) == pytest.approx(float(want["psnr"]), rel=1e-5)
    assert abs(float(got["ssim"]) - float(want["ssim"])) < 2e-4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail", [False, True])
def test_loader_batches_equal_jax(tmp_path, tail):
    """Two identical trees (each package builds its own npy cache from the
    PNGs): every batch of two epochs is equal, masks included."""
    root_j = write_tree(tmp_path / "j", np.random.default_rng(5))
    root_t = write_tree(tmp_path / "t", np.random.default_rng(5))
    kw = dict(tree_kw(root_j, tmp_path), batch_size=4, faithful_tail_batch=tail)
    jl, jsets = jax_create_datasets(JaxConfig(**kw))
    tl, tsets = create_datasets(Config(**dict(kw, data_path=str(root_t))))
    assert len(tl) == len(jl) == (2 if tail else 1)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    lj, hj, nj = jsets[0]["dataset"][0]
    lt, ht, nt = tsets[0]["dataset"][0]
    assert nj == nt
    np.testing.assert_array_equal(lj, lt)
    np.testing.assert_array_equal(hj, ht)


# ---------------------------------------------------------------------------
# train step, optimizer
# ---------------------------------------------------------------------------


def _step_grads(cfg, jcfg, params, lr_np, hr_np):
    """JAX (loss, grads as a reference-keyed state dict) and the port's
    (loss, {name: grad}) for one train step on the same weights."""
    policy = jax_policy(jcfg, for_training=True)

    def loss_fn(p):
        return jax_l1(jax_apply(p, jnp.asarray(lr_np), jcfg, policy=policy),
                      jnp.asarray(hr_np)) * jcfg.lambda_l1

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                      jcfg, module_prefix=False)
    model = module_from_params(params, cfg)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=0.0)
    aux = make_train_step(cfg, model, opt)(torch.from_numpy(lr_np),
                                           torch.from_numpy(hr_np))
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return float(jloss), want, float(aux["loss"]), got


@pytest.fixture(scope="module")
def steps():
    """One train step on the same weights and batch, f32 and bf16 with the
    kernels, in both packages: {dtype: (jax loss, jax grads, port loss,
    port grads)}."""
    kw = dict(scale=2, n_feats=16, n_blocks=1, patch_size=32, batch_size=2)
    params = jax_init(jax.random.PRNGKey(1), JaxConfig(**kw))
    rng = np.random.default_rng(1)
    lr_np = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    hr_np = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    out = {}
    for dtype, extra in (("f32", {}), ("bf16", dict(dtype="bfloat16",
                                                    use_pallas=True))):
        out[dtype] = _step_grads(Config(**kw, **extra), JaxConfig(**kw, **extra),
                                 params, lr_np, hr_np)
    return out


def test_f32_train_step_matches_jax(steps):
    jloss, want, loss, got = steps["f32"]
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert set(got) == set(want) - set(FROZEN)
    for name, g in got.items():
        assert rel_l2(g.numpy(), want[name]) < 1e-4, name


def test_bf16_kernel_step_matches_jax_pallas(steps):
    """bf16 with use_pallas: the port's plain kernel versions (CPU) vs the
    JAX Pallas kernels in interpret mode, forward and backward. Each
    gradient is within max(5e-2, 1.5 e) relative L2 of JAX's, e being the
    distance of JAX's bf16 gradient from the f32 gradient of the same step
    (two independent bf16 errors of size e differ by about 1.41 e; the
    rel-pos gradients of the wide branches sit at e = 0.05-0.08), or at
    least as close to the f32 gradient as JAX's (bias sums rounded in
    bf16: JAX's head.bias is 0.4 from f32, the port's 0.01)."""
    jloss, want, loss, got = steps["bf16"]
    want32 = steps["f32"][1]
    assert loss == pytest.approx(jloss, rel=2e-2)
    for name, g in got.items():
        g = g.float().numpy()
        e = rel_l2(want[name], want32[name])
        assert (rel_l2(g, want[name]) < max(5e-2, 1.5 * e)
                or rel_l2(g, want32[name]) <= e), name


def test_adam_and_cosine_lr_match_jax_optimizer():
    """The same synthetic gradients, 5 steps over 3 epochs of 2 steps:
    the port's Adam + per-epoch cosine LR vs the JAX make_optimizer."""
    kw = dict(scale=2, n_feats=8, n_blocks=1, epochs=3, lr=1e-3, eta_min=1e-5)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    params = jax_init(jax.random.PRNGKey(2), jcfg)
    model = module_from_params(params, cfg)
    tx = jax_make_optimizer(jcfg, steps_per_epoch=2)
    state = tx.init(params)
    opt = make_optimizer(cfg, model)
    rng = np.random.default_rng(3)
    for step in range(5):
        # the frozen MeanShift convs are dead in the forward: their real
        # gradient is 0 (optax.masked would pass a nonzero one through)
        grads = {k: jax.tree_util.tree_map(
            lambda v: (np.zeros if k in ("sub_mean", "add_mean") else
                       lambda shp: rng.normal(0, 1, shp))(v.shape).astype(np.float32), sub)
            for k, sub in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        sd = params_to_torch_state_dict(grads, jcfg, module_prefix=False)
        set_lr(opt, epoch_lr(cfg, step // 2 + 1))
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(np.ascontiguousarray(sd[name]))
        opt.step()
    want = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                      jcfg, module_prefix=False)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], atol=1e-6, rtol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------


def _write_cfg(path, kw):
    import yaml

    d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in kw.items()}
    path.write_text(yaml.dump(d))
    return str(path)


def test_train_cli_two_epochs_then_resume(tmp_path, monkeypatch, capsys):
    """python -m m2trans_tpu_torch.train on the CPU: two epochs, the
    experiment tree and reference-format checkpoints, then --resume
    continues at epoch 3. The saved .pt loads strictly through both
    packages' load_params_any."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the trainer tees stdout
    root = write_tree(tmp_path / "data", np.random.default_rng(6))
    kw = tree_kw(root, tmp_path)
    yml = _write_cfg(tmp_path / "tiny.yml", kw)
    train_cli.main(["--config", yml, "--device", "cpu"])
    (exp,) = glob.glob(str(tmp_path / "experiments" / "*"))
    for f in ("config.yml", "log.txt", "stat_dict.yml", "models/model_x2_1.pt",
              "models/model_x2_2.pt"):
        assert os.path.exists(os.path.join(exp, f)), f
    log = open(os.path.join(exp, "log.txt")).read()
    assert "Epoch:2, 6/6, loss: " in log and "L1loss: " in log
    assert log.count("[CCA-US-X2], PSNR/SSIM: ") == 2
    ckpt = torch.load(os.path.join(exp, "models/model_x2_2.pt"), weights_only=True)
    assert set(ckpt) == {"epoch", "model_state_dict", "optimizer_state_dict",
                         "scheduler_state_dict", "stat_dict"}
    assert ckpt["epoch"] == 2 and len(ckpt["stat_dict"]["CCA-US"]["psnrs"]) == 2

    cfg = Config(**kw)
    pt = os.path.join(exp, "models/model_x2_2.pt")
    model = load_params_any(pt, cfg)
    jparams = jax_load_params_any(pt, JaxConfig(**kw))
    sd = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                                    JaxConfig(**kw), module_prefix=False)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
        np.testing.assert_array_equal(v.numpy(), ckpt["model_state_dict"][k].numpy())

    yml3 = _write_cfg(tmp_path / "tiny3.yml", dict(kw, epochs=3))
    train_cli.main(["--config", yml3, "--resume", exp, "--device", "cpu"])
    assert "## resume training from epoch 3. ##" in capsys.readouterr().out
    assert os.path.exists(os.path.join(exp, "models/model_x2_3.pt"))
    stat = torch.load(os.path.join(exp, "models/model_x2_3.pt"),
                      weights_only=True)["stat_dict"]
    assert stat["epochs"] == 3 and len(stat["CCA-US"]["psnrs"]) == 3


def test_train_cli_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", "configs/M2Trans_x4.yml"])


@pytest.mark.parametrize("option", [
    {"cutmix": True}, {"cutout": True}, {"data_add_noise": True},
    {"medclip_path": "medclip.pt"}, {"mesh_data": 2}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer(Config(**option))


def test_full_metrics_raise():
    """``full_metrics`` is ported (it raised "not yet ported" before the
    eval slice): it adds FSIM and GMSD to the result. What still raises is
    an SR frame that does not match its HR frame."""
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    hr = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    model = init_m2trans(cfg)
    out = evaluate_dataset(model, cfg, [(lr, hr, "a.png")], full_metrics=True)
    assert set(out) == {"psnr", "ssim", "fsim", "gmsd"}
    assert 0.0 < out["fsim"] <= 1.0 and out["gmsd"] >= 0.0
    with pytest.raises(ValueError, match="SR .* != HR"):
        evaluate_dataset(model, cfg, [(lr, hr[:, :30], "a.png")], full_metrics=True)


def test_lambda_clip_without_medclip_trains_l1(tmp_path, monkeypatch, capsys):
    """As train.py: lambda_clip > 0 with no medclip_path prints its line
    and goes on with L1 (here stopped by an empty training range)."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    root = write_tree(tmp_path / "data", np.random.default_rng(7))
    yml = _write_cfg(tmp_path / "c.yml", dict(tree_kw(root, tmp_path),
                                              lambda_clip=0.01, train_range=(1, 1)))
    with pytest.raises(ValueError, match="empty training set"):
        train_cli.main(["--config", yml, "--device", "cpu"])
    assert "training with L1 only" in capsys.readouterr().out
    assert load_config(yml).lambda_clip == 0.01


# ---------------------------------------------------------------------------
# the model's repairs: a differentiable forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [ComputePolicy(torch.bfloat16, True),
                                    ComputePolicy()], ids=["bf16", "f32"])
def test_every_trainable_parameter_gets_a_gradient(policy):
    cfg = Config(scale=4, n_feats=16, n_blocks=2)
    model = init_m2trans(cfg, seed=0)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    y = m2trans_apply(model, x, cfg, policy)
    assert y.requires_grad
    y.float().square().mean().backward()
    mask = trainable_mask(model)
    for name, p in model.named_parameters():
        if name in FROZEN:
            assert not mask[name] and p.grad is None, name
            continue
        assert mask[name], name
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert float(p.grad.abs().max()) > 0, name
    qkv = [n for n in mask if n.endswith("qkv_conv.weight") or n.endswith("rel_h")
           or n.endswith("rel_w")]
    assert len(qkv) == 2 * 4 * 3
    assert param_count(model) == param_count(model, trainable_only=True) + 24


def test_qkv_weight_cached_only_without_grad():
    tb = init_m2trans(Config(scale=2, n_feats=8, n_blocks=1), seed=0).body[0].attn2
    with torch.no_grad():
        a = port_model._qkv_w(tb, torch.bfloat16)
        assert a is port_model._qkv_w(tb, torch.bfloat16)
    b = port_model._qkv_w(tb, torch.bfloat16)
    assert b.grad_fn is not None and b is not a
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
