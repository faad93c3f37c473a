"""The port's data parallelism (``mesh_data`` > 1) on gloo CPU ranks: the
step of 2 ranks under DistributedDataParallel against one process on the
same global batch, against JAX's single-device step, the Trainer's
refusals and the train CLI under ``torch.distributed.run``.

Tolerances, with their reasons:

* 2 ranks against 1 process, f32, with cutmix, cutout and noise on (and
  the semantic loss in one case): the loss 1e-6 relative and every parameter after the Adam step 1e-6
  absolute (the gradients differ only in the order of the batch sums);
* against JAX's single-device step: tests/test_torch_port_train.py's f32
  bounds, the loss 1e-5 relative, every gradient 1e-4 relative L2.

The ranks run in fresh processes (``mesh.run_ranks``, a 120 s process
timeout and a 60 s group timeout); ``tests/torch_ranks.py`` holds what they
run.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_ranks
from torch_ranks import run_launcher
from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.losses import l1_loss as jax_l1
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models import policy_from_config as jax_policy
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.augment import cutmix_draw, cutout_draw, noise_draw
from m2trans_tpu_torch.data.pipeline import rank_rows
from m2trans_tpu_torch.parallel.mesh import run_ranks
from m2trans_tpu_torch.train.convert import reference_state_dict
from m2trans_tpu_torch.train.jax_params import module_from_params
from test_torch_port_train import rel_l2, tree_kw, write_tree

KW = dict(scale=2, n_feats=8, n_blocks=1, patch_size=32, lr=1e-3)
AUG = dict(KW, cutmix=True, data_add_noise=True)
CLIP = dict(AUG, patch_size=64, lambda_clip=0.5)
LH = 16  # LR patch side


def firing_seed(b, lh=LH):
    """The first seed whose draws apply cutmix (a box in every half),
    cutout (holes in every half) and the noise, in the step's order, to a
    batch of ``b`` LR patches of ``lh`` x ``lh`` (patch_size 2 * lh)."""
    cutout_len = int(0.1 * 2 * lh // KW["scale"])
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        mix = cutmix_draw(rng, b, lh, lh)
        holes = cutout_draw(rng, b, lh, lh, cutout_len)
        if all(p for _, _, p in mix) and all(h for _, _, h in holes) \
                and noise_draw(rng) is not None:
            return seed
    raise AssertionError("no seed fires every augmentation")


def _batch(b, seed, lh=LH):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, lh, lh, 3)).astype(np.float32),
            rng.uniform(0, 1, (b, 2 * lh, 2 * lh, 3)).astype(np.float32))


def one_process(*case):
    aux, model = torch_ranks.train_step(*case)
    return float(aux["loss"]), {k: p.detach().numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    """The JAX weights and batch, and the 2-rank steps: 2 x 1 and 2 x 2
    with every augmentation, 2 x 1 with every augmentation and the semantic
    loss (HR 64 x 64, so the 56 x 56 crops are drawn), 2 x 1 without either
    (the JAX comparison)."""
    params = jax_init(jax.random.PRNGKey(5), JaxConfig(**KW))
    sd = {k: v.numpy() for k, v in
          reference_state_dict(module_from_params(params, Config(**KW))).items()}
    cases = []
    for b in (2, 4):
        cases.append((f"aug{b}", AUG, sd, *_batch(b, b), firing_seed(b), True, None))
    cases.append(("clip", CLIP, sd, *_batch(2, 7, 2 * LH), firing_seed(2, 2 * LH), True,
                  ["carotid artery", "liver"]))
    cases.append(("plain", KW, sd, *_batch(2, 9), 0, False, None))
    return params, cases, run_ranks(torch_ranks.ddp_rank, 2, (cases,))


@pytest.mark.parametrize("b", [2, 4])
def test_two_ranks_equal_one_process_with_augmentation(runs, b):
    _, cases, ranks = runs
    case = next(c for c in cases if c[0] == f"aug{b}")
    want_loss, want = one_process(*case[1:])
    loss, _, got = ranks[0][f"aug{b}"]
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for name, p in want.items():
        np.testing.assert_allclose(got[name], p, rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(ranks[1][f"aug{b}"][2][name], got[name])


def test_two_ranks_equal_one_process_with_semantic_loss(runs):
    """The step of every shipped training config (lambda_clip > 0): the
    crop offsets drawn for the global batch after the augmentation's draws,
    the captions and the semantic loss (a sum over the batch) split over 2
    ranks equal one process on the global batch."""
    _, cases, ranks = runs
    case = next(c for c in cases if c[0] == "clip")
    want_loss, want = one_process(*case[1:])
    loss, _, got = ranks[0]["clip"]
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert loss > one_process(*case[1:-1], None)[0]  # the clip term counts
    for name, p in want.items():
        np.testing.assert_allclose(got[name], p, rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(ranks[1]["clip"][2][name], got[name])


def test_two_ranks_match_jax_single_device_step(runs):
    params, cases, ranks = runs
    _, kw, _, lr, hr, _, _, _ = next(c for c in cases if c[0] == "plain")
    jcfg = JaxConfig(**kw)
    policy = jax_policy(jcfg, for_training=True)

    def loss_fn(p):
        return jax_l1(jax_apply(p, jnp.asarray(lr), jcfg, policy=policy),
                      jnp.asarray(hr)) * jcfg.lambda_l1

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                      jcfg, module_prefix=False)
    loss, grads, _ = ranks[0]["plain"]
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    assert grads and set(grads) <= set(want)
    for name, g in grads.items():
        assert rel_l2(g, want[name]) < 1e-4, name
        np.testing.assert_array_equal(ranks[1]["plain"][1][name], g)


def test_uneven_global_batch_raises(runs):
    with pytest.raises(ValueError, match="must divide evenly over 2 ranks"):
        rank_rows(3, 0, 2)
    assert rank_rows(4, 1, 2) == slice(2, 4)
    assert "must divide evenly over 2 ranks" in runs[2][0]["uneven"]


def test_rank_processes_load_no_jax(runs):
    assert all(r["loaded"] == [] for r in runs[2])


def test_train_cli_two_ranks(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    m2trans_tpu_torch.train`` with ``mesh_data: 2`` on the CPU, 1 epoch of 2
    steps: rank 0 alone prints and writes the experiment tree and the
    checkpoint, and both ranks end with equal parameters."""
    root = write_tree(tmp_path / "data", np.random.default_rng(0), n=2)
    kw = dict(tree_kw(root, tmp_path), epochs=1, mesh_data=2, data_repeat=2,
              train_range=[1, 3], cutmix=True, data_add_noise=True)
    yml = tmp_path / "train.yml"
    yml.write_text(yaml.safe_dump(kw))
    out = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", "-m", "m2trans_tpu_torch.train",
                        "--config", str(yml), "--device", "cpu"])
    assert out.count("## device: cpu ##") == 1
    assert "## 2 ranks, gloo" in out
    assert "## parameters equal on all 2 ranks ##" in out
    exps = os.listdir(tmp_path / "experiments")
    assert len(exps) == 1
    exp = tmp_path / "experiments" / exps[0]
    log = (exp / "log.txt").read_text()
    assert log.count("Epoch:1, ") == 2 and log.count("[CCA-US-X2], PSNR/SSIM: ") == 1
    assert sorted(os.listdir(exp / "models")) == ["model_x2_1.pt"]
    ck = torch.load(exp / "models" / "model_x2_1.pt", weights_only=True)
    assert ck["epoch"] == 1 and not any(k.startswith("module.")
                                        for k in ck["model_state_dict"])
