"""The train step's augmentations in their fixed layout, on the CPU.

The port's cutmix, cutout and noise take their host draws packed into
fixed-shape arrays and build every box mask from an iota, so that they run
inside the train step's CUDA graph (``data/augment.py``,
``train/graphed.py``). Here the masked applies are held against the slice
applies they replace (a copy of that form is kept below as the oracle) bit
for bit, over seeded draws at b = 1, 2, 4, 5 with every patch and hole
count, and against the JAX package's ``_coords_mask`` / ``jnp.where``
composition on the same draws; the train step with every augmentation on
against the step of the earlier form (the slice applies and the normal
draw before the step, the step's own augmentations off) bit for bit, and
against ``jax.value_and_grad`` on the JAX-augmented batch (loss rtol 1e-5,
gradients 1e-4 relative L2, as ``test_graphed_make_train_step_on_a_cpu_
model_is_eager_and_matches_jax``); and ``GraphedTrainStep``'s key and
static inputs through the stand-in capture of
``tests/test_torch_port_graphed_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.data import augment as jaug
from m2trans_tpu.losses import l1_loss as jax_l1
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models import policy_from_config as jax_policy
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data import augment
from m2trans_tpu_torch.models.m2trans import init_m2trans
from m2trans_tpu_torch.train.graphed import LOSS_NAMES, GraphedTrainStep
from m2trans_tpu_torch.train.jax_params import module_from_params
from m2trans_tpu_torch.train.loop import make_train_step

from test_torch_port_graphed_train import _Ctx, _FakeGraph, _Stream
from test_torch_port_train import rel_l2


# ---------------------------------------------------------------------------
# the slice applies the masked ones replace (the oracle)
# ---------------------------------------------------------------------------


def _paste(img, perm, y1, y2, x1, x2):
    img[:, y1:y2, x1:x2] = torch.stack([img[i, y1:y2, x1:x2] for i in perm])


def sliced_cutmix(lr, hr, draws, scale):
    lr, hr = lr.clone(), hr.clone()
    for lo, hi, patches in draws:
        for perm, (y1, y2, x1, x2) in patches:
            if y2 > y1 and x2 > x1:
                _paste(lr[lo:hi], perm, y1, y2, x1, x2)
                _paste(hr[lo:hi], perm, y1 * scale, y2 * scale, x1 * scale, x2 * scale)
    return lr, hr


def sliced_cutout(img, draws):
    img = img.clone()
    for lo, hi, holes in draws:
        for y1, y2, x1, x2 in holes:
            img[lo:hi, y1:y2, x1:x2] = 0
    return img


def earlier_noise(img, std, seed):
    gen = torch.Generator(device=img.device).manual_seed(seed)
    return img + std * torch.randn(img.shape, generator=gen, device=img.device,
                                   dtype=img.dtype)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _batch(b, lh, lw, scale, seed):
    rng = np.random.default_rng(seed)
    # negative pixels too: a select writes +0, a product -0 there
    lr = rng.uniform(-1, 1, (b, lh, lw, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (b, lh * scale, lw * scale, 3)).astype(np.float32)
    return torch.from_numpy(lr), torch.from_numpy(hr)


@pytest.mark.parametrize("b", [1, 2, 4, 5])
def test_masked_applies_equal_the_slice_applies_bit_for_bit(b):
    """120 seeded draws a batch size, every patch count 1..4 and hole count
    1..9 among them (boxes clipped at every edge): the packed draws through
    the masked applies give the slice applies' bits, the noise the earlier
    form's, and the inputs are left as they were."""
    scale, lh, lw = 2, 13, 11
    lr, hr = _batch(b, lh, lw, scale, 40 + b)
    lr0, hr0 = lr.clone(), hr.clone()
    rng = np.random.default_rng(b)
    n_patch, n_holes, noised = set(), set(), 0
    for _ in range(120):
        state = rng.bit_generator.state
        (mix, holes, noise, _), seed = augment.draw_augment(
            rng, b, lh, lw, cutmix=True, cutout_len=4, noise=True)
        after = rng.bit_generator.state
        rng.bit_generator.state = state  # the same draws, unpacked
        draws = augment.cutmix_draw(rng, b, lh, lw)
        hole_draws = augment.cutout_draw(rng, b, lh, lw, 4)
        noise_draw = augment.noise_draw(rng)
        assert rng.bit_generator.state == after
        n_patch |= {len(p) for _, _, p in draws}
        n_holes |= {len(h) for _, _, h in hole_draws}

        got = augment.cutmix_apply(lr, hr, torch.from_numpy(mix), scale)
        want = sliced_cutmix(lr, hr, draws, scale)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        got = augment.cutout_apply(lr, torch.from_numpy(holes))
        assert torch.equal(_bits(got), _bits(sliced_cutout(lr, hole_draws)))
        normal = torch.full(lr.shape, float("nan"))
        if seed is not None:
            augment.normal_draw(normal, seed)
            noised += 1
            want = earlier_noise(lr, *noise_draw)
        else:
            want = lr
        got = augment.noise_apply(lr, torch.from_numpy(noise), normal)
        assert torch.equal(_bits(got), _bits(want))
    assert n_patch >= {1, 2, 3, 4} and n_holes == set(range(10)) and noised
    assert torch.equal(lr, lr0) and torch.equal(hr, hr0)


@pytest.mark.parametrize("b", [1, 2, 4, 5])
def test_masked_applies_equal_jax_mask_composition(b):
    """The same packed draws against the JAX package's masks composed on
    the unpacked draws, each half on its own (``_coords_mask``,
    ``jnp.where`` of the permuted half, the keep mask's product for
    cutout, ``img + std * normal`` on the port's normal): equal."""
    scale, lh, lw = 3, 10, 12
    lr, hr = _batch(b, lh, lw, scale, 60 + b)
    rng = np.random.default_rng(100 + b)
    for _ in range(12):
        state = rng.bit_generator.state
        (mix, holes, noise, _), seed = augment.draw_augment(
            rng, b, lh, lw, cutmix=True, cutout_len=3, noise=True)
        after = rng.bit_generator.state
        rng.bit_generator.state = state
        draws = augment.cutmix_draw(rng, b, lh, lw)
        hole_draws = augment.cutout_draw(rng, b, lh, lw, 3)
        nd = augment.noise_draw(rng)
        assert rng.bit_generator.state == after

        got_lr, got_hr = augment.cutmix_apply(lr, hr, torch.from_numpy(mix), scale)
        want_lr, want_hr = jnp.asarray(lr.numpy()), jnp.asarray(hr.numpy())
        for lo, hi, patches in draws:
            jl, jh = want_lr[lo:hi], want_hr[lo:hi]
            for perm, (y1, y2, x1, x2) in patches:
                m = jaug._coords_mask(lh, lw, y1, y2, x1, x2)
                mh = jaug._coords_mask(lh * scale, lw * scale, y1 * scale, y2 * scale,
                                       x1 * scale, x2 * scale)
                p = jnp.asarray(perm)
                jl, jh = (jnp.where(m[None, :, :, None], jl[p], jl),
                          jnp.where(mh[None, :, :, None], jh[p], jh))
            want_lr, want_hr = want_lr.at[lo:hi].set(jl), want_hr.at[lo:hi].set(jh)
        np.testing.assert_array_equal(got_lr.numpy(), np.asarray(want_lr))
        np.testing.assert_array_equal(got_hr.numpy(), np.asarray(want_hr))

        got = augment.cutout_apply(lr, torch.from_numpy(holes))
        want = jnp.asarray(lr.numpy())
        for lo, hi, boxes in hole_draws:
            keep = jnp.ones((lh, lw), jnp.bool_)
            for y1, y2, x1, x2 in boxes:
                keep = keep & ~jaug._coords_mask(lh, lw, y1, y2, x1, x2)
            want = want.at[lo:hi].set(want[lo:hi] * keep[None, :, :, None])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

        normal = torch.zeros(lr.shape)
        if seed is not None:
            augment.normal_draw(normal, seed)
        got = augment.noise_apply(lr, torch.from_numpy(noise), normal)
        want = jnp.asarray(lr.numpy())
        if nd is not None:
            want = want + jnp.float32(nd[0]) * jnp.asarray(normal.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_layout_of_unequal_halves():
    """b = 5: halves of 2 and 3 rows; a slot's source rows stay in their
    half, an inactive slot keeps its rows (itself, empty box)."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        draws = augment.cutmix_draw(rng, 5, 20, 20)
        mix = augment.pack_cutmix(draws, 5)
        assert mix.shape == (augment.MAX_PATCHES, 5, 6) and mix.dtype == np.int64
        for (lo, hi, patches) in draws:
            for i in range(augment.MAX_PATCHES):
                rows = mix[i, lo:hi]
                if i < len(patches):
                    perm, box = patches[i]
                    assert (rows[:, 0] == 1).all() and (rows[:, 1:5] == box).all()
                    assert list(rows[:, 5]) == [lo + p for p in perm]
                else:
                    assert (rows[:, :5] == 0).all() and list(rows[:, 5]) == list(range(lo, hi))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


KW = dict(scale=2, n_feats=16, n_blocks=1, patch_size=32, lr=1e-3)
CUT = int(0.1 * KW["patch_size"] // KW["scale"])  # the step's cutout side


def firing_seed(b, lh):
    """The first seed whose draws fire cutmix, cutout and the noise."""
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        mix = augment.cutmix_draw(rng, b, lh, lh)
        holes = augment.cutout_draw(rng, b, lh, lh, CUT)
        if any(p for _, _, p in mix) and any(h for _, _, h in holes) \
                and augment.noise_draw(rng) is not None:
            return seed
    raise AssertionError("no seed fires every augmentation")


def _earlier_step(cfg, model, lr, hr, rng, do_cutout):
    """The step as it was: the draws in the step's order, the slice
    applies and the normal before the step, then the step with its own
    augmentations off (the same rng draws nothing more without the
    semantic loss)."""
    b, lh, lw = lr.shape[:3]
    draws = augment.cutmix_draw(rng, b, lh, lw)
    lr, hr = sliced_cutmix(lr, hr, draws, cfg.scale)
    if do_cutout:
        lr = sliced_cutout(lr, augment.cutout_draw(rng, b, lh, lw, CUT))
    nd = augment.noise_draw(rng)
    if nd is not None:
        lr = earlier_noise(lr, *nd)
    return lr, hr


@pytest.mark.parametrize("dtype,b", [("float32", 2), ("float32", 5), ("bfloat16", 2)])
def test_train_step_with_augmentations_equals_the_earlier_form_bit_for_bit(dtype, b):
    """Three steps of ``make_train_step`` (cutmix, cutout, noise) on a CPU
    model against the earlier form's three steps from the same weights
    and draws: losses and every parameter bit for bit (bf16: with
    ``use_pallas``, the kernels' plain versions on the CPU)."""
    cfg = Config(**KW, cutmix=True, data_add_noise=True, dtype=dtype,
                 use_pallas=dtype == "bfloat16", batch_size=b)
    plain = cfg.replace(cutmix=False, data_add_noise=False)
    lh = 16
    lr, hr = _batch(b, lh, lh, 2, 7)
    lr, hr = lr.abs(), hr.abs()
    got_m, want_m = init_m2trans(cfg, seed=1), init_m2trans(cfg, seed=1)
    from m2trans_tpu_torch.train.loop import make_optimizer
    step = make_train_step(cfg, got_m, make_optimizer(cfg, got_m))
    earlier = make_train_step(plain, want_m, make_optimizer(plain, want_m))
    seed = firing_seed(b, lh)
    for i in range(3):
        rng_a, rng_b = np.random.default_rng(seed + i), np.random.default_rng(seed + i)
        got = step(lr, hr, rng=rng_a, do_cutout=i != 1)
        alr, ahr = _earlier_step(cfg, want_m, lr, hr, rng_b, i != 1)
        want = earlier(alr, ahr, rng=rng_b)
        for k in LOSS_NAMES:
            assert torch.equal(got[k], want[k]), (i, k)
        assert rng_a.bit_generator.state == rng_b.bit_generator.state
    for (name, a), c in zip(got_m.named_parameters(), want_m.parameters()):
        assert torch.equal(a, c), name


def test_train_step_with_augmentations_matches_jax():
    """One f32 step with every augmentation fired against
    ``jax.value_and_grad`` of the JAX loss on the batch that the JAX mask
    composition makes from the same draws (and the port's normal): loss
    rtol 1e-5, gradients 1e-4 relative L2."""
    kw = dict(KW, batch_size=4)
    cfg = Config(**kw, cutmix=True, data_add_noise=True)
    jcfg = JaxConfig(**kw)
    params = jax_init(jax.random.PRNGKey(6), jcfg)
    lr, hr = _batch(4, 16, 16, 2, 8)
    lr, hr = lr.abs(), hr.abs()
    seed = firing_seed(4, 16)
    rng = np.random.default_rng(seed)
    draws = augment.cutmix_draw(rng, 4, 16, 16)
    holes = augment.cutout_draw(rng, 4, 16, 16, CUT)
    nd = augment.noise_draw(rng)
    jl, jh = jnp.asarray(lr.numpy()), jnp.asarray(hr.numpy())
    for lo, hi, patches in draws:
        a, c = jl[lo:hi], jh[lo:hi]
        for perm, (y1, y2, x1, x2) in patches:
            m = jaug._coords_mask(16, 16, y1, y2, x1, x2)
            mh = jaug._coords_mask(32, 32, 2 * y1, 2 * y2, 2 * x1, 2 * x2)
            p = jnp.asarray(perm)
            a = jnp.where(m[None, :, :, None], a[p], a)
            c = jnp.where(mh[None, :, :, None], c[p], c)
        jl, jh = jl.at[lo:hi].set(a), jh.at[lo:hi].set(c)
    for lo, hi, boxes in holes:
        keep = jnp.ones((16, 16), jnp.bool_)
        for y1, y2, x1, x2 in boxes:
            keep = keep & ~jaug._coords_mask(16, 16, y1, y2, x1, x2)
        jl = jl.at[lo:hi].set(jl[lo:hi] * keep[None, :, :, None])
    normal = augment.normal_draw(torch.empty(lr.shape), nd[1])
    jl = jl + jnp.float32(nd[0]) * jnp.asarray(normal.numpy())
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


def test_graphed_train_step_holds_the_augmentations(monkeypatch):
    """``make_train_step``'s device part under a ``GraphedTrainStep`` with
    the stand-in capture (a replay reruns the step on the static inputs):
    the key makes cutmix, cutout and the noise static (JAX's static
    ``do_cutout``: a graph with cutout and one without), the static inputs
    hold each step's packed draws and normal, and the replayed steps equal
    the eager ones bit for bit."""
    for name, value in (("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", _Ctx), ("graph", _Ctx), ("CUDAGraph", _FakeGraph),
                        ("graph_pool_handle", lambda: "pool")):
        monkeypatch.setattr(torch.cuda, name, value)
    cfg = Config(**KW, cutmix=True, data_add_noise=True, batch_size=2)
    lr, hr = _batch(2, 16, 16, 2, 9)
    lr, hr = lr.abs(), hr.abs()

    def make():
        model = init_m2trans(cfg, seed=2)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                               lr=torch.tensor(1e-3), betas=(0.9, 0.999), eps=1e-8)
        return model, opt, make_train_step(cfg, model, opt)

    model, opt, step = make()
    runner = GraphedTrainStep(step.device_step, [p for p in model.parameters()
                                                 if p.requires_grad], opt)
    monkeypatch.setattr(runner, "_check_optimizer", lambda: None)
    real_capture = runner._capture

    def capture(key, args):  # records the step: its effects are put back
        snap = runner._snapshot()
        entry = real_capture(key, args)
        runner._restore(snap)

        def rerun():
            entry.out.copy_(runner.step_fn(*entry.inputs))
        entry.graph.fn = rerun
        return entry

    monkeypatch.setattr(runner, "_capture", capture)
    step.graphed = runner
    eager_model, _, eager = make()
    seed = firing_seed(2, 16)
    for i, cut in enumerate((True, True, False, True, False)):
        got = step(lr, hr, rng=np.random.default_rng(seed + i), do_cutout=cut)
        want = eager(lr, hr, rng=np.random.default_rng(seed + i), do_cutout=cut)
        for k in LOSS_NAMES:
            assert torch.equal(got[k], want[k]), (i, k)
        rng = np.random.default_rng(seed + i)
        (mix, holes, noise, _), nseed = augment.draw_augment(
            rng, 2, 16, 16, cutmix=True, cutout_len=CUT if cut else None, noise=True)
        (entry,) = [e for k, e in runner._graphs.items() if (e.inputs[5].holes is None) != cut]
        aug = entry.inputs[5]
        assert torch.equal(aug.mix, torch.from_numpy(mix))
        assert torch.equal(aug.noise, torch.from_numpy(noise))
        assert (aug.holes is None) == (not cut)
        if cut:
            assert torch.equal(aug.holes, torch.from_numpy(holes))
        if nseed is not None:
            assert torch.equal(aug.normal, augment.normal_draw(torch.empty(lr.shape), nseed))
    assert (runner.captures, runner.replays, len(runner._graphs)) == (2, 5, 2)
    augs = [key[1][5] for key in runner._graphs]  # (name, fields' layouts)
    assert all(name == "Augment" for name, _ in augs)
    assert {fields[1] is None for _, fields in augs} == {True, False}  # holes: static
    for a, c in zip(model.parameters(), eager_model.parameters()):
        assert torch.equal(a, c)
