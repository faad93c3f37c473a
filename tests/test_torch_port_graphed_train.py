"""The port's graphed train step and eval forward, on the CPU.

A CUDA graph exists only on the card, so here the pieces that make the
train step capturable are held against the slicing form they replace and
against the JAX package: the crops taken by one-hot products from crop
offsets that may lie on the device (bit for bit against slicing, forward
and gradient, f32 and bf16), the staged semantic loss fed such offsets
(against JAX's at ``test_semantic_loss_and_staged_match_jax``'s
tolerances: values rtol 2e-5, d loss / d sr rtol 1e-4), the train step of
``make_train_step(graphs=True)`` on a CPU model (eager, against
``jax.value_and_grad``: loss rtol 1e-5, gradients 1e-4 relative L2, as
``test_f32_train_step_matches_jax``), the Trainer's printed losses (summed
on the device in f64: the digits a host float sum prints), the
checkpoint's optimizer state (a float LR, loadable by both packages), the
bf16 u8 output quantised as JAX quantises it (bit for bit), the refusal
of orbax directories, and the graph bookkeeping through a stand-in
capture.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.losses import semantic as jsem
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.parallel.streaming import StreamingSR as JaxStreamingSR
from m2trans_tpu.train.checkpoint import load_params_any as jax_load_params_any
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.losses import semantic
from m2trans_tpu_torch.models.graphed import served
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    init_m2trans,
    m2trans_apply,
    m2trans_apply_microbatched,
)
from m2trans_tpu_torch.parallel.streaming import StreamingSR
from m2trans_tpu_torch.train import checkpoint as ckpt_lib
from m2trans_tpu_torch.train import graphed as graphed_train
from m2trans_tpu_torch.train.graphed import LOSS_NAMES, GraphedTrainStep
from m2trans_tpu_torch.train.jax_params import medclip_from_jax, module_from_params
from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step

from test_torch_port_semantic import KW, _close, _t, images, mcfgs, np_tree, tokens
from test_torch_port_train import _step_grads, rel_l2, tree_kw, write_tree


def _sliced(x, offsets, n, size):
    """The crops as slices at Python integers (the form the products
    replace)."""
    ys, xs = offsets
    return torch.stack([x[b, int(ys[i, b]):int(ys[i, b]) + size,
                          int(xs[i, b]):int(xs[i, b]) + size]
                        for i in range(n) for b in range(x.shape[0])])


def _bits(t):
    return t.detach().contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                        else torch.int32)


# ---------------------------------------------------------------------------
# crops from device offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_product_crops_equal_slicing_bit_for_bit(dtype, as_tensor):
    """Two overlapping crops an image (the recipe's 3 patches), origins at
    0 and at the last position: the one-hot products give the slices' bits,
    and x's gradient under a random cotangent too; the origins as numpy
    arrays or as int64 tensors give the same."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (3, 40, 36, 3)).astype(np.float32)).to(dtype)
    size = 24
    ys = np.array([[0, 16, 5], [3, 16, 0]])
    xs = np.array([[12, 0, 7], [12, 2, 12]])
    offsets = (torch.from_numpy(ys), torch.from_numpy(xs)) if as_tensor else (ys, xs)
    g = torch.from_numpy(rng.normal(0, 1, (6, size, size, 3)).astype(np.float32)).to(dtype)
    got_x = x.clone().requires_grad_(True)
    want_x = x.clone().requires_grad_(True)
    got = semantic._crops_at(got_x, offsets, 2, size)
    want = _sliced(want_x, (ys, xs), 2, size)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    (got * g).sum().backward()
    (want * g).sum().backward()
    assert torch.equal(_bits(got_x.grad), _bits(want_x.grad))


def test_product_crops_take_the_first_n_origins():
    x = torch.arange(2 * 10 * 10, dtype=torch.float32).reshape(2, 10, 10, 1)
    ys = np.array([[1, 2], [3, 4], [0, 0]])
    xs = np.array([[4, 3], [2, 1], [0, 0]])
    assert torch.equal(semantic._crops_at(x, (ys, xs), 2, 5),
                       _sliced(x, (ys, xs), 2, 5))


@pytest.fixture(scope="module")
def medclip():
    """(JAX params, JAX config, port MedCLIP)."""
    from m2trans_tpu.models.medclip import model as jmodel

    jc, tc = mcfgs()
    params = jmodel.init_medclip(jax.random.PRNGKey(0), jc)
    return params, jc, medclip_from_jax(np_tree(params), tc)


def test_staged_loss_from_device_offsets_matches_jax(medclip):
    """The staged semantic loss fed its crop offsets as int64 tensors (as
    the captured step feeds them) and its tokens as tensors, through
    ``SemanticLossFn``'s two stages, against JAX's ``semantic_loss`` with
    the same offsets: value rtol 2e-5, d loss / d sr rtol 1e-4."""
    params, jc, model = medclip
    sr, hr = images(11)
    ids, mask = tokens(11)
    key = jax.random.PRNGKey(11)
    ys, xs = jsem.crop_offsets(key, 2, 64, 64, 2, 56)
    offsets = (torch.from_numpy(np.array(ys, np.int64)),
               torch.from_numpy(np.array(xs, np.int64)))

    def jfn(s):
        return jsem.semantic_loss(params, jc, s, jnp.asarray(hr), jnp.asarray(ids),
                                  jnp.asarray(mask), key, **KW)

    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(sr))
    fn = semantic.SemanticLossFn(model, None, None, **KW)
    caps = {"input_ids": _t(ids).long(), "attention_mask": _t(mask).long()}
    with torch.no_grad():
        const = fn.const_stage_from_params(model, _t(hr), caps, offsets=offsets)
    srs = _t(sr).requires_grad_(True)
    staged = fn.loss_staged_from_params(model, srs, const)
    assert float(staged.detach()) == pytest.approx(float(jval), rel=2e-5, abs=2e-7)
    staged.backward()
    assert float(jnp.abs(jgrad).max()) > 0
    _close(srs.grad, jgrad, rtol=1e-4, atol=1e-6)
    # the numpy offsets give the same bits
    srn = _t(sr).requires_grad_(True)
    with torch.no_grad():
        const_np = fn.const_stage_from_params(
            model, _t(hr), {"input_ids": ids, "attention_mask": mask},
            offsets=(np.asarray(ys), np.asarray(xs)))
    again = fn.loss_staged_from_params(model, srn, const_np)
    again.backward()
    assert torch.equal(again.detach(), staged.detach()) and torch.equal(srn.grad, srs.grad)


# ---------------------------------------------------------------------------
# F5: the bf16 u8 output
# ---------------------------------------------------------------------------


def test_bf16_u8_ramp_quantises_as_jax():
    """A ramp of 4096 bf16 values in [0, 1): the port's u8 (round(y * 255)
    in bf16) equals the JAX StreamingSR's ``jnp.round(raw * 255.0)`` on the
    bf16 output, bit for bit. XLA on the CPU rounds the product to bf16
    before the round (its fusion keeps the convert pair), so the product in
    bf16 is the form both compute; an f32 product (the port's earlier
    form) differs on about 8.5% of the levels."""
    ramp = np.linspace(0, 1, 4096, endpoint=False).astype(np.float32)
    y = torch.from_numpy(ramp).bfloat16()
    want = np.asarray(jax.jit(lambda r: jnp.round(r * 255.0).astype(jnp.uint8))(
        jnp.asarray(ramp).astype(jnp.bfloat16)))
    got = served(y, True)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    f32_form = torch.round(y.float() * 255.0).to(torch.uint8).numpy()
    assert (f32_form != want).mean() > 0.05


def test_bf16_u8_of_a_forward_quantises_as_jax_streaming():
    """A small bf16 forward (x2, n_feats 8, one block): the JAX
    ``StreamingSR(output_u8=True)`` frames equal the port's quantisation
    (``served``) of the JAX bf16 forward's output, bit for bit, and the
    port's own bf16 u8 stream is ``served`` of its bf16 forward (whose
    values differ from JAX's bf16 forward where the two round in other
    places, so its levels are not held to JAX's)."""
    fields = dict(scale=2, n_feats=8, n_blocks=1)
    jcfg, cfg = JaxConfig(**fields), Config(**fields)
    params = jax_init(jax.random.PRNGKey(4), jcfg)
    model = module_from_params(params, cfg)
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
              for i in range(2)]
    jpol = JaxPolicy(dtype=jnp.bfloat16)
    raw = list(JaxStreamingSR(params, jcfg, policy=jpol).stream(frames))
    ju8 = list(JaxStreamingSR(params, jcfg, policy=jpol, output_u8=True).stream(frames))
    pol = ComputePolicy(torch.bfloat16, False)
    pu8 = list(StreamingSR(model, cfg, policy=pol, output_u8=True).stream(frames))
    for f, r, j, p in zip(frames, raw, ju8, pu8):
        assert np.asarray(r).dtype == jnp.bfloat16
        y = torch.from_numpy(np.asarray(r).astype(np.float32)).bfloat16()
        np.testing.assert_array_equal(served(y, True).numpy(), np.asarray(j))
        with torch.inference_mode():
            own = m2trans_apply_microbatched(model, torch.from_numpy(f), cfg, pol)
        np.testing.assert_array_equal(p, served(own, True).numpy())


# ---------------------------------------------------------------------------
# F4, checkpoints
# ---------------------------------------------------------------------------


def test_orbax_directories_are_refused_naming_the_converter(tmp_path):
    with pytest.raises(NotImplementedError) as err:
        ckpt_lib.load_params_any(str(tmp_path), Config(scale=2, n_feats=8, n_blocks=1))
    msg = str(err.value)
    assert "convert_checkpoint.py" in msg and "orbax" in msg
    assert "not ported yet" not in msg


def _adam_steps(model, opt, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
        opt.step()


def test_checkpoint_of_a_tensor_lr_saves_a_float_and_resumes(tmp_path):
    """An Adam whose LR is a tensor (the capturable CUDA optimizer's form;
    here on the CPU) is saved as the reference's plain Adam: a float LR and
    ``capturable`` False, the state not aliased to the live optimizer's.
    The .pt loads through both packages' ``load_params_any``, and resumes:
    into an optimizer with a tensor LR (the same tensor, refilled) and into
    the plain CPU one, each continuing as the uninterrupted run does."""
    cfg = Config(scale=2, n_feats=8, n_blocks=1)

    def tensor_lr_adam(model):
        return torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                                lr=torch.tensor(3e-3), betas=(0.9, 0.999), eps=1e-8)

    straight = init_m2trans(cfg, seed=0)
    opt = tensor_lr_adam(straight)
    _adam_steps(straight, opt, 2, seed=1)
    path = ckpt_lib.save_state(str(tmp_path), 1, 2, straight, opt, {}, {"epochs": 1})
    assert torch.is_tensor(opt.param_groups[0]["lr"])
    assert all(torch.is_tensor(st["step"]) for st in opt.state.values())
    saved = torch.load(path, weights_only=True)["optimizer_state_dict"]
    assert saved["param_groups"][0]["lr"] == pytest.approx(3e-3)
    assert isinstance(saved["param_groups"][0]["lr"], float)
    assert saved["param_groups"][0]["capturable"] is False
    _adam_steps(straight, opt, 2, seed=2)
    for name in ("tensor lr", "float lr"):
        model = init_m2trans(cfg, seed=5)
        opt2 = tensor_lr_adam(model) if name == "tensor lr" else make_optimizer(cfg, model)
        lr_t = opt2.param_groups[0]["lr"]
        assert ckpt_lib.restore_latest(str(tmp_path), 2, model, opt2)[0] == 1
        if name == "tensor lr":
            assert opt2.param_groups[0]["lr"] is lr_t and float(lr_t) == pytest.approx(3e-3)
        else:
            assert opt2.param_groups[0]["lr"] == pytest.approx(3e-3)
        assert opt2.param_groups[0]["capturable"] is False
        _adam_steps(model, opt2, 2, seed=2)
        for (k, a), b in zip(model.named_parameters(), straight.parameters()):
            assert torch.equal(a, b), (name, k)
    jcfg = JaxConfig(scale=2, n_feats=8, n_blocks=1)
    assert jax_load_params_any(path, jcfg) is not None


# ---------------------------------------------------------------------------
# the train step and the Trainer on the CPU
# ---------------------------------------------------------------------------


def test_graphed_make_train_step_on_a_cpu_model_is_eager_and_matches_jax():
    """``make_train_step(graphs=True)`` on a CPU model makes no graph
    runner and takes the eager step, which matches ``jax.value_and_grad``
    of the same loss (f32): loss rtol 1e-5, gradients 1e-4 relative L2."""
    kw = dict(scale=2, n_feats=16, n_blocks=1, patch_size=32, batch_size=2)
    cfg = Config(**kw)
    model = init_m2trans(cfg, seed=0)
    assert make_train_step(cfg, model, make_optimizer(cfg, model)).graphed is None
    params = jax_init(jax.random.PRNGKey(5), JaxConfig(**kw))
    rng = np.random.default_rng(5)
    lr_np = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    hr_np = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jloss, want, loss, got = _step_grads(cfg, JaxConfig(**kw), params, lr_np, hr_np)
    assert loss == pytest.approx(jloss, rel=1e-5)
    for name, g in got.items():
        assert rel_l2(g.numpy(), want[name]) < 1e-4, name


def test_trainer_prints_the_losses_a_host_float_sum_prints(tmp_path, monkeypatch, capsys):
    """The Trainer sums each step's losses on the device in f64 and reads
    them at ``log_every``: its printed lines and ``stat_dict['losses']``
    are those a host float summed step by step gives (the earlier form),
    over two epochs with cutmix and cutout."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the trainer tees stdout
    root = write_tree(tmp_path / "data", np.random.default_rng(9))
    kw = dict(tree_kw(root, tmp_path), cutmix=True, cutout=True, log_every=2,
              data_repeat=4)
    trainer = Trainer(Config(**kw), device="cpu")
    seen = []
    step = trainer.step

    def recorded(it, batch, do_cutout=False):
        aux = step(it, batch, do_cutout)
        seen.append([float(aux[k]) for k in LOSS_NAMES])
        return aux

    trainer.step = recorded
    stat = trainer.run()
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Epoch:")]
    per_epoch = trainer.steps_per_epoch
    want, losses = [], []
    for epoch in (1, 2):
        acc = [0.0, 0.0, 0.0]
        for it in range(per_epoch):
            acc = [a + v for a, v in zip(acc, seen[(epoch - 1) * per_epoch + it])]
            if (it + 1) % 2 == 0:
                avg = acc[0] / (it + 1)
                losses.append(avg / (it + 1))
                want.append(f"Epoch:{epoch}, {(it + 1) * 2}/{len(trainer.train_loader.dataset)}, "
                            f"loss: {avg:.4f}, L1loss: {acc[1] / (it + 1):.4f}, "
                            f"CLIPloss: {acc[2] / (it + 1):.8f} time: ")
    assert len(lines) == len(want) >= 4
    for ln, w in zip(lines, want):
        assert ln.startswith(w), (ln, w)
    assert stat["losses"] == losses


class _FakeGraph:
    """Replays by calling the captured step again into its static output,
    as a CUDA graph reruns its kernels."""

    def __init__(self):
        self.fn = None

    def replay(self):
        self.fn()


class _Ctx:
    def __init__(self, *args, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Stream:
    def wait_stream(self, other):
        pass


def test_graphed_train_step_bookkeeping_with_a_stand_in_capture(monkeypatch):
    """GraphedTrainStep on the CPU with a stand-in for the CUDA calls: a
    capture that records the step without running it (the snapshot is put
    back) and a replay that reruns it. A key's first call snapshots the
    parameters and Adam's state, runs one step (the side-stream run),
    restores them in place (Adam's fresh state zeroed) and captures, so the
    first replay equals an eager step from the same state, and so do the
    next; a new key (a sample mask) captures again; a moved optimizer
    state drops every graph; a float LR or an optimizer that is not
    capturable is refused."""
    for name, value in (("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", _Ctx), ("graph", _Ctx), ("CUDAGraph", _FakeGraph),
                        ("graph_pool_handle", lambda: "pool")):
        monkeypatch.setattr(torch.cuda, name, value)
    cfg = Config(scale=2, n_feats=8, n_blocks=1)

    def make():
        model = init_m2trans(cfg, seed=0)
        opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                               lr=torch.tensor(1e-2), betas=(0.9, 0.999), eps=1e-8)
        return model, opt

    def device_step_of(model, opt):
        def device_step(lr, hr, mask, offsets, tokens, aug):
            per = (m2trans_apply(model, lr, cfg, ComputePolicy()) - hr).abs().mean(
                dim=(1, 2, 3))
            l1 = per.mean() if mask is None else (per * mask).sum() / mask.sum()
            opt.zero_grad(set_to_none=True)
            l1.backward()
            opt.step()
            return torch.stack([l1, l1, torch.zeros(())]).detach()
        return device_step

    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    model, opt = make()
    params = [p for p in model.parameters() if p.requires_grad]
    runner = GraphedTrainStep(device_step_of(model, opt), params, opt)
    with pytest.raises(ValueError, match="capturable"):  # the CPU Adam is not
        runner(lr, hr)
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
    eager_model, eager_opt = make()
    eager = device_step_of(eager_model, eager_opt)
    eager_params = [q for q in eager_model.parameters() if q.requires_grad]
    for i in range(3):
        assert torch.equal(runner(lr, hr), eager(lr, hr, None, None, None, None)), i
        for a, b in zip(params, eager_params):
            assert torch.equal(a, b), i
        for p, q in zip(params, eager_params):
            for k, v in opt.state[p].items():
                assert torch.equal(v, eager_opt.state[q][k]), (i, k)
    assert (runner.captures, runner.replays) == (1, 3)
    mask = torch.tensor([1.0, 0.0])
    assert torch.equal(runner(lr, hr, mask), eager(lr, hr, mask, None, None, None))
    assert (runner.captures, len(runner._graphs)) == (2, 2)
    runner(lr, hr)
    eager(lr, hr, None, None, None, None)
    assert runner.captures == 2
    # a state moved by load_state_dict: every graph dropped, captured again
    opt.load_state_dict(opt.state_dict())
    assert torch.equal(runner(lr, hr), eager(lr, hr, None, None, None, None))
    assert (runner.captures, len(runner._graphs)) == (3, 1)
    for a, b in zip(params, eager_params):
        assert torch.equal(a, b)
    monkeypatch.undo()
    opt.param_groups[0]["lr"] = 1e-2
    with pytest.raises(ValueError, match="tensors"):
        GraphedTrainStep(runner.step_fn, params, opt)._check_optimizer()
    assert graphed_train.COUNTED.keys() >= {"cftm_branch_bwd", "tail_band_bwd"}
