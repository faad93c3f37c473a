"""The port's training recipe (MedCLIP semantic loss, resize,
augmentations) against the JAX package, on the CPU.

The same numpy inputs (made with a seed) and the same weights (the JAX
``init_medclip`` tree, bridged by ``train.jax_params.medclip_from_jax``) on
both sides, f32 unless stated. Tolerances, with their reasons:

* resize: 1e-5 absolute (f32, two products in another order);
* encoders (Swin with a shifted block, BERT with a padded mask, the
  projections): 2e-5 absolute, the bound of tests/test_medclip.py against
  ``transformers``;
* the semantic loss, monolithic and staged: values rtol 2e-5, d loss / d sr
  rtol 1e-4 (the staged test of tests/test_medclip.py);
* bf16 encoders: within 0.05 * max(1, |f32 loss|) of the f32 loss (the JAX
  test's bound);
* the augmentations' apply halves: exact (copies only);
* one train step with the semantic loss: loss rtol 1e-5, every gradient
  1e-4 relative L2 (as the L1 step of test_torch_port_train.py).

``jax.random`` and the port's host draws (numpy) differ, so the same crop
offsets (JAX's, drawn from its key, or the port's) and augmentation boxes
(the port's) are fed to both sides.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.data import augment as jaug
from m2trans_tpu.losses import l1_loss as jax_l1
from m2trans_tpu.losses import semantic as jsem
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models import policy_from_config as jax_policy
from m2trans_tpu.models.medclip import model as jmodel
from m2trans_tpu.models.medclip.bert import BertConfig as JBertConfig
from m2trans_tpu.models.medclip.bert import bert_apply, init_bert
from m2trans_tpu.models.medclip.swin import SwinConfig as JSwinConfig
from m2trans_tpu.models.medclip.swin import init_swin, swin_apply
from m2trans_tpu.ops.resize import bicubic_resize as jax_bicubic
from m2trans_tpu.ops.resize import bilinear_resize as jax_bilinear
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data import augment
from m2trans_tpu_torch.losses import semantic
from m2trans_tpu_torch.models.m2trans import init_m2trans
from m2trans_tpu_torch.models.medclip import ParamTree
from m2trans_tpu_torch.models.medclip.bert import BertConfig, BertEncoder
from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, load_medclip_torch
from m2trans_tpu_torch.models.medclip.swin import SwinConfig, SwinEncoder
from m2trans_tpu_torch.ops.resize import bicubic_resize, bilinear_resize
from m2trans_tpu_torch.train.jax_params import medclip_from_jax, module_from_params
from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step

from test_torch_port_train import tree_kw, write_tree

# a Swin with a shifted block and its mask: stage 1 is 14x14 tokens, window 7
SHIFTED = dict(image_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 4))


def mcfgs():
    """The same MedCLIP config for both packages: tiny, with the shifted
    Swin."""
    jc = dataclasses.replace(jmodel.MedCLIPConfig.tiny(), vision=JSwinConfig(**SHIFTED))
    tc = dataclasses.replace(MedCLIPConfig.tiny(), vision=SwinConfig(**SHIFTED))
    return jc, tc


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def medclip():
    """(JAX params, JAX config, port MedCLIP, port config)."""
    jc, tc = mcfgs()
    params = jmodel.init_medclip(jax.random.PRNGKey(0), jc)
    return params, jc, medclip_from_jax(np_tree(params), tc), tc


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **kw)


def images(seed, shape=(2, 64, 64, 3)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def tokens(seed, bsz=2, seq=12, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (bsz, seq)).astype(np.int32)
    mask = np.ones((bsz, seq), np.int32)
    mask[1, 7:] = 0
    ids[1, 7:] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bicubic", "bilinear"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("out_hw", [(56, 40), (9, 13)], ids=["up", "down"])
def test_resize_matches_jax(kind, align, out_hw):
    x = np.random.default_rng(1).uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
    port, ref = {"bicubic": (bicubic_resize, jax_bicubic),
                 "bilinear": (bilinear_resize, jax_bilinear)}[kind]
    got = port(_t(x), out_hw, align_corners=align)
    assert tuple(got.shape) == (2, *out_hw, 3)
    _close(got, ref(jnp.asarray(x), out_hw, align_corners=align), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(224, 224), (17, 30)])
def test_bicubic_matches_interpolate(out_hw):
    """The reference's own call (losses.py:53-54)."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    got = bicubic_resize(_t(x).bfloat16(), out_hw)
    assert got.dtype == torch.bfloat16
    want = F.interpolate(_t(x).permute(0, 3, 1, 2), size=out_hw, mode="bicubic",
                         align_corners=True).permute(0, 2, 3, 1)
    _close(bicubic_resize(_t(x), out_hw), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def test_swin_with_shifted_block_matches_jax():
    jc, tc = JSwinConfig(**SHIFTED), SwinConfig(**SHIFTED)
    params = init_swin(jax.random.PRNGKey(3), jc)
    # unit-scale weights and biases, so the shifted block's mask and the
    # bias table move the output well past the tolerance if wrong
    params = jax.tree_util.tree_map(
        lambda a: a * 20.0 if a.ndim == 2 else a + 0.3, params)
    enc = SwinEncoder(tc, np_tree(params))
    x = np.random.default_rng(3).standard_normal((2, 56, 56, 3)).astype(np.float32)
    seq, pooled = enc(_t(x))
    jseq, jpooled = jax.jit(lambda p, v: swin_apply(p, v, jc))(params, jnp.asarray(x))
    assert tuple(seq.shape) == (2, 49, 32)
    _close(seq, jseq, atol=2e-5)
    _close(pooled, jpooled, atol=2e-5)


def test_swin_shift_and_merge_order_matter():
    """The shifted block's roll and mask and the merge order change the
    output, so the test above would see a mistake in either."""
    from m2trans_tpu_torch.models.medclip import swin

    params = np_tree(init_swin(jax.random.PRNGKey(4), JSwinConfig(**SHIFTED)))
    mask = swin._shift_attn_mask(14, 14, 7, 3)
    assert mask.shape == (4, 49, 49) and (mask == -100).any() and (mask[0] == 0).all()
    attn = ParamTree(params["stages"][0]["blocks"][1]["attn"])
    y = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 14, 14, 16))
                         .astype(np.float32) * 20)
    assert not torch.allclose(swin._attention(attn, y, 2, 7, 3, 14, 14),
                              swin._attention(attn, y, 2, 7, 0, 14, 14), atol=1e-3)
    down = ParamTree(params["stages"][0]["downsample"])
    merged = swin._patch_merge(down, y, 1e-5)
    swapped = swin._patch_merge(down, y.transpose(1, 2), 1e-5).transpose(1, 2)
    assert merged.shape == (1, 7, 7, 32)
    assert not torch.allclose(merged, swapped, atol=1e-3)


def test_bert_every_hidden_state_matches_jax():
    jc = JBertConfig(vocab_size=99, hidden_size=32, num_layers=3, num_heads=4,
                     intermediate_size=64, max_position_embeddings=64)
    tc = BertConfig(**dataclasses.asdict(jc))
    params = init_bert(jax.random.PRNGKey(5), jc)
    ids, mask = tokens(5, seq=11, vocab=99)
    last, hidden = BertEncoder(tc, np_tree(params))(_t(ids).long(), _t(mask))
    jlast, jhidden = jax.jit(lambda i, m: bert_apply(params, i, m, jc))(
        jnp.asarray(ids), jnp.asarray(mask))
    assert len(hidden) == len(jhidden) == 4
    _close(last, jlast, atol=2e-5)
    for got, want in zip(hidden, jhidden):
        _close(got, want, atol=2e-5)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("pooling", ["mixed", "last4", "cls"])
def test_encode_text_matches_jax(medclip, pooling, masked):
    params, jc, model, tc = medclip
    jc = dataclasses.replace(jc, text_pooling=pooling, masked_token_mean=masked)
    model.cfg = dataclasses.replace(tc, text_pooling=pooling, masked_token_mean=masked)
    try:
        ids, mask = tokens(6)
        got = model.encode_text(_t(ids).long(), _t(mask))
    finally:
        model.cfg = tc
    want = jax.jit(lambda i, m: jmodel.encode_text(params, i, m, jc))(
        jnp.asarray(ids), jnp.asarray(mask))
    _close(got, want, atol=2e-5)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_encode_image_matches_jax(medclip):
    params, jc, model, _ = medclip
    x = np.random.default_rng(7).uniform(0, 1, (3, 56, 56, 3)).astype(np.float32)
    want = jax.jit(lambda v: jmodel.encode_image(params, v, jc))(jnp.asarray(x))
    _close(model.encode_image(_t(x)), want, atol=2e-5)
    with pytest.raises(ValueError, match="patch"):
        model.encode_image(_t(x)[:, :54, :54])


# ---------------------------------------------------------------------------
# the semantic loss
# ---------------------------------------------------------------------------


KW = dict(n_patches=3, clip_size=56)


@pytest.mark.parametrize("faithful", [False, True])
def test_semantic_loss_and_staged_match_jax(medclip, faithful):
    """The port's monolithic and staged losses, fed the crop offsets JAX's
    ``semantic_loss`` draws from its key, against that loss: values rtol
    2e-5, d loss / d sr rtol 1e-4 (0 when faithful)."""
    params, jc, model, _ = medclip
    sr, hr = images(8)
    ids, mask = tokens(8)
    key = jax.random.PRNGKey(8)
    ys, xs = jsem.crop_offsets(key, 2, 64, 64, 2, 56)
    offsets = (np.asarray(ys), np.asarray(xs))
    j_ids, j_mask = jnp.asarray(ids), jnp.asarray(mask)

    def jfn(s):
        return jsem.semantic_loss(params, jc, s, jnp.asarray(hr), j_ids, j_mask, key,
                                  faithful=faithful, **KW)

    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(sr))
    jt = jax.jit(lambda i, m: jsem.clip_text_embed(params, jc, i, m, faithful=faithful))(
        j_ids, j_mask)
    jsim_y = jax.jit(lambda h: jsem.clip_image_sims(params, jc, h, ys, xs, jt, **KW))(
        jnp.asarray(hr))

    srt = _t(sr).requires_grad_(True)
    mono = semantic.semantic_loss(model, srt, _t(hr), _t(ids).long(), _t(mask),
                                  offsets=offsets, faithful=faithful, **KW)
    t = semantic.clip_text_embed(model, _t(ids).long(), _t(mask), faithful=faithful)
    sim_y = semantic.clip_image_sims(model, _t(hr), offsets, t, **KW)
    _close(t, jt, atol=2e-5)
    _close(sim_y, jsim_y, atol=2e-5)
    srs = _t(sr).requires_grad_(True)
    staged = semantic.semantic_loss_staged(model, srs, offsets, t, sim_y,
                                           faithful=faithful, **KW)
    for val in (mono, staged):
        assert float(val.detach()) == pytest.approx(float(jval), rel=2e-5, abs=2e-7)
    if faithful:
        assert not mono.requires_grad and not staged.requires_grad
        np.testing.assert_array_equal(np.asarray(jgrad), 0.0)
        return
    mono.backward()
    staged.backward()
    assert float(jnp.abs(jgrad).max()) > 0
    for g in (srt.grad, srs.grad):
        _close(g, jgrad, rtol=1e-4, atol=1e-6)


def test_semantic_loss_fn_staged_equals_call(medclip):
    """SemanticLossFn: the staged pair equals __call__ (the monolithic loss)
    with the same offsets, the same generator draws the same offsets, and
    no captions give 0."""
    params, jc, model, tc = medclip
    sr, hr = images(9)
    ids, mask = tokens(9)
    caps = {"input_ids": ids, "attention_mask": mask}
    fn = semantic.SemanticLossFn(model, tc, None, **KW)
    offsets = semantic.crop_offsets(np.random.default_rng(9), 2, 64, 64, 2, 56)
    const = fn.const_stage_from_params(model, _t(hr), caps, offsets=offsets)
    staged = fn.loss_staged_from_params(model, _t(sr), const)
    mono = fn(_t(sr), _t(hr), caps, offsets=offsets)
    assert float(staged) == pytest.approx(float(mono), rel=2e-5)
    # the same offsets drawn from the same generator
    const2 = fn.const_stage_from_params(model, _t(hr), caps, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(const2[0][0], offsets[0])
    assert float(fn(_t(sr), _t(hr), None)) == 0.0
    assert fn.const_stage_from_params(model, _t(hr), None) is None
    assert float(fn.loss_staged_from_params(model, _t(sr), None)) == 0.0


@pytest.mark.parametrize("case", ["one_patch", "gray"])
def test_fallback_and_gray_input_match_jax(medclip, case):
    """Images no larger than the clip size take the resized patch only; a
    1-channel image is repeated to 3 channels."""
    params, jc, model, _ = medclip
    shape = (2, 56, 48, 3) if case == "one_patch" else (2, 64, 64, 1)
    sr, hr = images(10, shape)
    ids, mask = tokens(10)
    offsets = semantic.crop_offsets(np.random.default_rng(10), 2, 64, 64, 2, 56)
    jt = jax.jit(lambda i, m: jsem.clip_text_embed(params, jc, i, m))(
        jnp.asarray(ids), jnp.asarray(mask))
    ys, xs = (jnp.asarray(o, jnp.int32) for o in offsets)
    jsim_y = jax.jit(lambda h: jsem.clip_image_sims(params, jc, h, ys, xs, jt, **KW))(
        jnp.asarray(hr))
    jfn = lambda s: jsem.semantic_loss_staged(params, jc, s, ys, xs, jt, jsim_y, **KW)  # noqa: E731
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(sr))
    srt = _t(sr).requires_grad_(True)
    got = semantic.semantic_loss(model, srt, _t(hr), _t(ids).long(), _t(mask),
                                 offsets=offsets, **KW)
    t = semantic.clip_text_embed(model, _t(ids).long(), _t(mask))
    assert semantic.clip_image_sims(model, _t(hr), offsets, t, **KW).shape == (
        1 if case == "one_patch" else 3, 2)
    assert float(got.detach()) == pytest.approx(float(jval), rel=2e-5)
    got.backward()
    _close(srt.grad, jgrad, rtol=1e-4, atol=1e-6)


def test_bf16_loss_close_to_f32(medclip):
    params, jc, model, tc = medclip
    sr, hr = images(11)
    ids, mask = tokens(11)
    caps = {"input_ids": ids, "attention_mask": mask}
    f32 = semantic.SemanticLossFn(model, tc, None, **KW)
    b16 = semantic.SemanticLossFn(model, tc, None, dtype=torch.bfloat16, **KW)
    assert b16.model.vision_proj["w"].dtype == torch.bfloat16
    assert f32.model is model and model.vision_proj["w"].dtype == torch.float32
    a = float(f32(_t(sr), _t(hr), caps))
    b = float(b16(_t(sr), _t(hr), caps))
    assert abs(a - b) < 0.05 * max(1.0, abs(a))
    assert a > 0


def test_load_medclip_release_layout_matches_jax():
    """load_medclip_torch on a release-layout state dict (random tiny
    transformers SwinModel / BertModel under the release's prefixes, as
    tests/test_medclip.py builds it): the port and JAX give the same
    embeddings."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel, SwinModel
    from transformers import SwinConfig as HFSwinConfig

    torch.manual_seed(0)
    sv = SwinModel(HFSwinConfig(image_size=56, patch_size=4, embed_dim=16, depths=[2, 2],
                                num_heads=[2, 4], window_size=7)).eval()
    tb = BertModel(HFBertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=64,
                                max_position_embeddings=64),
                   add_pooling_layer=False).eval()
    sd = {f"vision_model.model.{k}": v for k, v in sv.state_dict().items()}
    sd.update({f"text_model.model.{k}": v for k, v in tb.state_dict().items()})
    sd["vision_model.projection_head.weight"] = torch.randn(16, 32)
    sd["text_model.projection_head.weight"] = torch.randn(16, 32)
    sd["text_model.projection_head.bias"] = torch.randn(16)
    sd["logit_scale"] = torch.tensor(2.0)
    jc, tc = mcfgs()
    model = load_medclip_torch(sd, tc)
    jparams = jmodel.load_medclip_torch(sd, jc)
    assert all(not p.requires_grad for p in model.parameters())
    assert float(model.logit_scale) == 2.0
    x = np.random.default_rng(12).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    want = jax.jit(lambda v: jmodel.encode_image(jparams, v, jc))(jnp.asarray(x))
    _close(model.encode_image(_t(x)), want, atol=2e-5)
    ids, mask = tokens(12)
    want = jax.jit(lambda i, m: jmodel.encode_text(jparams, i, m, jc))(
        jnp.asarray(ids), jnp.asarray(mask))
    _close(model.encode_text(_t(ids).long(), _t(mask)), want, atol=2e-5)
    with torch.no_grad():
        hf = sv(_t(x).permute(0, 3, 1, 2))
    _close(model.vision(_t(x))[1], hf.pooler_output.numpy(), atol=2e-5)


def test_tokenize_matches_jax(tmp_path, medclip):
    from transformers import BertTokenizerFast

    params, jc, model, tc = medclip
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "ultrasound",
                                "image", "of", "carotid", "artery", "liver", "the", "a"]))
    tok = BertTokenizerFast(vocab_file=str(vocab), do_lower_case=True)
    caps = ["ultrasound image of carotid artery", "the liver image of a kidney"]
    got = semantic.SemanticLossFn(model, tc, tok, max_length=16).tokenize(caps)
    want = jsem.SemanticLossFn(params, jc, tok, max_length=16).tokenize(caps)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------


def test_clipped_box_matches_jax():
    rng = np.random.default_rng(13)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(4, 40, 2))
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        ch, cw = (int(v) for v in rng.integers(0, 45, 2))
        want = tuple(int(v) for v in jaug._clipped_box(h, w, cy, cx, ch, cw))
        assert augment.clipped_box(h, w, cy, cx, ch, cw) == want


@pytest.mark.parametrize("b", [1, 4, 5])
def test_cutmix_and_cutout_apply_match_jax(b):
    """The apply halves against JAX's _clipped_box / _coords_mask composed
    on the same draws, patch after patch from the state the last one left."""
    scale, lh, lw = 2, 12, 10
    rng = np.random.default_rng(14 + b)
    lr = rng.uniform(0, 1, (b, lh, lw, 3)).astype(np.float32)
    hr = rng.uniform(0, 1, (b, lh * scale, lw * scale, 3)).astype(np.float32)
    draw_rng = np.random.default_rng(b)
    mixed = cut = 0
    for _ in range(8):
        draws = augment.cutmix_draw(draw_rng, b, lh, lw)
        got_lr, got_hr = augment.cutmix_apply(_t(lr), _t(hr), draws, scale)
        want_lr, want_hr = jnp.asarray(lr), jnp.asarray(hr)
        for lo, hi, patches in draws:
            jl, jh = want_lr[lo:hi], want_hr[lo:hi]
            for perm, (y1, y2, x1, x2) in patches:
                m = jaug._coords_mask(lh, lw, y1, y2, x1, x2)
                mh = jaug._coords_mask(lh * scale, lw * scale, y1 * scale, y2 * scale,
                                       x1 * scale, x2 * scale)
                p = jnp.asarray(perm)
                jl, jh = (jnp.where(m[None, :, :, None], jl[p], jl),
                          jnp.where(mh[None, :, :, None], jh[p], jh))
            want_lr = want_lr.at[lo:hi].set(jl)
            want_hr = want_hr.at[lo:hi].set(jh)
            mixed += len(patches)
        np.testing.assert_array_equal(got_lr.numpy(), np.asarray(want_lr))
        np.testing.assert_array_equal(got_hr.numpy(), np.asarray(want_hr))

        holes = augment.cutout_draw(draw_rng, b, lh, lw, 3)
        got = augment.cutout_apply(_t(lr), holes)
        want = jnp.asarray(lr)
        for lo, hi, boxes in holes:
            keep = jnp.ones((lh, lw), jnp.bool_)
            for y1, y2, x1, x2 in boxes:
                keep = keep & ~jaug._coords_mask(lh, lw, y1, y2, x1, x2)
            want = want.at[lo:hi].set(want[lo:hi] * keep[None, :, :, None])
            cut += len(boxes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mixed and cut
    np.testing.assert_array_equal(lr, lr)  # inputs untouched: apply copies


def test_draws_keep_bounds_and_frequencies():
    """Over many seeded draws: each half applied with p = 0.5, n_patch
    uniform on 1..4, boxes from lam in [0.1, 0.3], n_holes uniform on 1..9,
    noise with p = 0.5 and std in [-0.01, 0.01]."""
    rng = np.random.default_rng(15)
    n = 4000
    n_patch, n_holes, stds, sides = [], [], [], []
    applied = noised = 0
    for _ in range(n):
        (_, _, pa), (lo, hi, pb) = augment.cutmix_draw(rng, 4, 100, 100)
        assert (lo, hi) == (2, 4)
        for patches in (pa, pb):
            if patches:
                applied += 1
                n_patch.append(len(patches))
            for perm, (y1, y2, x1, x2) in patches:
                assert sorted(perm) == [0, 1]
                assert 0 <= y1 <= y2 <= 100 and 0 <= x1 <= x2 <= 100
                sides.append(max(y2 - y1, x2 - x1))
        for _, _, holes in augment.cutout_draw(rng, 4, 40, 30, 6):
            if holes:
                n_holes.append(len(holes))
            for y1, y2, x1, x2 in holes:
                assert y2 - y1 <= 6 and x2 - x1 <= 6
        draw = augment.noise_draw(rng)
        if draw is not None:
            noised += 1
            stds.append(draw[0])
    assert abs(applied / (2 * n) - 0.5) < 0.03 and abs(noised / n - 0.5) < 0.03
    assert np.bincount(n_patch, minlength=5)[0] == 0 and len(set(n_patch)) == 4
    assert np.allclose(np.bincount(n_patch)[1:] / len(n_patch), 0.25, atol=0.03)
    assert set(n_holes) == set(range(1, 10))
    assert max(sides) <= int(100 * np.sqrt(0.3)) and min(stds) >= -0.01
    assert max(stds) <= 0.01 and np.mean(np.abs(stds)) > 0.004
    # the side of an unclipped box is 2 * (dim * sqrt(lam) // 2): lam >= 0.1
    assert np.percentile(sides, 99) >= 2 * (int(100 * np.sqrt(0.3)) // 2)


def test_gaussian_noise_is_seeded():
    img = torch.full((2, 8, 8, 3), 0.5)
    a = augment.gaussian_noise(img, 0.01, 7)
    assert torch.equal(a, augment.gaussian_noise(img, 0.01, 7))
    assert not torch.equal(a, augment.gaussian_noise(img, 0.01, 8))
    assert 0 < float((a - 0.5).abs().max()) < 0.06


# ---------------------------------------------------------------------------
# one train step, and the trainer with captions
# ---------------------------------------------------------------------------


def test_train_step_with_semantic_loss_matches_jax(medclip):
    """make_train_step with the semantic loss (scale 2, n_feats 8, one
    block, HR 64, clip 56) against jax.value_and_grad of JAX's
    l1 + lambda_clip * semantic_loss_staged with the same offsets."""
    params, jc, model, tc = medclip
    kw = dict(scale=2, n_feats=8, n_blocks=1, patch_size=64, batch_size=2,
              lambda_clip=0.5)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    sr_params = jax_init(jax.random.PRNGKey(16), jcfg)
    rng = np.random.default_rng(16)
    lr_np = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    hr_np = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ids, mask = tokens(16)

    fn = semantic.SemanticLossFn(model, tc, None, **KW)
    net = module_from_params(sr_params, cfg)
    opt = torch.optim.Adam([p for p in net.parameters() if p.requires_grad], lr=0.0)
    aux = make_train_step(cfg, net, opt, fn)(
        _t(lr_np), _t(hr_np), captions={"input_ids": ids, "attention_mask": mask},
        rng=np.random.default_rng(17))

    ys, xs = (jnp.asarray(o, jnp.int32) for o in semantic.crop_offsets(
        np.random.default_rng(17), 2, 64, 64, 2, 56))
    jt = jax.jit(lambda i, m: jsem.clip_text_embed(params, jc, i, m))(
        jnp.asarray(ids), jnp.asarray(mask))
    hr_j = jnp.asarray(hr_np)
    jsim_y = jax.jit(lambda h: jsem.clip_image_sims(params, jc, h, ys, xs, jt, **KW))(hr_j)
    policy = jax_policy(jcfg, for_training=True)

    def loss_fn(p):
        sr = jax_apply(p, jnp.asarray(lr_np), jcfg, policy=policy)
        l1 = jax_l1(sr, hr_j) * jcfg.lambda_l1
        clip = jsem.semantic_loss_staged(params, jc, sr, ys, xs, jt, jsim_y,
                                         **KW) * jcfg.lambda_clip
        return l1 + clip, clip

    (jloss, jclip), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(sr_params)
    assert float(aux["clip"]) > 0
    assert float(aux["clip"]) == pytest.approx(float(jclip), rel=2e-5)
    assert float(aux["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    want = params_to_torch_state_dict(np_tree(jgrads), jcfg, module_prefix=False)
    for name, p in net.named_parameters():
        if p.requires_grad:
            g, w = p.grad.double().numpy(), np.asarray(want[name], np.float64)
            assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-30), name


def write_captions(path, n=4):
    words = ["ultrasound image of carotid artery", "the liver", "a carotid image",
             "image of the liver"]
    path.write_text("\n".join(words[i % 4] for i in range(n)), encoding="utf-16")
    return str(path)


def tiny_semantic_fn(tmp_path, model, tc):
    from transformers import BertTokenizerFast

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "ultrasound",
                                "image", "of", "carotid", "artery", "liver", "the", "a"]))
    return semantic.SemanticLossFn(
        model, tc, BertTokenizerFast(vocab_file=str(vocab), do_lower_case=True),
        max_length=16, **KW)


def test_trainer_with_captions_trains_an_epoch(tmp_path, medclip, monkeypatch, capsys):
    """Trainer with a semantic loss and a utf-16 captions file: one epoch
    of 3 steps, each with cutmix, cutout and noise on; the log's CLIPloss is
    above 0."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the trainer tees stdout
    _, _, model, tc = medclip
    root = write_tree(tmp_path / "data", np.random.default_rng(18))
    kw = dict(tree_kw(root, tmp_path), patch_size=64, epochs=1, lambda_clip=0.5,
              captions_path=write_captions(tmp_path / "caps.txt"), cutmix=True,
              cutout=True, data_add_noise=True)
    trainer = Trainer(Config(**kw), device="cpu",
                      semantic_loss_fn=tiny_semantic_fn(tmp_path, model, tc))
    assert trainer._batch_captions(1, 2) == ["a carotid image", "image of the liver"]
    stat = trainer.run()
    out = capsys.readouterr().out
    clip = [float(ln.split("CLIPloss: ")[1].split()[0]) for ln in out.splitlines()
            if "CLIPloss: " in ln]
    assert len(clip) == 3 and all(c > 0 for c in clip), out
    assert stat["epochs"] == 1


def test_trainer_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config())


def test_chip_smoke_recipe_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 17 at a small size on the CPU (tiny MedCLIP,
    clip 56, one block of width 16; the kernels' plain versions, so no
    launches), its checks and the Trainer with captions included."""
    import chip_smoke

    cfg = Config(scale=4, n_feats=16, n_blocks=1, dtype="bfloat16", use_pallas=True)
    gen = torch.Generator().manual_seed(2)
    lr, hr = torch.rand(2, 96, 96, 3, generator=gen), torch.rand(2, 384, 384, 3, generator=gen)
    net = init_m2trans(cfg, seed=0)
    loss_k = float(make_train_step(cfg, net, make_optimizer(cfg, net))(lr, hr)["loss"])
    none = dict.fromkeys(("cftm_branch", "ff_conv", "tail_band_fused", "cftm_branch_bwd",
                          "tail_band_bwd"), 0)
    chip_smoke.semantic_step_phase(torch.device("cpu"), cfg, lr, hr, loss_k, none,
                                   str(tmp_path), mcfg=MedCLIPConfig.tiny(), clip_size=56,
                                   timed=False)
