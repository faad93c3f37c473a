"""The LayerNorm with the residual sum or the SiLU gate taken in
(``ops/kernels/row_norm.py``) on the CPU: the plain version against the
torch composition it stands for, bit for bit, in each form; HAT's and
MambaIR's forwards under the kernels policy against the compositions their
call sites replaced, bit for bit; the number of LayerNorms a forward sends
to the wrapper, and the paths that keep to the plain version; the
wrapper's checks. The kernel itself runs in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from h100bench.reference import hat as hat_ref
from h100bench.reference import mambair as mambair_ref
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import hat as hat_mod
from m2trans_tpu_torch.models import mambair as mambair_mod
from m2trans_tpu_torch.models import sr_blocks
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.ops.kernels import row_norm as rn
from m2trans_tpu_torch.ops.kernels.ss2d_scan import ss2d_scan

SEED = 2 ** 33 + 7
BF16_KERNELS = ComputePolicy(torch.bfloat16, True)
# the small seeded sizes of tests/test_torch_port_hat.py and _mambair.py
HAT_TINY = {"scale": 4, "colors": 3, "n_feats": 24, "n_blocks": 2, "num_heads": 2,
            "depths": [2, 2], "window_size": 4, "squeeze_factor": 6, "num_feat": 16}
MAMBAIR_TINY = {"scale": 4, "colors": 3, "n_feats": 36, "n_blocks": 2, "depths": [2, 2],
                "d_state": 16, "squeeze_factor": 6, "num_feat": 16}
FORMS = ["plain", "residual", "scaled", "gated"]


def _operands(shape, seed=0, dtype=torch.bfloat16):
    """x, the other map, the scale, gamma and beta of no special structure
    (the rows with their own offset, so no mean sits near zero)."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g) * 1.5 + torch.randn(c, generator=g)
    other = torch.randn(shape, generator=g) * 2.0
    scale = 1.0 + 0.1 * torch.randn(c, generator=g)
    w = 1.0 + 0.2 * torch.randn(c, generator=g)
    b = 0.1 * torch.randn(c, generator=g)
    return tuple(t.to(dtype) for t in (x, other, scale, w, b))


def _form_kwargs(form, other, scale):
    return {"plain": {}, "residual": {"add": other}, "scaled": {"add": other, "scale": scale},
            "gated": {"gate": other}}[form]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 37, 53, 180), (1, 9, 11, 360), (3, 5, 180)])
@pytest.mark.parametrize("form", FORMS)
def test_plain_version_is_the_torch_composition(form, shape, dtype):
    """Each form's plain version, and the wrapper on CPU tensors, against
    the ops it stands for, written out here: bit for bit, in bf16 (where
    every op rounds) and in f32."""
    x, other, scale, w, b = _operands(shape, seed=len(shape) + shape[-1], dtype=dtype)
    kw = _form_kwargs(form, other, scale)
    eps = 1e-5
    if form in ("residual", "scaled"):
        want_x = (x * scale if form == "scaled" else x) + other
        want = (want_x, F.layer_norm(want_x, (shape[-1],), w, b, eps))
    elif form == "gated":
        want = F.layer_norm(x, (shape[-1],), w, b, eps) * F.silu(other)
    else:
        want = F.layer_norm(x, (shape[-1],), w, b, eps)
    for fn in (rn.row_norm_plain, rn.row_norm):
        got = fn(x, w, b, eps, **kw)
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == 2
            assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        else:
            assert torch.equal(got, want)
            assert got.dtype == dtype and got.shape == shape


# ---------------------------------------------------------------------------
# The call sites' compositions before the kernel, kept here to hold the new
# call sites to them
# ---------------------------------------------------------------------------


def _old_layer_norm(mod, x, dtype):
    return F.layer_norm(x, mod.normalized_shape, *sr_blocks.params(mod, dtype), mod.eps)


def _old_hab_apply(blk, x, s, policy):
    dt = policy.dtype
    xn = _old_layer_norm(blk.norm1, x, dt)
    q, k, v = hat_mod._qkv(blk.attn, xn, dt)
    table = blk.attn.relative_position_bias_table
    a = hat_mod.hat_attn.window_attention_16(q, k, v, table, s.heads, blk.shift,
                                             window=s.window)
    x = x + sr_blocks.linear(blk.attn.proj, a, dt) + sr_blocks.cab_apply(
        blk.conv_block, xn, dt, s.conv_scale)
    return x + hat_mod._mlp(blk.mlp, _old_layer_norm(blk.norm2, x, dt), dt)


def _old_ocab_apply(blk, x, s, policy):
    dt = policy.dtype
    q, k, v = hat_mod._qkv(blk, _old_layer_norm(blk.norm1, x, dt), dt)
    a = hat_mod.hat_attn.overlap_attention(q, k, v, blk.relative_position_bias_table, s.heads,
                                           s.window, s.key_window)
    x = x + sr_blocks.linear(blk.proj, a, dt)
    return x + hat_mod._mlp(blk.mlp, _old_layer_norm(blk.norm2, x, dt), dt)


def _old_ss2d_apply(mod, h, policy):
    dt = policy.dtype
    d = mod.out_norm.normalized_shape[0]
    wx, wz, wp = sr_blocks.prepared(mod, "proj", dt, (mod.in_proj.weight, mod.x_proj_weight),
                                    lambda w, p: (w[:d], w[d:], p.reshape(-1, d)))
    x = F.silu(sr_blocks.conv(mod.conv2d, F.linear(h, wx), dt)).contiguous()
    z = F.linear(h, wz)
    y = ss2d_scan(x, F.linear(x, wp), *mambair_mod._scan_tables(mod))
    return sr_blocks.linear(mod.out_proj, _old_layer_norm(mod.out_norm, y, dt) * F.silu(z), dt)


def _old_vss_apply(blk, u, policy):
    dt = policy.dtype
    s1, s2 = mambair_mod._skip(blk, dt)
    x = u * s1 + _old_ss2d_apply(blk.self_attention, _old_layer_norm(blk.ln_1, u, dt), policy)
    return x * s2 + sr_blocks.cab_apply(blk.conv_blk, _old_layer_norm(blk.ln_2, x, dt), dt)


def _old_norm(mod, x, policy):
    """The stem's and the body's LayerNorm as the call sites made it."""
    return _old_layer_norm(mod, x, policy.dtype)


def _models():
    hat_cfg = Config(model="HAT", scale=4, colors=3, n_feats=24, n_blocks=2, num_heads=2,
                     extras={k: v for k, v in HAT_TINY.items()
                             if k not in ("scale", "colors", "n_feats", "n_blocks",
                                          "num_heads")})
    mambair_cfg = Config(model="MambaIR", scale=4, colors=3, n_feats=36, n_blocks=2,
                         extras={k: v for k, v in MAMBAIR_TINY.items()
                                 if k not in ("scale", "colors", "n_feats", "n_blocks")})
    with torch.device("meta"):
        hat_net, mambair_net = hat_mod.HAT(hat_cfg), mambair_mod.MambaIR(mambair_cfg)
    hat_net = hat_mod.load_hat_state_dict(hat_net.to_empty(device="cpu"),
                                          hat_ref.state_dict(HAT_TINY, SEED, "cpu"))
    mambair_net = mambair_mod.load_mambair_state_dict(
        mambair_net.to_empty(device="cpu"), mambair_ref.state_dict(MAMBAIR_TINY, SEED, "cpu"))
    return {"HAT": (hat_mod, hat_mod.hat_apply, hat_net, hat_cfg, 14),
            "MambaIR": (mambair_mod, mambair_mod.mambair_apply, mambair_net, mambair_cfg, 14)}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["HAT", "MambaIR"])
def test_forward_under_the_kernels_policy_is_the_replaced_composition(models, name,
                                                                      monkeypatch):
    """``hat_apply`` / ``mambair_apply`` in bf16 under the kernels policy on
    the CPU against the same forward with the blocks' and the stem's
    LayerNorms, residual sums and gate as they were composed before the
    kernel: the same bits."""
    mod, apply, net, cfg, _ = models[name]
    x = torch.rand(2, 10, 13, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = apply(net, x, cfg, BF16_KERNELS)
        monkeypatch.setattr(mod, "layer_norm", _old_norm)
        if name == "HAT":
            monkeypatch.setattr(mod, "hab_apply", _old_hab_apply)
            monkeypatch.setattr(mod, "ocab_apply", _old_ocab_apply)
        else:
            monkeypatch.setattr(mod, "vss_apply", _old_vss_apply)
        want = apply(net, x, cfg, BF16_KERNELS)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["HAT", "MambaIR"])
def test_which_layer_norms_reach_the_wrapper(models, name, monkeypatch):
    """Under the kernels policy every LayerNorm of the forward goes to the
    wrapper: 14 at these depths (two a HAB and an OCAB, three a VSSBlock,
    the stem's, the body's; 86 and 110 at the released depths); a forward
    under autograd too (the wrapper runs the plain version for CPU tensors
    and raises on the card), with the same bits; the f32 path and the bf16
    path without kernels keep to the plain version."""
    mod, apply, net, cfg, calls = models[name]
    seen = []

    def counting(*args, **kw):
        seen.append(kw)
        return rn.row_norm(*args, **kw)

    monkeypatch.setattr(sr_blocks, "row_norm", counting)
    x = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = apply(net, x, cfg, BF16_KERNELS)
    assert len(seen) == calls
    forms = [("add" if kw.get("add") is not None else "gate" if kw.get("gate") is not None
              else "plain") for kw in seen]
    blocks = 2 * 2
    if name == "HAT":  # norm2 of each HAB and OCAB takes in the residual
        assert forms.count("add") == blocks + 2 and forms.count("gate") == 0
    else:  # ln_2 takes in the scaled residual, out_norm the gate
        assert forms.count("add") == forms.count("gate") == blocks
        assert all(kw.get("scale") is not None for kw in seen if kw.get("add") is not None)
    seen.clear()
    got = apply(net, x, cfg, BF16_KERNELS)  # parameters that want gradients
    assert len(seen) == calls and got.requires_grad and torch.equal(got.detach(), want)
    seen.clear()
    with torch.no_grad():
        apply(net, x, cfg, ComputePolicy())
        apply(net, x, cfg, ComputePolicy(torch.bfloat16, False))
    assert seen == []


def _check_raises(match, x, w, b, **kw):
    with pytest.raises(ValueError, match=match):
        rn._check(x, w, b, kw.get("add"), kw.get("scale"), kw.get("gate"))


def test_wrapper_checks():
    """The checks that run before any launch, on CPU tensors: bf16, C a
    multiple of 4 up to 384, contiguous rows of one shape, the forms kept
    apart, forward only."""
    x, other, scale, w, b = _operands((2, 5, 7, 180))
    rn._check(x, w, b, other, scale, None)
    rn._check(x, w, b, None, None, other)
    _check_raises("bf16", x.float(), w, b)
    _check_raises("bf16", x, w.float(), b)
    _check_raises("multiple of 4", x[..., :178].contiguous(), w[:178], b[:178])
    _check_raises("up to 384", torch.zeros(2, 388, dtype=torch.bfloat16),
                  torch.ones(388, dtype=torch.bfloat16), torch.zeros(388, dtype=torch.bfloat16))
    _check_raises("contiguous", x.transpose(1, 2), w, b)
    _check_raises("must be", x, w, b, add=other[:1])
    _check_raises("two forms", x, w, b, add=other, gate=other)
    _check_raises("residual form", x, w, b, scale=scale)
    _check_raises("forward only", x, w.clone().requires_grad_(True), b)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    """On a CUDA tensor the wrapper raises, and does not fall back, for
    f32 rows, C no multiple of 4, rows that are not contiguous."""
    x, other, scale, w, b = (t.to(dev) for t in _operands((2, 5, 8, 180)))
    with pytest.raises(ValueError, match="bf16"):
        rn.row_norm(x.float(), w, b, 1e-5)
    with pytest.raises(ValueError, match="multiple of 4"):
        rn.row_norm(x[..., :178].contiguous(), w[:178].contiguous(), b[:178].contiguous(), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        rn.row_norm(x.transpose(1, 2), w, b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        rn.row_norm(x, w, b, 1e-5, add=other.transpose(1, 2))
