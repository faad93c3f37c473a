"""The port's kernel modules against the JAX package, on the CPU.

K1 (m2trans_tpu_torch.ops.kernels.halo_attn) and K2
(m2trans_tpu_torch.ops.kernels.tail_band): on CPU tensors their wrappers run
the plain versions, which are held against the JAX Pallas entry points in
interpret mode (bf16, the tolerances of tests/test_cftm_fused.py and
tests/test_tail_band.py) and against the JAX XLA compositions in f32.
The CUDA kernels themselves run only on the card
(tests/test_torch_port_cuda.py, and chip_smoke.py at the slice shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.ops.pallas.halo_attn import _cascade_xla, cftm_branch_fused
from m2trans_tpu.ops.pallas.tail_band import tail_band_apply as jax_tail_band
from m2trans_tpu.ops.tail_phase import tail_phase_apply as jax_tail_phase
from m2trans_tpu_torch.ops.kernels import build, halo_attn, tail_band
from m2trans_tpu_torch.ops.kernels.halo_attn import cftm_branch, cftm_branch_plain
from m2trans_tpu_torch.ops.kernels.tail_band import tail_band_apply
from m2trans_tpu_torch.ops.tail_phase import tail_phase_apply


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _branch_inputs(levels, cb=4, bsz=2, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    c = cb * 4 ** levels
    return dict(
        x=rng.normal(0, 1, (bsz, hw, hw, cb)).astype(np.float32),
        w=rng.normal(0, c ** -0.5, (c, 3 * c)).astype(np.float32),
        rel_h=rng.normal(0, 1, (10, c // 2)).astype(np.float32),
        rel_w=rng.normal(0, 1, (10, c // 2)).astype(np.float32),
        s=rng.uniform(0.5, 1.5, (bsz, cb)).astype(np.float32),
        t=rng.normal(0, 0.2, (bsz, cb)).astype(np.float32),
        add=rng.normal(0, 1, (bsz, hw, hw, cb)).astype(np.float32))


@pytest.mark.parametrize("levels,with_add", [(0, False), (0, True),
                                             (1, False), (1, True),
                                             (2, False), (2, True)])
def test_k1_plain_matches_pallas_bf16(levels, with_add):
    d = _branch_inputs(levels)
    bf = jnp.bfloat16
    jadd = jnp.asarray(d["add"]).astype(bf) if with_add else None
    want = np.asarray(cftm_branch_fused(
        jnp.asarray(d["x"]).astype(bf), jnp.asarray(d["w"]).astype(bf),
        jnp.asarray(d["rel_h"]), jnp.asarray(d["rel_w"]), jnp.asarray(d["s"]),
        jnp.asarray(d["t"]), x_add=jadd, r=0.5, levels=levels,
        interpret=True)).astype(np.float32)
    got = cftm_branch(
        _t(d["x"], torch.bfloat16), _t(d["w"], torch.bfloat16),
        _t(d["rel_h"]), _t(d["rel_w"]), _t(d["s"]), _t(d["t"]),
        x_add=_t(d["add"], torch.bfloat16) if with_add else None, r=0.5,
        levels=levels).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("levels,with_add", [(0, True), (1, False), (2, True)])
def test_k1_plain_matches_xla_f32(levels, with_add):
    d = _branch_inputs(levels, seed=1)
    jadd = jnp.asarray(d["add"]) if with_add else None
    want = np.asarray(_cascade_xla(
        jnp.asarray(d["x"]), jadd, jnp.asarray(d["s"]), jnp.asarray(d["t"]),
        jnp.asarray(d["w"]), jnp.asarray(d["rel_h"]), jnp.asarray(d["rel_w"]),
        block=8, halo=1, levels=levels, r=0.5,
        precision=jax.lax.Precision.HIGHEST))
    got = cftm_branch_plain(
        _t(d["x"]), _t(d["w"]), _t(d["rel_h"]), _t(d["rel_w"]), _t(d["s"]),
        _t(d["t"]), x_add=_t(d["add"]) if with_add else None, r=0.5,
        levels=levels).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _tail_params(scale, nf, seed):
    """(JAX HWIO params, port OIHW params) of one random tail."""
    rng = np.random.default_rng(seed)

    def conv(kh, cin, cout, bias=True):
        bound = (cin * kh * kh) ** -0.5
        p = {"w": rng.uniform(-bound, bound, (kh, kh, cin, cout)).astype(np.float32)}
        if bias:
            p["b"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        return p

    if scale == 4:
        jp = {"c0": conv(1, nf, 4 * nf), "c1": conv(1, nf, 4 * nf),
              "c2": conv(3, nf, 3, bias=False)}
    else:
        jp = {"c0": conv(1, nf, nf * scale * scale),
              "c1": conv(3, nf, 3, bias=False)}
    tp = {k: {n: _t(v.transpose(3, 2, 0, 1) if n == "w" else v)
              for n, v in sp.items()} for k, sp in jp.items()}
    jp = {k: {n: jnp.asarray(v) for n, v in sp.items()} for k, sp in jp.items()}
    return jp, tp


@pytest.mark.parametrize("scale,hw", [(2, (16, 16)), (3, (16, 24)),
                                      (4, (16, 16)), (4, (24, 40))])
def test_k2_plain_matches_pallas_bf16(scale, hw):
    nf = 8
    jp, tp = _tail_params(scale, nf, seed=scale)
    x = np.random.default_rng(7).normal(0, 1, (2, *hw, nf)).astype(np.float32)
    want = np.asarray(jax_tail_band(
        jp, jnp.asarray(x).astype(jnp.bfloat16), scale=scale, rgb_range=1.0,
        dtype=jnp.bfloat16, interpret=True)).astype(np.float32)
    got = tail_band_apply(tp, _t(x, torch.bfloat16), scale=scale,
                          rgb_range=1.0).float().numpy()
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got, want, atol=8e-3)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_k2_plain_matches_tail_phase_f32(scale):
    """In f32 the plain K2 (rgb_range large enough that the clamp is idle
    on these inputs) is the JAX phase-plane composition."""
    nf = 8
    jp, tp = _tail_params(scale, nf, seed=10 + scale)
    x = np.random.default_rng(8).normal(0, 1, (2, 16, 24, nf)).astype(np.float32)
    want = np.asarray(jax_tail_phase(jp, jnp.asarray(x), scale=scale,
                                     dtype=jnp.float32,
                                     precision=jax.lax.Precision.HIGHEST))
    got = tail_band_apply(tp, _t(x), scale=scale, rgb_range=1e9,
                          dtype=torch.float32).numpy()
    np.testing.assert_allclose(np.maximum(want, 0.0), got, atol=1e-5, rtol=1e-5)
    port = tail_phase_apply(tp, _t(x), scale=scale, dtype=torch.float32).numpy()
    np.testing.assert_allclose(port, want, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((16, 48), dtype=torch.bfloat16, device="meta")
    rel = torch.zeros((10, 8), device="meta")
    st = torch.zeros((1, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cftm_branch(x, w, rel, rel, st, st, levels=0)


@pytest.mark.parametrize("case,match", [
    ("levels", "levels must be"), ("dtype", "must be bf16"),
    ("size", "H, W must be multiples"), ("slice", "channel slice")])
def test_k1_launch_refuses_what_the_kernel_does_not_take(case, match):
    """The launch path checks its operands before it builds or launches
    (the checks run on any device, so they are tested here)."""
    x = torch.zeros((1, 32, 32, 16), dtype=torch.bfloat16)
    levels = 3 if case == "levels" else 1
    if case == "dtype":
        x = x.float()
    elif case == "size":
        x = torch.zeros((1, 40, 32, 16), dtype=torch.bfloat16)
    elif case == "slice":
        x = torch.zeros((1, 32, 32, 32), dtype=torch.bfloat16)[..., ::2]
    c = 64
    w = torch.zeros((c, 3 * c), dtype=torch.bfloat16)
    rel, st = torch.zeros((10, c // 2)), torch.zeros((1, 16))
    with pytest.raises(ValueError, match=match):
        halo_attn._launch(x, w, rel, rel, st, st, None, 0.5, levels, 8, 1)


def test_k2_launch_refuses_what_the_kernel_does_not_take():
    y = torch.zeros((1, 8, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tail_band._launch(y, *[None] * 9, 4, 1.0)
    with pytest.raises(ValueError, match="scale must be"):
        tail_band._launch(y, *[None] * 9, 5, 1.0)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No fallback: without nvcc the build raises."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so it is rebuilt."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path()
    src.write_text("// two")
    assert build.library_path() != first
    assert first.parent == build.BUILD_DIR
