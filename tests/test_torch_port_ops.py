"""The port's plain ops against their JAX twins (f32, atol 1e-5), and the
guard that the port never loads jax."""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu_torch.ops import (
    conv,
    halo_attention,
    norm,
    pad,
    pixel_shuffle,
    tail_phase,
    wavelet,
)

# by importlib: m2trans_tpu.ops re-exports functions under some module names
jconv, jhalo, jnorm, jpad, jps, jtail, jwav = (
    importlib.import_module(f"m2trans_tpu.ops.{m}")
    for m in ("conv", "halo_attention", "norm", "pad", "pixel_shuffle",
              "tail_phase", "wavelet"))

HI = jax.lax.Precision.HIGHEST


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("hw", [(20, 28), (32, 32), (5, 40)])
def test_pad_to_multiple(hw):
    x = _x((2, *hw, 3))
    want = jpad.pad_to_multiple(jnp.asarray(x), 32)
    got = pad.pad_to_multiple(torch.from_numpy(x), 32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("padding,k,bias", [("zeros", 3, True),
                                            ("reflect", 3, False),
                                            ("valid", 1, True)])
def test_conv2d(padding, k, bias):
    x, w, b = _x((2, 12, 16, 5)), _x((k, k, 5, 7), 1), _x((7,), 2)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                        jnp.asarray(b) if bias else None, padding=padding,
                        precision=HI)
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(b) if bias else None, padding=padding)
    _close(got, want)


def test_gelu_and_instance_norm():
    x = _x((2, 8, 12, 6)) * 3 + 1
    _close(conv.gelu_exact(torch.from_numpy(x)), jconv.gelu_exact(jnp.asarray(x)))
    _close(norm.instance_norm(torch.from_numpy(x)),
           jnorm.instance_norm(jnp.asarray(x)))
    inv, t = norm.in_stats(torch.from_numpy(x))
    _close(torch.from_numpy(x) * inv[:, None, None] + t[:, None, None],
           jnorm.instance_norm(jnp.asarray(x)), atol=2e-5)


def test_wavelets():
    x = _x((2, 8, 12, 4))
    d = wavelet.haar_dwt(torch.from_numpy(x))
    _close(d, jwav.haar_dwt(jnp.asarray(x)))
    _close(wavelet.haar_iwt(d), jwav.haar_iwt(jwav.haar_dwt(jnp.asarray(x))))
    _close(wavelet.haar_iwt(d), x)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle(r):
    x = _x((2, 5, 6, 4 * r * r))
    np.testing.assert_array_equal(pixel_shuffle.ps_weight_perm(4, r),
                                  jps.ps_weight_perm(4, r))
    _close(pixel_shuffle.pixel_shuffle(torch.from_numpy(x), r),
           jps.pixel_shuffle(jnp.asarray(x), r), atol=0)
    _close(pixel_shuffle.pixel_shuffle_fast(torch.from_numpy(x), r),
           jps.pixel_shuffle_fast(jnp.asarray(x), r), atol=0)


def test_halo_attention():
    q, k, v = _x((2, 16, 24, 8), 1), _x((2, 16, 24, 8), 2), _x((2, 16, 24, 8), 3)
    rh, rw = _x((10, 4), 4), _x((10, 4), 5)
    want = jhalo.halo_attention(*map(jnp.asarray, (q, k, v, rh, rw)),
                                precision=HI)
    got = halo_attention.halo_attention(*map(torch.from_numpy, (q, k, v, rh, rw)))
    _close(got, want)


def _tail(scale, nf=4, seed=0):
    rng = np.random.default_rng(seed)
    P = 4 if scale == 4 else scale * scale
    jp = {"c0": {"w": rng.normal(0, .3, (1, 1, nf, P * nf)).astype(np.float32),
                 "b": rng.normal(0, .3, (P * nf,)).astype(np.float32)}}
    last = rng.normal(0, .3, (3, 3, nf, 3)).astype(np.float32)
    if scale == 4:
        jp["c1"] = {"w": rng.normal(0, .3, (1, 1, nf, 4 * nf)).astype(np.float32),
                    "b": rng.normal(0, .3, (4 * nf,)).astype(np.float32)}
        jp["c2"] = {"w": last}
    else:
        jp["c1"] = {"w": last}
    tp = {k: {n: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if n == "w" else v)
              for n, v in sp.items()} for k, sp in jp.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return jp, tp


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_tail_phase(scale):
    jp, tp = _tail(scale, seed=scale)
    np.testing.assert_array_equal(tail_phase._phase_layout(scale),
                                  jtail._phase_layout(scale))
    np.testing.assert_array_equal(tail_phase._k_selector(scale),
                                  jtail._k_selector(scale))
    f32 = dict(dtype=jnp.float32, precision=HI)
    for g, w in zip(tail_phase.tail_phase_weights(tp, scale=scale, dtype=torch.float32),
                    jtail.tail_phase_weights(jp, scale=scale, **f32)):
        _close(g, w)
    x = _x((2, 8, 12, 4), 9)
    for g, w in zip(tail_phase.phase_edges(tp, torch.from_numpy(x), scale=scale,
                                           dtype=torch.float32),
                    jtail.phase_edges(jp, jnp.asarray(x), scale=scale, **f32)):
        _close(g, w)
    _close(tail_phase.tail_phase_apply(tp, torch.from_numpy(x), scale=scale,
                                       dtype=torch.float32),
           jtail.tail_phase_apply(jp, jnp.asarray(x), scale=scale, **f32))


def test_port_never_loads_jax():
    """Importing every module of the port, the test bridge
    ``train.jax_params`` and the measurement tools included, loads neither
    jax nor the JAX package, nor ``transformers``; nor does
    ``make_semantic_loss`` on a tiny MedCLIP directory (a release-format
    ``pytorch_model.bin``, ``vocab.txt``), whose tokenizer is the port's."""
    code = (
        "import pkgutil, importlib, sys, tempfile, os, torch\n"
        "import m2trans_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(m2trans_tpu_torch.__path__, 'm2trans_tpu_torch.')]\n"
        "assert 'm2trans_tpu_torch.train.jax_params' in names\n"
        "assert {'m2trans_tpu_torch.bench', 'm2trans_tpu_torch.models.graphed',\n"
        "        'm2trans_tpu_torch.train.graphed', 'm2trans_tpu_torch.models.medclip.tokenizer',\n"
        "        'm2trans_tpu_torch.utils.roofline', 'm2trans_tpu_torch.tools.timing',\n"
        "        'm2trans_tpu_torch.tools.bench_latency', 'm2trans_tpu_torch.tools.bench_scales',\n"
        "        'm2trans_tpu_torch.tools.bench_batch64', 'm2trans_tpu_torch.tools.bench_clip_train',\n"
        "        'm2trans_tpu_torch.tools.roofline', 'm2trans_tpu_torch.tools.train_full_recipe'\n"
        "        } <= set(names)\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from m2trans_tpu_torch.config import Config\n"
        "from m2trans_tpu_torch.losses.semantic import make_semantic_loss\n"
        "from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip, medclip_release_state_dict\n"
        "d = tempfile.mkdtemp()\n"
        "torch.save(medclip_release_state_dict(init_medclip(MedCLIPConfig.tiny(), 1)), os.path.join(d, 'pytorch_model.bin'))\n"
        "open(os.path.join(d, 'vocab.txt'), 'w').write('[PAD]\\n[UNK]\\n[CLS]\\n[SEP]\\nliver\\n')\n"
        "fn = make_semantic_loss(Config(medclip_path=d, medclip_tiny=True), torch.device('cpu'))\n"
        "assert fn.tokenize(['Liver'])['input_ids'][0, :4].tolist() == [2, 4, 3, 0]\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'm2trans_tpu', 'transformers'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 55


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


@pytest.mark.parametrize("name", [None] + sorted(os.listdir(CONFIGS)))
def test_config_matches_jax_loader(name):
    """The port's config loader reads every file of configs/ (and the
    defaults) into the same fields and values as the JAX package's."""
    from m2trans_tpu.config import Config as JaxConfig
    from m2trans_tpu.config import load_config as jax_load

    from m2trans_tpu_torch.config import Config, load_config

    assert ([f.name for f in dataclasses.fields(Config)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    path = None if name is None else os.path.join(CONFIGS, name)
    got, want = load_config(path), jax_load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pad_multiple == want.pad_multiple
    over = {"model_path": "m.pt", "dtype": "bfloat16", "batch_size": None}
    assert (dataclasses.asdict(load_config(path, over))
            == dataclasses.asdict(jax_load(path, over)))
