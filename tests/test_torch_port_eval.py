"""The port's eval path against the JAX package, on the CPU.

FSIM and GMSD (m2trans_tpu_torch.metrics) on seeded numpy images against
the JAX metrics (atol 1e-5, f32 on both sides) and the float64 scipy /
numpy oracles of tests/metric_oracles.py (the tolerances the JAX metrics
are held to there: 1e-4 FSIM, 1e-5 GMSD); ``evaluate_dataset`` with
``full_metrics`` and with ``bucket``, and the eval CLI with ``--device
cpu``, against ``m2trans_tpu.train.evaluate`` and the JAX package's
``test.py`` on the same synthetic benchmark tree and weights in f32: PSNR,
FSIM and GMSD equal after the reference's rounding, SSIM within 1e-3.

Why SSIM has a tolerance: the reference's recipe divides by 255 inside
``rgb_to_ycbcr`` and multiplies by 255 after it, so SSIM sees luminances
near 4100 with a spread of ~50. Its variances E[x^2] - mu^2 then subtract
two f32 numbers near 1.7e7, whose rounding (~2 to 4 in absolute terms,
against the stabiliser C2 = 58.5) depends on the order of the window sums.
XLA's convolution and the port's shifted-slice sums order them differently,
and on one and the same SR array the two f32 SSIMs differ by up to ~7e-4;
neither is the exact value.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from m2trans_tpu.config import load_config as jax_load_config
from m2trans_tpu.data import create_datasets as jax_create_datasets
from m2trans_tpu.metrics import fsim as jax_fsim
from m2trans_tpu.metrics import gmsd as jax_gmsd
from m2trans_tpu.train.checkpoint import load_params_any as jax_load_params
from m2trans_tpu.train.evaluate import evaluate_all as jax_evaluate_all
from m2trans_tpu_torch import test as eval_cli
from m2trans_tpu_torch.config import Config, load_config
from m2trans_tpu_torch.data.pipeline import create_datasets
from m2trans_tpu_torch.metrics import fsim, gmsd
from m2trans_tpu_torch.metrics.fsim import _median
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.train.checkpoint import load_params_any
from m2trans_tpu_torch.train.convert import reference_state_dict
from m2trans_tpu_torch.train.evaluate import evaluate_all, evaluate_dataset

from metric_oracles import oracle_fsim, oracle_gmsd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSIM_TOL = 1e-3  # see the module docstring


def assert_metrics_match(got, want):
    """Every metric equal after the reference's rounding, SSIM within
    SSIM_TOL."""
    assert set(got) == set(want)
    for k in got:
        if k == "ssim":
            assert abs(got[k] - want[k]) <= SSIM_TOL, (k, got, want)
        else:
            assert got[k] == want[k], (k, got, want)


def parse_lines(out):
    """The CLI's lines -> {set: {metric: value}}."""
    res, name = {}, None
    for line in out.strip().splitlines():
        if line.startswith("["):
            name, line = line[1:].split("] ")
            res[name] = {}
        for part in line.split(","):
            k, v = part.split(":")
            res[name][k.lower()] = float(v)
    return res


def _pair(shape, seed, noise=0.08):
    """A smooth image with texture and a distorted copy, NHWC in [0, 1]."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w]
    x = rng.uniform(0, 1, shape)
    x = x + 2.0 * np.sin(xx / 7.0)[None, ..., None] * np.cos(yy / 11.0)[None, ..., None]
    x = (x - x.min()) / (x.max() - x.min())
    y = np.clip(x + rng.normal(0, noise, shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


# colour, gray, odd sizes, a batch, and the F = 2 downsample path
SHAPES = [(1, 64, 64, 3), (2, 33, 47, 3), (1, 48, 48, 1), (1, 97, 125, 3),
          (1, 384, 400, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fsim_matches_jax_and_oracle(shape):
    x, y = _pair(shape, seed=shape[1])
    got = fsim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jax_fsim(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for i in range(shape[0]):
        xi, yi = (x[i], y[i]) if shape[3] == 3 else (x[i, ..., 0], y[i, ..., 0])
        assert abs(float(got[i]) - oracle_fsim(xi, yi)) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_gmsd_matches_jax_and_oracle(shape):
    x, y = _pair(shape, seed=shape[2])
    got = gmsd(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jax_gmsd(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for i in range(shape[0]):
        xi, yi = (x[i], y[i]) if shape[3] == 3 else (x[i, ..., 0], y[i, ..., 0])
        assert abs(float(got[i]) - oracle_gmsd(xi, yi)) <= 1e-5


@pytest.mark.parametrize("name", ["fsim", "gmsd"])
def test_full_metrics_invariants_and_data_range(name):
    """Identical images score 1 (FSIM) / 0 (GMSD); more distortion scores
    worse; ``data_range`` 255 inputs give the [0, 1] score."""
    fn = {"fsim": fsim, "gmsd": gmsd}[name]
    x, y1 = _pair((1, 50, 37, 3), seed=5, noise=0.05)
    _, y2 = _pair((1, 50, 37, 3), seed=5, noise=0.3)
    t = torch.from_numpy
    same, s1, s2 = (float(fn(t(x), t(v))[0]) for v in (x, y1, y2))
    if name == "fsim":
        assert abs(same - 1.0) < 1e-4 and 0.0 < s2 < s1 < 1.0
    else:
        assert abs(same) < 1e-5 and 0.0 < s1 < s2
    s255 = float(fn(t(x * 255), t(y1 * 255), data_range=255.0)[0])
    assert abs(s255 - s1) < 1e-5


@pytest.mark.parametrize("name", ["fsim", "gmsd"])
def test_full_metrics_promote_bf16_inputs(name):
    """A bf16 SR tensor is promoted to f32 before any metric arithmetic:
    the score is that of the same values held in f32, as in the JAX
    metrics."""
    fn, jfn = {"fsim": (fsim, jax_fsim), "gmsd": (gmsd, jax_gmsd)}[name]
    x, y = _pair((1, 40, 56, 3), seed=9)
    y16 = torch.from_numpy(y).bfloat16()
    got = float(fn(torch.from_numpy(x), y16)[0])
    assert got == float(fn(torch.from_numpy(x), y16.float())[0])
    want = float(jfn(jnp.asarray(x), jnp.asarray(y).astype(jnp.bfloat16))[0])
    assert abs(got - want) <= 1e-5


def test_median_averages_the_middle_pair():
    """numpy's rule (the mean of the two middle values for an even count),
    not ``torch.median``'s lower value."""
    rng = np.random.default_rng(0)
    for n in (7, 8):
        a = rng.normal(size=(3, n)).astype(np.float32)
        np.testing.assert_allclose(_median(torch.from_numpy(a)).numpy(),
                                   np.median(a, axis=-1), rtol=1e-6)


# ---------------------------------------------------------------------------
# evaluate_dataset / evaluate_all / the CLI, against the JAX package
# ---------------------------------------------------------------------------

SCALE = 2
TINY = dict(scale=SCALE, n_feats=16, n_blocks=2)


def write_benchmark(root, rng, shapes):
    """A CCA-US (benchmark/UI5) tree: smooth HR frames of the LR shapes
    times SCALE, LR by striding, JPEGs written with Pillow."""
    hr_dir = root / "benchmark/UI5/HR"
    lr_dir = root / f"benchmark/UI5/LR_bicubic/X{SCALE}"
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(shapes):
        x, _ = _pair((1, SCALE * h, SCALE * w, 3), seed=int(rng.integers(1 << 30)))
        u8 = (x[0] * 255).astype(np.uint8)
        Image.fromarray(u8).save(hr_dir / f"e{i}.jpg", quality=95)
        Image.fromarray(u8[::SCALE, ::SCALE]).save(lr_dir / f"e{i}x{SCALE}.jpg",
                                                   quality=95)
    return root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The synthetic set, seeded weights as a reference ``.pt`` written by
    the port, and a test yml naming both."""
    import yaml

    tmp = tmp_path_factory.mktemp("eval")
    root = write_benchmark(tmp / "data", np.random.default_rng(21),
                           [(24, 40), (33, 27), (24, 40)])
    cfg = Config(**TINY)
    pt = str(tmp / f"model_x{SCALE}.pt")
    torch.save({"model_state_dict": reference_state_dict(
        init_m2trans(cfg, seed=4), module_prefix=True)}, pt)
    yml = str(tmp / "test.yml")
    with open(yml, "w") as f:
        yaml.dump(dict(TINY, model_path=pt, data_path=str(root),
                       eval_sets=["CCA-US"], dtype="float32"), f)
    return {"yml": yml, "pt": pt, "root": root}


def _jax_results(bench, **kw):
    jcfg = jax_load_config(bench["yml"])
    _, sets = jax_create_datasets(jcfg, train=False)
    return jax_evaluate_all(jax_load_params(bench["pt"], jcfg), jcfg, sets, **kw)


@pytest.mark.parametrize("kw", [dict(full_metrics=True),
                                dict(full_metrics=True, bucket=32),
                                dict(full_metrics=False, bucket=16)],
                         ids=["full", "full-bucket32", "bucket16"])
def test_evaluate_all_matches_jax(bench, kw):
    cfg = load_config(bench["yml"])
    _, sets = create_datasets(cfg, train=False)
    model = load_params_any(cfg.model_path, cfg)
    got = evaluate_all(model, cfg, sets, **kw)
    want = _jax_results(bench, **kw)
    assert list(got) == list(want) == ["CCA-US"]
    assert_metrics_match(got["CCA-US"], want["CCA-US"])
    keys = {"psnr", "ssim", "fsim", "gmsd"} if kw["full_metrics"] else {"psnr", "ssim"}
    assert set(got["CCA-US"]) == keys


def test_bucket_pads_and_crops(bench):
    """``bucket`` changes the frame the model sees (so border pixels move a
    little) and never the SR shape; the unbucketed run is the exact one."""
    cfg = load_config(bench["yml"])
    _, sets = create_datasets(cfg, train=False)
    model = load_params_any(cfg.model_path, cfg)
    ds = sets[0]["dataset"]
    exact = evaluate_dataset(model, cfg, ds)
    padded = evaluate_dataset(model, cfg, ds, bucket=64)
    assert abs(padded["psnr"] - exact["psnr"]) < 0.5
    assert evaluate_dataset(model, cfg, ds, bucket=1) == exact


def test_evaluate_bf16_close_to_f32(bench):
    """The bf16 eval (plain kernel versions on the CPU) against the f32
    one: PSNR within 0.1 dB, SSIM/FSIM/GMSD within 2e-3, the bounds the
    chip run holds the kernels to."""
    cfg = load_config(bench["yml"])
    _, sets = create_datasets(cfg, train=False)
    model = load_params_any(cfg.model_path, cfg)
    f32 = evaluate_all(model, cfg, sets, full_metrics=True)["CCA-US"]
    bf16 = evaluate_all(model, cfg, sets, full_metrics=True,
                        policy=ComputePolicy(torch.bfloat16, True))["CCA-US"]
    assert abs(bf16["psnr"] - f32["psnr"]) <= 0.1
    for k in ("ssim", "fsim", "gmsd"):
        assert abs(bf16[k] - f32[k]) <= 2e-3


def _jax_cli_output(argv, capsys, monkeypatch):
    """Run the JAX package's test.py (its main reads sys.argv)."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_cli", os.path.join(ROOT, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["test.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--no-full_metrics"], ["--bucket", "32"]],
                         ids=["full", "no-full", "bucket32"])
def test_eval_cli_prints_the_reference_lines(bench, extra, capsys, monkeypatch):
    argv = ["--config", bench["yml"], *extra]
    want = _jax_cli_output(argv, capsys, monkeypatch)
    eval_cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == \
        [ln.split(":")[0] for ln in want.splitlines()]
    got_m, want_m = parse_lines(got), parse_lines(want)
    assert list(got_m) == list(want_m) == [f"CCA-US-X{SCALE}"]
    assert_metrics_match(got_m[f"CCA-US-X{SCALE}"], want_m[f"CCA-US-X{SCALE}"])
    lines = got.strip().splitlines()
    assert lines[0].startswith(f"[CCA-US-X{SCALE}] PSNR:")
    assert (len(lines) == 2 and lines[1].startswith("FSIM:")) == (
        "--no-full_metrics" not in extra)


def test_eval_cli_options(bench, capsys, tmp_path, monkeypatch):
    """``--model_path`` overrides the yml; ``--dtype bfloat16`` runs the
    bf16 path with the kernels' wrappers (plain versions on the CPU);
    ``--save_image`` writes the SR frames."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**TINY)
    other = str(tmp_path / "other.pt")
    torch.save(reference_state_dict(init_m2trans(cfg, seed=5)), other)
    base = ["--config", bench["yml"], "--device", "cpu", "--no-full_metrics"]
    eval_cli.main(base)
    first = capsys.readouterr().out
    eval_cli.main([*base, "--model_path", other, "--save_image"])
    assert capsys.readouterr().out != first
    saved = sorted(os.listdir(tmp_path / "test_results" / "CCA-US"))
    assert saved == ["e0.jpg", "e1.jpg", "e2.jpg"]
    with Image.open(tmp_path / "test_results" / "CCA-US" / "e1.jpg") as img:
        assert img.size == (27 * SCALE, 33 * SCALE)
    eval_cli.main([*base, "--dtype", "bfloat16"])
    bf16 = capsys.readouterr().out
    psnr = [float(o.split("PSNR:")[1].split(",")[0]) for o in (first, bf16)]
    assert abs(psnr[0] - psnr[1]) <= 0.1


def test_eval_cli_needs_a_card_unless_cpu(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--config", bench["yml"]])
