"""The port's measurement tools (``m2trans_tpu_torch/tools/``) on the CPU at
small sizes, the counts of ``utils/roofline.py``, the release-format MedCLIP
checkpoint and the full recipe's fixtures.

On the CPU a tool runs its path with the kernels' plain versions and prints
null for every device metric; its last line is the JSON it returns. The
counts of work depend on shapes, scale, width, depth and the loss only. The
bound helpers that ``chip_smoke.py`` reads give the numbers of the formulas
it had before they moved (copied below as the oracle). The fixtures' speckle
phantom equals the JAX script's bit for bit, and their LR is JAX's bicubic
within 1 u8 level. The full-recipe tool trains one tiny epoch through the
train CLI, the port's tokenizer and a release-format ``pytorch_model.bin``.
"""

import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2trans_tpu.ops.resize import bicubic_resize as jax_bicubic
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.losses.semantic import SemanticLossFn
from m2trans_tpu_torch.models.m2trans import init_m2trans
from m2trans_tpu_torch.models.medclip.model import (
    MedCLIPConfig,
    init_medclip,
    load_medclip_torch,
    medclip_release_state_dict,
)
from m2trans_tpu_torch.tools import (
    bench_batch64,
    bench_clip_train,
    bench_latency,
    bench_scales,
    roofline,
    train_full_recipe,
)
from m2trans_tpu_torch.utils import roofline as counts
from m2trans_tpu_torch.utils.flops import model_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--n-blocks", "1", "--n-feats", "16"]


def _last_line(capsys, line):
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert printed["device"] == "cpu" and printed["power_limit_w"] is None
    assert "config" in printed and "method" in printed
    return printed


def _nulls(entry, keys):
    for k in keys:
        assert entry[k] is None, (k, entry)


def test_bench_latency_cpu(capsys, tmp_path):
    out = tmp_path / "lat.json"
    line = bench_latency.main(TINY + ["--sizes", "16", "24", "--frames", "3",
                                      "--out", str(out)])
    got = _last_line(capsys, line)
    assert json.loads(out.read_text()) == got
    assert sorted(got["sizes"]) == ["16x16", "24x24"]
    for hw, entry in ((16, got["sizes"]["16x16"]), (24, got["sizes"]["24x24"])):
        for label, nbytes in (("f32", 4), ("u8", 1)):
            e = entry[label]
            assert e["frames"] == 3 and e["samples"] == 3
            assert e["copy_back_bytes"] == (4 * hw) ** 2 * 3 * nbytes
            _nulls(e, ("p50_ms", "p90_ms", "p99_ms", "beyond_p50", "beyond_p99",
                       "captures", "device_ms"))
        _nulls(entry, ("device_chain_ms",))
    assert got["memory_reserved_gib"] is None


def test_bench_scales_cpu(capsys):
    line = bench_scales.main(TINY + ["--scales", "4", "3", "2", "--batch", "1",
                                     "--out-hw", "48"])
    got = _last_line(capsys, line)
    assert {k: v["lr_size"] for k, v in got["scales"].items()} == {"x4": 12, "x3": 16,
                                                                   "x2": 24}
    for entry in got["scales"].values():
        _nulls(entry, ("mps", "ms_per_batch", "device_ms", "split", "launches"))


def test_bench_batch64_cpu(capsys):
    line = bench_batch64.main(TINY + ["--batch", "4", "--hw", "16", "--micro", "2", "4"])
    got = _last_line(capsys, line)
    assert sorted(got["micro_batch"]) == ["2", "4"]
    for entry in got["micro_batch"].values():
        _nulls(entry, ("mps", "ms_per_batch", "device_ms", "peak_gib", "launches"))


def test_bench_clip_train_cpu(capsys):
    line = bench_clip_train.main(TINY + ["--batches", "2", "--hw", "16", "--medclip-tiny"])
    got = _last_line(capsys, line)
    assert sorted(got["steps"]) == ["L1 b2", "recipe-bf16 b2", "recipe-f32 b2"]
    for entry in got["steps"].values():
        _nulls(entry, ("ms_queued", "ms_sync", "device_ms", "peak_gib", "captures",
                       "launches_per_capture"))
    assert got["replay_vs_eager"] == {}


def test_roofline_cpu_counts_and_null_shares(capsys):
    line = roofline.main(TINY + ["--fwd-batch", "1", "--out-hw", "32", "--step-hw", "16",
                                 "--medclip-tiny"])
    got = _last_line(capsys, line)
    progs = got["programs"]
    assert sorted(progs) == sorted(roofline.PROGRAMS)
    for name, entry in progs.items():
        assert entry["flops"] > 0 and entry["bytes"] > 0
        _nulls(entry, ("ms", "device_ms", "mfu", "hbm_floor_share"))
        assert ("mfu_f32_peak" in entry) == (name in ("step-recipe", "step-f32"))
    # the f32 step does the same work as the bf16 one, on 4-byte operands
    assert progs["step-f32"]["flops"] == progs["step-L1"]["flops"]
    assert progs["step-recipe"]["flops"] > progs["step-L1"]["flops"]
    assert progs["step-f32"]["bytes"] > progs["step-L1"]["bytes"]


def test_roofline_forward_count_is_model_flops(capsys):
    """The tool's count of the x4 forward at 1 x 96x96 is
    ``utils/flops.py::model_flops`` (the complexity report's number)."""
    line = roofline.main(TINY + ["--programs", "fwd-x4", "--fwd-batch", "1",
                                 "--out-hw", "384"])
    capsys.readouterr()
    cfg = Config(scale=4, n_feats=16, n_blocks=1)
    assert line["programs"]["fwd-x4"]["flops"] == model_flops(init_m2trans(cfg, 0), cfg)


@pytest.mark.parametrize("flavour", [dict(dtype="bfloat16", use_pallas=True),
                                     dict(dtype="bfloat16", use_pallas=False),
                                     dict(dtype="float32", use_pallas=False)],
                         ids=["bf16-kernels", "bf16-plain", "f32"])
def test_counts_do_not_depend_on_the_policy(flavour):
    """Operations and compulsory bytes of the forward and the step are the
    same whatever ``use_pallas`` and the config's dtype say, and linear in
    the batch."""
    base = Config(scale=4, n_feats=16, n_blocks=1)
    cfg = base.replace(**flavour)
    model = init_m2trans(cfg, 0)
    mcfg = MedCLIPConfig.tiny()
    fn = SemanticLossFn(init_medclip(mcfg, seed=1), mcfg, None, clip_size=56)
    ref = init_m2trans(base, 0)
    assert model_flops(model, cfg, 16, 24, 2) == model_flops(ref, base, 16, 24, 2)
    assert model_flops(model, cfg, 16, 24, 2) == 2 * model_flops(model, cfg, 16, 24, 1)
    for loss in (None, fn):
        one = counts.step_flops(model, cfg, 1, 16, 16, loss)
        assert one > 0
        assert counts.step_flops(model, cfg, 2, 16, 16, loss) == 2 * one
        assert one == counts.step_flops(ref, base, 1, 16, 16, loss)
    n = sum(p.numel() for p in model.parameters())
    for f in (counts.forward_bytes, counts.step_bytes):
        assert f(cfg, n, 2, 16, 16, 2) == f(base, n, 2, 16, 16, 2)
        assert f(cfg, n, 2, 16, 16, 2) > f(cfg, n, 1, 16, 16, 2)


def test_step_counts_closed_form():
    """The bytes formulas on fixed numbers."""
    cfg = Config(scale=4)
    assert counts.forward_bytes(cfg, 100, 2, 8, 8, 2) == 2 * (2 * 64 * 3 + 2 * 1024 * 3 + 100)
    assert counts.step_bytes(cfg, 100, 2, 8, 8, 2) == (
        counts.forward_bytes(cfg, 100, 2, 8, 8, 2) + 2 * 2 * 1024 * 3 + 4 * 100 * 7)
    assert counts.step_bytes(cfg, 100, 2, 8, 8, 2, medclip_params=50) == (
        counts.step_bytes(cfg, 100, 2, 8, 8, 2) + 50 * 4 + 2 * 8 * 2 * 64)
    s = counts.shares(989e9, 3.35e9, 1.0)
    assert s["mfu"] == pytest.approx(1.0) and s["hbm_floor_share"] == pytest.approx(1.0)
    assert counts.shares(1.0, 1.0, None, f32=True) == {"mfu": None, "hbm_floor_share": None,
                                                        "mfu_f32_peak": None}


# the formulas chip_smoke.py had before they moved to utils/roofline.py
def _old_bound(bytes_moved, flops):
    t_b = bytes_moved / 3.35e12 * 1e3
    t_f = flops / 989e12 * 1e3
    return {"bound_ms": max(t_b, t_f), "bound_by": "bytes" if t_b >= t_f else "operations"}


def _old_branch_flops(shape, levels):
    bsz, h, w, cb = shape
    c, n = cb * 4 ** levels, bsz * h * w // 4 ** levels
    return n * (6.0 * c * c + 400.0 * c)


def _old_tail_flops(shape, scale):
    n, nf = shape[0] * shape[1] * shape[2], shape[3]
    stages = (2.0 * n * nf * 4 * nf + 2.0 * 4 * n * nf * 4 * nf if scale == 4
              else 2.0 * n * nf * nf * scale * scale)
    return stages + 2.0 * scale * scale * n * 9 * nf * 3


@pytest.mark.parametrize("levels", [0, 1, 2])
def test_kernel_bounds_are_the_old_formulas(levels):
    """chip_smoke's K1 / K1b / K2 / K2b / K3 / K4 bounds at the slice shapes
    (8 x 96 x 96, base width 16; 2 x 96 x 96 for the backward) from the moved
    helpers equal the formulas it had, to the last digit."""
    cb, c = 16, 16 * 4 ** levels
    body = torch.zeros(8, 96, 96, 4 * cb, dtype=torch.bfloat16)
    x = body[..., cb:2 * cb]
    add = torch.zeros(8, 96, 96, cb, dtype=torch.bfloat16)
    w = torch.zeros(c, 3 * c, dtype=torch.bfloat16)
    rel = torch.zeros(10, c // 2)
    st = torch.zeros(8, cb)
    k1_bytes = 2 * (8 * 96 * 96 * cb * 3 + c * 3 * c) + 4 * (2 * 10 * c // 2 + 2 * 8 * cb)
    assert counts.nbytes(x, w, rel, rel, st, st, add, x) == k1_bytes
    got = counts.bound(counts.nbytes(x, w, rel, rel, st, st, add, x),
                       counts.branch_flops(x, levels))
    assert got == _old_bound(k1_bytes, _old_branch_flops(x.shape, levels))
    k1b = counts.bound(2 * counts.nbytes(x, w, rel, rel, st, st, add) + counts.nbytes(x),
                       2 * counts.branch_flops(x, levels))
    want_b = 2 * (k1_bytes - 2 * 8 * 96 * 96 * cb) + 2 * 8 * 96 * 96 * cb
    assert k1b == _old_bound(want_b, 2 * _old_branch_flops(x.shape, levels))
    a, b = counts.bound(1e6, 1e9), counts.bound(3e9, 1e6)
    assert counts.add_bounds(a, b, b) == {"bound_ms": a["bound_ms"] + 2 * b["bound_ms"],
                                          "bound_by": "bytes"}
    assert counts.nbytes(None, x) == counts.nbytes(x)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_tail_and_ff_bounds_are_the_old_formulas(scale):
    y = torch.zeros(8, 96, 96, 64, dtype=torch.bfloat16)
    assert counts.tail_flops(y, scale) == _old_tail_flops(y.shape, scale)
    k3 = counts.bound(counts.nbytes(y, y, y), 2.0 * 9 * 64 * 64 * y.numel() / 64)
    assert k3 == _old_bound(3 * 2 * y.numel(), 2.0 * 9 * 64 * 64 * y.numel() / 64)
    assert k3["bound_by"] == "bytes"
    assert counts.bound(0.0, 989e9) == {"bound_ms": 1.0, "bound_by": "operations"}


def _hf_models():
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel, SwinModel
    from transformers import SwinConfig as HFSwinConfig

    tiny = MedCLIPConfig.tiny()
    v, t = tiny.vision, tiny.text
    torch.manual_seed(0)
    sv = SwinModel(HFSwinConfig(image_size=v.image_size, patch_size=v.patch_size,
                                embed_dim=v.embed_dim, depths=list(v.depths),
                                num_heads=list(v.num_heads),
                                window_size=v.window_size)).eval()
    tb = BertModel(HFBertConfig(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                                num_hidden_layers=t.num_layers,
                                num_attention_heads=t.num_heads,
                                intermediate_size=t.intermediate_size,
                                max_position_embeddings=t.max_position_embeddings),
                   add_pooling_layer=False).eval()
    return tiny, sv, tb


def test_release_state_dict_round_trip_and_keys():
    """``medclip_release_state_dict`` -> ``load_medclip_torch`` gives back
    identical tensors; its keys and shapes are those of ``transformers``'
    SwinModel / BertModel state dicts under the release's prefixes (built as
    test_torch_port_semantic.py builds them) and the projections; and a
    release state dict read in is written back unchanged."""
    tiny, sv, tb = _hf_models()
    model = init_medclip(tiny, seed=3)
    sd = medclip_release_state_dict(model)
    back = load_medclip_torch(sd, tiny)
    want, got = model.state_dict(), back.state_dict()
    assert list(want) == list(got)
    assert all(torch.equal(want[k], got[k]) for k in want)
    hf = {f"vision_model.model.{k}": v for k, v in sv.state_dict().items()}
    hf.update({f"text_model.model.{k}": v for k, v in tb.state_dict().items()})
    hf["vision_model.projection_head.weight"] = torch.randn(16, 32)
    hf["text_model.projection_head.weight"] = torch.randn(16, 32)
    hf["text_model.projection_head.bias"] = torch.randn(16)
    hf["logit_scale"] = torch.tensor(2.0)
    assert set(sd) == set(hf)
    assert all(sd[k].shape == hf[k].shape and sd[k].dtype == hf[k].dtype for k in hf)
    again = medclip_release_state_dict(load_medclip_torch(hf, tiny))
    assert all(torch.equal(again[k], hf[k]) for k in hf)


def test_release_state_dict_refuses_a_vision_bias():
    model = init_medclip(MedCLIPConfig.tiny(), seed=3)
    with torch.no_grad():
        model.vision_proj["b"].fill_(0.5)
    with pytest.raises(ValueError, match="no bias"):
        medclip_release_state_dict(model)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_full_recipe", os.path.join(ROOT, "scripts", "train_full_recipe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,shape", [(0, (384, 384)), (5, (96, 128))])
def test_speckle_phantom_equals_the_jax_script(seed, shape):
    want = _jax_script()._speckle_phantom(np.random.default_rng(seed), *shape)
    got = train_full_recipe.speckle_phantom(np.random.default_rng(seed), *shape)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert train_full_recipe.CAPTIONS == _jax_script().CAPTION_WORDS


def test_fixture_lr_matches_jax_bicubic():
    """The fixture's LR against the JAX script's: bicubic with
    ``align_corners=False``, clipped and truncated; within 1 u8 level."""
    hr = train_full_recipe.speckle_phantom(np.random.default_rng(2), 384, 384)
    x = jnp.asarray(hr, jnp.float32)[None, ..., None]
    want = np.clip(np.asarray(jax_bicubic(x, (96, 96), align_corners=False))[0, ..., 0],
                   0, 255).astype(np.uint8)
    got = train_full_recipe.downscale(hr, 4)
    assert got.shape == (96, 96)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_parse_run():
    out = ("Epoch:1, 10/20, loss: 0.5000, L1loss: 0.4, CLIPloss: 0.1 time: 3.000\n"
           "Epoch:1, 20/20, loss: 0.4000, L1loss: 0.3, CLIPloss: 0.1 time: 1.000\n"
           "[CCA-US-X4], PSNR/SSIM: 20.1000/0.5000 (Best: 20.1000/0.5000, Epoch: 1/1)\n"
           "Epoch:2, 10/20, loss: 0.3000, L1loss: 0.2, CLIPloss: 0.1 time: 9.000\n"
           "Epoch:2, 20/20, loss: 0.2000, L1loss: 0.1, CLIPloss: 0.1 time: 1.000\n"
           "[CCA-US-X4], PSNR/SSIM: 21.0000/0.6000 (Best: 21.0000/0.6000, Epoch: 2/2)\n")
    losses, vals, rate = train_full_recipe.parse_run(out, 5)
    assert losses == {1: 0.4, 2: 0.2}
    assert vals == [{"epoch": 1, "psnr": 20.1, "ssim": 0.5},
                    {"epoch": 2, "psnr": 21.0, "ssim": 0.6}]
    assert rate == 5.0


def test_full_recipe_cpu_epoch(capsys):
    """The train CLI for one tiny epoch on the CPU: the port's tokenizer on
    the fixture's vocab.txt, a tiny release-format pytorch_model.bin, UTF-16
    captions; a finite loss, one validation, null wall time."""
    line = train_full_recipe.main(["--device", "cpu", "--epochs", "1", "--n-train", "2",
                                   "--n-eval", "1", "--size", "64", "--n-feats", "8",
                                   "--n-blocks", "1", "--medclip-tiny"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(line))
    assert "## device: cpu ##" in out and "CLIPloss:" in out
    assert list(line["train_loss_last_logged_per_epoch"]) == [1]
    assert math.isfinite(line["train_loss_last_logged_per_epoch"][1])
    assert len(line["val_trajectory"]) == 1 and line["val_trajectory"][0]["psnr"] > 0
    assert line["wall_s"] is None and line["steps_per_s"] is None
    assert line["config"]["batch_size"] == 2 and line["device"] == "cpu"
