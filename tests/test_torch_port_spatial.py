"""The port's spatially sharded forward (``parallel/spatial.py``) on gloo CPU
ranks, against the JAX package's ``spatial_sharded_forward`` on conftest's
8-device CPU mesh (its Pallas kernels in interpret mode) and against the
port's own single-device forward; the same weights on both sides through
``train/jax_params.py``.

Tolerances, with their reasons:

* f32: atol 2e-4 (tests/test_spatial.py's bound; the two differ in the
  order of float sums only);
* bf16 with the kernels (their plain versions on the CPU) against JAX's bf16
  Pallas sharded forward: mean 2e-2, the bound of test_spatial.py's bf16 case;
* the tail on LR-extended shards (K2's plain version) against the unsharded
  tail: exactly equal.

The ranks run in fresh processes (``mesh.run_ranks``: a 120 s process
timeout and a 60 s group timeout, so a deadlock fails a test instead of
hanging the suite); ``tests/torch_ranks.py`` holds what they run.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import Mesh
from PIL import Image

import torch_ranks
from torch_ranks import run_launcher
from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.parallel.spatial import spatial_sharded_forward as jax_sharded
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import (
    ComputePolicy,
    init_m2trans,
    m2trans_apply,
    tail_apply,
)
from m2trans_tpu_torch.parallel import spatial
from m2trans_tpu_torch.parallel.mesh import run_ranks
from m2trans_tpu_torch.train.convert import reference_state_dict
from m2trans_tpu_torch.train.jax_params import module_from_params

# name: (config, frame (B, H, W), JAX mesh size, port rank counts). Heights
# split into 32-row units: at 4 ranks a shard is 32 or 64 rows, below the
# 96-row halo, so the halo comes over several hops; x2 at 2 ranks is the
# single-hop case (128-row shards), with batch 2 and W = 45 (pad and crop).
F32_CASES = {
    "x2": (dict(scale=2, n_feats=8, n_blocks=1), (2, 256, 45), 4, (2, 4)),
    "x3": (dict(scale=3, n_feats=8, n_blocks=2), (1, 128, 32), 4, (2, 4)),
    "x4": (dict(scale=4, n_feats=8, n_blocks=1), (1, 128, 32), 2, (2, 4)),
}
BF16_CASE = (dict(scale=2, n_feats=8, n_blocks=1), (1, 64, 32), 2)
UNEVEN = (dict(scale=2, n_feats=8, n_blocks=1), (1, 96, 64))  # pad32 96
# the 2-D (data, space) mesh on 4 ranks as 2 x 2 (tests/test_spatial.py's
# test_data_space_2d_mesh on 2 x 2): name: (config, batch (B, H, W), policy);
# 2 images a data row, each row of 2 ranks takes single-hop halos
GRID = (2, 2)
GRID_CASES = {"2d_f32": (dict(scale=2, n_feats=8, n_blocks=1), (4, 128, 45), "f32"),
              "2d_bf16": (dict(scale=3, n_feats=8, n_blocks=1), (2, 64, 32), "bf16")}
GRID_UNEVEN = (dict(scale=2, n_feats=8, n_blocks=1), (3, 64, 32))  # 3 over 2 rows


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _grid_mesh(n_data, n_space):
    return Mesh(np.array(jax.devices()[:n_data * n_space]).reshape(n_data, n_space),
                ("data", "space"))


def _weights(kw, seed):
    params = jax_init(jax.random.PRNGKey(seed), JaxConfig(**kw))
    model = module_from_params(params, Config(**kw))
    return params, model, {k: v.numpy() for k, v in reference_state_dict(model).items()}


def _frame(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, (*shape, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """The JAX references, the port's single-device forwards and the port's
    sharded forwards on 2 and 4 ranks (with the streaming, eval and refusal
    checks of tests/torch_ranks.py at 2 ranks)."""
    jax_out, single, cases = {}, {}, {2: [], 4: []}
    for i, (name, (kw, shape, jn, ranks)) in enumerate(F32_CASES.items()):
        params, model, sd = _weights(kw, i)
        x = _frame(shape, i)
        jax_out[name] = np.asarray(jax_sharded(params, jnp.asarray(x), JaxConfig(**kw),
                                               mesh=_mesh(jn)))
        with torch.no_grad():
            single[name] = m2trans_apply(model, torch.from_numpy(x), Config(**kw),
                                         ComputePolicy()).numpy()
        for n in ranks:
            cases[n].append((name, kw, sd, x, "f32"))
    kw, shape, jn = BF16_CASE
    params, _, sd = _weights(kw, 7)
    x = _frame(shape, 7)
    pol = JaxPolicy(dtype=jnp.bfloat16, precision=None, use_pallas=True)
    jax_out["bf16"] = np.asarray(jax_sharded(params, jnp.asarray(x), JaxConfig(**kw),
                                             mesh=_mesh(jn), policy=pol), np.float32)
    cases[2].append(("bf16", kw, sd, x, "bf16"))
    kw, shape = UNEVEN
    for n in (2, 4):  # 96 rows do not split into 32-row units over 2 or 4
        cases[n].append(("uneven", kw, _weights(kw, 8)[2], _frame(shape, 8), "f32"))
    for i, (name, (kw, shape, pol)) in enumerate(GRID_CASES.items()):
        params, model, sd = _weights(kw, 10 + i)
        x = _frame(shape, 10 + i)
        jpol = None if pol == "f32" else JaxPolicy(dtype=jnp.bfloat16, precision=None,
                                                   use_pallas=True)
        jax_out[name] = np.asarray(jax_sharded(params, jnp.asarray(x), JaxConfig(**kw),
                                               mesh=_grid_mesh(*GRID), policy=jpol,
                                               batch_axis="data"), np.float32)
        with torch.no_grad():
            single[name] = m2trans_apply(model, torch.from_numpy(x), Config(**kw),
                                         ComputePolicy()).numpy()
        cases[4].append((name, kw, sd, x, pol, GRID))
    kw, shape = GRID_UNEVEN
    cases[4].append(("2d_uneven", kw, _weights(kw, 9)[2], _frame(shape, 9), "f32", GRID))
    port = {2: run_ranks(torch_ranks.spatial_rank, 2,
                         (cases[2], ("streaming", "auto_eval", "refusals"))),
            4: run_ranks(torch_ranks.spatial_rank, 4, (cases[4], ("refusals", "groups")))}
    return jax_out, single, port


@pytest.mark.parametrize("name,n", [(name, n) for name, c in F32_CASES.items()
                                    for n in c[3]])
def test_sharded_f32_matches_jax_and_single_device(runs, name, n):
    jax_out, single, port = runs
    got = port[n][0][name]
    assert got.shape == jax_out[name].shape == single[name].shape
    np.testing.assert_allclose(got, jax_out[name], atol=2e-4)
    np.testing.assert_allclose(got, single[name], atol=2e-4)
    for other in port[n][1:]:  # every rank holds the whole frame
        np.testing.assert_array_equal(other[name], got)


def test_sharded_bf16_kernels_match_jax_pallas(runs):
    jax_out, _, port = runs
    got = port[2][0]["bf16"]
    assert got.shape == jax_out["bf16"].shape
    assert np.abs(got - jax_out["bf16"]).mean() < 2e-2
    np.testing.assert_array_equal(port[2][1]["bf16"], got)


@pytest.mark.parametrize("n", [2, 4])
def test_uneven_height_raises(runs, n):
    msg = runs[2][n][0]["uneven"]
    assert isinstance(msg, str) and msg.startswith("ValueError") and "shards" in msg


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_refusals(runs, n):
    """A 1-D or 2-D mesh larger than the world, and ``batch_axis`` with a
    1-D mesh."""
    msgs = runs[2][n][0]["refusals"]
    for what in ("too_many", "too_many_2d"):
        assert msgs[what].startswith("ValueError")
        assert "torch.distributed.run --nproc_per_node" in msgs[what]
    assert msgs["batch_axis_1d_mesh"].startswith("ValueError")
    assert "DataSpaceMesh" in msgs["batch_axis_1d_mesh"]


@pytest.mark.parametrize("name", list(GRID_CASES))
def test_data_space_mesh_matches_jax_and_single_device(runs, name):
    """``batch_axis="data"`` on 4 ranks as a 2 x 2 (data, space) mesh against
    JAX's on a 2 x 2 mesh of conftest's CPU devices: f32 to 2e-4 (also
    against the port's single-device forward), bf16 with the kernels' plain
    versions against JAX's bf16 Pallas forward to mean 2e-2 (the bounds of
    the 1-D cases above). Every rank holds the whole batch."""
    jax_out, single, port = runs
    got = port[4][0][name]
    assert got.shape == jax_out[name].shape == single[name].shape
    if GRID_CASES[name][2] == "f32":
        np.testing.assert_allclose(got, jax_out[name], atol=2e-4)
        np.testing.assert_allclose(got, single[name], atol=2e-4)
    else:
        assert np.abs(got - jax_out[name]).mean() < 2e-2
    for other in port[4][1:]:
        np.testing.assert_array_equal(other[name], got)


def test_data_space_mesh_uneven_batch_raises(runs):
    """A batch of 3 over 2 data rows."""
    for res in runs[2][4]:
        msg = res["2d_uneven"]
        assert isinstance(msg, str) and msg.startswith("ValueError")
        assert "must divide evenly over 2 data rows" in msg


def test_one_and_two_d_meshes_do_not_collide(runs):
    """A 1-D mesh of ranks 0-1 beside a 2 x 2 mesh (rows 0-1 and 2-3,
    columns 0-2 and 1-3) in one world of 4: each rank sits at (r // 2, r %
    2), and a sum over each of its groups adds exactly that group's ranks."""
    got = [res["groups"] for res in runs[2][4]]
    assert got == [(0, 0, 3.0, 4.0, 3.0), (1, 0, 3.0, 6.0, 3.0),
                   (0, 1, 7.0, 4.0, None), (1, 1, 7.0, 6.0, None)]


def test_streaming_with_mesh_matches_single_device(runs):
    res = runs[2][2][0]["streaming"]
    assert res["shapes"] == [(1, 256, 80, 3)] * 3
    assert res["max_err"] < 2e-4


def test_eval_auto_dispatch_matches_single(runs):
    """make_forward_fn(auto_space=True) with the threshold patched to 64x64
    (JAX test_make_forward_fn_auto_dispatch_matches_single): the 64x64 frame
    goes over both ranks, the 32x32 frame stays single-device."""
    res = runs[2][2][0]["auto_eval"]
    calls64, shape64, err64 = res[64]
    calls32, shape32, err32 = res[32]
    assert calls64 == [2] and shape64 == (1, 128, 128, 3) and err64 < 2e-2
    assert calls32 == [2] and shape32 == (1, 64, 64, 3) and err32 == 0.0


def test_rank_processes_load_no_jax(runs):
    for n in (2, 4):
        assert all(r["loaded"] == [] for r in runs[2][n])


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_tail_on_extended_shards_equals_unsharded(scale, n):
    """Item 4 of the sharded tail: each row shard extended by 1 LR row from
    each neighbour, K2's plain version on it, ``scale`` HR rows cropped from
    each extended side, equals the unsharded tail exactly."""
    cfg = Config(scale=scale, n_feats=16, n_blocks=1)
    p = init_m2trans(cfg, seed=scale).tail_params()
    pol = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
    y = torch.from_numpy(np.random.default_rng(n).normal(
        0, 1, (2, 24, 20, 16)).astype(np.float32)).to(torch.bfloat16)
    hs = 24 // n
    with torch.no_grad():
        want = tail_apply(p, y, scale=scale, policy=pol, rgb_range=1.0)
        got = torch.cat([spatial.tail_extended(
            p, y[:, max(r * hs - 1, 0):(r + 1) * hs + 1], first=r == 0,
            last=r == n - 1, scale=scale, policy=pol, rgb_range=1.0)
            for r in range(n)], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


BF16 = ComputePolicy(dtype=torch.bfloat16, use_kernels=True)
FLAGSHIP = Config(scale=4, n_feats=64, n_blocks=8)


@pytest.mark.parametrize("shape,ranks,want", [
    ((512, 512), 8, 8),    # 16 units: the largest count up to 8
    ((512, 512), 1, 1),    # one rank never shards
    ((96, 96), 8, 1),      # small frames stay single-device
    ((1024, 256), 3, 2),   # 32 units: 3 does not divide, 2 does
    ((300, 1024), 8, 5),   # 10 units: 5
])
def test_auto_space_rule(shape, ranks, want):
    assert spatial.auto_space_count([shape], FLAGSHIP, BF16, ranks) == want


def test_auto_space_rule_cases_that_differ_from_jax():
    """f32 never shards (as in JAX). A 300x512 bf16 frame (153,600 px) shards
    in JAX only because its Pallas VMEM gate (``fused_gate_ok``) fails at
    W = 512 (tests/test_spatial.py picks 2, 5 or 10 shards); the port has no
    VMEM gate, and the frame is below 512^2, so it stays single-device."""
    assert spatial.auto_space_count([(512, 512)], FLAGSHIP, ComputePolicy(), 8) == 1
    assert spatial.auto_space_count([(300, 512)], FLAGSHIP, BF16, 8) == 1


def test_auto_space_rule_mixed_shapes():
    """JAX test_auto_space_mesh_multi_mixed_shapes: the count divides every
    frame's padded height; none shared -> single-device; and a single shape
    decides as auto_space_mesh does."""
    assert spatial.auto_space_count([(512, 512), (300, 512)], FLAGSHIP, BF16, 8) == 2
    assert spatial.auto_space_count([(512, 512), (96 * 3, 512)], FLAGSHIP, BF16, 8) == 1
    assert spatial.auto_space_mesh(512, 512, FLAGSHIP, BF16) is None  # one rank here


def _infer_args(tmp_path):
    """The infer CLI's arguments for a tiny x2 model and two frames whose
    padded height is 64 rows (2 units of 32) on the CPU."""
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    pt = tmp_path / "model.pt"
    torch.save({"model_state_dict": reference_state_dict(init_m2trans(cfg, seed=3), True)},
               pt)
    yml = tmp_path / "cfg.yml"
    yml.write_text(yaml.safe_dump({"scale": 2, "n_feats": 8, "n_blocks": 1}))
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for name, hw in (("a.png", (64, 40)), ("b.png", (50, 24))):  # pad32: 64, 64
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(frames / name)
    return ["--config", str(yml), "--model_path", str(pt), "--input", str(frames),
            "--device", "cpu"]


def test_infer_cli_two_ranks_matches_one(tmp_path, capsys):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    m2trans_tpu_torch.infer --mesh-space 2`` on the CPU: rank 0 alone writes
    the PNGs and the report; they are within 1 level of ``--mesh-space
    1``'s (f32)."""
    from m2trans_tpu_torch import infer

    base = _infer_args(tmp_path) + ["--f32"]
    infer.main(base + ["--output", str(tmp_path / "one"), "--mesh-space", "1"])
    capsys.readouterr()
    out = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", "-m", "m2trans_tpu_torch.infer",
                        *base, "--output", str(tmp_path / "two"), "--mesh-space", "2"])
    reports = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(reports) == 1  # rank 0's
    assert reports[0]["mesh_space"] == 2 and reports[0]["ranks"] == 2
    assert reports[0]["backend"] == "gloo" and reports[0]["frames"] == 2
    for name in ("a.png", "b.png"):
        one = np.asarray(Image.open(tmp_path / "one" / name), np.int32)
        two = np.asarray(Image.open(tmp_path / "two" / name), np.int32)
        assert one.shape == two.shape and np.abs(one - two).max() <= 1


def test_infer_cli_auto_mesh_leaves_a_rank_out(tmp_path, capsys):
    """``--mesh-space 0`` (bf16) on 3 CPU ranks with the auto threshold
    lowered to 32x32 pixels: the frames' padded height is 2 units of 32
    rows, so the auto mesh takes 2 of the 3 ranks, and rank 2 runs each
    frame single-device. Rank 0 alone prints the auto line and the report;
    its PNGs are within the bf16 bound (mean 2e-2) of ``--mesh-space 1``'s."""
    from m2trans_tpu_torch import infer

    base = _infer_args(tmp_path)
    infer.main(base + ["--output", str(tmp_path / "one"), "--mesh-space", "1"])
    capsys.readouterr()
    out = run_launcher([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "3", "tests/torch_ranks.py", str(32 * 32),
                        *base, "--output", str(tmp_path / "three"), "--mesh-space", "0"])
    assert out.count("## auto spatial sharding: 2 shards over H for 2 frame "
                     "shape(s) ##") == 1
    reports = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(reports) == 1  # rank 0's
    assert reports[0]["mesh_space"] == 2 and reports[0]["ranks"] == 3
    for name in ("a.png", "b.png"):
        one = np.asarray(Image.open(tmp_path / "one" / name), np.float64)
        three = np.asarray(Image.open(tmp_path / "three" / name), np.float64)
        assert one.shape == three.shape and np.abs(one - three).mean() / 255 < 2e-2
