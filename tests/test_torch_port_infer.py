"""The port's serving slice on the CPU: ``python -m m2trans_tpu_torch.infer``
on tiny PNG frames with a reference-format ``.pt`` written from JAX params,
held against the JAX forward quantised to u8; plus its refusals."""

import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from m2trans_tpu.models import init_m2trans as jax_init
from m2trans_tpu.models import m2trans_apply as jax_apply
from m2trans_tpu.models.m2trans import ComputePolicy as JaxPolicy
from m2trans_tpu.train.convert import params_to_torch_state_dict
from m2trans_tpu_torch import infer
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models.m2trans import init_m2trans
from m2trans_tpu_torch.parallel.mesh import space_mesh
from m2trans_tpu_torch.parallel.streaming import StreamingSR


def _setup(tmp_path, scale=2):
    cfg = Config(scale=scale, n_feats=8, n_blocks=1)
    params = jax_init(jax.random.PRNGKey(11), cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          params_to_torch_state_dict(params, cfg).items()}
    pt = tmp_path / "model.pt"
    torch.save({"model_state_dict": sd}, pt)
    yml = tmp_path / "cfg.yml"
    yml.write_text(yaml.safe_dump({"scale": scale, "n_feats": 8, "n_blocks": 1,
                                   "dtype": "float32"}))
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    imgs = {}
    for name, hw in (("a.png", (20, 28)), ("b.png", (24, 24))):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        imageio.imwrite(frames / name, img)
        imgs[name] = img
    return cfg, params, pt, yml, frames, imgs


def test_infer_cli_cpu_matches_jax(tmp_path, capsys):
    cfg, params, pt, yml, frames, imgs = _setup(tmp_path)
    out = tmp_path / "out"
    infer.main(["--config", str(yml), "--model_path", str(pt), "--input",
                str(frames), "--output", str(out), "--device", "cpu", "--f32"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 2 and report["device"] == "cpu"
    assert {"fps", "output_megapixels_per_sec", "p50_ms", "p99_ms"} <= set(report)
    for name, img in imgs.items():
        got = imageio.imread(out / name)
        x = jnp.asarray(img.astype(np.float32)[None] / 255.0)
        y = np.asarray(jax_apply(params, x, cfg, policy=JaxPolicy()))[0]
        want = np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8)
        assert got.shape == (img.shape[0] * 2, img.shape[1] * 2, 3)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_infer_cli_refusals(tmp_path):
    _, _, pt, yml, frames, _ = _setup(tmp_path)
    base = ["--config", str(yml), "--model_path", str(pt), "--input", str(frames)]
    # --mesh-space 2 needs a world of 2 ranks; this process is one
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        infer.main(base + ["--mesh-space", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(base + ["--device", "cuda"])
    with pytest.raises(NotImplementedError, match="orbax"):
        infer.main(["--config", str(yml), "--model_path", str(tmp_path),
                    "--input", str(frames), "--device", "cpu"])


def test_streaming_order_u8_and_stats():
    """stream() yields frames in order with depth frames in flight, the u8
    output is round(x*255) of the float output, and a mesh that is no
    SpaceMesh, or one larger than the world, is refused."""
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    model = init_m2trans(cfg, seed=2)
    from m2trans_tpu_torch.models.m2trans import ComputePolicy

    run = StreamingSR(model, cfg, policy=ComputePolicy())
    frames = [np.random.default_rng(i).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
              for i in range(3)]
    outs = list(run.stream(frames, collect_stats=True))
    assert len(outs) == 3 and len(run.latencies_s) == 3
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, run(f))
    assert set(run.latency_percentiles()) == {"p50_s", "p90_s", "p99_s"}
    u8 = StreamingSR(model, cfg, policy=ComputePolicy(), output_u8=True)(frames[0])
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, np.round(run(frames[0]) * 255.0).astype(np.uint8))
    with pytest.raises(TypeError, match="SpaceMesh"):
        StreamingSR(model, cfg, mesh=object())
    with pytest.raises(ValueError, match="torch.distributed.run --nproc_per_node 2"):
        StreamingSR(model, cfg, mesh=space_mesh(2))
