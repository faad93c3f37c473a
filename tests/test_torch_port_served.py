"""The served-model table (``models/served.py``) as the one seam between the
models and what serves them, on the CPU.

A stand-in third model, given a temporary entry, runs through
``StreamingSR``, ``GraphedForward`` (eager, and through a stand-in capture)
and the infer CLI with its launches counted, with no edit to any of them;
an unknown ``model:`` is refused by the loader; and a scan of the sources
holds the layers above the table to naming no model and the models to
taking the shared numerics from ``models/numerics.py``.
"""

from __future__ import annotations

import ast
import json
import os
import re

import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from m2trans_tpu_torch import infer
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.models import graphed, served
from m2trans_tpu_torch.models.graphed import GraphedForward, serving_forward
from m2trans_tpu_torch.models.numerics import ComputePolicy
from m2trans_tpu_torch.parallel.mesh import SpaceMesh
from m2trans_tpu_torch.parallel.streaming import StreamingSR
from m2trans_tpu_torch.train.checkpoint import load_params_any

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "m2trans_tpu_torch")


def nearest(x: torch.Tensor, s: int) -> torch.Tensor:
    """The stand-in model's one kernel wrapper: nearest upsampling by s."""
    nearest.launches += 1
    return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


nearest.launches = 0


class Nearest(nn.Module):
    """A stand-in served model: one gain, then nearest upsampling."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.gain = nn.Parameter(torch.full((), 1.5))


def _forward(model, x, cfg, policy, output_u8):
    return nearest(x * model.gain, cfg.scale).to(policy.dtype).clamp(0.0, 1.0)


def _load(path, cfg, device):
    model = Nearest(cfg).to(device or "cpu")
    model.load_state_dict(torch.load(path, weights_only=True))
    return model


@pytest.fixture
def stand_in(monkeypatch):
    """The stand-in's entry in the table while a test runs."""
    entry = served.ServedModel(Nearest, _forward, {"nearest": nearest}, row_sharded=False,
                               load=_load)
    monkeypatch.setitem(served.SERVED, "Nearest", entry)
    return entry


def _cfg():
    return Config(model="Nearest", scale=2)


def _want(frame, u8=False):
    y = np.clip(np.repeat(np.repeat(frame * 1.5, 2, axis=1), 2, axis=2), 0.0, 1.0)
    return np.round(y * 255.0).astype(np.uint8) if u8 else y.astype(np.float32)


@pytest.mark.parametrize("output_u8", [False, True])
def test_a_third_model_streams_with_its_launches_counted(stand_in, output_u8):
    """``StreamingSR`` serves the stand-in by its entry's forward, a
    ``GraphedForward`` of it counts its wrapper, and a mesh is refused by
    the entry's ``row_sharded``."""
    cfg, model = _cfg(), Nearest(_cfg())
    assert served.of(model) is stand_in and served.by_name("Nearest") is stand_in
    frames = [np.random.default_rng(i).random((2, 4, 6, 3), np.float32) for i in range(3)]
    n0 = nearest.launches
    server = StreamingSR(model, cfg, policy=ComputePolicy(), depth=2, output_u8=output_u8)
    got = list(server.stream(frames))
    assert nearest.launches == n0 + 3
    for f, g in zip(frames, got):
        want = _want(f, output_u8)
        assert g.dtype == want.dtype and g.shape == (2, 8, 12, 3)
        np.testing.assert_allclose(g, want, atol=1 if output_u8 else 1e-6)
    assert GraphedForward(model, cfg, server.policy).counted is stand_in.counted
    with pytest.raises(ValueError, match="Nearest runs on one device"):
        StreamingSR(model, cfg, mesh=SpaceMesh(n=2, rank=0))


def test_a_third_model_through_a_capture(stand_in, monkeypatch):
    """``GraphedForward`` on the stand-in through a stand-in capture (the
    function run twice, as the side-stream run and the captured call): the
    capture counts the entry's wrapper once, in the captured call, and the
    replay gives the eager serving forward."""

    class Graph:
        def __init__(self, fn, out):
            self.fn, self.out = fn, out

        def replay(self):
            self.out.copy_(self.fn())

    def fake_capture(fn, pool):
        fn()
        out = fn()
        return Graph(fn, out), out

    monkeypatch.setattr(graphed, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    cfg, model = _cfg(), Nearest(_cfg())
    policy = ComputePolicy()
    gf = GraphedForward(model, cfg, policy)
    gf.graphs = True
    x = torch.from_numpy(np.random.default_rng(3).random((1, 4, 4, 3), np.float32))
    with torch.inference_mode():
        got = gf(x).clone()
        assert torch.equal(gf(x), got)
        want = serving_forward(model, x, cfg, policy, False)
    assert torch.equal(got, want)
    assert gf.capture_launches == {(1, 4, 4, 3): {"nearest": 1}}
    assert (gf.captures, gf.replays) == (1, 2)


def test_the_infer_cli_serves_a_third_model(stand_in, tmp_path, capsys):
    """``python -m m2trans_tpu_torch.infer`` on the CPU with a yml naming the
    stand-in: its entry loads it, no mesh is tried, the report counts its
    wrapper's launches by the entry's names and the PNGs are its frames."""
    torch.save(Nearest(_cfg()).state_dict(), tmp_path / "nearest.pt")
    (tmp_path / "nearest.yml").write_text("model: Nearest\nscale: 2\n")
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    imgs = {f"{i}.png": rng.integers(0, 160, (5, 7, 3), dtype=np.uint8) for i in range(2)}
    for name, img in imgs.items():
        Image.fromarray(img).save(src / name)
    infer.main(["--config", str(tmp_path / "nearest.yml"), "--model_path",
                str(tmp_path / "nearest.pt"), "--input", str(src), "--output",
                str(tmp_path / "out"), "--device", "cpu", "--f32"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["kernel_launches"] == {"nearest": 2} and report["mesh_space"] == 1
    for name, img in imgs.items():
        want = np.clip(_want(img[None].astype(np.float32) / 255.0)[0] * 255.0 + 0.5,
                       0, 255).astype(np.uint8)
        got = np.asarray(Image.open(tmp_path / "out" / name))
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_an_unknown_model_is_refused(tmp_path):
    """A config whose ``model`` the table lacks raises, naming the served
    models."""
    path = tmp_path / "model.pt"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="'SwinIR': the port serves HAT, M2Trans"):
        load_params_any(str(path), Config(model="SwinIR"))
    with pytest.raises(TypeError, match="not a served model"):
        served.of(nn.Linear(2, 2))


# ---------------------------------------------------------------------------
# the sources: which module may name which
# ---------------------------------------------------------------------------


def _imports(path):
    """(module, names) of every import in the file at ``path``."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, ()
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", tuple(a.name for a in node.names)


def _sources(*dirs):
    return sorted(os.path.join(d, f) for base in dirs for d, _, files in os.walk(base)
                  for f in files if f.endswith(".py"))


ABOVE_THE_TABLE = ["models/graphed.py", "parallel/streaming.py", "infer.py",
                   "train/checkpoint.py",
                   *sorted(os.path.join("ops", "kernels", f)
                           for f in os.listdir(os.path.join(PKG, "ops", "kernels"))
                           if f.endswith(".py"))]


@pytest.mark.parametrize("rel", ABOVE_THE_TABLE)
def test_serving_layers_import_no_model_of_their_own(rel):
    """The serving layers and the kernel wrappers import nothing of HAT's
    module (they reach models through ``models/served.py``), and MedCLIP's
    window attention imports nothing of HAT's kernels."""
    for module, names in _imports(os.path.join(PKG, rel)):
        assert not module.endswith("models.hat"), (rel, module)
        assert not (module.endswith(".models") and "hat" in names), (rel, module, names)
        if rel.endswith("swin_attn.py"):
            assert "hat_attn" not in module and "hat_attn" not in names, (rel, module)


def test_no_module_imports_a_private_name_of_m2trans():
    """No module of the port, and not the card scripts, imports a name
    starting with ``_`` from ``models/m2trans.py``; the models, the loss,
    the sharded forward and the graphs take the shared numerics from
    ``models/numerics.py``."""
    files = _sources(PKG) + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        for module, names in _imports(path):
            if module == "m2trans_tpu_torch.models.m2trans":
                assert not [n for n in names if n.startswith("_")], (path, names)
    for rel in ("models/hat.py", "losses/semantic.py", "parallel/spatial.py",
                "models/graphed.py"):
        numerics = [names for module, names in _imports(os.path.join(PKG, rel))
                    if module == "m2trans_tpu_torch.models.numerics"]
        assert numerics, rel


# what only HAT's module, the table and HAT's kernels may say
MODEL_NAMED = [r"isinstance\([^)]*\bHAT\)", r"cfg\.model\s*==", r"cfg\.model\s*!=",
               r"import[^\n]*models\.hat\b|models\.hat import|models import[^\n]*\bhat\b",
               r"HAT_COUNTED"]


@pytest.mark.parametrize("pattern", MODEL_NAMED)
def test_only_the_table_branches_on_the_model(pattern):
    allowed = {os.path.join(PKG, p) for p in
               ("models/hat.py", "models/served.py", "ops/kernels/hat_attn.py")}
    hits = [path for path in _sources(PKG) if path not in allowed
            and re.search(pattern, open(path).read())]
    assert not hits, hits
