"""The port's host spans (``utils/spans.py``) and the train step's device
marks (``ops/kernels/marks.py``): what a profiler trace of a stream, a
loader and a train step holds, that no ``record_function`` runs while no
profiler is active, and that the marks change no number.

The CPU tests run the eager paths; the ``cuda`` test replays a recipe step
from its CUDA graph and reads the marks' kernels in the trace. The file
imports neither jax nor the JAX package, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_spans.py -q
"""

import inspect
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from m2trans_tpu_torch import runtime
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data import pipeline
from m2trans_tpu_torch.data.pipeline import TrainLoader, create_datasets
from m2trans_tpu_torch.losses.semantic import SemanticLossFn
from m2trans_tpu_torch.models.m2trans import ComputePolicy, init_m2trans
from m2trans_tpu_torch.models.medclip.model import MedCLIPConfig, init_medclip
from m2trans_tpu_torch.ops.kernels import marks
from m2trans_tpu_torch.parallel import streaming
from m2trans_tpu_torch.parallel.streaming import StreamingSR
from m2trans_tpu_torch.runtime import NativeTrainLoader
from m2trans_tpu_torch.train import graphed, loop
from m2trans_tpu_torch.train.graphed import LOSS_NAMES
from m2trans_tpu_torch.train.loop import Trainer, make_optimizer, make_train_step
from m2trans_tpu_torch.utils import spans, staging

RECIPE_MARKS = [marks.SEMANTIC_FWD_BEGIN, marks.SEMANTIC_FWD_END,   # the constant stage
                marks.SEMANTIC_FWD_BEGIN, marks.SEMANTIC_FWD_END,   # the SR-side loss
                marks.SEMANTIC_BWD_BEGIN, marks.SEMANTIC_BWD_END,
                marks.OPTIMIZER_BEGIN, marks.OPTIMIZER_END]
L1_MARKS = [marks.OPTIMIZER_BEGIN, marks.OPTIMIZER_END]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marks are kernels, with no CPU mode")
    return torch.device("cuda")


def _host_spans(prof):
    """The port's spans in a trace, (name, start, end) in start order."""
    got = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("m2t::") and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(got, key=lambda e: e[1])


def _profile(cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def _write_tree(root, scale=2, n=3, hr_hw=64):
    """A US1K tree of ``n`` random HR PNGs and their LR by striding."""
    rng = np.random.default_rng(4)
    hr_dir = root / "US1K/US1K_train_HR"
    lr_dir = root / f"US1K/US1K_train_LR_bicubic/X{scale}"
    for d in (hr_dir, lr_dir):
        d.mkdir(parents=True)
    for i in range(1, n + 1):
        hr = rng.integers(0, 256, (hr_hw, hr_hw, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_dir / f"{i:04d}.png")
        Image.fromarray(hr[::scale, ::scale]).save(lr_dir / f"{i:04d}x{scale}.png")
    return root


def _tree_cfg(tmp_path, **kw):
    root = _write_tree(tmp_path / "data")
    args = dict(scale=2, n_feats=8, n_blocks=1, patch_size=32, batch_size=2,
                data_repeat=2, epochs=1, lr=1e-3, log_every=100, data_path=str(root),
                eval_sets=[], log_path=str(tmp_path / "experiments"), threads=2,
                train_range=(1, 4), save_image=False, cutmix=False, cutout=False,
                native_loader=False)
    args.update(kw)
    return Config(**args)


def _native_loads() -> bool:
    try:
        runtime.lib()
    except RuntimeError:  # no g++ here: the numpy loader stands in
        return False
    return True


def _stream(depth=2, n=5):
    cfg = Config(scale=2, n_feats=8, n_blocks=1)
    model = init_m2trans(cfg, seed=0, device="cpu")
    server = StreamingSR(model, cfg, depth=depth, policy=ComputePolicy())
    frames = [np.random.default_rng(i).random((1, 12, 12, 3), dtype=np.float32)
              for i in range(n)]
    return server, frames


def _case(kind, device="cpu", n_feats=8, lr_hw=32, **kw):
    """The step's inputs: the recipe's with a tiny random MedCLIP (clip size
    56, 3 patches) and ragged token ids, or L1's."""
    cfg = Config(scale=2, n_feats=n_feats, n_blocks=1,
                 lambda_clip=0.01 if kind == "recipe" else 0.0, **kw)
    fn = caps = None
    if kind == "recipe":
        mcfg = MedCLIPConfig.tiny()
        fn = SemanticLossFn(init_medclip(mcfg, seed=0, device=device), mcfg, None,
                            clip_size=56)
        ids = np.random.default_rng(0).integers(5, 128, (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        mask[1, 9:] = 0
        caps = {"input_ids": ids, "attention_mask": mask}
    x = torch.rand(2, lr_hw, lr_hw, 3, generator=torch.Generator().manual_seed(0)).to(device)
    hr = torch.rand(2, 2 * lr_hw, 2 * lr_hw, 3,
                    generator=torch.Generator().manual_seed(1)).to(device)
    return cfg, fn, caps, x, hr


def _steps(case, n=3, device="cpu", graphs=True):
    """``n`` steps from init seed 0, step i's draws from seed 10 + i;
    returns the losses, the parameters and the step."""
    cfg, fn, caps, x, hr = case
    model = init_m2trans(cfg, seed=0, device=device)
    step = make_train_step(cfg, model, make_optimizer(cfg, model), fn, graphs=graphs)
    losses = []
    for i in range(n):
        aux = step(x, hr, captions=caps, rng=np.random.default_rng(10 + i))
        losses.append(torch.stack([aux[k] for k in LOSS_NAMES]))
    return torch.stack(losses), [p.detach().clone() for p in model.parameters()], step


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_spans_each_request_in_order(depth, monkeypatch):
    """A submit and a copy-out span a request, in the stream's order (at most
    ``depth`` submitted ahead of the copy-out), each with the request's
    sequence number; no wait on the CPU (no event)."""
    server, frames = _stream(depth)
    seen, real = [], spans.record_function

    def recording(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(spans, "record_function", recording)
    with _profile() as prof:
        outs = list(server.stream(frames))
    assert len(outs) == len(frames)
    got = _host_spans(prof)
    want = [(spans.STREAM_SUBMIT, i) for i in range(min(depth, len(frames)))]
    for i in range(len(frames)):
        want.append((spans.STREAM_COPY_OUT, i))
        if i + depth < len(frames):
            want.append((spans.STREAM_SUBMIT, i + depth))
    assert [n for n, _, _ in got] == [n for n, _ in want]
    assert seen == [(n, str(i)) for n, i in want]
    for (_, _, end), (_, start, _) in zip(got, got[1:]):
        assert end <= start  # one after the other, none inside another


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_loader_spans_each_batch_and_epoch(tmp_path, kind):
    """One ``m2t::loader.epoch`` an epoch, before its batches, and one
    ``m2t::loader.next`` a batch (the C++ loader where its library loads)."""
    native = kind == "native" and _native_loads()
    loader, _ = create_datasets(_tree_cfg(tmp_path, native_loader=native))
    assert isinstance(loader, NativeTrainLoader if native else TrainLoader)
    with _profile() as prof:
        batches = [b for _ in range(2) for b in loader]
    assert len(batches) == 2 * len(loader) > 0
    want = ([spans.LOADER_EPOCH] + [spans.LOADER_NEXT] * len(loader)) * 2
    assert [n for n, _, _ in _host_spans(prof)] == want
    if hasattr(loader, "close"):
        loader.close()


def test_trainer_step_spans_its_host_work(tmp_path):
    """A Trainer step's host work: the draws and their staging, then the
    device part (the stager's wait is the CUDA path's, in the cuda test)."""
    stdout = sys.stdout
    try:
        trainer = Trainer(_tree_cfg(tmp_path), device="cpu")
    finally:
        sys.stdout = stdout  # the Trainer tees stdout into its log
    batches = iter(trainer.train_loader)
    first = [next(batches) for _ in range(2)]
    with _profile() as prof:
        for it, batch in enumerate(first):
            trainer.step(it, batch)
    assert [n for n, _, _ in _host_spans(prof)] == [spans.AUGMENT, spans.DEVICE_STEP] * 2


def test_no_record_function_runs_untraced(tmp_path, monkeypatch):
    """With no profiler active, ``span`` is the shared no-op: a stream, both
    loaders and the L1 and recipe steps enter no ``record_function``, and
    no module on those paths reaches it but through ``utils/spans.py``."""
    entered = []
    monkeypatch.setattr(spans, "record_function", lambda *a: entered.append(a))
    assert spans.span(spans.AUGMENT) is spans.span(spans.STREAM_SUBMIT, 3)
    server, frames = _stream()
    assert len(list(server.stream(frames))) == len(frames)
    for native in {False, _native_loads()}:
        loader, _ = create_datasets(_tree_cfg(tmp_path / str(native), native_loader=native))
        assert sum(1 for _ in loader) == len(loader)
    for kind in ("l1", "recipe"):
        _steps(_case(kind), n=1)
    assert entered == []
    for mod in (streaming, runtime, pipeline, loop, graphed, staging):
        assert "record_function" not in inspect.getsource(mod), mod.__name__


@pytest.mark.parametrize("kind", ["recipe", "l1"])
def test_eager_step_calls_the_marks_in_order(kind, monkeypatch):
    """The recipe step marks the semantic loss's constant stage and SR-side
    loss, its backward, and Adam; the L1 step Adam alone."""
    called = []
    monkeypatch.setattr(marks, "mark", lambda name, device: called.append(name))
    _steps(_case(kind), n=1)
    assert called == (RECIPE_MARKS if kind == "recipe" else L1_MARKS)


def test_marks_change_no_number(monkeypatch):
    """Three recipe steps with the marks and their gradient hooks give the
    losses and parameters of three steps without them, bit for bit."""
    called = []
    with monkeypatch.context() as m:
        m.setattr(marks, "mark", lambda name, device: called.append(name))
        marked = _steps(_case("recipe"))
    assert called == RECIPE_MARKS * 3
    with monkeypatch.context() as m:
        m.setattr(marks, "mark", lambda name, device: None)
        m.setattr(torch.Tensor, "register_hook", lambda self, hook: None)
        plain = _steps(_case("recipe"))
    assert torch.equal(marked[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(marked[1], plain[1]))


@pytest.mark.cuda
def test_replayed_recipe_step_shows_each_mark(dev):
    """A recipe step replayed from its CUDA graph (bf16 with the kernels,
    flagship width, one block): each replay runs every mark's kernel once
    (the forward's pair twice), in order, and the host spans its draws, the
    stager's wait and the replay."""
    case = _case("recipe", device=dev, n_feats=64, lr_hw=96, dtype="bfloat16",
                 use_pallas=True)
    _, _, step = _steps(case, n=2, device=dev)
    cfg, fn, caps, x, hr = case
    torch.cuda.synchronize()
    with _profile(cuda=True) as prof:
        for i in range(3):
            step(x, hr, captions=caps, rng=np.random.default_rng(20 + i))
        torch.cuda.synchronize()
    assert (step.graphed.captures, step.graphed.replays) == (1, 5)
    kernels = sorted((e.time_range.start, e.name.split("(")[0]) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.name.startswith("m2t_mark_"))
    assert [n for _, n in kernels] == [marks.kernel_name(m) for m in RECIPE_MARKS] * 3
    names = [n for n, _, _ in _host_spans(prof)]
    assert names.count(spans.AUGMENT) == names.count(spans.DEVICE_STEP) == 3
    assert names.count(spans.WAIT) >= 1
