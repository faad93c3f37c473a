"""The port's C++ training loader (``m2trans_tpu_torch/runtime``) against
the JAX package's (``m2trans_tpu/runtime``) on the same npy cache, and the
JAX package's own properties of its loader (tests/test_native_loader.py)
as cases of the port's. Batches must be bit-identical: the two libraries
are built from copies of one source with the same g++ flags."""

import os

import numpy as np
import pytest

from m2trans_tpu.config import Config as JaxConfig
from m2trans_tpu.data import create_datasets as jax_create_datasets
from m2trans_tpu.runtime import NativeTrainLoader as JaxNativeTrainLoader
from m2trans_tpu_torch import runtime
from m2trans_tpu_torch.config import Config
from m2trans_tpu_torch.data.pipeline import TrainLoader, create_datasets
from m2trans_tpu_torch.ops.kernels.build import BUILD_DIR
from m2trans_tpu_torch.runtime import LoaderRejected, NativeTrainLoader
from test_torch_port_train import tree_kw, write_tree

PATCH = 24  # a multiple of 2, 3 and 4; HR 72x48 covers LR x scale at each


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """{scale: (hr paths, lr paths, [(lr, hr) arrays])}: 4 random HR images
    of 72x48x3 and their LR by striding (an aligned crop of one is a
    subsampling of the other)."""
    root = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(5)
    hrs = [rng.integers(0, 256, (72, 48, 3), np.uint8) for _ in range(4)]
    out = {}
    for scale in (2, 3, 4):
        hp, lp, arrays = [], [], []
        for i, hr in enumerate(hrs):
            lr = np.ascontiguousarray(hr[::scale, ::scale])
            np.save(root / f"hr_{i}.npy", hr)
            np.save(root / f"lr_x{scale}_{i}.npy", lr)
            hp.append(str(root / f"hr_{i}.npy"))
            lp.append(str(root / f"lr_x{scale}_{i}.npy"))
            arrays.append((lr, hr))
        out[scale] = (hp, lp, arrays)
    return out


def loader(caches, scale=2, cls=NativeTrainLoader, **kw):
    hp, lp, _ = caches[scale]
    args = dict(patch_size=PATCH, scale=scale, batch_size=2, repeat=3, num_workers=3,
                seed=7)
    args.update(kw)
    return cls(hp, lp, **args)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_batches_equal_jax_loader(caches, scale):
    """Two epochs of the port's loader and the JAX package's, bit for bit."""
    port, ref = loader(caches, scale), loader(caches, scale, JaxNativeTrainLoader)
    assert len(port) == len(ref) == 4 * 3 // 2
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for (l1, h1), (l2, h2) in zip(got, want):
            assert l1.dtype == h1.dtype == np.float32
            assert l1.shape == (2, PATCH // scale, PATCH // scale, 3)
            assert h1.shape == (2, PATCH, PATCH, 3)
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(h1, h2)


def _aligned(caches, scale):
    """Every LR patch is a subsampling of its HR patch: with lr = hr[::s,
    ::s] an aligned crop gives lr == hr[o::s, o::s] for an offset o of each
    axis (a flip moves it) or its transpose (rot90)."""
    for lr, hr in loader(caches, scale):
        for i in range(lr.shape[0]):
            variants = []
            for oy in range(scale):
                for ox in range(scale):
                    sub = hr[i][oy::scale, ox::scale]
                    variants += [sub, sub.transpose(1, 0, 2)]
            assert any(np.array_equal(lr[i], v) for v in variants)


def _deterministic(caches, scale):
    for (l1, h1), (l2, h2) in zip(loader(caches, scale), loader(caches, scale)):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(h1, h2)


def _epochs_differ(caches, scale):
    ld = loader(caches, scale)
    e1 = np.stack([h for _, h in ld])
    e2 = np.stack([h for _, h in ld])
    assert not np.array_equal(e1, e2)


def _values_from_source(caches, scale):
    """Every HR patch's values occur in one of the source images."""
    arrays = caches[scale][2]
    for _, hr in loader(caches, scale, batch_size=1, repeat=2):
        patch = np.round(hr[0] * 255).astype(np.uint8)
        assert any(np.isin(patch, src).all() for _, src in arrays)


def _no_deadlock(caches, scale):
    """Many epochs x many workers x batches of one with the consumer-gated
    window: every epoch completes."""
    ld = loader(caches, scale, batch_size=1, repeat=24, num_workers=6)
    for _ in range(6):
        assert sum(1 for _ in ld) == len(ld) == 96


PROPERTIES = {"aligned_crops": _aligned, "deterministic": _deterministic,
              "epochs_differ": _epochs_differ, "values_from_source": _values_from_source,
              "no_deadlock": _no_deadlock}


@pytest.mark.parametrize("name", list(PROPERTIES))
@pytest.mark.parametrize("scale", [2, 4])
def test_loader_property(caches, name, scale):
    PROPERTIES[name](caches, scale)


def _reject(caches, tmp_path, case):
    hp, lp, _ = caches[2]
    rng = np.random.default_rng(9)
    if case == "lr_smaller_than_patch":
        np.save(tmp_path / "x.npy", rng.integers(0, 256, (8, 8, 3), np.uint8))
        return [hp[0]], [str(tmp_path / "x.npy")], PATCH
    if case == "hr_smaller_than_scaled_lr":
        np.save(tmp_path / "x.npy", rng.integers(0, 256, (40, 40, 3), np.uint8))
        return [str(tmp_path / "x.npy")], [lp[0]], PATCH
    if case == "channels_differ":
        np.save(tmp_path / "x.npy", rng.integers(0, 256, (36, 24), np.uint8))
        return [hp[0]], [str(tmp_path / "x.npy")], PATCH
    if case == "float_cache":
        np.save(tmp_path / "x.npy", rng.uniform(0, 1, (36, 24, 3)))
        return [hp[0]], [str(tmp_path / "x.npy")], PATCH
    return [hp[0]], [lp[0]], PATCH + 1  # patch_not_divisible


@pytest.mark.parametrize("case", ["lr_smaller_than_patch", "hr_smaller_than_scaled_lr",
                                  "channels_differ", "float_cache",
                                  "patch_not_divisible"])
def test_rejects_invalid_caches(caches, tmp_path, case):
    """Caches the sampler cannot index are refused (the JAX loader refuses
    the same ones)."""
    hp, lp, patch = _reject(caches, tmp_path, case)
    with pytest.raises(LoaderRejected, match="cannot index"):
        NativeTrainLoader(hp, lp, patch_size=patch, scale=2, batch_size=1)
    with pytest.raises(RuntimeError):
        JaxNativeTrainLoader(hp, lp, patch_size=patch, scale=2, batch_size=1)


def test_library_is_built_under_build_dir(caches):
    """The .so lands in m2trans_tpu_torch/build/, named by the source hash;
    the source directory holds only the sources."""
    loader(caches)
    so = runtime.library_path()
    assert so.parent == BUILD_DIR and so.exists()
    assert so.name.startswith("libm2t_loader_")
    files = {f for f in os.listdir(runtime.SRC.parent) if f != "__pycache__"}
    assert files == {"__init__.py", "loader.cc"}


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback around the build: g++'s error reaches the caller."""
    bad = tmp_path / "loader.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(runtime, "SRC", bad)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building the C\\+\\+ "
                       "loader(.|\n)*error"):
        runtime.build()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


@pytest.mark.parametrize("native", [True, False])
def test_create_datasets_equals_jax(tmp_path, native):
    """``create_datasets`` of both packages on a tiny US1K tree: the same
    kind of loader (the C++ one with ``native_loader``, which the shipped
    training configs select) and equal batches over two epochs."""
    root_j = write_tree(tmp_path / "j", np.random.default_rng(5))
    root_t = write_tree(tmp_path / "t", np.random.default_rng(5))
    kw = dict(tree_kw(root_j, tmp_path), native_loader=native)
    jl, _ = jax_create_datasets(JaxConfig(**kw))
    tl, _ = create_datasets(Config(**dict(kw, data_path=str(root_t))))
    assert isinstance(jl, JaxNativeTrainLoader) == native
    assert isinstance(tl, NativeTrainLoader if native else TrainLoader)
    assert len(tl) == len(jl) and len(tl.dataset) == len(jl.dataset)
    for _ in range(2):
        for jb, tb in zip(list(jl), list(tl), strict=True):
            assert len(jb) == len(tb) == 2
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("option", [{"faithful_tail_batch": True}, {"colors": 1},
                                    {"data_augment": 0}])
def test_create_datasets_python_loader_cases(tmp_path, option):
    """JAX's conditions: no C++ loader with the ragged tail batch, the Y
    channel cache or augmentation off, in either package."""
    root = write_tree(tmp_path / "d", np.random.default_rng(3))
    kw = dict(tree_kw(root, tmp_path), native_loader=True, **option)
    jl, _ = jax_create_datasets(JaxConfig(**kw))
    tl, _ = create_datasets(Config(**kw))
    assert not isinstance(jl, JaxNativeTrainLoader)
    assert isinstance(tl, TrainLoader)


def test_create_datasets_rejected_cache_uses_python_loader(tmp_path, capsys):
    """A tree whose LR images are smaller than the patch: both packages
    print the line and use the Python loader."""
    root = write_tree(tmp_path / "d", np.random.default_rng(4), hr_hw=32)
    kw = dict(tree_kw(root, tmp_path), native_loader=True, patch_size=48)
    jl, _ = jax_create_datasets(JaxConfig(**kw))
    jax_out = capsys.readouterr().out
    tl, _ = create_datasets(Config(**kw))
    out = capsys.readouterr().out
    assert not isinstance(jl, JaxNativeTrainLoader) and isinstance(tl, TrainLoader)
    for text in (jax_out, out):
        assert "## native loader unavailable (" in text
        assert text.rstrip().endswith("using the Python loader ##")


@pytest.mark.parametrize("keep", ["half_header", "header_only", "part_of_payload",
                                  "all_but_one_byte"])
def test_rejects_a_cache_cut_short(caches, tmp_path, keep):
    """A cache file shorter than its header says (one caught mid-write) is
    refused, not read past its end (which faults). The JAX loader reads such
    a file unchecked, so it is not called here."""
    hp, lp, _ = caches[2]
    data = open(hp[0], "rb").read()
    header = 10 + int.from_bytes(data[8:10], "little")
    cut = {"half_header": header // 2, "header_only": header,
           "part_of_payload": header + 100, "all_but_one_byte": len(data) - 1}[keep]
    (tmp_path / "x.npy").write_bytes(data[:cut])
    with pytest.raises(LoaderRejected, match="cannot index"):
        NativeTrainLoader([str(tmp_path / "x.npy")], [lp[0]], patch_size=PATCH, scale=2,
                          batch_size=1)
    # the whole file is taken
    (tmp_path / "y.npy").write_bytes(data)
    assert len(NativeTrainLoader([str(tmp_path / "y.npy")], [lp[0]], patch_size=PATCH,
                                 scale=2, batch_size=1, repeat=2)) == 2


def test_cache_files_appear_whole(tmp_path, monkeypatch):
    """The dataset writes each npy cache file under a name of its own and
    renames it into place, so a rank converting the same tree at the same
    time sees either no file or the whole one; a second conversion over a
    file already mapped leaves the mapping's values as they were."""
    from m2trans_tpu_torch.data import us1k

    root = write_tree(tmp_path / "d", np.random.default_rng(6))
    writes = []
    save = np.save

    def watched_save(f, arr):
        final = f.name.rsplit(".tmp", 1)[0]
        writes.append((f.name, final))
        assert f.name != final and final.endswith(".npy")
        assert not os.path.exists(final) or np.array_equal(np.load(final), arr)
        save(f, arr)

    monkeypatch.setattr(us1k.np, "save", watched_save)
    cfg = Config(**dict(tree_kw(root, tmp_path), native_loader=True))
    loader_, _ = create_datasets(cfg)
    assert isinstance(loader_, NativeTrainLoader)
    assert len(writes) == 2 * 3  # HR and LR of the three training images
    cache = root / "us1k_cache"
    assert not [p for p in cache.rglob("*") if ".tmp" in p.name]
    ds = us1k.US1KDataset(str(root / "US1K/US1K_train_HR"),
                          str(root / "US1K/US1K_train_LR_bicubic"), str(cache),
                          scale=2, start_idx=1, end_idx=4)
    assert len(writes) == 2 * 3  # the cache was there: nothing written again
    mapped = np.load(ds.hr_npy[0], mmap_mode="r")
    want = np.array(mapped)
    ds._convert(str(root / "US1K/US1K_train_HR/0001.png"), ds.hr_npy[0])
    assert len(writes) == 2 * 3 + 1
    np.testing.assert_array_equal(mapped, want)
    np.testing.assert_array_equal(np.load(ds.hr_npy[0]), want)
