"""What the harness may load and where it may run.

- No module under ``h100bench/`` imports ``jax``, ``jaxlib``, ``flax`` or
  the JAX package ``m2trans_tpu``, top-level names compared whole (the
  port, ``m2trans_tpu_torch``, begins with the JAX package's name).
- The reference, the comparison and the frozen counts import nothing of
  the port.
- Without a card the harness exits non-zero and prints no result; it never
  falls back to the CPU. The same holds in a directory that has only
  ``BENCHMARK.json`` and the benchmark's files.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import run
from h100bench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "m2trans_tpu"}


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(*subdirs):
    for sub in subdirs:
        for dirpath, _, files in os.walk(os.path.join(spec.HERE, sub)):
            yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(""):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference", "core"):
        assert "m2trans_tpu_torch" not in set(_imports(path)), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "m2trans_tpu_torch_fake", sys)
    assert "m2trans_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.loaded_forbidden()


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "h100bench/run.py", "--workload", "x4-serve-b8",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_means_no_result(has_card):
    if has_card:
        pytest.skip("this machine has a card")
    res = _run(spec.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_only_the_benchmark_files_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""
