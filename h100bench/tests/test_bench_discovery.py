"""The harness finds a configuration, a traffic mix, a metric and a cell by
the names BENCHMARK.json gives them: adding one is adding files and
entries. Also: every cell of the repository's BENCHMARK.json resolves, and
the file keeps to the benchmark's contract on names, units and bounds."""

import json
import os
import re

import pytest

from h100bench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture()
def tree(tmp_path):
    """A checkout with one dummy configuration, mix, metric and cell."""
    here = tmp_path / "h100bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "toy.json").write_text(json.dumps({"model": {"n_feats": 8}}))
    (here / "traffic" / "toy-mix.json").write_text(json.dumps({"driver": "stream", "batch": 3}))
    (here / "metrics" / "toy.ms.serve.py").write_text(
        "def read(trace):\n    return trace.get('toy')\n")
    (here / "metrics" / "silent.serve.py").write_text("def read(trace):\n    return None\n")
    bench = {
        "configs": [{"name": "toy", "file": "h100bench/configs/toy.json"}],
        "workloads": [{"name": "toy-cell", "config": "toy", "traffic": "toy-mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "other_only", "unit": "s", "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "toy.ms.serve", "unit": "ms"},
                      {"name": "silent.serve", "unit": "%"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, here


def test_added_files_are_found_by_name(tree):
    root, here = tree
    bench = spec.benchmark(str(root))
    cell = spec.workload(bench, "toy-cell")
    assert spec.config(bench, cell["config"], str(root)) == {"model": {"n_feats": 8}}
    assert spec.traffic(cell["traffic"], str(here)) == {"driver": "stream", "batch": 3}
    assert [m["name"] for m in spec.metrics(bench, "toy-cell", "end_to_end")] == ["setup_s"]
    got = spec.read_metrics(bench, "toy-cell", {"toy": 1.5}, str(here))
    assert got == {"toy.ms.serve": {"value": 1.5, "unit": "ms"}}  # silent.serve left out


def test_unknown_cell_names_the_known_ones(tree):
    root, _ = tree
    with pytest.raises(KeyError, match="toy-cell"):
        spec.workload(spec.benchmark(str(root)), "nope")


def test_every_cell_of_the_benchmark_resolves():
    from h100bench.reference import compare

    bench = spec.benchmark()
    for cell in bench["workloads"]:
        cfg = spec.config(bench, cell["config"])
        assert {"scale", "n_feats", "n_blocks"} <= set(cfg["model"])
        mix = spec.traffic(cell["traffic"])
        drv = spec.driver(mix["driver"])
        assert callable(drv.run) and callable(drv.control)
        assert compare.limits(cell["name"])
        e2e = [m["name"] for m in spec.metrics(bench, cell["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics(bench, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert callable(spec.reader(m["name"]).read)


def test_benchmark_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/") and os.path.isfile(
            os.path.join(spec.ROOT, c["file"]))
        assert c["name"] in {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for cell in m["workloads"]:
            reported = [e["name"] for e in spec.metrics(bench, cell, "end_to_end")]
            assert m["moves"] in reported
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
