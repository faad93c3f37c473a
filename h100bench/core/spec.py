"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them.

- the cell: an entry of ``workloads``;
- its configuration: the ``file`` of the ``configs`` entry it names (a JSON
  file of sizes under ``h100bench/configs/``);
- its traffic mix: ``h100bench/traffic/<traffic>.json``, parameters that the
  general driver the mix names (``"driver"``, a module of
  ``h100bench/drivers/``) reads;
- its metrics: the ``end_to_end`` and ``per_layer`` entries whose
  ``workloads`` list the cell (or that have no such list); a per-layer
  metric's reader is ``h100bench/metrics/<name>.py``, whose ``read(trace)``
  returns a number or None.

Adding a configuration, a mix, a metric or a cell is adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # h100bench/
ROOT = os.path.dirname(HERE)  # the checkout


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(cells: {', '.join(c['name'] for c in bench['workloads'])})")


def config(bench: Dict[str, Any], name: str, root: str = ROOT) -> Dict[str, Any]:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(os.path.join(root, entry["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> Dict[str, Any]:
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def driver(name: str):
    """The general driver a traffic mix names."""
    return importlib.import_module(f"h100bench.drivers.{name}")


def metrics(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(name: str, here: str = HERE):
    """The module ``h100bench/metrics/<name>.py`` (loaded by its path: a
    metric's name may hold dots)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(bench: Dict[str, Any], cell: str, trace: Dict[str, Any],
                 here: str = HERE) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of ``cell`` that its reader finds in
    ``trace``; a metric whose reader returns None is left out."""
    out = {}
    for m in metrics(bench, cell, "per_layer"):
        value: Optional[float] = reader(m["name"], here).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
