"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It makes the inputs and weights from the
seed, sets up ``m2trans_tpu_torch`` (the port; never the JAX package),
runs the window, checks what the window produced against the plain
reference in ``h100bench/reference/``, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; the numbers compared, each beside its limit, come last in
it (``checked``) and as the last lines of standard error.

It exits 2, printing no result, where there is no CUDA card or fewer than
the cell asks for, and 3 where ``jax``, ``jaxlib``, ``flax`` or
``m2trans_tpu`` is loaded once the window has closed. Kernel builds and
compiler caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "m2trans_tpu")


def _env() -> None:
    """Caches at fixed paths inside the checkout; keep libraries from
    loading JAX by themselves."""
    cache = os.path.join(ROOT, "build", "h100bench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``m2trans_tpu_torch`` is not ``m2trans_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: str, out: dict, bench: dict, trace: bool, dev: dict) -> dict:
    from h100bench.core import spec, trace as tr
    from h100bench.reference import compare

    checked = compare.judged(out["numbers"], compare.limits(cell))
    checked["requests_incomplete"] = {"value": float(not out["complete"]), "limit": 0.0}
    line = {"correct": compare.passes(checked), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": {}, "device": dict(dev)}
    line["device"]["memory_peak_bytes"] = out["memory_peak_bytes"]
    if trace:
        summary = tr.device_summary(out["trace"])
        line["device"]["busy_s"] = summary["busy_s"]
        line["device"]["window_s"] = summary["window_s"]
        line["metrics"] = spec.read_metrics(bench, cell, out["trace"])
        line["breakdown"] = summary["breakdown"]
    else:
        for m in spec.metrics(bench, cell, "end_to_end"):
            line["metrics"][m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    line["checked"] = checked
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()

    from h100bench.core import spec

    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"this machine has {have}; no result", file=sys.stderr)
        return 2

    from h100bench.core.card import card
    from h100bench.drivers import Context

    traffic = spec.traffic(cell["traffic"])
    ctx = Context(cell=cell["name"], seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), config=spec.config(bench, cell["config"], ROOT),
                  traffic=traffic, device="cuda", t_start=T_START)
    out = spec.driver(traffic["driver"]).run(ctx)
    bad = loaded_forbidden()
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    got = card()
    dev = {"platform": "gpu", "kind": got["kind"], "count": cell["chips"],
           "power_limit_w": got["power_limit_w"]}
    line = result_line(cell["name"], out, bench, bool(args.trace), dev)
    print("set-up phases (s since start): " + ", ".join(
        f"{name} {t:.3f}" for name, t in ctx.marks), file=sys.stderr)
    for name, c in line["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
