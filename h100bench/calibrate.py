"""Readings for the limits of ``correct``; not part of a benchmark run.

    python h100bench/calibrate.py --workload <cell> --seeds 1 2 3 [--seconds 2]
        [--control] [--fault NAME]

For each seed, in one process, it runs the cell's driver as a run does
(with a window of ``--seconds``) and prints the numbers it compares
(``program``); with ``--control`` it also prints the control's numbers
for the seed (the reference with its products in fp8 in the program's
place); with ``--fault`` a fault of the reference planted in the
program's place (the train driver's ``FAULTS``). One JSON line a seed
and kind, then nothing else. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--program", type=int, default=1, help="0: skip the program's runs")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from h100bench.core import spec
    from h100bench.drivers import Context

    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    traffic = spec.traffic(cell["traffic"])
    drv = spec.driver(traffic["driver"])
    config = spec.config(bench, cell["config"], ROOT)
    for seed in args.seeds:
        ctx = Context(cell=cell["name"], seed=seed, seconds=args.seconds, trace=False,
                      config=config, traffic=traffic, t_start=time.perf_counter())
        if args.program:
            out = drv.run(ctx)
            print(json.dumps({"seed": seed, "kind": "program", "numbers": out["numbers"],
                              "e2e": out["e2e"], "attempted": out["attempted"],
                              "marks": ctx.marks,
                              "memory_peak_bytes": out["memory_peak_bytes"]}), flush=True)
        if args.control:
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": drv.control(ctx)}), flush=True)
        if args.fault:
            print(json.dumps({"seed": seed, "kind": f"fault:{args.fault}",
                              "numbers": drv.fault(ctx, args.fault)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
