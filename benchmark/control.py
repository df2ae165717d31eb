"""Readings that a cell's limits are set from: whole runs of the cell over seeds,
with the program, and with each control of its configuration in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--sides program fp8 ...]

A control is the plain reference computed below the precision that the
configuration states (its ``controls``: one mode, or a mode per sub-network),
put in the program's place by ``bench.run``'s ``fault``; the run then judges its
answers as it judges the program's. A run's window lasts until the cell's
``sample_calls`` calls have finished: the answers of a call do not depend on
when it is sent. One JSON line per run: the cell, the seed, the side, ``correct``
and every number that the comparison computed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(precision):
    """A ``fault`` that puts the reference, computed in ``precision``, in the program's place."""
    def in_place(program, side):
        return side.entry.reference(side.cfg, side.state, side.device, precision)
    return in_place


def readings(cell, seeds, device, sides=None, registry=None, log=None, **overrides):
    """One row per (seed, side): ``sides`` are ``program`` and control names
    (default: the program and every control of the cell's configuration)."""
    from benchmark.harness import bench
    from benchmark.harness.registry import Registry

    reg = registry or Registry()
    wl = reg.workload(cell)
    controls = bench._merge(reg.config(wl["config"]), overrides.get("cfg_override"))["controls"]
    for seed in seeds:
        for side in sides or ["program", *controls]:
            numbers = {}
            fault = None if side == "program" else control(controls[side])
            r = bench.run(cell, seed, 0.0, False, device=device, registry=reg, fault=fault,
                          numbers_out=numbers, min_calls=int(wl["sample_calls"]),
                          log=log or (lambda *a, **k: None), **overrides)
            yield {"cell": cell, "seed": seed, "side": side, "correct": r["correct"], "numbers": numbers}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for row in readings(args.workload, args.seeds, "cuda", args.sides, log=print):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
