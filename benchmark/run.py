"""Runs one cell of the benchmark once and prints its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA cards. The cells,
configurations, traffic mixes and metrics are files under ``benchmark/`` found by
name (``harness/registry.py``); ``BENCHMARK.json`` says which metrics each cell
reports. With ``--trace 0`` the run measures the cell's end-to-end metrics over a
window of ``--seconds``; with ``--trace 1`` it traces the cell's fixed count of
calls and reports its per-layer metrics. Either way a sample of the answers is
checked against the plain reference, and the numbers compared are printed
beside their limits, last on standard error and last in the result.

Exits 2 without a result when there is no card or fewer cards than the cell
needs, and 3 when JAX, flax or the JAX package was loaded by the end of the run.
The program's build and kernel caches stay in ``build/`` inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "glare_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not bring in (whole-name compare)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)   # one process, one host thread: the host's other work is noise enough

    from benchmark.harness import bench
    from benchmark.harness.registry import Registry

    reg = Registry()
    cells = {w["name"]: w for w in reg.spec()["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = bench.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                       t_start=T0, registry=reg)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that must not be loaded are: {loaded}", file=sys.stderr)
        return 3
    for name, v in result["limits"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
