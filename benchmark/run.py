#!/usr/bin/env python3
"""The benchmark of lambda_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload blastp_sprot_half.proteome \
        --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  The cell, its configuration, its
traffic mix and its metrics are looked up by name from BENCHMARK.json.
Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, breakdown (traced runs) and,
last, checks: each number the check compared, with its limit, which are
also the last lines of standard error.  ``--control 1`` makes the run the
check's control: the sampled records are judged as the reference in
8-bit arithmetic would have written them, in the program's place, so a
sound check prints ``correct`` false (the program's own readings are
under ``detail.program``).  ``detail.built`` counts the native libraries
and kernels this run compiled: a checkout's first run builds them.

Exits 3 without printing a result where CUDA is missing or has fewer
cards than the cell asks for, and 4 where JAX or the JAX package was
loaded by the time the window closed.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "lambda_tpu_torch"    # the program's builds
BUILT_BEFORE = set(BUILD_DIR.glob("*")) if BUILD_DIR.is_dir() else set()
FORBIDDEN = {"jax", "jaxlib", "flax", "lambda_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--control", type=int, default=0, choices=(0, 1))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{cards} available", file=sys.stderr)
        return 3
    from benchmark.harness import cell as cell_mod

    result = cell_mod.run(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda",
                          control=bool(args.control), t_proc=T_PROC)
    after = set(BUILD_DIR.glob("*")) if BUILD_DIR.is_dir() else set()
    result["detail"]["built"] = len(after - BUILT_BEFORE)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
