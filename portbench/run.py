"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload linear-bulk --seed 7 --seconds 51 --trace 0

Run from the root of a checkout.  It needs a CUDA card (and as many as
the cell asks for); without one, or without the port's sources beside
it, it exits with a non-zero code and prints no result.  Kernels build
once into ``build/repro_torch/`` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.t_start = T_START
    return args


def prepare() -> None:
    """Put the port and the benchmark on the path, and fix the kernels'
    build directory inside the checkout."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"the port's sources are not at {src}/repro_torch")
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(src), str(ROOT)] + [p for p in sys.path
                                           if Path(p or ".").resolve() != here]
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    # the configuration fixes the backend and the tile screen
    os.environ.pop("REPRO_ALIGN_BACKEND", None)
    os.environ.pop("REPRO_GRAPH_PREFILTER", None)
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    args = parse(argv)
    prepare()
    import torch

    # one host thread for the CPU ops: the launch loop is the host's work
    torch.set_num_threads(1)
    from portbench import harness

    need = harness.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no CUDA card, or fewer than the {need} the cell needs",
              file=sys.stderr)
        return 3
    return report(harness.run(args))


def report(out: dict) -> int:
    """Print a run's set-up line and result, the numbers compared last on
    standard error; print no result, and return 4, where JAX or the JAX
    package is loaded in this process by now."""
    from portbench import harness

    info, result = out["info"], out["result"]
    loaded = harness.forbidden_modules()
    if loaded:
        print(json.dumps({"setup": info}), file=sys.stderr)
        print(f"loaded by the end of the run: {loaded}", file=sys.stderr)
        return 4
    print(json.dumps({"setup": info}))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
