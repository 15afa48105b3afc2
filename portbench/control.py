"""The control: the plain reference with one of the configuration's
guarantees broken, run in the program's place through a whole cell.

The configuration's ``control`` names the break (the filter over the
read's first 64 bases, not 128: half the filter's work).  The check must
find it: every seed prints ``correct`` false and the mismatched reads.
The benchmark's own runs never run it.

    python3 portbench/control.py --workload linear-bulk --seeds 21 22 23 --seconds 30
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as entry  # noqa: E402

BLOCK = 32768  # reads the control maps at once


def control_program(mode, filter_bits: int, block: int = BLOCK):
    """A class of the program's interface that maps each batch with
    ``mode``'s plain reference at ``filter_bits`` filter bits."""
    import torch

    from portbench.harness import answer_in_blocks

    class Control:
        stage_times: list = []

        def __init__(self, cfg, data, device):
            self.ref = mode.Reference(cfg, data, device)
            self.device = device

        def __call__(self, reads, lens) -> dict:
            return answer_in_blocks(self.ref, torch, reads.cpu().numpy(),
                                    lens.cpu().numpy(), block, self.device,
                                    filter_bits=filter_bits)

        def work(self, batch: int) -> list:
            return []

    return Control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    args = ap.parse_args(argv)
    entry.prepare()
    from portbench import harness

    c = harness.cell(args.workload)
    cls = control_program(c.mode, c.cfg["control"]["filter_bits"])
    rc = 0
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=args.seconds, trace=0,
                                t_start=time.perf_counter())
        out = harness.run(ns, program_cls=cls)
        r = out["result"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": c.cfg["control"]["filter_bits"],
                          "correct": r["correct"], "checks": r["checks"],
                          "batches": out["info"]["batches_in_window"],
                          "mapped_share": out["info"]["mapped_share"]}), flush=True)
        rc |= int(r["correct"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
