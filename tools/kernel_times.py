#!/usr/bin/env python3
"""CUDA-event times of the PyTorch port's kernels at their main-path sites.

    PYTHONPATH=<tree>/src python3 tools/kernel_times.py --label <name>

Times each kernel of `repro_torch.kernels.ops.KERNELS` at the call sites
that `chip_smoke.py` lists (`SITES`), on the same seeded inputs and with
the same timer (median of 20 trials of 10 back-to-back launches, after a
warm-up), and prints one JSON line per site with the card's name and
power limit.  `repro_torch` comes from PYTHONPATH (this tree's `src/`
when it is unset); the sites, the timer and the bounds come from this
tree's `chip_smoke.py`.  So another tree -- a parent commit unpacked with
`git archive` into a gitignored directory -- can be timed beside this one
in one process per tree, in turns (A, B, B, A), on one card.  Exits
non-zero without a CUDA device.

``--scale`` also times each site at multiples of its batch (does the
time follow the warps a launch gives each SM?); ``--ks`` times each
site at other edit budgets k in place of its own; ``--long`` adds the
Myers kernel's L = 100 kbp set (`MYERS_LONG`, 3 trials of one launch).
Each line also carries the kernel's own device time per launch from
`torch.profiler` (null where the profiler records none), which leaves
out the host's time to launch it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the entry functions of the kernels' first designs, so that a tree from
# before their redesign gets device times too
FIRST_ENTRIES = {"window_dc_batch_v2": ("dc_kernel_v2",),
                 "myers_distance_batch": ("myers_kernel",)}

def entries(cs, name: str) -> tuple[str, ...]:
    return cs.KERNEL_ENTRIES[name] + FIRST_ENTRIES.get(name, ())


def time_sites(args, cs, ops, torch, np, dev, card: str) -> None:
    name = torch.cuda.get_device_name(dev)
    for kern in ops.KERNELS:
        if args.kernels and kern.name not in args.kernels:
            continue
        sites = list(cs.SITES[kern.name])
        if args.long and kern.name == "myers_distance_batch":
            sites.append(("long", cs.MYERS_LONG))
        for site, site_shape in sites:
            ks = args.ks if args.ks and "k" in site_shape else [None]
            for scale, k in ((x, k) for x in args.scale for k in ks):
                shape = dict(site_shape, b=max(1, round(site_shape["b"] * scale)))
                if k is not None:
                    shape["k"] = k
                kargs, kw = kern.make_inputs(np.random.default_rng(7), dev,
                                             **shape)
                call = lambda: kern.wrapper(*kargs, **kw)  # noqa: E731
                long = site == "long"
                ms = cs.time_ms(torch, call, 3 if long else 20, 1 if long else 10)
                dev_ms = cs.device_ms(torch, call, entries(cs, kern.name),
                                      calls=3 if long else 10)
                print(json.dumps({
                    "label": args.label, "kernel": kern.name, "site": site,
                    "scale": scale, "shape": shape, "ms": ms,
                    "device_ms": dev_ms,
                    **cs.bound(name, *cs.work(kern.name, kargs, kw)),
                    "package": str(Path(ops.__file__).resolve().parents[2]),
                    "card": card}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True, help="name of the tree timed")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="kernel names (default: all)")
    ap.add_argument("--scale", nargs="*", type=float, default=[1.0],
                    help="batch multiples to time each site at (default 1)")
    ap.add_argument("--ks", nargs="*", type=int, default=None,
                    help="edit budgets k to time each site at (default: "
                         "the site's own)")
    ap.add_argument("--long", action="store_true",
                    help="also time Myers at L = 100 kbp")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.append(str(ROOT))
    sys.path.append(str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    time_sites(args, cs, ops, torch, np, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
