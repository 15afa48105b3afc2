"""Markdown tables from the dry run's results (`launch/dryrun.py`).

Port of `repro.launch.report`, reading ``dryrun_results_torch.json``.
Its columns follow the port's records: local shard bytes per H100 in
place of XLA's memory analysis, no compile time and no parsed
collectives (the dry run writes those as null), the analytic roofline
on the ``h100_sxm`` spec.

    PYTHONPATH=src python -m repro_torch.launch.report > dryrun_tables.md
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.dryrun import RESULTS


def fmt_gb(b) -> str:
    return f"{b / 1e9:.1f}"


def dryrun_table(res: dict) -> str:
    rows = ["| cell | mesh | chips | lower s (cut) | params GB/dev | "
            "opt GB/dev | batch+state GB/dev | total GB/dev | fits 80 GB |",
            "|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(res):
        r = res[key]
        if "error" in r:
            rows.append(f"| {r['arch']}×{r['shape']} | {r['mesh']} | — | "
                        f"ERROR | | | | | |")
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']}×{r['shape']} | {r['mesh']} | {r['chips']} | "
            f"{r['lower_s']:.2f} ({lower_cut(r)}) | "
            f"{fmt_gb(m['param_bytes'])} | {fmt_gb(m['opt_bytes'])} | "
            f"{fmt_gb(m['batch_bytes'] + m['state_bytes'])} | "
            f"{fmt_gb(m['per_device_total'])} | {'yes' if m['fits'] else 'no'} |")
    return "\n".join(rows)


def lower_cut(r: dict) -> str:
    """How far the timed step was cut: blocks, and tokens where it was."""
    return ", ".join([r.get("lower_blocks", "all blocks")]
                     + ([r["lower_seq"]] if "lower_seq" in r else []))


def roofline_table(res: dict) -> str:
    rows = ["| cell | mesh | compute s | memory s | collective s | bottleneck | "
            "roofline s/step | MFU bound | useful ratio (6ND/analytic) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(res):
        r = res[key]
        if "analytic" not in r or r["mesh"] != "16x16":
            continue  # the roofline table is single-pod
        a = r["analytic"]
        rows.append(
            f"| {r['arch']}×{r['shape']} | {r['mesh']} | {a['compute_s']:.2e} | "
            f"{a['memory_s']:.2e} | {a['collective_s']:.2e} | {a['bottleneck']} | "
            f"{a['roofline_s']:.2e} | {a['mfu_bound']:.2f} | "
            f"{a['useful_ratio_6nd']:.2f} |")
    return "\n".join(rows)


def multi_table(res: dict) -> str:
    rows = ["| cell | 16x16 GB/dev | 2x16x16 GB/dev | 2x16x16 collective s |",
            "|---|---|---|---|"]
    for key in sorted(k for k, v in res.items() if v.get("mesh") == "16x16"):
        r = res[key]
        m = res.get(key.replace("16x16", "2x16x16"))
        if "memory" not in r or not m or "memory" not in m:
            continue
        rows.append(
            f"| {r['arch']}×{r['shape']} | "
            f"{fmt_gb(r['memory']['per_device_total'])} | "
            f"{fmt_gb(m['memory']['per_device_total'])} | "
            f"{m['analytic']['collective_s']:.2e} |")
    return "\n".join(rows)


def main(path: Path = RESULTS) -> str:
    res = json.loads(Path(path).read_text())
    out = "\n".join(["## DRYRUN\n", dryrun_table(res), "\n## ROOFLINE\n",
                     roofline_table(res), "\n## MULTI\n", multi_table(res)])
    print(out)
    return out


if __name__ == "__main__":
    main()
