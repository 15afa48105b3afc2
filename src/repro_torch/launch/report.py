"""Markdown tables from the dry run's results (`launch/dryrun.py`).

Port of `repro.launch.report`, reading ``dryrun_results_torch.json``.
Its columns follow the port's records: local shard bytes per H100 by the
specs, and rank 0's peak live bytes of the sharded step extended to full
depth, in place of XLA's memory analysis (fits 80 GB by each, counted
per mesh under FITS; a step cut to fewer tokens claims no measured fit,
"cut"); the sharded step's seconds and rank 0's collectives (ops, link
bytes, of them cross-pod) in place of parsed HLO; no compile time; the
analytic roofline on the ``h100_sxm`` spec.

    PYTHONPATH=src python -m repro_torch.launch.report > dryrun_tables.md
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.dryrun import RESULTS


def fmt_bytes(b) -> str:
    """Bytes as GB with one decimal."""
    return f"{b / 1e9:.1f}"


def dryrun_table(res: dict) -> str:
    rows = ["| cell | mesh | chips | lower s (cut) | sharded s | params GB/dev | "
            "opt GB/dev | batch+state GB/dev | total GB/dev | fits 80 GB | "
            "measured GB/dev | fits measured | collective ops | link GB | "
            "cross-pod GB |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(res):
        r = res[key]
        if "error" in r:
            rows.append(f"| {r['arch']}×{r['shape']} | {r['mesh']} | — | "
                        f"ERROR | | | | | | | | | | | |")
            continue
        m = r["memory"]
        sharded = r.get("sharded") or {}
        if sharded.get("error"):
            sh = ["SHARDED ERROR"] + [""] * 5
        elif "measured" in m and m["measured"]:
            me, c = m["measured"], r["collectives"]
            sh = [f"{sharded['lower_s']:.2f}",
                  fmt_bytes(me["peak_bytes_full_depth_est"]),
                  fit_word(me["fits_measured"]), f"{c['n_ops']:.0f}",
                  fmt_bytes(c["link_bytes"]), fmt_bytes(c["cross_pod_bytes"])]
        else:
            sh = ["—"] * 6
        rows.append(
            f"| {r['arch']}×{r['shape']} | {r['mesh']} | {r['chips']} | "
            f"{r['lower_s']:.2f} ({lower_cut(r)}) | {sh[0]} | "
            f"{fmt_bytes(m['param_bytes'])} | {fmt_bytes(m['opt_bytes'])} | "
            f"{fmt_bytes(m['batch_bytes'] + m['state_bytes'])} | "
            f"{fmt_bytes(m['per_device_total'])} | {'yes' if m['fits'] else 'no'} | "
            + " | ".join(sh[1:]) + " |")
    return "\n".join(rows)


def fit_word(fits) -> str:
    """A measured fit: yes, no, or "cut" where the step ran at fewer
    tokens than the cell (``fits_measured`` null)."""
    return "cut" if fits is None else "yes" if fits else "no"


def fits_table(res: dict) -> str:
    """Cells that fit 80 GB per mesh: by the specs and by the measured
    peak (of the cells whose sharded step ran at the cell's length)."""
    rows = ["| mesh | cells | fit by specs | measured | fit measured |",
            "|---|---|---|---|---|"]
    for mesh in sorted({r["mesh"] for r in res.values()}):
        cells = [r for r in res.values() if r["mesh"] == mesh and "memory" in r]
        measured = [r["memory"]["measured"] for r in cells
                    if (r["memory"].get("measured") or {}).get("fits_measured")
                    is not None]
        rows.append(f"| {mesh} | {len(cells)} | "
                    f"{sum(r['memory']['fits'] for r in cells)} | "
                    f"{len(measured)} | "
                    f"{sum(m['fits_measured'] for m in measured)} |")
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
            f"{fmt_bytes(r['memory']['per_device_total'])} | "
            f"{fmt_bytes(m['memory']['per_device_total'])} | "
            f"{m['analytic']['collective_s']:.2e} |")
    return "\n".join(rows)


def main(path: Path = RESULTS) -> str:
    res = json.loads(Path(path).read_text())
    out = "\n".join(["## DRYRUN\n", dryrun_table(res), "\n## FITS\n",
                     fits_table(res), "\n## ROOFLINE\n",
                     roofline_table(res), "\n## MULTI\n", multi_table(res)])
    print(out)
    return out


if __name__ == "__main__":
    main()
