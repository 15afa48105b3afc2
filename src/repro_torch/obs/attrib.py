"""Per-stage wall-time attribution and the Amdahl report.

`build_ledger` folds finished spans (a `TraceLog` or a span list) into a
`StageLedger`: total wall time, call count, and the raw duration sample
per canonical pipeline stage —

    enqueue_wait   admission-queue wait (submit → flush start)
    encode         host read batching/padding
    seed_filter    linear seed + GenASM-DC pre-alignment filter
    prefilter      graph seed + q-gram tile screen (no DC)
    dc_filter      graph BitAlign-DC over the compacted candidate rows
    scatter        sharded per-shard seed+filter stage
    merge          host lexicographic merge of per-shard winners (legacy)
    merge_device   packed-key argmin-reduce of shard winners on device
    align          windowed GenASM/BitAlign alignment of the winners
    align_shard    the same align stage sharded over the shard mesh
    emit           result materialization, cache put, future resolution
    other          flush time not covered by any child stage span

Stage spans parented by a ``flush`` span additionally feed the coverage
accounting: ``coverage`` is attributed-stage time over total flush time,
the "stage wall-times sum to ≥90% of end-to-end time" check.  Stage
spans without a flush parent (direct executor use, failover drills)
still land in the ledger.

`StageLedger.report()` renders the Amdahl view the ROADMAP's sharding
items need: each stage's wall-time fraction of engine busy time,
p50/p99, whether today's implementation runs it serially, the measured
serial fraction, and the projected whole-pipeline speedup from sharding
*each* stage across N devices (``1 / ((1-f) + f/N)``) plus its ``N→∞``
ceiling (``1 / (1-f)``) — the number that says which stage to shard
next.  `render_report` formats the same dict as a fixed-width text
table for terminals and EXPERIMENTS.md.

Copied from `repro.obs.attrib`: the port's executors emit the same
canonical stage names.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, NamedTuple

from .trace import Span, TraceLog

# canonical stage order (pipeline position, not size)
STAGE_ORDER = ("enqueue_wait", "encode", "seed_filter", "prefilter",
               "dc_filter", "scatter", "merge", "merge_device", "align",
               "align_shard", "emit", "other")
_STAGE_SET = frozenset(STAGE_ORDER)

# stages whose current implementation already scales with shards; the
# rest (host merge, serial align launch, host emit, …) are the measured
# serial fraction sharding cannot touch until they are redesigned.
# merge_device/align_shard are the device-resident replacements for the
# serial host merge and serial align launch.
PARALLEL_STAGES = frozenset({"seed_filter", "prefilter", "dc_filter",
                             "scatter", "merge_device", "align_shard"})


def _quantile(sorted_durs: list[float], q: float) -> float:
    if not sorted_durs:
        return 0.0
    i = min(int(q * len(sorted_durs)), len(sorted_durs) - 1)
    return sorted_durs[i]


class AttributionReport(NamedTuple):
    """The Amdahl report: per-stage rows + whole-pipeline aggregates."""

    stages: list[dict]  # per-stage {name, calls, total_s, frac, p50_ms, ...}
    busy_s: float  # attributed engine busy time (excl. enqueue_wait)
    flush_s: float  # total wall time inside flush spans
    n_flushes: int
    coverage: float  # attributed-stage time / flush time (0 if no flushes)
    serial_fraction: float  # busy-time fraction in non-parallel stages

    def to_dict(self) -> dict:
        """Plain-dict form for JSON summaries and the `/attrib` endpoint."""
        return {"stages": self.stages, "busy_s": self.busy_s,
                "flush_s": self.flush_s, "n_flushes": self.n_flushes,
                "coverage": self.coverage,
                "serial_fraction": self.serial_fraction}


class StageLedger:
    """Accumulated per-stage durations, foldable from spans or directly."""

    def __init__(self) -> None:
        self._durs: dict[str, list[float]] = defaultdict(list)
        self._ops: dict[str, float] = defaultdict(float)  # analytic word-ops
        self._bytes: dict[str, float] = defaultdict(float)  # analytic HBM B
        self.flush_s = 0.0
        self.n_flushes = 0
        self.attributed_s = 0.0  # stage time parented inside flush spans

    def add(self, stage: str, duration_s: float, *, word_ops: float = 0.0,
            hbm_bytes: float = 0.0) -> None:
        """Record one stage execution (unknown names fold into "other").

        ``word_ops``/``hbm_bytes`` are the stage's analytic kernel
        counters when known (the engine attaches them to align spans) —
        they surface as ops/s and intensity columns in the report.
        """
        name = stage if stage in _STAGE_SET else "other"
        self._durs[name].append(max(float(duration_s), 0.0))
        self._ops[name] += max(float(word_ops), 0.0)
        self._bytes[name] += max(float(hbm_bytes), 0.0)

    def total(self, stage: str) -> float:
        """Accumulated wall seconds recorded for one stage."""
        return sum(self._durs.get(stage, ()))

    @property
    def busy_s(self) -> float:
        """Attributed busy time: every stage except the queue wait."""
        return sum(sum(d) for s, d in self._durs.items()
                   if s != "enqueue_wait")

    @property
    def coverage(self) -> float:
        """Attributed-stage share of total flush wall time (1.0 = all)."""
        if self.flush_s <= 0.0:
            return 0.0
        return self.attributed_s / self.flush_s

    def report(self, shard_counts: tuple[int, ...] = (2, 4)
               ) -> AttributionReport:
        """Fold the ledger into the Amdahl report (see module docstring)."""
        busy = self.busy_s
        stages = []
        serial = 0.0
        for name in STAGE_ORDER:
            durs = sorted(self._durs.get(name, ()))
            if not durs:
                continue
            total = sum(durs)
            # enqueue_wait overlaps other flushes' compute and is not
            # part of busy time, so a busy-fraction would be meaningless
            # (and can exceed 1 under load) — report it as 0
            frac = (total / busy if busy > 0 and name != "enqueue_wait"
                    else 0.0)
            parallel = name in PARALLEL_STAGES
            if name != "enqueue_wait" and not parallel:
                serial += frac
            row = {
                "stage": name, "calls": len(durs),
                "total_s": round(total, 6),
                "frac": round(frac, 4),
                "p50_ms": round(_quantile(durs, 0.50) * 1e3, 3),
                "p99_ms": round(_quantile(durs, 0.99) * 1e3, 3),
                "parallel": parallel,
            }
            # projected whole-pipeline speedup from sharding THIS stage
            for n in shard_counts:
                row[f"speedup_x{n}"] = round(
                    1.0 / ((1.0 - frac) + frac / n), 3) if frac < 1.0 else n
            row["speedup_inf"] = (round(1.0 / (1.0 - frac), 3)
                                  if frac < 1.0 else float("inf"))
            # per-kernel roofline columns, when counters were attached
            ops, nbytes = self._ops.get(name, 0.0), self._bytes.get(name, 0.0)
            if ops > 0.0 or nbytes > 0.0:
                row["word_ops"] = ops
                row["hbm_bytes"] = nbytes
                row["ops_per_s"] = round(ops / total, 1) if total else 0.0
                row["intensity"] = round(ops / nbytes, 4) if nbytes else 0.0
            stages.append(row)
        return AttributionReport(
            stages=stages, busy_s=round(busy, 6),
            flush_s=round(self.flush_s, 6), n_flushes=self.n_flushes,
            coverage=round(self.coverage, 4),
            serial_fraction=round(serial, 4))


def build_ledger(spans: TraceLog | Iterable[Span]) -> StageLedger:
    """Fold finished spans into a `StageLedger`.

    ``flush`` spans define the end-to-end window; their children with
    canonical stage names are attributed, and per-flush time no child
    covers lands in ``other`` (so the ledger always sums back to the
    flush wall time).  ``enqueue_wait`` spans are tallied but excluded
    from busy time and coverage — they overlap the previous flush's
    compute by design.
    """
    if isinstance(spans, TraceLog):
        spans = spans.spans()
    spans = list(spans)
    led = StageLedger()
    flushes = {s.span_id: s for s in spans if s.name == "flush"}
    covered = defaultdict(float)  # flush id → child stage time
    for s in spans:
        if s.name not in _STAGE_SET:
            continue
        led.add(s.name, s.duration_s,
                word_ops=s.attrs.get("word_ops", 0.0) or 0.0,
                hbm_bytes=s.attrs.get("hbm_bytes", 0.0) or 0.0)
        if s.parent_id in flushes and s.name != "enqueue_wait":
            covered[s.parent_id] += s.duration_s
            led.attributed_s += s.duration_s
    for fid, f in flushes.items():
        led.flush_s += f.duration_s
        led.n_flushes += 1
        led.add("other", max(f.duration_s - covered[fid], 0.0))
    return led


def render_report(report: AttributionReport) -> str:
    """Fixed-width text table of the Amdahl report."""
    lines = [
        f"stage attribution: {report.n_flushes} flushes, "
        f"busy {report.busy_s * 1e3:.1f} ms, coverage "
        f"{report.coverage:.1%}, serial fraction "
        f"{report.serial_fraction:.1%}",
        f"{'stage':<13}{'calls':>6}{'total_ms':>10}{'frac':>7}"
        f"{'p50_ms':>9}{'p99_ms':>9}{'par':>5}{'spd@4':>7}{'spd@inf':>9}",
    ]
    for r in report.stages:
        inf = r["speedup_inf"]
        inf_s = "inf" if inf == float("inf") else f"{inf:.2f}"
        lines.append(
            f"{r['stage']:<13}{r['calls']:>6}{r['total_s'] * 1e3:>10.1f}"
            f"{r['frac']:>7.1%}{r['p50_ms']:>9.2f}{r['p99_ms']:>9.2f}"
            f"{'y' if r['parallel'] else '-':>5}"
            f"{r.get('speedup_x4', 1.0):>7.2f}{inf_s:>9}")
    return "\n".join(lines)
