"""Kernel-level roofline observability (DESIGN.md §13).

Port of `repro.obs.roofline`.  The tracing plane says *where wall time
goes* per stage; this module says *whether each kernel is fast for the
hardware it runs on*.  GenASM's DC phase has exact, analytically
countable work — bit-vector word-ops per (text step, distance row, word)
and TB-store bytes per window — so every align dispatch site gets three
numbers:

* **analytic** — exact per-call counters (`align_counters`) as a pure
  function of ``(backend, bucket_cap, k, batch, w, o)``.  The per-window
  terms are the reference's (``w·(k+1)·6·nw`` word-ops,
  ``w·(k+1)·3·nw·4`` TB bytes for the M/I/D store, ``(w+1)·(k+1)·nw·4``
  for the v2 R-only store).  The launch structure is the port's: the
  CUDA DC kernels take no batch tile — one launch per window step over
  the whole batch, a warp a window (four windows a block for v2) — so a
  call makes ``n_windows`` launches over ``batch`` lanes, and the
  counters equal the reference's Pallas counters at ``block_bt = batch``.
* **measured** — the DC kernels' device time from `torch.profiler`:
  one distances-only `align_batch` at the site's signature on seeded
  inputs, warmed once, then profiled (`measured_align_cost`).  It counts
  the kernel records (``measured_launches``) and sums their device time
  (``measured_kernel_s``).  The card has no compiler cost model, so
  ``measured_ops`` / ``measured_bytes`` stay ``None``; a site with no
  CUDA kernel (the CPU, the ``torch`` backend) reports an error instead.
* **achieved** — analytic ops over the wall seconds of the align stage
  that the tracing plane collects (``pct_of_roof``), and over the
  kernels' measured device seconds (``pct_of_roof_kernel``), against a
  pluggable :class:`DeviceSpec` (JSON files under ``device_specs/``:
  ``h100_sxm``, ``gpu_generic``, ``cpu_host``).

The reference's ``predict_block_bt`` ranks Pallas batch tiles with
`predict_time_s`; no CUDA kernel of the port takes a batch tile, so it
has no counterpart here.

Stdlib-only at import time (the `repro_torch.obs` contract): `torch`,
`repro_torch.align` and `repro_torch._device` (a CUDA device must
be visible: every default device is ``cuda``) are imported lazily inside
`DeviceSpec.for_device` and the measured-side helpers.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path

SPEC_DIR = Path(__file__).with_name("device_specs")

# mirrors repro_torch.core.bitvector.WORD_BITS without importing torch
WORD_BITS = 32
# word-ops per (text step, distance row, word) of the DC recurrence:
# three shl1 (shift+carry-or counts as 2) feed one 3-way AND chain —
# ~6 uint32 ops per cell
DC_OPS_PER_CELL = 6
# the paper's TB store streams 3 intermediate bitvectors (M, I, D)
TB_VECTORS_V1 = 3


# ---------------------------------------------------------------- specs ----
@dataclass(frozen=True)
class DeviceSpec:
    """Roofline targets of one device, loaded from a JSON spec file.

    ``peak_flops`` is the dense-matmul peak (bf16 FMA/s); ``peak_word_ops``
    is the 32-bit integer/logical throughput outside the tensor cores,
    the peak the bit-parallel GenASM kernels can actually reach (on the
    H100, their word operations as the sources write them, a second, as
    `repro_torch.kernels.word_ops` measured them);
    ``launch_overhead_s`` is the fixed per-kernel-launch host cost.
    """

    name: str
    peak_flops: float
    peak_word_ops: float
    hbm_bw: float
    link_bw: float = 0.0
    launch_overhead_s: float = 0.0
    description: str = ""

    @classmethod
    def from_json(cls, path: str | Path) -> "DeviceSpec":
        """Load a spec file (unknown keys are ignored, future-proof)."""
        raw = json.loads(Path(path).read_text())
        kw = {k: raw[k] for k in
              ("name", "peak_flops", "peak_word_ops", "hbm_bw", "link_bw",
               "launch_overhead_s", "description") if k in raw}
        return cls(**kw)

    @classmethod
    def load(cls, name: str | Path) -> "DeviceSpec":
        """Bundled spec by name (``h100_sxm``/``gpu_generic``/``cpu_host``)
        or any explicit ``*.json`` path."""
        p = Path(name)
        if p.suffix == ".json" and p.exists():
            return cls.from_json(p)
        bundled = SPEC_DIR / f"{name}.json"
        if not bundled.exists():
            known = sorted(f.stem for f in SPEC_DIR.glob("*.json"))
            raise ValueError(f"unknown device spec {name!r}; bundled: {known}")
        return cls.from_json(bundled)

    @classmethod
    def for_device(cls, device="cuda") -> "DeviceSpec":
        """Spec for a torch device: ``h100_sxm`` for an H100 other than the
        PCIe card, ``gpu_generic`` for any other CUDA card (the report
        names the card), ``cpu_host`` for the CPU.  A CUDA device must be
        visible (no silent CPU fallback)."""
        card = device_name(_resolve(device))
        if card == "cpu":
            return cls.load("cpu_host")
        return cls.load("h100_sxm" if "H100" in card and "PCIe" not in card
                        else "gpu_generic")

    def roof_ops_per_s(self, intensity: float) -> float:
        """Attainable word-ops/s at ``intensity`` (ops/HBM byte)."""
        return min(self.peak_word_ops, max(intensity, 0.0) * self.hbm_bw)


def _resolve(device):
    from repro_torch._device import resolve_device

    return resolve_device(device)


def device_name(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, else ``"cpu"``."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# ------------------------------------------------------- analytic model ----
@dataclass(frozen=True)
class KernelCounters:
    """Exact per-``align_batch``-call work of one dispatch site."""

    word_ops: float  # uint32 ops across all launches of one call
    tb_bytes: float  # TB-store stream (the ASIC's TB-SRAM traffic)
    hbm_bytes: float  # total device-memory traffic (inputs+outputs+TB)
    launches: int  # kernel grid launches per call
    exact: bool = True  # False for the ref oracle's DP-cell estimate
    notes: dict = field(default_factory=dict)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity: word-ops per HBM byte."""
        return self.word_ops / self.hbm_bytes if self.hbm_bytes else 0.0


def n_windows(bucket_cap: int, *, w: int = 64, o: int = 24) -> int:
    """Window steps of one aligned read at ``bucket_cap`` (cfg.n_windows)."""
    return -(-bucket_cap // (w - o)) + 2


def dc_window_counters(w: int, k: int, *, store: str = "mid") -> dict:
    """Hand-checkable per-lane, per-window DC terms.

    ``store`` selects the TB layout: ``"mid"`` (M/I/D, paper-faithful —
    the v1 kernel and the ``torch`` backend, which materializes the same
    store) or ``"r"`` (v2 R-only rows).
    """
    if w % WORD_BITS:
        raise ValueError(f"w must be a multiple of {WORD_BITS}, got {w}")
    nw = w // WORD_BITS
    word_ops = w * (k + 1) * DC_OPS_PER_CELL * nw
    if store == "mid":
        tb_bytes = w * (k + 1) * TB_VECTORS_V1 * nw * 4
    elif store == "r":
        tb_bytes = (w + 1) * (k + 1) * nw * 4  # incl. the i=w boundary row
    else:
        raise ValueError(f"store must be 'mid' or 'r', got {store!r}")
    return {"word_ops": word_ops, "tb_bytes": tb_bytes, "nw": nw}


# the torch backend is the reference's lax twin (one batched DC pass a step)
_STORE_OF = {"torch": "mid", "cuda_dc": "mid", "cuda_dc_v2": "r"}


def align_counters(backend: str, bucket_cap: int, k: int, batch: int, *,
                   w: int = 64, o: int = 24) -> KernelCounters:
    """Exact analytic counters for one ``align_batch`` call at a site.

    Every modelled backend runs one DC launch per window step over the
    whole batch (the CUDA kernels have no batch tile), so every lane
    counts; distances-only vs CIGAR does not change DC work.  The
    ``ref`` oracle has no kernel — it gets a DP-cell estimate (1 op +
    ~2 bytes per cell) flagged ``exact=False``.  The graph backends have
    no model (``KeyError``), as in the reference.
    """
    nwin = n_windows(bucket_cap, w=w, o=o)
    if backend == "ref":
        t_cap = bucket_cap + 2 * w
        cells = float(batch) * bucket_cap * t_cap
        return KernelCounters(
            word_ops=cells, tb_bytes=0.0, hbm_bytes=2.0 * cells, launches=0,
            exact=False, notes={"model": "dp_cells", "n_windows": nwin})
    store = _STORE_OF.get(backend)
    if store is None:
        raise KeyError(f"no analytic counter model for backend {backend!r}")
    per = dc_window_counters(w, k, store=store)
    lanes = nwin * batch  # window executions across the whole call
    word_ops = float(lanes) * per["word_ops"]
    tb_bytes = float(lanes) * per["tb_bytes"]
    # per window step: read text+pattern tiles (int8), write d_min (int32)
    # and stream the TB store to device memory
    io_bytes = float(nwin) * batch * (2 * w + 4)
    return KernelCounters(
        word_ops=word_ops, tb_bytes=tb_bytes, hbm_bytes=io_bytes + tb_bytes,
        launches=nwin,
        notes={"n_windows": nwin, "batch_padded": batch, "store": store})


def predict_time_s(c: KernelCounters, spec: DeviceSpec) -> float:
    """Model time of one call: launch overhead + the binding roof term."""
    roof = max(c.word_ops / spec.peak_word_ops,
               c.hbm_bytes / spec.hbm_bw if spec.hbm_bw else 0.0)
    return c.launches * spec.launch_overhead_s + roof


# -------------------------------------------------------- measured side ----
# each CUDA backend's DC kernel, as the profiler names its entry function
KERNEL_ENTRY = {"cuda_dc": "dc_wave_v1", "cuda_dc_v2": "dc_wave_v2"}


def measured_align_cost(backend: str, bucket_cap: int, k: int, batch: int, *,
                        device="cuda") -> dict:
    """The DC kernels' device time for one call at a dispatch site.

    Runs one distances-only `align_batch` on ``device`` at the site's
    signature (seeded inputs, the reference's), once to warm up and once
    under `torch.profiler`, and returns ``{"measured_launches",
    "measured_kernel_s", "measured_ops": None, "measured_bytes": None}``.
    The profiler sees every kernel of the process, so a caller that
    shares the card with a serving engine holds the engine off (the
    `RooflineManager` does, through ``device_lock``).  A site with no
    CUDA kernel returns ``{"error": ...}``.
    """
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.align.api import align_batch
    from repro_torch.core.genasm import GenASMConfig

    dev = _resolve(device)
    entry = KERNEL_ENTRY.get(backend)
    if dev.type != "cuda" or entry is None:
        return {"error": f"no CUDA kernel to profile: backend {backend!r} "
                         f"on {dev}"}
    cfg = GenASMConfig(k=k, o=min(k, 24) or 8)
    rng = np.random.default_rng(0xB10C)
    texts = torch.from_numpy(rng.integers(
        0, 4, size=(batch, bucket_cap + 2 * cfg.w)).astype(np.int8)).to(dev)
    pats = torch.from_numpy(rng.integers(
        0, 4, size=(batch, bucket_cap)).astype(np.int8)).to(dev)
    p_lens = torch.full((batch,), bucket_cap, dtype=torch.int32, device=dev)
    t_lens = torch.full((batch,), bucket_cap + 2 * cfg.w, dtype=torch.int32,
                        device=dev)

    def run():
        align_batch(texts, pats, p_lens, t_lens, cfg=cfg, backend=backend,
                    p_cap=bucket_cap, emit_cigar=False)
        torch.cuda.synchronize(dev)

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    recs = [(t0, t1) for name, t0, t1 in device_records(prof) if entry in name]
    return {"measured_ops": None, "measured_bytes": None,
            "measured_launches": len(recs),
            "measured_kernel_s": sum(t1 - t0 for t0, t1 in recs) / 1e9}


def device_records(prof) -> list[tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every device record (kernels,
    copies, memsets) of a finished `torch.profiler` session.

    Read from the profiler's raw records: its event tree (``events()``,
    ``key_averages()``) is slow to build for the ~10^5 records of one
    align call, and built from a CUDA-only session it has held fewer
    kernels than ran.
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


# ------------------------------------------------------------- manager ----
@dataclass
class _Site:
    """One ``(backend, bucket_cap, k, batch)`` dispatch site."""

    backend: str
    bucket_cap: int
    k: int
    batch: int
    counters: KernelCounters
    calls: int = 0
    align_s: float = 0.0
    measured: dict | None = None  # profiled kernel run cache (or {"error"})

    @property
    def key(self) -> str:
        return f"{self.backend}/cap{self.bucket_cap}"


class RooflineManager:
    """Per-process registry of align-kernel dispatch sites.

    The serve engine calls :meth:`record_flush` after every linear-
    workload flush with the align stage's wall interval; the manager
    folds in the site's analytic counters, increments the per-kernel
    `Metrics` counters (``kernel_<backend>_cap<cap>_word_ops`` /
    ``_tb_bytes`` / ``_hbm_bytes`` / ``_launches`` / ``_align_s``), and
    emits a Perfetto ``"C"`` counter sample through the bound tracer.
    :meth:`report` is the ``/roofline`` payload: one row per site with
    analytic, measured (the profiled kernel run on ``device``, cached)
    and achieved terms against the device spec.  ``enabled=False`` makes
    ``record_flush`` a no-op.

    ``device_lock`` serialises the measured run with the engine's
    flushes (the engine holds it around each flush's device work), so
    the profiler sees the measured call's kernels only.
    """

    def __init__(self, spec: DeviceSpec | None = None, *, device="cuda",
                 metrics=None, tracer=None, enabled: bool = True,
                 measure: bool = True) -> None:
        _resolve(device)  # a CUDA device must be visible
        self.device = device
        self.spec = spec or DeviceSpec.for_device(device)
        self.metrics = metrics
        self.tracer = tracer
        self.enabled = enabled
        self.measure = measure  # allow profiled kernel runs from report()
        self.device_lock = threading.Lock()
        self._sites: dict[tuple, _Site] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ record --
    def site(self, backend: str, bucket_cap: int, k: int,
             batch: int) -> _Site | None:
        """Get-or-register a dispatch site (None if unmodelable)."""
        key = (backend, bucket_cap, k, batch)
        with self._lock:
            s = self._sites.get(key)
            if s is None:
                try:
                    c = align_counters(backend, bucket_cap, k, batch)
                except KeyError:  # graph/unknown backends: no model yet
                    return None
                s = self._sites[key] = _Site(
                    backend=backend, bucket_cap=bucket_cap, k=k, batch=batch,
                    counters=c)
            return s

    def record_flush(self, backend: str, bucket_cap: int, k: int, batch: int,
                     *, align_s: float | None) -> KernelCounters | None:
        """Fold one flush's align launch into the site's running totals."""
        if not self.enabled:
            return None
        s = self.site(backend, bucket_cap, k, batch)
        if s is None:
            return None
        c = s.counters
        with self._lock:
            s.calls += 1
            if align_s is not None:
                s.align_s += max(align_s, 0.0)
            cum_ops, cum_bytes = c.word_ops * s.calls, c.hbm_bytes * s.calls
        if self.metrics is not None:
            pre = f"kernel_{backend}_cap{bucket_cap}"
            self.metrics.counter(f"{pre}_word_ops").inc(c.word_ops)
            self.metrics.counter(f"{pre}_tb_bytes").inc(c.tb_bytes)
            self.metrics.counter(f"{pre}_hbm_bytes").inc(c.hbm_bytes)
            self.metrics.counter(f"{pre}_launches").inc(c.launches)
            if align_s is not None:
                self.metrics.counter(f"{pre}_align_s").inc(max(align_s, 0.0))
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.counter(f"kernel/{s.key}", word_ops=cum_ops,
                                hbm_bytes=cum_bytes)
        return c

    # ------------------------------------------------------------ report --
    def _measure_site(self, s: _Site) -> dict | None:
        if s.measured is None and self.measure:
            try:
                with self.device_lock:
                    s.measured = measured_align_cost(
                        s.backend, s.bucket_cap, s.k, s.batch,
                        device=self.device)
            except Exception as e:  # keep /roofline alive on exotic backends
                s.measured = {"error": f"{type(e).__name__}: {e}"}
        return s.measured

    def report(self, *, measure: bool | None = None) -> dict:
        """The ``/roofline`` payload: one row per dispatch site."""
        with self._lock:
            sites = list(self._sites.values())
        rows = []
        for s in sites:
            c = s.counters
            m = self._measure_site(s) if (measure if measure is not None
                                          else self.measure) else s.measured
            m = m or {}
            ach_ops = c.word_ops * s.calls / s.align_s if s.align_s else 0.0
            ach_bytes = c.hbm_bytes * s.calls / s.align_s if s.align_s else 0.0
            roof = self.spec.roof_ops_per_s(c.intensity)
            kernel_s = m.get("measured_kernel_s")
            rows.append({
                "kernel": s.key,
                "backend": s.backend, "bucket_cap": s.bucket_cap,
                "k": s.k, "batch": s.batch,
                "launches_per_call": c.launches, "calls": s.calls,
                "exact": c.exact,
                "analytic_ops": c.word_ops,
                "analytic_tb_bytes": c.tb_bytes,
                "bytes": c.hbm_bytes,
                "measured_ops": m.get("measured_ops"),
                "measured_bytes": m.get("measured_bytes"),
                "measure_error": m.get("error"),
                "intensity": round(c.intensity, 4),
                "align_s": round(s.align_s, 6),
                "achieved_ops_per_s": ach_ops,
                "achieved_bytes_per_s": ach_bytes,
                "pct_of_roof": round(ach_ops / roof, 6) if roof else 0.0,
                "measured_launches": m.get("measured_launches"),
                "kernel_s": kernel_s,
                "pct_of_roof_kernel": (
                    round(c.word_ops / kernel_s / roof, 6)
                    if kernel_s and roof else None),
            })
        rows.sort(key=lambda r: (r["backend"], r["bucket_cap"]))
        return {"device_spec": {
                    "name": self.spec.name,
                    "peak_word_ops": self.spec.peak_word_ops,
                    "peak_flops": self.spec.peak_flops,
                    "hbm_bw": self.spec.hbm_bw,
                    "link_bw": self.spec.link_bw,
                    "launch_overhead_s": self.spec.launch_overhead_s,
                    "card": device_name(self.device)},
                "kernels": rows}
