"""One run of one benchmark cell: set-up, the measured window, the
profiled batches, the check against the plain reference, the result line.

The cell is found by name in ``BENCHMARK.json``; its configuration file
names the mode (``modes/<mode>.py``: the program's side and the
reference's side of one kind of deployment), its traffic file the reads
and the arrival loop that drives the window (``arrivals/<name>.py``), and
each metric, end-to-end or per-layer, is read by ``metrics/<metric>.py``.
All of them are found by name under the checkout's ``portbench/``.

The timed path is the port's bulk pipeline: the read pool's batches,
encoded once by `ReadBatches` in set-up and cycled, feed a `Prefetcher`
(pinned memory, a non-blocking copy to the card on its thread); each
batch goes through the mode's executor and its results are copied to the
host.  `ReadBatches` encodes read by read in Python: on the prefetch
thread it held the interpreter against the executor's launch loop and
spread the runs, so it runs before the window.
"""
from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import generate

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that must not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold
    characters a dotted import would not take)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(SimpleNamespace):
    """A workload of ``BENCHMARK.json`` with its configuration and traffic."""


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; configuration files
    resolve against ``root``, everything found by name (traffic, modes,
    arrival loops, readers) under ``root/portbench``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "portbench"
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    # a configuration may fix traffic keys its deployment needs (a batch
    # that fits its card)
    traffic = {**json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
               **cfg.get("traffic", {})}
    metrics = [m for m in bench["per_layer"]
               if name in m.get("workloads", [w["name"]])]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], cfg=cfg, traffic=traffic,
                per_layer=metrics, end_to_end=e2e, dir=here,
                mode=load_module(here / "modes" / f"{cfg['mode']}.py"),
                arrivals=load_module(here / "arrivals" / f"{traffic['arrivals']}.py"))


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


class Window:
    """What the measured window saw, batch by batch: the arrival loop
    records each batch that completed inside it."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.done: list[float] = []  # completion times inside the window
        self.took: list[float] = []  # each batch's seconds, wait included
        self.launched: dict[str, int] = {}  # rows or windows launched: batches
        self.waits: list[float] = []
        self.stages: dict[str, list[float]] = {}
        self.reads = 0

    def record(self, rec: dict) -> None:
        """One batch, as `run`'s ``step`` returned it."""
        self.took.append(rec["done"] - (self.done[-1] if self.done else self.t0))
        self.done.append(rec["done"])
        self.waits.append(rec["wait"])
        self.reads += rec["reads"]
        key = ",".join(str(shape.get("rows", shape.get("windows")))
                       for _, shape in rec["work"])
        self.launched[key] = self.launched.get(key, 0) + 1
        for name, a, e, _ in rec["stages"]:
            self.stages.setdefault(name, []).append(e - a)

    @property
    def seconds(self) -> float:
        """From the window's start to the last completion inside it."""
        return self.done[-1] - self.t0

    def stage_mean_ms(self, *names) -> float | None:
        if not any(n in self.stages for n in names):
            return None
        total = sum(sum(self.stages.get(n, ())) for n in names)
        return 1e3 * total / len(self.done)


class Profile(SimpleNamespace):
    """The profiled batches: device records, span and launched work."""


def profile_batches(torch, step, n: int, card: str) -> Profile:
    """Run ``n`` batches under `torch.profiler` (device activity only) and
    return their device records, host span and work records."""
    from torch.profiler import ProfilerActivity, profile

    work, host = [], []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            rec = step()
            work += rec["work"]
            host += rec["host"]
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    records = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    kernels = [r for r in records if not r[0].startswith(("Memcpy", "Memset"))]
    return Profile(records=records, kernel_count=len(kernels), batches=n,
                   span_s=span, busy_s=union_s(r[1:] for r in records),
                   work=work, host=host, card=card)


def breakdown(prof: Profile) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host stage they fell in."""
    by_name: dict[str, float] = {}
    for name, a, b in prof.records:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for name, a, b in sorted(prof.records, key=lambda r: r[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        where = next((s for s, t0, t1 in prof.host if t0 <= mid <= t1), "outside a stage")
        named.append([f"idle in {where}", (b - a) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def run(args, *, device: str = "cuda", program_cls=None, root: Path = ROOT) -> dict:
    """One run of ``args.workload``; returns the result (without printing).

    ``program_cls`` stands a callable of the program's interface in its
    place (the control and the fault tests use it); ``device`` is
    ``cuda`` for every run of the benchmark.
    """
    t_setup0 = time.perf_counter()
    parts: dict[str, float] = {"startup": t_setup0 - args.t_start}
    import torch

    from repro_torch.genomics.pipeline import Prefetcher, ReadBatches

    c = cell(args.workload, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        card = torch.cuda.get_device_name(dev)
        from repro_torch.kernels import _build
        t = time.perf_counter()
        _build.build_all(c.cfg["kernels"])
        parts["kernels"] = time.perf_counter() - t
    else:
        card = "cpu"
    parts["import"] = time.perf_counter() - t_setup0 - parts.get("kernels", 0.0)
    t = time.perf_counter()
    data = c.mode.deployment(c.cfg, args.seed)
    parts["deployment"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = (program_cls or c.mode.Program)(c.cfg, data, dev)
    parts["index"] = time.perf_counter() - t
    t = time.perf_counter()
    tr = c.traffic
    pool = generate.read_pool(tr, args.seed, c.mode.read_source(c.cfg, data, dev),
                              dev)
    sample = generate.check_sample(pool, tr["check_per_batch"], args.seed)
    parts["pool"] = time.perf_counter() - t
    cap, b = c.cfg["mapper"]["p_cap"], pool.batch
    t = time.perf_counter()
    encoded = list(ReadBatches(pool.reads, batch=b, cap=cap))
    pool = pool._replace(reads=None)  # a million arrays the window need not keep
    parts["encode"] = time.perf_counter() - t
    got: dict[int, list] = {i: [] for i in range(pool.batches)}
    feed = Prefetcher(itertools.cycle(encoded), device=dev)
    batches = iter(feed)
    wall0 = time.time_ns() - time.monotonic_ns()  # monotonic -> wall ns

    def step():
        """One batch through the timed path: wait for it, map it, copy
        its results to the host; keep the sampled rows."""
        tw = time.perf_counter()
        bid, arr, lens = next(batches)
        t_got = time.perf_counter()
        out = prog(arr, lens)
        t_done = time.perf_counter()
        got[bid].append({k: v[sample[bid]] for k, v in out.items()})
        host = [(name, int(a * 1e9) + wall0, int(e * 1e9) + wall0)
                for name, a, e, _ in prog.stage_times]
        return {"wait": t_got - tw, "done": t_done, "stages": prog.stage_times,
                "work": prog.work(b), "host": host, "reads": b}

    try:
        t = time.perf_counter()
        step()  # the warm-up batch, at the cell's shape
        if dev.type == "cuda":
            torch.cuda.synchronize()
        parts["warmup"] = time.perf_counter() - t
        # what set-up made lives to the end: keep the collector off it
        gc.collect()
        gc.freeze()
        win = Window(time.perf_counter())
        setup_s = win.t0 - args.t_start
        c.arrivals.run(step, win, args.seconds)
        if not win.done:
            raise RuntimeError(f"no batch completed in a {args.seconds} s window")
        prof = None
        if args.trace and dev.type == "cuda":
            prof = profile_batches(torch, step, tr["profiled_batches"], card)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        feed.close()
    del prog, feed, batches
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the plain reference on every sampled row of every pool
    # batch, against each time the program answered for it
    t = time.perf_counter()
    ref = c.mode.Reference(c.cfg, data, dev)
    bids = [i for i, a in got.items() if a]
    rows = np.concatenate([i * b + sample[i] for i in bids])
    want = answer_in_blocks(ref, torch, pool.arr[rows][:, :cap],
                            pool.lens[rows].clip(max=cap), tr["check_block"], dev)
    n_checked = n_bad = 0
    mapped = float((want["position"] >= 0).mean())
    s = sample.shape[1]
    for j, bid in enumerate(bids):
        w = {k: v[j * s:(j + 1) * s] for k, v in want.items()}
        for ans in got[bid]:
            ok = c.mode.same(ans, w)
            n_checked += ok.size
            n_bad += int((~ok).sum())
    check_s = time.perf_counter() - t

    ctx = SimpleNamespace(
        window=win, setup_s=setup_s, profile=prof,
        roofline=lambda kernel, names, count: _roofline(prof, kernel, names, count))
    metrics = {}
    for m in (c.per_layer if args.trace else c.end_to_end):
        v = load_module(c.dir / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the last step before the result: whatever ran after the window (the
    # check, the readers) may not have loaded JAX or the JAX package
    loaded = forbidden_modules()
    result = {
        "correct": n_bad == 0 and n_checked > 0 and not loaded,
        "attempted": win.reads, "failed": n_bad, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card, "count": 1 if dev.type == "cuda" else 0,
                   "memory_peak_bytes": int(peak)},
    }
    if prof is not None:
        result["device"].update(busy_s=prof.busy_s, window_s=prof.span_s)
        result["breakdown"] = breakdown(prof)
    result["checks"] = {"mismatched_reads": {"value": n_bad, "limit": 0},
                        "checked_reads": {"value": n_checked, "limit": 1}}
    info = {"setup_s": setup_s, "setup_parts_s": parts, "batch": b,
            "batches_in_window": len(win.done), "window_s": win.seconds,
            "max_memory_allocated": int(peak), "check_s": check_s, "mapped_share": mapped,
            "stage_ms": {k: 1e3 * statistics.mean(v) for k, v in win.stages.items()},
            "batch_s": win.took, "launched": win.launched, "forbidden_modules": loaded}
    return {"result": result, "info": info}


def answer_in_blocks(fn, torch, arr, lens, block: int, dev, **kw) -> dict:
    """``fn`` (a mode's `Reference` or the control) over host reads in
    blocks of ``block`` rows, the answers concatenated."""
    parts = [fn(torch.as_tensor(arr[i:i + block], device=dev),
                torch.as_tensor(lens[i:i + block], device=dev), **kw)
             for i in range(0, arr.shape[0], block)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _roofline(prof, kernel: str, names, count) -> float | None:
    """``kernel``'s share of its roofline over the profiled batches: the
    card's least time for its work records, counted by ``count``, over the
    device time of the kernels whose names hold one of ``names``."""
    if prof is None:
        return None
    from portbench import work

    dev_s = sum(b - a for n, a, b in prof.records if any(k in n for k in names)) / 1e9
    if dev_s <= 0:
        return None
    return 100.0 * work.least_seconds(prof.work, prof.card, kernel, count) / dev_s
