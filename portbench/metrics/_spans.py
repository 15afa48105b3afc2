"""The program's spans of the profiled batches, for the readers of the
per-layer metrics that read them.

`repro_torch.core.mapper.LinearMapExecutor` traces each batch it maps
while a torch profiler records into `repro_torch.obs.trace`'s
``PROCESS_TRACER``: a ``map_batch`` root over ``seed_filter`` (``seed``,
``filter``) and ``align`` (``dc``, ``tb`` a window step), every span
tagged with the batch's number.  The profiled batches are the only ones
the harness runs under the profiler, so the log holds theirs alone.
"""
from __future__ import annotations

import sys


def batches(ctx):
    """``(epoch_offset_ns, [{span name: [spans]} a profiled batch])``, or
    None without a profile or where the program keeps no process log (a
    program older than its spans); raises where the log's batches are not
    the profiled ones.  ``epoch_offset_ns`` takes a span's monotonic
    stamps onto the profiler's epoch clock."""
    if ctx.profile is None:
        return None
    # the log of the module as the program loaded it: the yardstick
    # imports nothing of the program
    tracer = getattr(sys.modules.get("repro_torch.obs.trace"), "PROCESS_TRACER", None)
    if tracer is None:
        return None
    spans = tracer.log.spans()
    roots = [s for s in spans if s.name == "map_batch"]
    if len(roots) != ctx.profile.batches:
        raise RuntimeError(f"{len(roots)} map_batch spans in the process log "
                           f"for {ctx.profile.batches} profiled batches")
    by_batch = {r.attrs["batch"]: {} for r in roots}
    for s in spans:
        by_batch[s.attrs["batch"]].setdefault(s.name, []).append(s)
    return tracer.log.epoch_offset_ns, list(by_batch.values())


def mean_per_batch(ctx, per_batch):
    """The mean over the profiled batches of ``per_batch({name: spans})``,
    or None where `batches` finds nothing to read."""
    got = batches(ctx)
    if got is None:
        return None
    _, bs = got
    return sum(per_batch(b) for b in bs) / len(bs)


def device_ms(ctx, name: str):
    """Mean device milliseconds a batch of the spans called ``name``."""
    return mean_per_batch(ctx, lambda b: sum(s.attrs["device_ms"] for s in b[name]))
