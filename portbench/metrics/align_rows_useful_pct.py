"""Share of the rows the align stage ran on that passed the pre-alignment
filter, over the profiled batches: the `filter` spans' `passed` over the
`align` spans' `rows`.  Rows the filter rejected are aligned and then
reported unmapped."""
from portbench.metrics import _spans


def read(ctx):
    got = _spans.batches(ctx)
    if got is None:
        return None
    _, bs = got
    passed = sum(s.attrs["passed"] for b in bs for s in b["filter"])
    rows = sum(s.attrs["rows"] for b in bs for s in b["align"])
    return 100.0 * passed / rows
