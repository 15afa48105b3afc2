"""Observability: request tracing (spans, ring-buffer log, Perfetto export)."""
