"""The model zoo's dense decoder-only family (port of `repro.models`)."""
