"""The model zoo: decoder-only and encoder-decoder LMs (port of `repro.models`)."""
