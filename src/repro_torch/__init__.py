"""repro_torch — the PyTorch + CUDA port of the GenASM read-mapping system.

A second package beside the JAX reference `repro`, with the same
subpackage names (`core`, `kernels`, `align`, `genomics`, `serve`,
`dist`, `obs`, `launch`) so each module's counterpart is easy to find.
It imports `torch` and numpy only.  Bitvector words are carried as
``torch.int32`` bit patterns (the uint32 words of the reference); the
two GenASM-DC kernels are hand-written CUDA for Hopper
(`kernels/csrc/genasm_dc.cu`), each with a plain PyTorch version that
the CPU runs.
"""
