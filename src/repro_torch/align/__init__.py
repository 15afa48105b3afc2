"""Unified alignment backend dispatch.

    from repro_torch import align
    res = align.align_batch(texts, patterns, p_lens, t_lens,
                            cfg=GenASMConfig(), backend="cuda_dc")

Importing the package registers the built-in backends (``ref``,
``torch``, ``cuda_dc``, ``cuda_dc_v2``) and the graph backends
(``graph_torch``, ``graph_cuda``, `repro_torch.graph.backends`).
"""
from .api import (  # noqa: F401
    Backend,
    align_batch,
    available_backends,
    get_backend,
    register_backend,
    resolve_backend,
)
from . import backends as _builtin_backends  # noqa: F401  (registers them)
from repro_torch.graph import backends as _graph_backends  # noqa: F401,E402
