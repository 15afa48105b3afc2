"""Sequence-to-graph mapping (SeGraM): windowed BitAlign, the tiled graph
index, the graph mapper and its two alignment backends.

Port of `repro.graph`, with the same 22 exports: the windowed BitAlign
that shares the linear aligner's window loop (`windowed`), the
``graph_torch``/``graph_cuda`` entries in the `repro_torch.align`
registry (`backends`), the tiled graph-reference index with epoch hooks
(`index`), and the batched graph mapper (`mapper`).  Importing this
package first, or `repro_torch.align` first, gives the same modules.
"""
from .backends import as_graph_text, batched_graph_align  # noqa: F401
from .index import (EpochedGraphIndex, GraphArrays, GraphIndex,  # noqa: F401
                    build_epoched_graph_index, build_graph_index,
                    load_graph_index, save_graph_index)
from .mapper import (GraphMapExecutor, GraphMapResult,  # noqa: F401
                     graph_backend_name, map_batch, map_batch_index,
                     tile_prefilter, tile_rung, unmapped_result)
from .windowed import (bitalign_search, graph_align,  # noqa: F401
                       pack_graph_text, pack_linear_text, unpack_graph_text)
