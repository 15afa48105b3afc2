"""On-device shard merge: packed order-preserving int64 keys + argmin.

Port of `repro.shard.merge`.  The per-shard winners of the scatter stage
reduce to one winner per read on the device, by one ``argmin`` over the
shard axis of a packed key:

* `pack_linear_key` / `pack_graph_key` pack one candidate's
  lexicographic sort tuple — ``(distance, position)`` for the linear
  workload, ``(distance, origin, tile)`` for the graph workload — into
  one ``int64`` whose order is the tuple's order.  Sentinel components
  (`POS_SENTINEL`, "no candidate") take the top of their field, so
  masked candidates sort last, as in the host rule.
* `merge_linear` / `merge_graph` take the stacked ``[S, B, ...]`` stage
  outputs, ``argmin`` the key over the shard axis and gather each
  read's winner row.  ``torch.argmin`` returns the *first* minimum, so a
  full-key tie goes to the lowest shard, as `repro.core.mapper.lex_best`
  and the host merge (``merge_host``) break it.

Field layout (the reference's, checked by `check_graph_domain`):

    linear  key = distance[32] . position[32]
    graph   key = distance[12] . origin[31] . tile[21]

The reference packs into ``uint64``.  torch has no ordered unsigned
64-bit type, so the keys are ``int64``.  The linear key is order-safe as
it is (both fields are non-negative int32).  The graph key would be
order-safe as a signed value only while ``distance < 2048``, and
`check_graph_domain` admits up to 4094, so the distance field is biased
by ``-2048``: the key is the reference's unsigned key minus ``2**63``,
which keeps its order over the whole domain.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapper import POS_SENTINEL

# graph key bit layout: 12 + 31 + 21 = 64
GRAPH_D_BITS = 12
GRAPH_ORIGIN_BITS = 31
GRAPH_TILE_BITS = 21
GRAPH_D_MAX = (1 << GRAPH_D_BITS) - 1
GRAPH_ORIGIN_MAX = (1 << GRAPH_ORIGIN_BITS) - 1  # == POS_SENTINEL
GRAPH_TILE_MAX = (1 << GRAPH_TILE_BITS) - 1  # sentinel encoding for tiles
# the distance field's bias: the top bit of the unsigned key, as a sign
GRAPH_D_BIAS = 1 << (GRAPH_D_BITS - 1)
_LOW_BITS = GRAPH_ORIGIN_BITS + GRAPH_TILE_BITS


def pack_linear_key(distance: torch.Tensor, position: torch.Tensor
                    ) -> torch.Tensor:
    """Order-preserving int64 key of the linear ``(distance, position)``
    tuple, for non-negative int32 components (`POS_SENTINEL` positions
    sort last)."""
    return (distance.to(torch.int64) << 32) | position.to(torch.int64)


def unpack_linear_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_linear_key`: ``(distance, position)`` int32."""
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def pack_graph_key(distance: torch.Tensor, origin: torch.Tensor,
                   tile: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of the graph ``(distance, origin, tile)``
    tuple: the reference's unsigned key minus ``2**63``.

    Domain (checked per geometry by `check_graph_domain`): ``0 <=
    distance <= GRAPH_D_MAX``; ``origin < POS_SENTINEL`` or exactly
    `POS_SENTINEL` (the 31-bit field max, its own encoding); ``tile <
    GRAPH_TILE_MAX`` or `POS_SENTINEL` (clamped to the 21-bit field max).
    Dead candidates carry sentinel origin *and* tile (one ``live`` mask
    upstream), which keeps the packed argmin equal to the host
    three-level merge.  The fields do not overlap, so the sum below is
    the reference's bitwise OR, with the distance field signed.
    """
    t = tile.to(torch.int64).clamp(0, GRAPH_TILE_MAX)
    return ((distance.to(torch.int64) - GRAPH_D_BIAS) * (1 << _LOW_BITS)
            + (origin.to(torch.int64) << GRAPH_TILE_BITS) + t)


def unpack_graph_key(key: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `pack_graph_key`: ``(distance, origin, tile)`` int32;
    the tile field's max decodes back to `POS_SENTINEL`."""
    d = (key >> _LOW_BITS) + GRAPH_D_BIAS  # arithmetic shift: floor
    origin = (key >> GRAPH_TILE_BITS) & GRAPH_ORIGIN_MAX
    t = key & GRAPH_TILE_MAX
    tile = torch.where(t == GRAPH_TILE_MAX, POS_SENTINEL, t)
    return d.to(torch.int32), origin.to(torch.int32), tile.to(torch.int32)


def check_graph_domain(*, n_tiles: int, filter_k: int) -> None:
    """Raise if a graph geometry cannot round-trip through the key fields.

    ``n_tiles`` must leave the 21-bit field max free for the sentinel and
    ``filter_k + 1`` (the "no candidate" distance) must fit the 12-bit
    distance field.
    """
    if n_tiles >= GRAPH_TILE_MAX:
        raise ValueError(
            f"graph index has {n_tiles} tiles but the packed merge key's "
            f"tile field holds {GRAPH_TILE_MAX - 1} + sentinel; shard the "
            f"graph or widen GRAPH_TILE_BITS")
    if filter_k + 1 > GRAPH_D_MAX:
        raise ValueError(
            f"filter_k {filter_k} overflows the packed merge key's "
            f"{GRAPH_D_BITS}-bit distance field (max {GRAPH_D_MAX - 1})")


def gather_winner(arr: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``arr[win[b], b, ...]`` for a stacked ``[S, B, ...]`` tensor."""
    return arr[win, torch.arange(win.shape[0], device=win.device)]


def merge_linear(distance, position, text, t_len):
    """Argmin-reduce of stacked linear shard winners on their device.

    Returns ``(fd, pos, text, t_len, winner_shard)`` per read, with the
    host merge's tie-break (lowest shard), as device tensors.
    """
    win = pack_linear_key(distance, position).argmin(0)  # first min
    return (gather_winner(distance, win), gather_winner(position, win),
            gather_winner(text, win), gather_winner(t_len, win), win)


def merge_graph(distance, origin, tile, *rest):
    """Argmin-reduce of stacked graph shard winners on their device.

    Picks each read's shard by the packed ``(distance, origin, tile)``
    key and returns the winner of every input (``distance``, ``origin``,
    ``tile``, then ``rest`` in order) plus the winner shard.
    """
    win = pack_graph_key(distance, origin, tile).argmin(0)
    return tuple(gather_winner(a, win)
                 for a in (distance, origin, tile) + rest) + (win,)
