"""Logical-axis sharding resolver, onto DTensor placements.

Port of `repro.dist.sharding`.  Every parameter of `repro_torch.models`
carries a logical-axis annotation (the ``*_AXES`` tables next to each
``*_init``); this module resolves those annotations against a mesh into
*specs*, and a spec into DTensor placements.  The mapping is
megatron-style tensor parallelism over ``"model"`` (heads / mlp /
experts / vocab sharded, ``embed`` replicated) with the batch over the
data-parallel axes (``"pod"`` and/or ``"data"``).

A spec is the reference's: a per-dimension tuple of mesh-axis names
(a name, a tuple of names, or None), in the canonical short form
(trailing Nones dropped), so ``tuple(jax PartitionSpec)`` compares equal
to it.  ``placements(spec, mesh)`` turns it into one placement per mesh
dimension: ``Shard(d)`` where the mesh dimension is named at tensor
dimension ``d``, ``Replicate()`` elsewhere.

A *mesh* here is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dimensions, or any named-size mapping
(`repro_torch.launch.mesh.mesh_shape`), which is all that ``_fit``
reads: the dry run resolves production meshes with no process group.

One difference in layout from the reference: the port keeps a block's
parameters as ``blocks.{b}.…`` rows (`models/transformer.py`), where
the reference stacks them on a leading axis; ``_fit`` pads a short
``want`` on the left either way, so a block leaf's spec here is the
reference's spec without its leading (stacked) entry.

A sharded forward runs on DTensors inside ``sharded_ops(mesh)``.  GSPMD
reshards wherever an op needs it; DTensor does so where it has a rule.
The places where the port redistributes by hand, as GSPMD does
silently:

* the plain tensors the model code builds (positions, masks, zeros)
  count as replicated (``sharded_ops``: DTensor's implicit
  replication);
* the embedding gather (``gather_rows``): each rank indexes the whole
  table with its own token shard — DTensor's rule for the index
  backward (``index_put``) fails on a table and indices placed so in
  PyTorch 2.11;
* the attention core (`models/attention._on_shards`): each rank attends
  its own batch rows and heads as local tensors — the core's einsums
  flatten the sharded batch and head dims together, which DTensor
  refuses;
* attention's replication: where the KV heads do not divide "model",
  ``_fit`` replicates k and v, and `_on_shards` then replicates q too,
  so every "model" rank computes all heads (on the 16-way production
  axis every arch but seamless-m4t-medium: attention is not
  tensor-parallel there);
* the chunked cross-entropy (`models/layers._xent_on_shards`): the
  vocab-sharded logits are gathered whole, each rank sums its own rows
  as local tensors and the sums are partial over the data axes —
  DTensor's gather rule on a vocab-sharded dim fails on these shapes;
* the MoE dispatch (`models/moe._moe_chunk`): the tokens and the router
  are replicated and routed as local tensors on every rank (the global
  cumsum of the capacity positions, the indexed copy into ``[E, cap,
  D]``), the dispatch and the expert outputs are constrained over
  "model", and the combine runs on the replicated expert outputs —
  left to DTensor, the ranks' collectives diverged and the step hung;
  where the tokens come in several dispatch chunks, all of them are
  gathered first (`moe.moe_apply`);
* the microbatches (`train/loop.py`): the global rows are cut first and
  each microbatch is distributed over the data axes on its own;
* the decode state (``shard_state``; `models/transformer._attn_decode`,
  `attention.decode_attention`): each rank reads and writes its own
  shard of the KV cache in place, the new token's q, k and v
  redistributed to the cache's placements first; the Mamba, RWKV-6 and
  shift states are written back through ``write_state``, which
  redistributes the new value to the state's placements (an all-gather
  over "model", where the state is replicated and the mixer is
  tensor-parallel) — DTensor's in-place rules on views of a sharded
  state differ between PyTorch releases;
* the WKV recurrence (`models/rwkv6._wkv_on_shards`): each rank runs
  its own batch rows and heads as local tensors, as the attention core
  does — every time step's einsums would flatten the sharded batch and
  head dims together;
* Mamba's causal conv and selective scan (`models/mamba._conv_on_shards`,
  `_ssm_on_shards`): each rank runs its own batch rows and channels as
  local tensors, B and C gathered over "model" — PyTorch 2.11's DTensor
  fails on the conv's pad;
* sequence parallelism (``gather_sequence``, ``as_residual``): the
  normed input of each mixer and MLP, and the final hidden states
  before the chunked loss (`models/model_zoo.loss_fn`), are gathered
  over the sequence first, and each mixer's and MLP's output is
  scattered back to the residual stream's placements before the add,
  as Megatron's sequence parallelism does — PyTorch 2.11's DTensor
  refuses the matmuls' flatten of a sharded sequence dim, forward and
  backward.

Each core run on local tensors takes its inputs through ``local_shard``,
which hands the gradient back contiguous.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping

import torch

from repro_torch.models.attention import ATTN_AXES
from repro_torch.models.layers import (CONV, EMBED, EXPERT, HEADS, KV_HEADS,
                                       MLP, MLP_AXES, QKV, STATE, VOCAB)
from repro_torch.models.mamba import MAMBA_AXES
from repro_torch.models.moe import MOE_AXES
from repro_torch.models.rwkv6 import RWKV_AXES, RWKV_CM_AXES

# logical axis -> mesh axis it shards over (None = always replicated).
# ``embed`` stays replicated: the paired dim of every matmul is the
# tensor-parallel one, so activations enter/leave TP regions replicated
# over "model" and the reduction happens on the output projection.
MESH_RULES: dict[str, str | None] = {
    EMBED: None,
    MLP: "model",
    HEADS: "model",
    KV_HEADS: "model",
    QKV: "model",
    VOCAB: "model",
    EXPERT: "model",
    CONV: None,
    STATE: None,
}

# data-parallel axes in outer-to-inner order (the subset on the mesh is
# used; see launch/mesh.py)
DP_AXES = ("pod", "data")

# module name (a component of a parameter's name) -> {leaf: logical axes}
_MODULE_AXES: dict[str, dict] = {
    "attn": ATTN_AXES,
    "xattn": ATTN_AXES,
    "mlp": MLP_AXES,
    "moe": MOE_AXES,
    "mamba": MAMBA_AXES,
    "rwkv": RWKV_AXES,
    "cmix": RWKV_CM_AXES,
    "embed": {"tokens": (VOCAB, EMBED)},
    "lm_head": {"w": (EMBED, VOCAB)},
    "frontend_proj": {"w": (None, EMBED)},
}


def _mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a DeviceMesh or a named-size mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)  # anything with a ``.shape`` mapping


def _fit(mesh, shape, want) -> tuple:
    """Reconcile a wanted spec against an actual shape on a mesh.

    ``want`` is a per-dim tuple of mesh-axis names (a str, a tuple of
    strs, or None).  Rules, in order:

    * shorter ``want`` than rank: pad with None on the *left* (leading
      axes: microbatch dims, the reference's stacked blocks); longer:
      drop leading entries;
    * a mesh axis that is not on the mesh is ignored;
    * each mesh axis is used at most once across the whole spec;
    * a dim is only sharded if the (product of) axis sizes divides it —
      otherwise the axis is dropped (replicate rather than fail, which is
      what makes 1-device and axis-size-1 meshes degenerate no-ops);
    * trailing Nones are dropped (the canonical short form).
    """
    sizes = _mesh_sizes(mesh)
    shape = tuple(shape)
    want = tuple(want)
    rank = len(shape)
    if len(want) < rank:
        want = (None,) * (rank - len(want)) + want
    elif len(want) > rank:
        want = want[len(want) - rank:]

    used: set[str] = set()
    out = []
    for dim, w in zip(shape, want):
        axes = (w,) if isinstance(w, str) else tuple(w or ())
        kept = []
        prod = 1
        for a in axes:
            if a not in sizes or a in used:
                continue
            if dim % (prod * sizes[a]) != 0:
                continue
            kept.append(a)
            prod *= sizes[a]
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _dp(mesh) -> tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in _mesh_sizes(mesh))


def _logical_to_want(axes) -> tuple:
    return tuple(None if a is None else MESH_RULES.get(a) for a in axes)


def _param_want(name: str) -> tuple | None:
    """Logical-axes lookup for one parameter by its dotted name."""
    keys = name.split(".")
    for key in reversed(keys[:-1]):
        table = _MODULE_AXES.get(key)
        if table is not None:
            axes = table.get(keys[-1])
            return None if axes is None else _logical_to_want(axes)
    return None  # norms, biases, unknown leaves: replicate


def _named(tree) -> dict[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def param_specs(params, mesh) -> dict[str, tuple]:
    """A module's parameters (or a ``{name: tensor}`` dict of them) ->
    ``{name: spec}``.  Unannotated leaves (norm scales, biases) are
    replicated; annotated leaves shard per ``MESH_RULES``."""
    out = {}
    for name, p in _named(params).items():
        want = _param_want(name)
        out[name] = () if want is None else _fit(mesh, p.shape, want)
    return out


def batch_specs(batch, mesh) -> dict[str, tuple]:
    """Input batches shard dim 0 (the global batch) over the data axes."""
    dp = _dp(mesh)
    return {k: _fit(mesh, a.shape, (dp,) + (None,) * (a.dim() - 1))
            for k, a in batch.items()}


def state_specs(state, mesh):
    """Decode-state trees: batch dim over data axes, KV heads over "model".

    State leaves are stacked over blocks ([n_blocks, B, ...]), as the
    reference stacks them; the per-slot ``pos`` bookkeeping arrays stay
    replicated.  Returns a tree of the state's structure.
    """
    dp = _dp(mesh)

    def one(name, leaf):
        rank = leaf.dim()
        if name == "pos" or rank < 3:
            return ()
        if name in ("k", "v") and rank == 5:  # [n_blocks, B, S, Hkv, dh]
            return _fit(mesh, leaf.shape, (None, dp, None, "model", None))
        if name in ("k_scale", "v_scale") and rank == 4:
            return _fit(mesh, leaf.shape, (None, dp, None, "model"))
        # SSM / conv / WKV states: [n_blocks, B, ...]
        return _fit(mesh, leaf.shape, (None, dp) + (None,) * (rank - 2))

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else one(k, v)
                for k, v in tree.items()}

    return walk(state)


def shard_state(state, mesh):
    """A decode-state tree (`model_zoo.decode_state_init`) distributed over
    ``mesh`` with ``state_specs``: KV caches and their int8 scales over the
    data axes and "model", SSM, conv, WKV and shift states over the data
    axes, ``pos`` replicated.  Returns a tree of DTensors."""
    specs = state_specs(state, mesh)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, Mapping)
                else _put(v, mesh, spec[k]) for k, v in tree.items()}

    return walk(state, specs)


def row_placements(placements) -> tuple:
    """The placements of one block's rows of a state leaf stacked over
    blocks (``leaf[blk]``; the block dim is never sharded)."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim - 1) if p.is_shard() else p for p in placements)


def write_state(dst, value) -> None:
    """``dst.copy_(value)`` for ``dst`` a DTensor (rows of a placed decode
    state): ``value`` is redistributed to ``dst``'s placements and copied
    into this rank's shard, so the state keeps its placements."""
    local = value.redistribute(dst.device_mesh, dst.placements).to_local()
    dst.to_local().copy_(local)


# ------------------------------------------------------------ placements ---

# open sharded_ops contexts: DTensor's implicit-replication switch is
# process-wide and its context manager does not nest
_SHARDED_DEPTH = [0]


@contextlib.contextmanager
def sharded_ops(mesh):
    """Where ``mesh`` is set, plain tensors met by a DTensor op count as
    replicated (DTensor's ``implicit_replication``: masks, positions and
    constants that the model code builds).  Re-entrant: the train step
    opens it around forward and backward (a checkpointed block's
    recompute runs in the backward), and the forward again inside."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    ctx = contextlib.nullcontext() if _SHARDED_DEPTH[0] else implicit_replication()
    _SHARDED_DEPTH[0] += 1
    try:
        with ctx:
            yield
    finally:
        _SHARDED_DEPTH[0] -= 1


def replicated_local(x):
    """A DTensor's whole value as a plain tensor on every rank (replicated
    first: an all-gather where it is sharded); differentiable."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim).to_local()


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def work_placements(x, dims=(0, 2)) -> tuple:
    """The placements a core run on local shards keeps for DTensor ``x``:
    each mesh dim keeps a shard of one of ``dims`` (the batch rows and the
    heads or channels, which the core splits in whole groups) and
    replicates otherwise."""
    from torch.distributed.tensor import Replicate

    return tuple(p if any(p.is_shard(d) for d in dims) else Replicate()
                 for p in x.placements)


def local_shard(x, placements, work=None):
    """A DTensor redistributed to ``placements``, as this rank's plain
    local tensor, differentiable; its gradient reaches ``x`` contiguous.
    A core run on local tensors can hand back a permuted gradient (an
    einsum's backward), and DTensor's view rules read a local gradient's
    strides as those of a contiguous tensor (the backward of a
    tensor-parallel projection failed on one).

    ``work``: the placements that split the core's work (its batch rows,
    heads or channels).  Where the work is split over a mesh dim and ``x``
    is replicated over it (a weight against split rows, B and C against
    split channels), each rank's gradient of ``x`` covers its own share of
    the work: a partial sum over that dim."""
    from torch.distributed.tensor import Partial

    grad = None
    if work is not None:
        grad = tuple(Partial() if w.is_shard() and not p.is_shard() else p
                     for w, p in zip(work, placements))
    return _ContiguousGrad.apply(
        x.redistribute(x.device_mesh, placements).to_local(
            grad_placements=grad))


def from_local(local, mesh, placements, shape):
    """A rank's contiguous local result as a DTensor of global ``shape``
    (the contiguous global stride, computed without allocating)."""
    from torch.distributed.tensor import DTensor

    stride, step = [], 1
    for size in reversed(tuple(shape)):
        stride.append(step)
        step *= size
    return DTensor.from_local(local, mesh, placements, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def gather_rows(table, idx):
    """``table[idx]`` for a DTensor table and DTensor indices: each rank
    indexes the whole table (gathered) with its own index shard.  The rows
    carry the indices' placements, and the table's gradient is a partial
    sum over the mesh dims that split the indices."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = idx.device_mesh
    whole = table.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=tuple(Partial() if p.is_shard() else Replicate()
                              for p in idx.placements))
    return DTensor.from_local(whole[idx.to_local().long()], mesh,
                              idx.placements)


def wrap_replicated(t: torch.Tensor, mesh):
    """A plain tensor equal on every rank, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)


def placements(spec, mesh) -> tuple:
    """A spec -> one DTensor placement per dimension of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, w in enumerate(spec):
        for a in ((w,) if isinstance(w, str) else tuple(w or ())):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def _put(t: torch.Tensor, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, placements(spec, mesh))


def shard_put(tree, mesh, specs=None):
    """Distribute a tree over a DeviceMesh with resolved (or given) specs.

    A module's parameters are replaced in place by DTensor parameters and
    the module is returned; a ``{name: tensor}`` dict (optimizer moments,
    a batch) is returned as a new dict of DTensors.  ``specs`` defaults
    to ``param_specs`` (parameters and moments, which share their
    names).  Every rank of the mesh calls it: ``distribute_tensor`` takes
    rank 0's values.
    """
    if isinstance(tree, torch.nn.Module):
        specs = param_specs(tree, mesh) if specs is None else specs
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            mod.register_parameter(leaf, torch.nn.Parameter(
                _put(p, mesh, specs[name]), requires_grad=p.requires_grad))
        return tree
    specs = param_specs(tree, mesh) if specs is None else specs
    return {k: _put(t, mesh, specs[k]) for k, t in tree.items()}


def gather_sequence(x):
    """A sequence-parallel activation [B, S, ...] with its sequence dim
    gathered (Shard(1) -> Replicate), as Megatron's sequence parallelism
    gathers before a tensor-parallel region; anything else unchanged.
    The matmuls flatten batch and sequence, which PyTorch 2.11's DTensor
    refuses while the sequence is sharded."""
    from torch.distributed.tensor import Replicate

    if not hasattr(x, "placements") or not any(p.is_shard(1)
                                               for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in x.placements))


def as_residual(y, x):
    """A mixer's or MLP's output ``y`` redistributed to the placements of
    the residual stream ``x`` that it is added to, where ``x`` is
    sequence-parallel (a reduce-scatter of a partial sum): left to the
    add, the gradient of ``y`` would reach the matmul before it with the
    sequence still sharded, which PyTorch 2.11's DTensor cannot flatten.
    Anything else unchanged."""
    if not hasattr(x, "placements") or not any(p.is_shard(1)
                                               for p in x.placements):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def constrain_activations(x, mesh, *, seq_axis: bool = False):
    """Constrain a residual-stream activation [B, S, D] at a layer boundary.

    Batch over the data axes; with ``seq_axis`` the *sequence* dim is
    sharded over "model" (sequence parallelism — bounds the remat storage
    of 96-layer models).  ``x`` is a DTensor (or a dict of them), which is
    redistributed to that placement; ``mesh=None`` is the unsharded path
    and is a no-op.
    """
    if mesh is None:
        return x
    if isinstance(x, Mapping):
        return {k: constrain_activations(v, mesh, seq_axis=seq_axis)
                for k, v in x.items()}
    dp = _dp(mesh)
    want = (dp, "model" if seq_axis else None) + (None,) * (x.dim() - 2)
    return x.redistribute(mesh, placements(_fit(mesh, x.shape, want), mesh))


# ---------------------------------------------------- shard-stacked arrays ---

def stacked_specs(tree, mesh, *, axis: str = "shard") -> dict[str, tuple]:
    """Specs for shard-stacked arrays: dim 0 over ``axis``, rest replicated.

    `repro_torch.shard` stacks every per-shard reference array along a
    leading ``[num_shards, ...]`` axis.  This resolves that convention
    through the same `_fit` rules as the model parameters (a mesh
    without the axis, or a leading dim the axis size does not divide,
    degrades to replication).  ``mesh`` is a named mesh, or the device
    tuple of ``shard_mesh`` (a 1-D mesh over ``axis``).
    """
    if isinstance(mesh, tuple):
        mesh = {axis: len(mesh)}
    return {k: _fit(mesh, a.shape, (axis,) + (None,) * (a.dim() - 1))
            for k, a in tree.items()}


def shard_mesh(num_shards: int):
    """One CUDA device per shard (``cuda:0`` .. ``cuda:{S-1}``), or None.

    Returns None when fewer than ``num_shards`` cards are visible
    (callers run every shard on one device) or when ``num_shards == 1``
    (nothing to place).  The placement itself has one implementation,
    `repro_torch.shard.partition.resolve_devices` (one process, one
    stacked row a card, `partition.place`); this returns its device
    tuple, which ``stacked_specs`` reads as a 1-D mesh over its ``axis``.
    """
    if num_shards <= 1 or not torch.cuda.is_available() or \
            torch.cuda.device_count() < num_shards:
        return None
    from repro_torch.shard.partition import resolve_devices

    return resolve_devices("cuda", num_shards)
