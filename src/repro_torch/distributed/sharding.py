"""Logical-axis sharding rules with divisibility fallback (MaxText-style),
ported from the JAX package's ``distributed/sharding.py``: the rule tables
and their resolution, in plain Python.

Every tensor dim carries a logical name (``w_*`` for weights, ``act_*`` for
activations): :func:`repro_torch.models.transformer.param_axes` and
``input_specs`` give them. A rule table maps logical names to a priority list
of mesh-axis tuples. Resolution is *global-priority* (the table's order), not
dim order: in decode, ``act_kv_heads`` is tried before ``act_kv_seq``, so GQA
caches shard by head when the head count divides the axis and fall back to
sequence sharding otherwise. Mesh-axis candidates absent from the mesh
degrade gracefully: ``("pod", "data")`` on a mesh without ``pod`` acts as
``("data",)``.

A mesh is given by its axis names and sizes (:class:`MeshShape`, the
counterpart of JAX's ``AbstractMesh``) or is a ``DeviceMesh`` with named
dims; a resolved spec is a tuple with one entry per leading dim: ``None``,
an axis name, a tuple of names, or :data:`UNCONSTRAINED`, as the JAX
``PartitionSpec`` holds them.

On a ``DeviceMesh`` a spec becomes DTensor placements, one per mesh dim
(:func:`spec_placements`): an axis that a dim takes is ``Shard(dim)`` on
that mesh dim, every other mesh dim ``Replicate()``. A dim split over a
tuple of axes (``("pod", "data")``) is sharded over those mesh dims in the
mesh's order, outer first, as JAX splits it. :class:`NamedSharding` pairs a
mesh with a spec, as JAX's does; :func:`tree_shardings` gives one a
parameter, :func:`make_resolver` one an activation for
``models.layers.shard_act``, and :func:`place` puts a tensor that every
rank holds whole onto its shards with no collective: each rank slices its
own.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

Axes = Tuple[Optional[str], ...]
RuleTable = Dict[str, Sequence[Tuple[str, ...]]]


class _Unconstrained:
    """A dim left to the compiler's choice (JAX's ``P.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


@dataclass(frozen=True)
class MeshShape:
    """A device mesh by its axis names and sizes, e.g.
    ``MeshShape((2, 16, 16), ("pod", "data", "model"))``."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} and axis names {self.axis_names} differ")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


# --------------------------------------------------------------------------
# Baseline rule tables (order is priority)
# --------------------------------------------------------------------------

TRAIN_RULES: RuleTable = {
    # weights — TP over `model`, FSDP (ZeRO-3) over `data` on the other dim
    "w_vocab": [("model",)],
    "w_qdim": [("model",)],
    "w_kvdim": [("model",)],
    "w_mlp": [("model",)],
    "w_expert": [("model",)],          # EP when E % axis == 0 (moonshot, jamba)
    "w_moe_mlp": [("model",)],         # picks up TP when w_expert fell through (grok)
    "w_dinner": [("model",)],
    "w_embed": [("data",)],            # FSDP dim (pod added per-arch, see
    "w_state": [],                     # rules_for_cfg: grok/jamba only)
    "w_layers": [],
    # activations
    "act_batch": [("pod", "data")],
    "act_heads": [("model",)],
    "act_kv_heads": [("model",)],
    "act_mlp": [("model",)],
    "act_vocab": [("model",)],
    "act_expert": [("model",)],
    "act_seq": [],
    "act_embed": [],
    "act_kv_seq": [],
}

# prefill returns the full KV cache: shard kv_heads (else kv_seq) over model
# like decode. kv_seq is reinserted AFTER kv_heads, so it comes last in priority.
PREFILL_RULES: RuleTable = {**TRAIN_RULES,
                            "act_kv_heads": [("model",)],
                            "act_kv_seq": [("model",)]}
PREFILL_RULES["act_kv_seq"] = PREFILL_RULES.pop("act_kv_seq")

DECODE_RULES: RuleTable = {
    "w_vocab": [("model",)],
    "w_qdim": [("model",)],
    "w_kvdim": [("model",)],
    "w_mlp": [("model",)],
    "w_expert": [("model",)],
    "w_moe_mlp": [("model",)],
    "w_dinner": [("model",)],
    "w_embed": [("data",)],            # weights stay 2D-sharded for HBM fit
    "w_state": [],
    "w_layers": [],
    # weight-stationary decode: the residual stream is feature-sharded over
    # `data`, aligned with the weights' FSDP dim. act_embed resolves BEFORE
    # act_batch; cache tensors have no act_embed, so their batch dim still
    # takes (pod, data).
    "act_embed": [("data",)],
    "act_batch": [("pod", "data")],
    "act_kv_heads": [("model",)],      # tried BEFORE kv_seq (priority order)
    "act_kv_seq": [("model",)],        # flash-decode fallback for kv=8 archs
    "act_heads": [("model",)],
    "act_mlp": [("model",)],
    "act_vocab": [("model",)],
    "act_expert": [("model",)],
    "act_seq": [],
}

LONG_DECODE_RULES: RuleTable = {
    # batch=1: context parallelism — cache sequence over every available axis
    "act_kv_seq": [("pod", "data", "model"), ("data", "model")],
    "w_vocab": [("model",)],
    "w_qdim": [("model",)],
    "w_kvdim": [("model",)],
    "w_mlp": [("model",)],
    "w_expert": [("model",)],
    "w_moe_mlp": [("model",)],
    "w_dinner": [("model",)],
    "w_embed": [("data",)],
    "w_state": [],
    "w_layers": [],
    "act_embed": [("data",)],          # weight-stationary stream (batch=1)
    "act_batch": [("pod", "data")],
    "act_kv_heads": [],
    "act_heads": [("model",)],
    "act_mlp": [("model",)],
    "act_vocab": [("model",)],
    "act_expert": [("model",)],
    "act_seq": [],
}

RULES_BY_MODE: Dict[str, RuleTable] = {
    "train": TRAIN_RULES,
    "prefill": PREFILL_RULES,
    "decode": DECODE_RULES,
    "long_decode": LONG_DECODE_RULES,
}


# --------------------------------------------------------------------------
# Resolver
# --------------------------------------------------------------------------


def _axis_size(mesh: MeshShape, axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def resolve_spec(mesh: MeshShape, shape: Tuple[int, ...], names: Axes,
                 rules: RuleTable, *, for_constraint: bool = False) -> tuple:
    """The partition spec of one tensor, honoring global rule priority and
    using no mesh axis twice.

    ``for_constraint=True`` (activation constraints): dims whose rule failed
    divisibility become :data:`UNCONSTRAINED` instead of replicated, and
    trailing ``None`` entries stay; otherwise they are trimmed.
    """
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and names {names} differ in rank")
    assignment: Dict[int, Tuple[str, ...]] = {}
    failed: set = set()
    used: set = set()
    # logical names in the table's order (= priority), then dims in order
    for lname in rules:
        for dim, n in enumerate(names):
            if n != lname or dim in assignment:
                continue
            tried = False
            for cand in rules[lname]:
                eff = tuple(a for a in cand if a in mesh.axis_names and a not in used)
                if not eff:
                    continue
                tried = True
                size = _axis_size(mesh, eff)
                if size > 1 and shape[dim] % size == 0:
                    assignment[dim] = eff
                    used.update(eff)
                    break
            if dim in assignment:
                break  # a logical name is assigned at most once per tensor
            if tried:
                failed.add(dim)
    entries = []
    for d in range(len(shape)):
        e = assignment.get(d)
        if e is not None:
            entries.append(e[0] if len(e) == 1 else e)
        elif for_constraint and d in failed:
            entries.append(UNCONSTRAINED)
        else:
            entries.append(None)
    if not for_constraint:
        while entries and entries[-1] is None:
            entries.pop()
    return tuple(entries)


def rules_for_cfg(mode: str, cfg) -> RuleTable:
    """Per-arch rule adjustments: ``fsdp_pod`` extends the weight FSDP axis to
    (pod, data) in training (the >300B archs' optimizer state on the
    multi-pod mesh)."""
    rules = dict(RULES_BY_MODE[mode])
    if mode == "train" and getattr(cfg, "fsdp_pod", False):
        rules["w_embed"] = [("pod", "data")]
    return rules


# --------------------------------------------------------------------------
# Placements on a DeviceMesh
# --------------------------------------------------------------------------


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    if not mesh.mesh_dim_names:
        raise ValueError("a mesh for the sharding rules needs named dims")
    return MeshShape(tuple(mesh.size(i) for i in range(mesh.ndim)), tuple(mesh.mesh_dim_names))


def spec_placements(mesh, spec: tuple, current=None) -> list:
    """DTensor placements (one per mesh dim) of a resolved spec.

    ``UNCONSTRAINED`` keeps, on a mesh dim that no dim of the spec takes, the
    ``current`` placement where that shards an unconstrained dim; anything
    else there (a ``Partial`` included) becomes ``Replicate``. Raises when a
    tuple of axes is out of the mesh's order, which DTensor cannot express.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_shape(mesh).axis_names
    out: list = [Replicate()] * len(names)
    free = []
    for d, e in enumerate(spec):
        if e is UNCONSTRAINED:
            free.append(d)
            continue
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} is out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    if current is not None:
        taken = {n for e in spec if e is not None and e is not UNCONSTRAINED
                 for n in ((e,) if isinstance(e, str) else e)}
        for i, (n, c) in enumerate(zip(names, current)):
            if n not in taken and isinstance(c, Shard) and c.dim in free:
                out[i] = c
    return out


def placements_spec(mesh, placements, ndim: int) -> tuple:
    """The spec of DTensor placements (no ``Partial``): each dim's mesh axes
    in mesh order, ``None`` where it is whole; the inverse of
    :func:`spec_placements`."""
    from torch.distributed.tensor import Shard
    names = mesh_shape(mesh).axis_names
    axes: list = [[] for _ in range(ndim)]
    for n, p in zip(names, placements):
        if isinstance(p, Shard):
            axes[p.dim].append(n)
        elif not p.is_replicate():
            raise ValueError(f"no spec for placement {p}")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec (JAX's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return spec_placements(self.mesh, self.spec)


def sharding_of(t) -> NamedSharding:
    """The :class:`NamedSharding` of a DTensor."""
    return NamedSharding(t.device_mesh, placements_spec(t.device_mesh, t.placements, t.dim()))


def mesh_device(mesh) -> torch.device:
    """The device of this rank in ``mesh``: the CPU, or its current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_ranges(shape: Sequence[int], mesh, placements, coord: Sequence[int]
                 ) -> Tuple[Tuple[int, int], ...]:
    """The ``[start, stop)`` of every dim that the rank at mesh coordinate
    ``coord`` holds. A dim sharded over several mesh dims is split by them in
    mesh order, the first outermost (DTensor's order and JAX's), each split
    as DTensor splits a dim, even or not (``torch.chunk``: parts of
    ``ceil(n / size)``, the last ones shorter or empty)."""
    from torch.distributed.tensor import Shard
    sizes = mesh_shape(mesh).sizes
    ranges = []
    for d, n in enumerate(shape):
        start, length = 0, n
        for i, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == d:
                part = -(-length // sizes[i])
                lo = min(coord[i] * part, length)
                start, length = start + lo, min(part, length - lo)
        ranges.append((start, start + length))
    return tuple(ranges)


def chunk_sizes(n: int, k: int) -> list:
    """The lengths of ``n`` items split ``k`` ways as DTensor splits a dim
    (``torch.chunk``: parts of ``ceil(n / k)``, the last ones shorter or
    empty)."""
    part = -(-n // k)
    return [max(0, min(part, n - r * part)) for r in range(k)]


def redistribute(t, placements):
    """DTensor ``t`` redistributed to ``placements`` on its mesh, where a
    mesh dim's split that moves from tensor dim a to tensor dim b
    (``Shard(a)`` to ``Shard(b)``) moves by all-to-all: each rank of that
    mesh dim sends every other one the piece of its shard that the other
    will hold, so no rank holds more than a shard before, during or after
    the move. DTensor's own move gathers the whole tensor on a rank and
    chunks it wherever the mesh is on the CPU (the gloo and the fake
    groups), though both groups have the all-to-all. Uneven splits move as
    DTensor lays them out (:func:`chunk_sizes`).

    Every other change is ``DTensor.redistribute``, made first. The moves
    go innermost mesh dim first. Where a later mesh dim also splits a or b
    (the pieces would cross it too), that split steps aside to a third
    dim for the move, by all-to-all, and back after it; a tensor with no
    third dim, or a split that cannot step aside, moves by
    ``DTensor.redistribute``. A move over a mesh dim of one rank is a
    relabelling. Under autograd the pieces move by
    ``all_to_all_single_autograd``, whose gradient moves back the same way
    after it is laid out as ``placements`` (a ``Partial`` gradient reduced
    there); with no move, the result and its gradient are
    ``DTensor.redistribute``'s."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    src, dst = tuple(t.placements), tuple(placements)
    if src == dst:
        return t
    moves = [i for i, (p, q) in enumerate(zip(src, dst))
             if isinstance(p, Shard) and isinstance(q, Shard) and p.dim != q.dim]
    cur = [src[i] if i in moves else dst[i] for i in range(mesh.ndim)]
    if tuple(cur) != src:
        t = t.redistribute(mesh, cur)
    if not moves:               # DTensor's own, backward too (a Partial gradient reduced once)
        return t
    shape, stride, local = t.shape, t.stride(), t.to_local()

    def move(i, b):
        """``local`` with mesh dim i's split moved to tensor dim b."""
        nonlocal local, stride
        a = cur[i].dim
        if mesh.size(i) > 1:
            outer = [p if j < i else None for j, p in enumerate(cur)]
            local = _all_to_all(local, a, b, mesh, i, _outer_length(shape, mesh, outer, a))
            stride = contiguous_stride(shape)             # the moved shard is contiguous
        cur[i] = Shard(b)

    for i in reversed(moves):                   # the innermost mesh dim first
        a, b = src[i].dim, dst[i].dim
        aside = [k for k in range(i + 1, mesh.ndim) if _splits(cur[k], (a, b))]
        free = [c for c in range(len(shape)) if c not in (a, b)
                and not any(_splits(p, (c,)) for p in cur[i + 1:])]
        if not aside:
            move(i, b)
        elif len(aside) == 1 and free:
            k, back = aside[0], cur[aside[0]].dim
            move(k, free[0])
            move(i, b)
            move(k, back)
        else:
            t = DTensor.from_local(local, mesh, cur, run_check=False, shape=shape, stride=stride)
            cur[i] = dst[i]
            t = t.redistribute(mesh, cur)
            local, stride = t.to_local(), t.stride()
    return DTensor.from_local(local, mesh, dst, run_check=False, shape=shape, stride=stride)


def _splits(p, dims) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard) and p.dim in dims


def _outer_length(shape, mesh, placements, dim: int) -> int:
    """The length of tensor dim ``dim`` on this rank under ``placements``
    (None where a mesh dim is left out)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p is None else p for p in placements]
    a, b = local_ranges(shape, mesh, pl, mesh.get_coordinate())[dim]
    return b - a


def _all_to_all(local: torch.Tensor, a: int, b: int, mesh, i: int, n_a: int) -> torch.Tensor:
    """``local`` (a rank's shard, whose dim a is split over mesh dim ``i``
    out of ``n_a`` and dim b is not) as the shard whose dim b is split over
    mesh dim ``i`` and dim a is whole: one all-to-all over that mesh dim of
    the flattened pieces (rank r's piece: its rows of b's r-th chunk)."""
    import torch.distributed._functional_collectives as funcol
    k, me = mesh.size(i), mesh.get_local_rank(i)
    sa, sb = chunk_sizes(n_a, k), chunk_sizes(local.shape[b], k)
    send = local.movedim(b, 0).contiguous()
    rest = list(send.shape[1:])
    pos = a + 1 if a < b else a                  # a's place in ``send``'s dims
    per_row = math.prod(rest)
    shapes = [[sb[me]] + rest[:pos - 1] + [sa[r]] + rest[pos:] for r in range(k)]
    in_splits = [s * per_row for s in sb]
    out_splits = [math.prod(sh) for sh in shapes]
    fn = (funcol.all_to_all_single_autograd if torch.is_grad_enabled() and local.requires_grad
          else funcol.all_to_all_single)
    got = fn(send.reshape(-1), out_splits, in_splits, (mesh, i))
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    pieces = [p.reshape(sh) for p, sh in zip(torch.split(got, out_splits), shapes)]
    return torch.cat(pieces, pos).movedim(0, b).contiguous()


def is_meshed(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor (without importing DTensor when
    nothing has)."""
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def mesh_of(*ts):
    """The mesh of the first DTensor among ``ts``."""
    from torch.distributed.tensor import DTensor
    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def shard_dims(t, dim: int):
    """The mesh dims over which DTensor ``t`` shards tensor dim ``dim``."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return []
    return [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]


def placed(mesh, shard: dict):
    """Placements over ``mesh`` that shard tensor dim d over the mesh dims
    ``shard[d]`` and replicate the rest."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate()] * mesh.ndim
    for d, dims in shard.items():
        for i in dims:
            pl[i] = Shard(d)
    return tuple(pl)


def split_range(mesh, dims: Sequence[int], n: int) -> Tuple[int, int]:
    """This rank's ``[start, stop)`` of ``n`` items split over the mesh dims
    ``dims`` in mesh order, the first outermost."""
    return local_ranges((n,), mesh, placed(mesh, {0: dims}), mesh.get_coordinate())[0]


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A DTensor of ``t`` (which every rank holds whole, on any device) under
    ``sharding``, made without a collective: each rank keeps its own slice,
    on its device of the mesh."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding.mesh, sharding.placements
    sl = tuple(slice(a, b) for a, b in local_ranges(t.shape, mesh, pl, mesh.get_coordinate()))
    local = torch.as_tensor(t)[sl].to(mesh_device(mesh)).contiguous()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        local = local.clone()    # a contiguous slice is a view that would hold all of t
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def contiguous_stride(shape) -> tuple:
    """The contiguous strides of ``shape`` (as ``torch.empty`` gives them,
    with no op that a dispatch mode would see)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))


def make_resolver(mesh, rules: RuleTable):
    """The closure for ``models.layers.sharding_context``: (shape, logical
    names) -> the :class:`NamedSharding` that an activation is constrained
    to (spec resolved for a constraint, so failed dims stay unconstrained)."""
    def resolver(shape, names):
        return NamedSharding(mesh, resolve_spec(mesh_shape(mesh), tuple(shape), tuple(names),
                                                rules, for_constraint=True))
    return resolver


def _map_pair(fn, a, b):
    if isinstance(a, dict):
        return {k: _map_pair(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)) and not _is_axes(b):
        return type(a)(_map_pair(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def tree_shardings(mesh, spec_tree, axes_tree, rules: RuleTable):
    """(tree of tensors, ``meta`` ones included; tree of logical axes) ->
    tree of :class:`NamedSharding`, by the rules."""
    ms = mesh_shape(mesh)
    return _map_pair(lambda s, ax: NamedSharding(mesh, resolve_spec(ms, tuple(s.shape),
                                                                    tuple(ax), rules)),
                     spec_tree, axes_tree)


def with_shardings(spec_tree, shardings_tree):
    """``meta`` DTensors of the spec tree's shapes and dtypes under the
    shardings (the dry run's inputs): each local tensor is the rank's shard,
    on ``meta``; nothing is allocated and no collective runs."""
    from torch.distributed.tensor import DTensor

    def one(s, sh):
        pl = sh.placements
        loc = local_ranges(s.shape, sh.mesh, pl, sh.mesh.get_coordinate())
        local = torch.empty([b - a for a, b in loc], dtype=s.dtype, device="meta")
        return DTensor.from_local(local, sh.mesh, pl, run_check=False, shape=s.shape,
                                  stride=contiguous_stride(s.shape))
    return _map_pair(one, spec_tree, shardings_tree)
