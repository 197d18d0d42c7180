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
counterpart of JAX's ``AbstractMesh``); a resolved spec is a tuple with one
entry per leading dim: ``None``, an axis name, a tuple of names, or
:data:`UNCONSTRAINED`, as the JAX ``PartitionSpec`` holds them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
