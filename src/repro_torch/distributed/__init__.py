"""Distributed support of the port: checkpoints (one card) and the sharding
rules' resolution (``sharding``: the rule tables and ``resolve_spec`` over a
mesh given by its axis names and sizes). Placing tensors onto a device mesh
and gradient compression are not ported yet (ROADMAP A6)."""
