"""Distributed support of the port: the sharding rules and their placements
on a ``DeviceMesh`` (``sharding``: the rule tables, ``resolve_spec``,
DTensor placements, ``tree_shardings``, ``make_resolver``, ``place``) and
sharded, elastic checkpoints (``checkpoint``). The meshes themselves are
built in ``launch.mesh``. Gradient compression is not ported yet (ROADMAP
queue A item 2)."""
