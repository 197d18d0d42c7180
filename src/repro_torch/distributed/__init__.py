"""Distributed support of the port: the sharding rules and their placements
on a ``DeviceMesh`` (``sharding``: the rule tables, ``resolve_spec``,
DTensor placements, ``tree_shardings``, ``make_resolver``, ``place``),
sharded, elastic checkpoints (``checkpoint``) and the cross-pod gradient
compression (``compression``). The meshes themselves are built in
``launch.mesh``."""
