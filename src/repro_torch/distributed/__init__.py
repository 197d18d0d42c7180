"""Distributed training support of the port: checkpoints (one card; the
sharding and compression of the JAX package's ``distributed/`` are ROADMAP A6)."""
