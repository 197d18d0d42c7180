"""The training data pipeline (own copy of the JAX package's ``data/``)."""
