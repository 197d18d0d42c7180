"""Demo "function images" for the HyperFaaS platform experiments.

These are the paper's analogue of user-supplied functions: small, real models
that workers actually execute. They drive the serving engine, the concurrency
study (RQ-A) and the emulation pipeline (RQ-B). The same three configs as the
JAX package's ``configs/hyperfaas_demo.py``, at the same widths.
"""
from repro_torch.configs.base import ModelConfig, register

# ~8M-param LM: the default "user function" for serving experiments.
TINY_LM = register(ModelConfig(
    name="tiny_lm",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    d_ff=1024,
    vocab_size=4096,
    tie_embeddings=True,
))

# ~35M-param LM: a "heavier function" so the worker-model sees two cost classes.
SMALL_LM = register(ModelConfig(
    name="small_lm",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=8192,
    tie_embeddings=True,
))

# ~110M-param LM for examples/train_small.py (the "train ~100M model" script).
TRAIN_100M = register(ModelConfig(
    name="train_100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=32768,
    tie_embeddings=True,
))
