"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

The port's copy of the JAX package's ``configs/mistral_large_123b.py``, at the same
widths (the port imports nothing of that package).

[hf:mistralai/Mistral-Large-Instruct-2407]
bf16 optimizer state + 16-way grad accumulation so the train_4k cell fits
16 GB/chip on the 256-chip pod (see EXPERIMENTS.md §Dry-run).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral_large_123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1000000.0,
    tie_embeddings=False,
    opt_state_dtype="bfloat16",
    grad_accum=16,
))
