"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

The port's copy of the JAX package's ``configs/qwen3_32b.py``, at the same
widths (the port imports nothing of that package).

qk_norm (per-head RMSNorm on q and k), GQA. [hf:Qwen/Qwen3-*]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3_32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    grad_accum=8,
    logits_chunk=1024,
))
