"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

The port's copy of the JAX package's ``configs/gemma3_12b.py``, at the same
widths (the port imports nothing of that package).

5:1 local(sliding-window 1024):global attention interleave, head_dim=256,
128k context. [hf:google/gemma-3-*-pt]
Sliding-window makes it sub-quadratic => the long_500k cell RUNS for this arch.
Large vocab => chunked cross-entropy.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3_12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1000000.0,       # global layers (locals use 10k; see models.attention)
    sliding_window=1024,
    swa_local=5,
    swa_period=6,
    tie_embeddings=True,
    grad_accum=8,
    logits_chunk=1024,
))
