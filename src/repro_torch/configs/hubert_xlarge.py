"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504.

The port's copy of the JAX package's ``configs/hubert_xlarge.py``, at the same
widths (the port imports nothing of that package).

Encoder-only (same transformer arch as wav2vec2-XL). [arXiv:2106.07447]
The CNN audio frontend is a STUB per assignment: ``input_specs`` provides
precomputed frame embeddings (B, S, d_model). Non-gated GELU MLP (w2v2-style).
vocab=504 k-means target classes for masked prediction.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert_xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,              # encoder-only: no decode shapes
    gated_mlp=False,           # plain GELU MLP
    tie_embeddings=False,      # input is frames; output head is its own matrix
    frontend="frames",
    grad_accum=4,
))
