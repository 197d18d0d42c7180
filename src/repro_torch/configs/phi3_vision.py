"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.

The port's copy of the JAX package's ``configs/phi3_vision.py``, at the same
widths (the port imports nothing of that package).

phi3-mini backbone + CLIP frontend. [hf:microsoft/Phi-3-vision-128k-instruct]
The CLIP image tower is a STUB per assignment: ``input_specs`` provides
precomputed patch embeddings (B, 576, d_model) that the model scatters over
reserved image-token positions at the head of the sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3_vision",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="patches",
    num_patches=576,
    grad_accum=4,
))
