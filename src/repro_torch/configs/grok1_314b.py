"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768(expert)
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1]

The port's copy of the JAX package's ``configs/grok1_314b.py``, at the same
widths. At 315.7 B parameters no single card holds it: the port runs it only
cut to size (``reduced``) in the CPU tests.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="grok1_314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32768, sharding="tp"),
    tie_embeddings=True,
    opt_state_dtype="bfloat16",
    fsdp_pod=True,
    optimizer="adafactor",
    grad_accum=16,
    logits_chunk=1024,
))
