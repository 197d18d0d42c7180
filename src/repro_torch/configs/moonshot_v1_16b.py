"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (MHA kv=16) d_ff=1408(expert),
vocab=163840, MoE 64 experts top-6. [hf:moonshotai/Moonlight-16B-A3B]

The port's copy of the JAX package's ``configs/moonshot_v1_16b.py``, at the
same widths: 27.72 B parameters (3.64 B active per token), 51.6 GiB in
bfloat16, so one 80 GB card holds it whole. Every layer is MoE (the d_ff
field is the per-expert hidden; there is no dense MLP): 64 experts, top-6,
expert_ff 1408, capacity factor 1.25.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="moonshot_v1_16b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # pure-MoE MLP stack
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408, sharding="ep"),
    rope_theta=50000.0,
    tie_embeddings=True,
    grad_accum=8,
    logits_chunk=1024,
))
