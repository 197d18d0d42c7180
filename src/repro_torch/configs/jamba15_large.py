"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave. [arXiv:2403.19887]

The port's copy of the JAX package's ``configs/jamba15_large.py``, at the
same widths. Within each 8-layer period, layers 0-6 are Mamba blocks and
layer 7 is attention; MoE replaces the dense MLP on every 2nd layer. At
398.6 B parameters no single card holds it: the port runs it only cut to
size (``reduced``) in the CPU tests.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="jamba15_large",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=24576, every=2, sharding="ep"),
    mamba=MambaConfig(d_inner=16384, d_state=16, d_conv=4, dt_rank=512),
    tie_embeddings=False,
    opt_state_dtype="bfloat16",
    fsdp_pod=True,
    grad_accum=16,
    logits_chunk=1024,
))
