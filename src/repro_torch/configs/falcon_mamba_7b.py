"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free, vocab=65024,
ssm_state=16 (mamba1 arch). [arXiv:2410.05355]

The port's copy of the JAX package's ``configs/falcon_mamba_7b.py``, at the
same widths. Pure Mamba-1: d_inner = 2*d_model = 8192, conv4, dt_rank =
d_model/16 = 256. The decode "cache" is (conv window, SSM state), O(1) in
sequence length.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    mamba=MambaConfig(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    tie_embeddings=True,
    grad_accum=16,   # mamba backward temporaries are f32 [B,S,DI,N]-shaped
    logits_chunk=1024,
))
