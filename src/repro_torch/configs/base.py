"""Configuration system of the PyTorch port.

Its own copy of the JAX package's ``configs/base.py`` (the port imports
nothing of that package): :class:`ModelConfig` with its layer pattern and
exact ``param_count``, the registry, and ``reduced`` for small test models.
The serving demo configs, ``falcon_mamba_7b`` and the three MoE configs
(``moonshot_v1_16b``, ``jamba15_large``, ``grok1_314b``) are registered;
the input-shape table of the dry run is not ported yet. Configs are plain
frozen dataclasses, so a JAX config moves to the port through
``to_json``/``from_json``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, replace
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

BLOCK_ATTN = "attn"
BLOCK_MAMBA = "mamba"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                     # per-expert hidden dim
    capacity_factor: float = 1.25      # Switch-style capacity
    every: int = 1                     # MoE layer every `every` layers (jamba: 2)
    router_dtype: str = "float32"
    # "ep": shard experts over model axis; "tp": shard expert_ff over model axis.
    sharding: str = "ep"


@dataclass(frozen=True)
class MambaConfig:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0                   # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact assigned values live in configs/<id>.py)."""

    name: str
    family: str                        # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                     # query heads (0 for attention-free)
    num_kv_heads: int                  # GQA kv heads
    d_ff: int                          # dense MLP hidden (0 if none / pure MoE)
    vocab_size: int
    head_dim: int = 128
    # --- architecture flavour flags -------------------------------------
    causal: bool = True                # False => encoder-only (hubert)
    gated_mlp: bool = True             # SwiGLU vs plain GELU MLP (hubert: False)
    qk_norm: bool = False              # qwen3-style per-head RMSNorm on q/k
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    # sliding-window pattern: window size and period "L:G" — every `swa_period`
    # layers, the first `swa_local` are local.  (gemma3: 5 local : 1 global)
    sliding_window: int = 0
    swa_local: int = 0
    swa_period: int = 1
    # hybrid interleave (jamba): attention every `attn_every` layers (index
    # attn_every-1 within each period); 1 => all attention.
    attn_every: int = 1
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # --- modality frontends (stubs per assignment) ----------------------
    frontend: str = "none"             # none | frames (audio) | patches (vlm)
    num_patches: int = 0               # vlm: patch embeddings per example
    # --- numerics / training ------------------------------------------
    dtype: str = "bfloat16"            # activations/params compute dtype
    norm_eps: float = 1e-6
    # optimizer-state dtype: f32 default; big archs use bf16 to fit HBM
    opt_state_dtype: str = "float32"
    optimizer: str = "adamw"           # adafactor for the largest archs
    fsdp_pod: bool = False             # FSDP weights/opt over (pod,data) too
    remat: bool = True
    # microbatches for grad accumulation at the assigned train shape
    grad_accum: int = 1
    logits_chunk: int = 0              # chunked CE loss (0 = off)

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def block_kind(self, layer_idx: int) -> str:
        """attn or mamba for layer `layer_idx` (jamba interleave)."""
        if self.attention_free:
            return BLOCK_MAMBA
        if self.mamba is None:
            return BLOCK_ATTN
        # attention sits at the LAST slot of each `attn_every` period.
        return BLOCK_ATTN if layer_idx % self.attn_every == self.attn_every - 1 else BLOCK_MAMBA

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.every == self.moe.every - 1

    def is_local_attn(self, layer_idx: int) -> bool:
        """Sliding-window vs global attention for this layer (gemma3 5:1)."""
        if self.sliding_window <= 0:
            return False
        return (layer_idx % self.swa_period) < self.swa_local

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the as-built model."""
        c, d = self, self.d_model
        if c.frontend == "frames":
            n = c.vocab_size * d                   # output head only (no tok embed)
        else:
            n = c.vocab_size * d                   # embedding
            if not c.tie_embeddings:
                n += c.vocab_size * d
        if c.frontend == "patches":
            n += d * d                             # patch projector
        for i in range(c.num_layers):
            kind = c.block_kind(i)
            if kind == BLOCK_ATTN:
                n += d * c.q_dim + c.q_dim * d     # wq, wo
                n += 2 * d * c.kv_dim              # wk, wv
                if c.qk_norm:
                    n += 2 * c.head_dim
                n += d                             # pre-attn norm
            else:
                m = c.mamba
                n += d * 2 * m.d_inner             # in_proj (x and z)
                n += m.d_conv * m.d_inner          # conv1d
                n += m.d_inner * (m.dt_rank + 2 * m.d_state)   # x_proj
                n += m.dt_rank * m.d_inner + m.d_inner         # dt_proj + bias
                n += m.d_inner * m.d_state + m.d_inner         # A_log, D
                n += m.d_inner * d                 # out_proj
                n += d                             # pre norm
            # MLP / MoE
            if c.is_moe_layer(i):
                e = c.moe
                n += d * e.num_experts             # router
                n += e.num_experts * 3 * d * e.expert_ff
            elif c.d_ff > 0:
                n += (3 if c.gated_mlp else 2) * d * c.d_ff
            n += d                                 # pre-mlp norm
        n += d                                     # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        c, e, d = self, self.moe, self.d_model
        moe_layers = sum(1 for i in range(c.num_layers) if c.is_moe_layer(i))
        dense_total = c.param_count() - moe_layers * (e.num_experts * 3 * d * e.expert_ff)
        return dense_total + moe_layers * e.top_k * 3 * d * e.expert_ff

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        raw = json.loads(s)
        if raw.get("moe"):
            raw["moe"] = MoEConfig(**raw["moe"])
        if raw.get("mamba"):
            raw["mamba"] = MambaConfig(**raw["mamba"])
        return ModelConfig(**raw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in ("hyperfaas_demo", "falcon_mamba_7b", "moonshot_v1_16b", "jamba15_large",
                "grok1_314b"):
        importlib.import_module(f"repro_torch.configs.{mod}")


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 128, seq: int = 0) -> ModelConfig:
    """Shrink a config to smoke-test size while keeping the family shape.

    Preserves: family, interleave patterns, GQA ratio, qk_norm, gating, MoE
    top-k routing (few experts), mamba block structure, frontend kind.
    """
    head_dim = 16
    if cfg.attention_free:
        heads = kv = 0
    else:
        heads = max(4, min(8, cfg.num_heads))
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = max(1, heads // ratio)
        heads = kv * ratio
        d_model = max(d_model, heads * head_dim // 2)
    # keep periods intact: round layer count up to cover one full period
    period = 1
    if cfg.mamba is not None and not cfg.attention_free:
        period = max(period, cfg.attn_every)
    if cfg.moe is not None:
        period = max(period, cfg.moe.every)
    if cfg.sliding_window > 0:
        period = max(period, cfg.swa_period)
    layers = max(layers, period)
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, num_experts=min(8, cfg.moe.num_experts),
                      top_k=min(2, cfg.moe.top_k), expert_ff=d_model * 2)
    mamba = None
    if cfg.mamba is not None:
        mamba = MambaConfig(d_inner=2 * d_model, d_state=8, d_conv=4,
                            dt_rank=max(4, d_model // 16))
    return replace(
        cfg,
        num_layers=layers, d_model=d_model, num_heads=heads, num_kv_heads=kv,
        head_dim=head_dim if heads else cfg.head_dim,
        d_ff=(d_model * 4 if cfg.d_ff else 0), vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe=moe, mamba=mamba, num_patches=min(cfg.num_patches, 4),
        grad_accum=1, logits_chunk=0,
    )
