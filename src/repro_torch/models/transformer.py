"""The LM, ported from the JAX package's ``models/transformer.py``.

:class:`LM` is an ``nn.Module`` whose parameters keep the JAX tree's names
and its stacked ``[K = L/P, ...]`` per-period-slot layout, so ``state_dict``
keys read like the JAX paths (``embed``, ``final_norm``, ``slots.0.wq``) and
``repro_torch.bridge`` copies a JAX params tree in name by name. The layer
stack runs as a Python loop over periods (the JAX package scans it).

Modes:
* ``forward_seq`` / ``prefill`` — [B, S] tokens -> last-token logits + cache
* ``decode_step`` — one token per sequence against the cache, which it
  updates in place (the JAX function returns a new cache; the port writes
  one row per layer instead of copying the cache each step)

Attention slots with a dense MLP and Mamba slots are ported; MoE slots and
the audio/vision frontends raise ``NotImplementedError``.

Parameters are allocated on the target device in the model's dtype and drawn
there, one period slice at a time, from a generator on that device: a 7B
model is never staged in host memory, and its weights depend on the seed and
the device type.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import BLOCK_ATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.layers import ParamSpec, init_param, mlp, rms_norm, sinusoidal_pos

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SlotKind:
    kind: str          # attn | mamba
    is_moe: bool
    is_local: bool     # sliding-window attention
    theta: float       # rope base (gemma3: 10k local / 1M global)


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class _Slot(nn.Module):
    """The parameters of one period slot, stacked over the K periods."""

    def __init__(self, specs: Dict[str, ParamSpec], device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        for name, spec in specs.items():
            self.register_parameter(name, _param(spec, device, dtype))

    def period(self, k: int) -> Dict[str, torch.Tensor]:
        return {name: p[k] for name, p in self.named_parameters()}


def _param(spec: ParamSpec, device: torch.device, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(spec.shape, device=device, dtype=dtype),
                        requires_grad=False)


class LM(nn.Module):
    """Decoder LM over period slots; parameters live on ``device`` in ``cfg.dtype``.

    ``device=None`` means the card (and raises without one); pass ``"cpu"``
    to run on the CPU with the kernels' plain versions. Weights are drawn
    from ``seed`` with a ``torch.Generator`` on that device, so one seed gives
    the same weights on one device type and different weights on the CPU
    and the card: to compare the two, load one model's ``state_dict`` into
    the other.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.period = self._period(cfg)
        if cfg.num_layers % self.period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not fill "
                             f"periods of {self.period}")
        self.num_periods = cfg.num_layers // self.period
        if cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} frontend is "
                                      f"not ported yet")
        self.slot_kinds: List[SlotKind] = []
        for s in range(self.period):
            kind = cfg.block_kind(s)
            if cfg.is_moe_layer(s):
                raise NotImplementedError(f"{cfg.name}: MoE slots are not ported yet")
            local = cfg.is_local_attn(s)
            theta = 10000.0 if cfg.sliding_window and local else cfg.rope_theta
            self.slot_kinds.append(SlotKind(kind, False, local, theta))

        specs = self.param_specs()
        self.embed = _param(specs["embed"], dev, dtype)
        self.unembed = _param(specs["unembed"], dev, dtype) if "unembed" in specs else None
        self.final_norm = _param(specs["final_norm"], dev, dtype)
        self.slots = nn.ModuleList(_Slot(ps, dev, dtype) for ps in specs["slots"])
        self.init_params(seed, specs)

    @staticmethod
    def _period(cfg: ModelConfig) -> int:
        p = 1
        if cfg.mamba is not None and not cfg.attention_free:
            p = math.lcm(p, cfg.attn_every)
        if cfg.moe is not None:
            p = math.lcm(p, cfg.moe.every)
        if cfg.sliding_window > 0:
            p = math.lcm(p, cfg.swa_period)
        return p

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        c = self.cfg
        K, D = self.num_periods, c.d_model
        specs: dict = {"embed": ParamSpec((c.vocab_size, D))}
        if not c.tie_embeddings:
            specs["unembed"] = ParamSpec((c.vocab_size, D))
        specs["final_norm"] = ParamSpec((D,), init="zeros")
        H, KV, hd = c.num_heads, c.num_kv_heads, c.head_dim
        slot_specs = []
        for sk in self.slot_kinds:
            ps = {"norm1": ParamSpec((K, D), init="zeros")}
            if sk.kind == BLOCK_ATTN:
                ps["wq"] = ParamSpec((K, D, H * hd))
                ps["wk"] = ParamSpec((K, D, KV * hd))
                ps["wv"] = ParamSpec((K, D, KV * hd))
                ps["wo"] = ParamSpec((K, H * hd, D))
                if c.qk_norm:
                    ps["q_norm"] = ParamSpec((K, hd), init="zeros")
                    ps["k_norm"] = ParamSpec((K, hd), init="zeros")
            else:
                m = c.mamba
                DI = m.d_inner
                ps["in_x"] = ParamSpec((K, D, DI))
                ps["in_z"] = ParamSpec((K, D, DI))
                ps["conv_w"] = ParamSpec((K, m.d_conv, DI))
                ps["conv_b"] = ParamSpec((K, DI), init="zeros")
                ps["x_proj"] = ParamSpec((K, DI, m.dt_rank + 2 * m.d_state))
                ps["dt_proj"] = ParamSpec((K, m.dt_rank, DI))
                ps["dt_bias"] = ParamSpec((K, DI), init="mamba_dt")
                ps["A_log"] = ParamSpec((K, DI, m.d_state), init="mamba_a")
                ps["D"] = ParamSpec((K, DI), init="ones")
                ps["out_proj"] = ParamSpec((K, DI, D))
            ps["norm2"] = ParamSpec((K, D), init="zeros")
            if c.d_ff > 0:
                ps["wi"] = ParamSpec((K, D, c.d_ff))
                if c.gated_mlp:
                    ps["wg"] = ParamSpec((K, D, c.d_ff))
                ps["wo_mlp"] = ParamSpec((K, c.d_ff, D))
            slot_specs.append(ps)
        specs["slots"] = slot_specs
        return specs

    @torch.no_grad()
    def init_params(self, seed: int, specs: Optional[dict] = None) -> None:
        """Draw every parameter from ``seed`` on its own device, a slot's
        stacked parameters one period slice at a time (float32 draws of one
        slice, then the cast)."""
        specs = specs or self.param_specs()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name in ("embed", "unembed", "final_norm"):
            if name in specs:
                init_param(specs[name], gen, getattr(self, name))
        for slot, ps in zip(self.slots, specs["slots"]):
            for name, spec in ps.items():
                stacked = getattr(slot, name)
                for k in range(self.num_periods):
                    init_param(spec, gen, stacked[k])

    # ------------------------------------------------------------------
    # Embedding and head
    # ------------------------------------------------------------------
    def embed_input(self, batch) -> torch.Tensor:
        x = self.embed[batch["tokens"].to(self.device)]
        if not self.cfg.causal:
            x = x + sinusoidal_pos(x.shape[1], self.cfg.d_model, x.dtype, x.device)[None]
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.unembed if self.unembed is not None else self.embed
        return x @ head.T

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _mlp(self, h, p):
        return mlp(h, {"wi": p["wi"], "wg": p.get("wg"), "wo": p["wo_mlp"]},
                   self.cfg.gated_mlp)

    def _block_seq(self, x, p, sk: SlotKind, positions):
        c = self.cfg
        h = rms_norm(x, p["norm1"], c.norm_eps)
        if sk.kind == BLOCK_ATTN:
            h, cache = attn_mod.attn_forward(h, p, c, sk.is_local, positions,
                                             theta=sk.theta)
        else:
            h, cache = mamba_mod.mamba_forward(h, p, c)
        x = x + h
        if c.d_ff > 0:
            x = x + self._mlp(rms_norm(x, p["norm2"], c.norm_eps), p)
        return x, cache

    def _block_decode(self, x, p, sk: SlotKind, cache, positions):
        c = self.cfg
        h = rms_norm(x, p["norm1"], c.norm_eps)
        if sk.kind == BLOCK_ATTN:
            h, cache = attn_mod.attn_decode(h, p, c, sk.is_local, cache, positions,
                                            theta=sk.theta)
        else:
            h, cache = mamba_mod.mamba_decode(h, p, c, cache)
        x = x + h
        if c.d_ff > 0:
            x = x + self._mlp(rms_norm(x, p["norm2"], c.norm_eps)[:, None], p)[:, 0]
        return x, cache

    # ------------------------------------------------------------------
    # Sequence mode (prefill)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward_seq(self, batch, *, want_cache: bool):
        x = self.embed_input(batch)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
        per_period = []
        for k in range(self.num_periods):
            caches = []
            for slot, sk in zip(self.slots, self.slot_kinds):
                x, cache = self._block_seq(x, slot.period(k), sk, positions)
                caches.append(cache)
            per_period.append(caches)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if not want_cache:
            return x, None
        caches = [{name: torch.stack([pc[s][name] for pc in per_period])
                   for name in per_period[0][s]} for s in range(self.period)]
        return x, caches

    def prefill(self, batch):
        """Returns (last-token logits [B, V], cache). The logits are taken at the
        padded end, x[:, -1], as in the JAX package."""
        x, caches = self.forward_seq(batch, want_cache=True)
        return self.logits(x[:, -1]), {"slots": caches}

    # ------------------------------------------------------------------
    # Decode mode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache, batch):
        """batch: {token: [B] int, pos: [B] int}. Returns (logits, cache); the
        cache is updated in place (every block writes its layer's slice)."""
        x = self.embed[batch["token"].to(self.device)]
        positions = batch["pos"].to(self.device)
        for k in range(self.num_periods):
            for s, (slot, sk) in enumerate(zip(self.slots, self.slot_kinds)):
                layer_cache = {name: c[k] for name, c in cache["slots"][s].items()}
                x, _ = self._block_decode(x, slot.period(k), sk, layer_cache, positions)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x), cache

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def _cache_width(self, sk: SlotKind, max_len: int) -> int:
        if sk.is_local and self.cfg.sliding_window:
            return min(self.cfg.sliding_window, max_len)
        return max_len

    def cache_specs(self, batch_size: int, max_len: int):
        """``(shape, dtype)`` of every decode-cache tensor, per slot: attention
        k/v [K, B, W, KV, hd] in the model's dtype; Mamba conv [K, B, d_conv-1,
        DI] in the model's dtype and ssm [K, B, DI, N] in float32 whatever the
        model's dtype, as in the JAX package."""
        c = self.cfg
        K = self.num_periods
        specs = []
        for sk in self.slot_kinds:
            if sk.kind == BLOCK_ATTN:
                W = self._cache_width(sk, max_len)
                sh = (K, batch_size, W, c.num_kv_heads, c.head_dim)
                specs.append({"k": (sh, self.dtype), "v": (sh, self.dtype)})
            else:
                m = c.mamba
                specs.append({
                    "conv": ((K, batch_size, m.d_conv - 1, m.d_inner), self.dtype),
                    "ssm": ((K, batch_size, m.d_inner, m.d_state), torch.float32)})
        return {"slots": specs}

    def init_cache(self, batch_size: int, max_len: int):
        specs = self.cache_specs(batch_size, max_len)
        return {"slots": [{name: torch.zeros(sh, dtype=dt, device=self.device)
                           for name, (sh, dt) in s.items()} for s in specs["slots"]]}


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)

