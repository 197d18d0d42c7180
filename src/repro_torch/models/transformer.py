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

Only attention blocks with a dense MLP are ported in this slice: Mamba and
MoE slots raise ``NotImplementedError``.
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

    def __init__(self, specs: Dict[str, ParamSpec]):
        super().__init__()
        for name, spec in specs.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(spec.shape), requires_grad=False))

    def period(self, k: int) -> Dict[str, torch.Tensor]:
        return {name: p[k] for name, p in self.named_parameters()}


class LM(nn.Module):
    """Decoder LM over period slots; parameters live on ``device`` in ``cfg.dtype``.

    ``device=None`` means the card (and raises without one); pass ``"cpu"``
    to run on the CPU with the kernels' plain versions. Weights are drawn
    from ``seed`` with a CPU ``torch.Generator``, so they do not depend on the
    device.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
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
            if kind != BLOCK_ATTN or cfg.is_moe_layer(s):
                raise NotImplementedError(f"{cfg.name}: Mamba and MoE slots are not "
                                          f"ported yet")
            local = cfg.is_local_attn(s)
            theta = 10000.0 if cfg.sliding_window and local else cfg.rope_theta
            self.slot_kinds.append(SlotKind(kind, False, local, theta))

        specs = self.param_specs()
        self.embed = nn.Parameter(torch.empty(specs["embed"].shape), requires_grad=False)
        if "unembed" in specs:
            self.unembed = nn.Parameter(torch.empty(specs["unembed"].shape),
                                        requires_grad=False)
        else:
            self.unembed = None
        self.final_norm = nn.Parameter(torch.empty(specs["final_norm"].shape),
                                       requires_grad=False)
        self.slots = nn.ModuleList(_Slot(ps) for ps in specs["slots"])
        self.init_params(seed, specs)
        self.to(device=resolve_device(device), dtype=torch_dtype(cfg.dtype))

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
        for _ in self.slot_kinds:
            ps = {"norm1": ParamSpec((K, D), init="zeros"),
                  "wq": ParamSpec((K, D, H * hd)),
                  "wk": ParamSpec((K, D, KV * hd)),
                  "wv": ParamSpec((K, D, KV * hd)),
                  "wo": ParamSpec((K, H * hd, D))}
            if c.qk_norm:
                ps["q_norm"] = ParamSpec((K, hd), init="zeros")
                ps["k_norm"] = ParamSpec((K, hd), init="zeros")
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
        """Draw every parameter from ``seed`` (float32 on the CPU, then cast)."""
        specs = specs or self.param_specs()
        gen = torch.Generator(device="cpu").manual_seed(seed)
        flat = {k: v for k, v in specs.items() if k != "slots"}
        for s, ps in enumerate(specs["slots"]):
            flat.update({f"slots.{s}.{k}": v for k, v in ps.items()})
        params = dict(self.named_parameters())
        for name, spec in flat.items():
            params[name].copy_(init_param(spec, gen))

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
        h, cache = attn_mod.attn_forward(h, p, c, sk.is_local, positions, theta=sk.theta)
        x = x + h
        if c.d_ff > 0:
            x = x + self._mlp(rms_norm(x, p["norm2"], c.norm_eps), p)
        return x, cache

    def _block_decode(self, x, p, sk: SlotKind, cache, positions):
        c = self.cfg
        h = rms_norm(x, p["norm1"], c.norm_eps)
        h, cache = attn_mod.attn_decode(h, p, c, sk.is_local, cache, positions,
                                        theta=sk.theta)
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
                   for name in ("k", "v")} for s in range(self.period)]
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
        cache is updated in place."""
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
        """Shapes and dtype of the decode cache: per slot k/v [K, B, W, KV, hd]."""
        c = self.cfg
        specs = []
        for sk in self.slot_kinds:
            W = self._cache_width(sk, max_len)
            sh = (self.num_periods, batch_size, W, c.num_kv_heads, c.head_dim)
            specs.append({"k": sh, "v": sh})
        return {"slots": specs}, self.dtype

    def init_cache(self, batch_size: int, max_len: int):
        specs, dt = self.cache_specs(batch_size, max_len)
        return {"slots": [{name: torch.zeros(sh, dtype=dt, device=self.device)
                           for name, sh in s.items()} for s in specs["slots"]]}


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)

