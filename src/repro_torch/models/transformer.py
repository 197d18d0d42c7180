"""The LM, ported from the JAX package's ``models/transformer.py``.

:class:`LM` is an ``nn.Module`` whose parameters keep the JAX tree's names
and its stacked ``[K = L/P, ...]`` per-period-slot layout, so ``state_dict``
keys read like the JAX paths (``embed``, ``final_norm``, ``slots.0.wq``) and
``repro_torch.bridge`` copies a JAX params tree in name by name. The layer
stack runs as a Python loop over periods (the JAX package scans it).

Inputs, as the JAX ``embed_input`` takes them: ``tokens``; for the
``patches`` frontend (phi3_vision) also ``patch_embeds`` [B, P, D], projected
by ``patch_proj`` into the first P positions; for the ``frames`` frontend
(hubert_xlarge) ``frames`` [B, S, D] in place of tokens, with no embedding
table. Non-causal inputs get sinusoidal positions added.

Modes:
* ``forward_seq`` — [B, S] inputs -> final hidden states (+ cache); under
  autograd the training forward, each period checkpointed when the config
  asks for ``remat`` (``torch.utils.checkpoint``, as the JAX package wraps
  its period in ``jax.remat``)
* ``loss_fn`` — mean cross-entropy (+ the MoE auxiliary loss), as the JAX
  function, over a dict of parameters: ``loss_fn(params, batch)`` with
  ``params`` named as ``named_parameters`` (``slots.0.wq``), so a train step
  differentiates the loss in the parameters it is given
* ``prefill`` — [B, S] inputs -> last-token logits + cache, without grad
* ``decode_step`` — one token per sequence against the cache, which it
  updates in place (the JAX function returns a new cache; the port writes
  one row per layer instead of copying the cache each step)

``prefill`` and ``decode_step`` take the module's parameters or, like
``loss_fn``, a dict of them, which may be DTensors of a device mesh (the
dry run's, under ``PREFILL_RULES`` and ``DECODE_RULES``); a meshed cache is
written shard by shard, each rank its own rows and slots.

Attention and Mamba slots, each with a dense MLP or an MoE layer after it,
and both frontends are ported. Activations are constrained with
``layers.shard_act`` where the JAX model constrains them, so the same code
trains on DTensor parameters of a device mesh.

The dry run's model surface needs no model: :func:`param_specs`,
:func:`abstract_params` (tensors on the ``meta`` device), :func:`param_axes`
and :func:`input_specs` are functions of the config, and ``LM``'s methods of
those names call them with its own.

Parameters are allocated on the target device in the model's dtype and drawn
there, one period slice at a time, from a generator on that device: a 28B
model is never staged in host memory, and its weights depend on the seed and
the device type. The transient peak of the draws is two float32 copies (the
draw and its scaled copy) of the largest tensor drawn at once: for
``moonshot_v1_16b`` the embedding ``[163840, 2048]``, 1.34 GB each, on top
of the 51.6 GiB of bf16 parameters (an expert stack's period slice,
``[64, 2048, 1408]``, is 738 MB).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BLOCK_ATTN, ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import is_meshed, placed, shard_dims, split_range
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, build_abstract, build_axes, init_param, mlp,
                                       rms_norm, shard_act, sinusoidal_pos)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AUX_LOSS_COEF = 0.01


@dataclass(frozen=True)
class SlotKind:
    kind: str          # attn | mamba
    is_moe: bool
    is_local: bool     # sliding-window attention
    theta: float       # rope base (gemma3: 10k local / 1M global)


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def period_of(cfg: ModelConfig) -> int:
    """The LCM of the arch's interleave patterns (jamba 8, gemma3 6, else 1)."""
    p = 1
    if cfg.mamba is not None and not cfg.attention_free:
        p = math.lcm(p, cfg.attn_every)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    if cfg.sliding_window > 0:
        p = math.lcm(p, cfg.swa_period)
    return p


def slot_kinds(cfg: ModelConfig) -> List[SlotKind]:
    out = []
    for s in range(period_of(cfg)):
        local = cfg.is_local_attn(s)
        theta = 10000.0 if cfg.sliding_window and local else cfg.rope_theta
        out.append(SlotKind(cfg.block_kind(s), cfg.is_moe_layer(s), local, theta))
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree, as ParamSpecs with their logical axes:
    ``embed`` (not for ``frames``), ``unembed`` (``frames`` and untied configs),
    ``patch_proj`` (``patches``), ``final_norm``, and per period slot its
    parameters stacked over the K = L / P periods."""
    c = cfg
    K, D = c.num_layers // period_of(c), c.d_model
    specs: dict = {}
    if c.frontend != "frames":
        specs["embed"] = ParamSpec((c.vocab_size, D), ("w_vocab", "w_embed"))
    if c.frontend == "frames" or not c.tie_embeddings:
        specs["unembed"] = ParamSpec((c.vocab_size, D), ("w_vocab", "w_embed"))
    if c.frontend == "patches":
        specs["patch_proj"] = ParamSpec((D, D), ("w_embed", None))
    specs["final_norm"] = ParamSpec((D,), (None,), init="zeros")
    H, KV, hd = c.num_heads, c.num_kv_heads, c.head_dim
    slot_specs = []
    for sk in slot_kinds(c):
        ps = {"norm1": ParamSpec((K, D), ("w_layers", None), init="zeros")}
        if sk.kind == BLOCK_ATTN:
            ps["wq"] = ParamSpec((K, D, H * hd), ("w_layers", "w_embed", "w_qdim"))
            ps["wk"] = ParamSpec((K, D, KV * hd), ("w_layers", "w_embed", "w_kvdim"))
            ps["wv"] = ParamSpec((K, D, KV * hd), ("w_layers", "w_embed", "w_kvdim"))
            ps["wo"] = ParamSpec((K, H * hd, D), ("w_layers", "w_qdim", "w_embed"))
            if c.qk_norm:
                ps["q_norm"] = ParamSpec((K, hd), ("w_layers", None), init="zeros")
                ps["k_norm"] = ParamSpec((K, hd), ("w_layers", None), init="zeros")
        else:
            m = c.mamba
            DI = m.d_inner
            ps["in_x"] = ParamSpec((K, D, DI), ("w_layers", "w_embed", "w_dinner"))
            ps["in_z"] = ParamSpec((K, D, DI), ("w_layers", "w_embed", "w_dinner"))
            ps["conv_w"] = ParamSpec((K, m.d_conv, DI), ("w_layers", None, "w_dinner"))
            ps["conv_b"] = ParamSpec((K, DI), ("w_layers", "w_dinner"), init="zeros")
            ps["x_proj"] = ParamSpec((K, DI, m.dt_rank + 2 * m.d_state),
                                     ("w_layers", "w_dinner", None))
            ps["dt_proj"] = ParamSpec((K, m.dt_rank, DI), ("w_layers", None, "w_dinner"))
            ps["dt_bias"] = ParamSpec((K, DI), ("w_layers", "w_dinner"), init="mamba_dt")
            ps["A_log"] = ParamSpec((K, DI, m.d_state), ("w_layers", "w_dinner", "w_state"),
                                    init="mamba_a")
            ps["D"] = ParamSpec((K, DI), ("w_layers", "w_dinner"), init="ones")
            ps["out_proj"] = ParamSpec((K, DI, D), ("w_layers", "w_dinner", "w_embed"))
        ps["norm2"] = ParamSpec((K, D), ("w_layers", None), init="zeros")
        if sk.is_moe:
            E, F = c.moe.num_experts, c.moe.expert_ff
            ps["router"] = ParamSpec((K, D, E), ("w_layers", "w_embed", None))
            for name in ("moe_wi", "moe_wg"):
                ps[name] = ParamSpec((K, E, D, F),
                                     ("w_layers", "w_expert", "w_embed", "w_moe_mlp"))
            ps["moe_wo"] = ParamSpec((K, E, F, D),
                                     ("w_layers", "w_expert", "w_moe_mlp", "w_embed"))
        elif c.d_ff > 0:
            ps["wi"] = ParamSpec((K, D, c.d_ff), ("w_layers", "w_embed", "w_mlp"))
            if c.gated_mlp:
                ps["wg"] = ParamSpec((K, D, c.d_ff), ("w_layers", "w_embed", "w_mlp"))
            ps["wo_mlp"] = ParamSpec((K, c.d_ff, D), ("w_layers", "w_mlp", "w_embed"))
        slot_specs.append(ps)
    specs["slots"] = slot_specs
    return specs


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors in the config's dtype: no storage."""
    return build_abstract(param_specs(cfg), torch_dtype(cfg.dtype))


def param_axes(cfg: ModelConfig) -> dict:
    """The parameter tree's logical axis names (``w_*``), one tuple a tensor."""
    return build_axes(param_specs(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(batch specs, batch axes) of an assigned shape: ``meta`` tensors of the
    batch's shapes and dtypes, and each one's logical axes (``act_*``)."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def meta(sh, dtype):
        return torch.empty(sh, dtype=dtype, device="meta")

    if shape.mode in ("train", "prefill"):
        if cfg.frontend == "frames":
            specs = {"frames": meta((B, S, cfg.d_model), dt),
                     "labels": meta((B, S), torch.int32),
                     "loss_mask": meta((B, S), torch.float32)}
            axes = {"frames": ("act_batch", "act_seq", None),
                    "labels": ("act_batch", "act_seq"),
                    "loss_mask": ("act_batch", "act_seq")}
        else:
            specs = {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}
            axes = {"tokens": ("act_batch", "act_seq"), "labels": ("act_batch", "act_seq")}
            if cfg.frontend == "patches":
                specs["patch_embeds"] = meta((B, cfg.num_patches, cfg.d_model), dt)
                axes["patch_embeds"] = ("act_batch", None, None)
        if shape.mode == "prefill":
            specs.pop("labels", None)
            axes.pop("labels", None)
        return specs, axes
    # decode / long_decode: one token + positions; the cache comes separately
    specs = {"token": meta((B,), torch.int32), "pos": meta((B,), torch.int32)}
    axes = {"token": ("act_batch",), "pos": ("act_batch",)}
    return specs, axes


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
    the other. ``attn_block`` is the block of the JAX package's blocked
    attention, which the CPU's plain versions take when training.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 attn_block: int = 512):
        super().__init__()
        self.cfg = cfg
        self.attn_block = attn_block
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        self.period = period_of(cfg)
        if cfg.num_layers % self.period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not fill "
                             f"periods of {self.period}")
        self.num_periods = cfg.num_layers // self.period
        self.slot_kinds: List[SlotKind] = slot_kinds(cfg)

        specs = self.param_specs()
        for name, spec in specs.items():      # embed, unembed, patch_proj, final_norm
            if name != "slots":
                self.register_parameter(name, _param(spec, dev, dtype))
        self.slots = nn.ModuleList(_Slot(ps, dev, dtype) for ps in specs["slots"])
        self.init_params(seed, specs)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.dtype

    # ------------------------------------------------------------------
    # Parameters (the module functions of these names, with this config)
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        return param_specs(self.cfg)

    def abstract_params(self) -> dict:
        return abstract_params(self.cfg)

    def param_axes(self) -> dict:
        return param_axes(self.cfg)

    def input_specs(self, shape: ShapeConfig):
        return input_specs(self.cfg, shape)

    @torch.no_grad()
    def init_params(self, seed: int, specs: Optional[dict] = None) -> None:
        """Draw every parameter from ``seed`` on its own device, a slot's
        stacked parameters one period slice at a time (float32 draws of one
        slice, then the cast)."""
        specs = specs or self.param_specs()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, spec in specs.items():
            if name != "slots":
                init_param(spec, gen, getattr(self, name))
        for slot, ps in zip(self.slots, specs["slots"]):
            for name, spec in ps.items():
                stacked = getattr(slot, name)
                for k in range(self.num_periods):
                    init_param(spec, gen, stacked[k])

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by name (``embed``, ``slots.0.wq``): the dict that
        ``loss_fn`` and the train step take."""
        return dict(self.named_parameters())

    def _periods(self, params: Dict[str, torch.Tensor]) -> List[List[Dict[str, torch.Tensor]]]:
        """Per period k, per slot, that slot's parameters' k-th slices."""
        per_slot = [{name: params[f"slots.{s}.{name}"].unbind(0)
                     for name, _ in slot.named_parameters()}
                    for s, slot in enumerate(self.slots)]
        return [[{n: t[k] for n, t in ps.items()} for ps in per_slot]
                for k in range(self.num_periods)]

    # ------------------------------------------------------------------
    # Embedding and head
    # ------------------------------------------------------------------
    def embed_input(self, batch, params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """[B, S, D] inputs of the first layer, as the JAX function makes them:
        frames cast to the model's dtype; or the tokens' embeddings, the
        first P replaced by ``patch_embeds @ patch_proj`` (P positions even
        where S < P, as the JAX ``concatenate`` gives); sinusoidal positions
        added, in the inputs' dtype, where the model is not causal."""
        c = self.cfg
        P = self._parameters if params is None else params
        if c.frontend == "frames":
            x = torch.as_tensor(batch["frames"], device=self.device).to(self.dtype)
            return x + sinusoidal_pos(x.shape[1], c.d_model, x.dtype, x.device)[None]
        x = P["embed"][torch.as_tensor(batch["tokens"], device=self.device)]
        if c.frontend == "patches" and "patch_embeds" in batch:
            pe = torch.as_tensor(batch["patch_embeds"], device=self.device).to(x.dtype)
            pe = pe @ P["patch_proj"]
            x = torch.cat([pe, x[:, pe.shape[1]:]], 1)
        if not c.causal:
            x = x + sinusoidal_pos(x.shape[1], c.d_model, x.dtype, x.device)[None]
        return x

    def _head(self, params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        P = self._parameters if params is None else params
        return P["unembed"] if "unembed" in P else P["embed"]

    def logits(self, x: torch.Tensor,
               params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        out = x @ self._head(params).T
        names = ("act_batch", "act_seq", "act_vocab") if out.dim() == 3 \
            else ("act_batch", "act_vocab")
        return shard_act(out, names)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _mlp(self, h, p):
        return mlp(h, {"wi": p["wi"], "wg": p.get("wg"), "wo": p["wo_mlp"]},
                   self.cfg.gated_mlp)

    def _moe(self, h, p):
        return moe_mod.moe_forward(h, {"router": p["router"], "wi": p["moe_wi"],
                                       "wg": p["moe_wg"], "wo": p["moe_wo"]}, self.cfg)

    def _block_seq(self, x, p, sk: SlotKind, positions):
        c = self.cfg
        h = rms_norm(x, p["norm1"], c.norm_eps)
        if sk.kind == BLOCK_ATTN:
            h, cache = attn_mod.attn_forward(h, p, c, sk.is_local, positions,
                                             theta=sk.theta, block=self.attn_block)
        else:
            h, cache = mamba_mod.mamba_forward(h, p, c)
        x = shard_act(x + h, ("act_batch", "act_seq", "act_embed"))
        if sk.is_moe:
            x = x + self._moe(rms_norm(x, p["norm2"], c.norm_eps), p)
        elif c.d_ff > 0:
            x = x + self._mlp(rms_norm(x, p["norm2"], c.norm_eps), p)
        return shard_act(x, ("act_batch", "act_seq", "act_embed")), cache

    def _block_decode(self, x, p, sk: SlotKind, cache, positions):
        c = self.cfg
        h = rms_norm(x, p["norm1"], c.norm_eps)
        if sk.kind == BLOCK_ATTN:
            h, cache = attn_mod.attn_decode(h, p, c, sk.is_local, cache, positions,
                                            theta=sk.theta)
        else:
            h, cache = mamba_mod.mamba_decode(h, p, c, cache)
        x = x + h
        if sk.is_moe:
            x = x + self._moe(rms_norm(x, p["norm2"], c.norm_eps), p)
        elif c.d_ff > 0:
            x = x + self._mlp(rms_norm(x, p["norm2"], c.norm_eps)[:, None], p)[:, 0]
        return x, cache

    # ------------------------------------------------------------------
    # Sequence mode (train / prefill)
    # ------------------------------------------------------------------
    def _period_seq(self, x, slot_params, positions):
        caches = []
        for p, sk in zip(slot_params, self.slot_kinds):
            x, cache = self._block_seq(x, p, sk, positions)
            caches.append(cache)
        return x, caches

    def forward_seq(self, batch, *, want_cache: bool,
                    params: Optional[Dict[str, torch.Tensor]] = None):
        """Final hidden states [B, S, D] (and, with ``want_cache``, the caches)
        from the module's parameters or from ``params``. Under autograd this
        is the training forward: attention goes through ``attend_blocked``,
        and where ``cfg.remat`` asks for it (without caches) each period runs
        under ``torch.utils.checkpoint``, so its activations are recomputed
        in the backward, the attention kernel B1 included."""
        use_remat = self.cfg.remat and not want_cache
        P = self.params() if params is None else params
        x = shard_act(self.embed_input(batch, P), ("act_batch", "act_seq", "act_embed"))
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
        per_period = []
        for pk in self._periods(P):
            if use_remat:
                x = checkpoint(lambda xc, pk=pk: self._period_seq(xc, pk, positions)[0], x,
                               use_reentrant=False)
            else:
                x, caches = self._period_seq(x, pk, positions)
                if want_cache:
                    caches = self._constrain_caches(caches, B, S)
                per_period.append(caches)
        x = rms_norm(x, P["final_norm"], self.cfg.norm_eps)
        if not want_cache:
            return x, None
        caches = [{name: torch.stack([pc[s][name] for pc in per_period])
                   for name in per_period[0][s]} for s in range(self.period)]
        return x, caches

    def _constrain_caches(self, caches, B: int, S: int):
        """One period's caches constrained to the decode cache's logical axes
        (``cache_specs``, the layer dim left out), as they come out of the
        period: the JAX scan writes each period's cache into the stacked
        output under its out-sharding, so no rank holds a layer's whole
        cache (deepseek's kv heads do not split over ``model``: their slots
        do) nor two copies of every layer's (the stack's)."""
        _, axes = self.cache_specs(B, S)
        return [{n: shard_act(t, axes["slots"][s][n][1:]) for n, t in c.items()}
                for s, c in enumerate(caches)]

    def loss_fn(self, params: Dict[str, torch.Tensor], batch):
        """Mean CE (+ MoE aux). batch: tokens (+ patch_embeds) or frames,
        labels, optional loss_mask.
        Returns (loss, {"ce", and "aux" for MoE configs})."""
        c = self.cfg
        x, _ = self.forward_seq(batch, want_cache=False, params=params)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, device=self.device) if mask is None
                else torch.as_tensor(mask, device=self.device).float())
        head = self._head(params)
        chunk = c.logits_chunk
        if chunk and labels.shape[1] % chunk == 0 and labels.shape[1] > chunk:
            loss_sum = _chunked_ce(x, head, labels, mask, chunk)
        else:
            loss_sum = -(_label_logprob(x, head, labels) * mask).sum()
        loss = loss_sum / torch.clamp_min(mask.sum(), 1.0)
        metrics = {"ce": loss}
        if c.moe is not None:
            # aux loss on the input embedding stream (cheap proxy over layers)
            aux = self._aux_loss(params, batch)
            metrics["aux"] = aux
            loss = loss + AUX_LOSS_COEF * aux
        return loss, metrics

    def _aux_loss(self, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        x = self.embed_input(batch, params)
        # first MoE slot, first period — representative balance signal
        for s, sk in enumerate(self.slot_kinds):
            if sk.is_moe:
                return moe_mod.moe_aux_loss(x, {"router": params[f"slots.{s}.router"][0]},
                                            self.cfg)
        return torch.zeros((), device=self.device)

    @torch.no_grad()
    def prefill(self, batch, params: Optional[Dict[str, torch.Tensor]] = None):
        """Returns (last-token logits [B, V], cache). The logits are taken at the
        padded end, x[:, -1], as in the JAX package. ``params`` (named as
        ``params()`` names them; the module's own by default) may be
        DTensors of a device mesh: the cache is then DTensors too."""
        with _replicating(params):
            x, caches = self.forward_seq(batch, want_cache=True, params=params)
            return self.logits(x[:, -1], params), {"slots": caches}

    # ------------------------------------------------------------------
    # Decode mode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache, batch, params: Optional[Dict[str, torch.Tensor]] = None):
        """batch: {token: [B] int, pos: [B] int}. Returns (logits, cache); the
        cache is updated in place (every block writes its layer's slice).
        ``params`` as :meth:`prefill` takes them; on a device mesh the cache
        is DTensors, and each rank writes the rows and slots of its shard."""
        P = self._parameters if params is None else params
        periods = None if params is None else self._periods(params)
        with _replicating(params):
            x = shard_act(P["embed"][batch["token"].to(self.device)], ("act_batch", "act_embed"))
            positions = batch["pos"].to(self.device)
            for k in range(self.num_periods):
                for s, (slot, sk) in enumerate(zip(self.slots, self.slot_kinds)):
                    layer_cache = {name: c[k] for name, c in cache["slots"][s].items()}
                    p = slot.period(k) if periods is None else periods[k][s]
                    x, _ = self._block_decode(x, p, sk, layer_cache, positions)
            x = rms_norm(x, P["final_norm"], self.cfg.norm_eps)
            return self.logits(x, params), cache

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------
    def _cache_width(self, sk: SlotKind, max_len: int) -> int:
        if sk.is_local and self.cfg.sliding_window:
            return min(self.cfg.sliding_window, max_len)
        return max_len

    def cache_specs(self, batch_size: int, max_len: int):
        """(``(shape, dtype)`` of every decode-cache tensor, its logical axes),
        per slot, as the JAX package gives them: attention k/v [K, B, W, KV,
        hd] in the model's dtype, axes ``("w_layers", "act_batch",
        "act_kv_seq", "act_kv_heads", None)``; Mamba conv [K, B, d_conv-1,
        DI] in the model's dtype and ssm [K, B, DI, N] in float32 whatever
        the model's dtype, axes ``("w_layers", "act_batch", None,
        "act_mlp")`` and ``("w_layers", "act_batch", "act_mlp", None)``."""
        c = self.cfg
        K = self.num_periods
        specs, axes = [], []
        for sk in self.slot_kinds:
            if sk.kind == BLOCK_ATTN:
                W = self._cache_width(sk, max_len)
                sh = (K, batch_size, W, c.num_kv_heads, c.head_dim)
                ax = ("w_layers", "act_batch", "act_kv_seq", "act_kv_heads", None)
                specs.append({"k": (sh, self.dtype), "v": (sh, self.dtype)})
                axes.append({"k": ax, "v": ax})
            else:
                m = c.mamba
                specs.append({
                    "conv": ((K, batch_size, m.d_conv - 1, m.d_inner), self.dtype),
                    "ssm": ((K, batch_size, m.d_inner, m.d_state), torch.float32)})
                axes.append({"conv": ("w_layers", "act_batch", None, "act_mlp"),
                             "ssm": ("w_layers", "act_batch", "act_mlp", None)})
        return {"slots": specs}, {"slots": axes}

    def init_cache(self, batch_size: int, max_len: int):
        specs, _ = self.cache_specs(batch_size, max_len)
        return {"slots": [{name: torch.zeros(sh, dtype=dt, device=self.device)
                           for name, (sh, dt) in s.items()} for s in specs["slots"]]}


def _replicating(params):
    """``implicit_replication`` where ``params`` are DTensors (the plain
    tensors the model makes then act as replicated), else nothing."""
    if params is not None and is_meshed(*params.values()):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _label_logprob(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log_softmax(x @ head^T) at the labels; logits in x's type, then float32.
    Logits split over the vocabulary (a mesh) take :func:`_vocab_parallel_logprob`."""
    logits = shard_act(x @ head.T, ("act_batch", "act_seq", "act_vocab"))
    if is_meshed(logits) and shard_dims(logits, 2):
        return _vocab_parallel_logprob(logits, labels)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, labels[..., None])[..., 0]


def _vocab_parallel_logprob(logits, labels) -> torch.Tensor:
    """The label's log-prob from logits [B, S, V] split over V, each rank on
    its own shard (as XLA partitions the JAX package's cross-entropy over
    the vocabulary): no rank holds a whole row of the vocabulary, forward
    or backward. Batch and sequence splits stay as the logits have them; the
    vocabulary's may be uneven (504 classes over 16 ranks)."""
    from repro_torch.kernels import ops
    mesh = logits.device_mesh
    vdims = shard_dims(logits, 2)
    rows = {d: [i for i in shard_dims(logits, d) if i not in vdims] for d in (0, 1)}
    lpl = placed(mesh, {**rows, 2: vdims})
    rpl = placed(mesh, rows)
    v0, _ = split_range(mesh, vdims, logits.shape[2])
    return ops.run_local(lambda lg, lab: _VocabLogProb.apply(lg, lab, mesh, vdims, v0), mesh,
                         [logits, labels], [lpl, rpl], rpl)


class _VocabLogProb(torch.autograd.Function):
    """On a rank's vocabulary shard ``lg`` [b, s, v] (columns ``[v0, v0 +
    v)`` of V, split over the mesh dims ``vdims``) and global labels [b, s]:
    ``logit[label] - max - log sum exp(logit - max)``, the max all-reduced by
    max and the sum of exponentials and the label's logit (a masked sum over
    the shard: exact, one term and zeros) by sum over ``vdims``. The
    backward, ``g (onehot - softmax)``, is local to the shard."""

    @staticmethod
    def forward(ctx, lg, lab, mesh, vdims, v0):
        from repro_torch.kernels.ops import all_reduce
        lg32 = lg.float()
        mx = all_reduce(lg32.amax(-1), "max", mesh, vdims)
        onehot = (torch.arange(v0, v0 + lg.shape[-1], device=lg.device) == lab[..., None])
        sums = torch.stack([torch.exp(lg32 - mx[..., None]).sum(-1),
                            torch.where(onehot, lg32, 0.0).sum(-1)])
        se, picked = all_reduce(sums, "sum", mesh, vdims)
        ctx.save_for_backward(lg, lab, mx, se)
        ctx.v0 = v0
        return picked - mx - torch.log(se)

    @staticmethod
    def backward(ctx, g):
        lg, lab, mx, se = ctx.saved_tensors
        v0 = ctx.v0
        onehot = (torch.arange(v0, v0 + lg.shape[-1], device=lg.device) == lab[..., None])
        p = torch.exp(lg.float() - mx[..., None]) / se[..., None]
        return (g[..., None] * (onehot.float() - p)).to(lg.dtype), None, None, None, None


def _chunked_ce(x, head, labels, mask, chunk: int) -> torch.Tensor:
    """Cross-entropy summed over the sequence without keeping full logits: each
    chunk under ``torch.utils.checkpoint``, as the JAX package's scan body
    under ``jax.remat``."""
    tot = torch.zeros((), device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        ll = checkpoint(_label_logprob, x[:, sl], head, labels[:, sl], use_reentrant=False)
        tot = tot - (ll * mask[:, sl]).sum()
    return tot


def build_model(cfg: ModelConfig, **kw) -> LM:
    return LM(cfg, **kw)

