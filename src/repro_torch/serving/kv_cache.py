"""Slot-pool KV cache for continuous batching, ported from the JAX package's
``serving/kv_cache.py``.

One :class:`SlotCache` backs one function instance: a decode cache of width
``slots`` on the batch dim (the within-instance concurrency), with per-slot
insert (admission after prefill) and a shared decode step over all slots.
Inactive slots decode garbage that is never read — standard continuous
batching semantics. The cache tensors live on the model's device and are
written in place; the bookkeeping stays in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch


class SlotCache:
    def __init__(self, model, slots: int, max_len: int):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.cache = model.init_cache(slots, max_len)
        self.pos = np.zeros(slots, np.int32)           # next position per slot
        self.active = np.zeros(slots, bool)
        self.rid = np.full(slots, -1, np.int64)
        self.remaining = np.zeros(slots, np.int32)

    def free_slots(self):
        return [i for i in range(self.slots) if not self.active[i]]

    @torch.no_grad()
    def admit(self, slot: int, prefill_cache, prompt_len: int, rid: int,
              gen_tokens: int):
        """Insert a prefilled (batch=1) sequence into `slot`.

        Attention k/v of prefill width S0 <= W are zero-padded into the row;
        a Mamba slot's conv window and SSM state go in whole, each in the
        cache's own dtype (the state stays float32)."""
        for c_slot, p_slot in zip(self.cache["slots"], prefill_cache["slots"]):
            for name, c in c_slot.items():
                p = p_slot[name].to(c.dtype)
                # c: [K, slots, W, ...]; p batch dim = 1
                if c.dim() >= 3 and p.dim() == c.dim() and p.shape[2] != c.shape[2]:
                    # attn cache: prefill width S0 <= W, zero-padded into the row
                    c[:, slot].zero_()
                    c[:, slot, :p.shape[2]] = p[:, 0]
                else:
                    c[:, slot] = p[:, 0]
        self.pos[slot] = prompt_len
        self.active[slot] = True
        self.rid[slot] = rid
        self.remaining[slot] = gen_tokens

    def release(self, slot: int):
        self.active[slot] = False
        self.rid[slot] = -1

    def positions(self) -> torch.Tensor:
        return torch.as_tensor(self.pos, device=self.model.device)

    def advance(self):
        self.pos[self.active] += 1
        self.remaining[self.active] -= 1

    def finished_slots(self):
        return [i for i in range(self.slots)
                if self.active[i] and self.remaining[i] <= 0]
