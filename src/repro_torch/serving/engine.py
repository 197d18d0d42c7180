"""The REAL worker engine on the card, ported from the JAX package's
``serving/engine.py``: executes registered functions as actual LMs with
continuous batching, measured cold starts, idle lifecycle and full
telemetry — paper Fig. 2 step 1's "actual server".

A :class:`Worker` owns function instances; an instance is (an ``LM``, a
``SlotCache``). Cold start = parameter materialization (allocation and
seeded draws on the device) plus a warm-up prefill and decode, each
wall-clocked up to ``torch.cuda.synchronize()`` (``materialize_s`` and
``warmup_s``; both 0 for a replica that hits the image cache) and charged
to the triggering request — the HyperFaaS analogue of a container
pull + boot. Building the CUDA kernels is set-up, done before serving, and is
not part of any cold start.

The :class:`Engine` glues a router tree over N workers in one process. It is
intentionally synchronous and deterministic. Everything runs on the card
unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass
from random import Random
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.config_store import ConfigStore, ImageRegistry
from repro_torch.core.router import LBNode, StateView, WorkerState
from repro_torch.core.types import FunctionConfig, Request, RequestResult, TelemetryRecord
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.kv_cache import SlotCache


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def weight_seed(arch: str) -> int:
    """Stable per-function weight seed. (The JAX engine seeds with
    ``hash(arch)``, which changes from process to process.)"""
    return zlib.crc32(arch.encode()) % 2**31


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# "image layer cache": the same function image (arch, slots, max_len) on one
# device yields the same weights — the first pull pays the full cold start,
# replica instances hit the cache (exactly a container image/layer cache).
_IMAGE_CACHE: Dict[tuple, object] = {}


class Instance:
    def __init__(self, iid: str, cfg: FunctionConfig, *, rng_seed: int = 0,
                 max_len: int = 256, device=None):
        self.iid = iid
        self.cfg = cfg
        self.device = resolve_device(device)
        t0 = time.monotonic()
        slots = cfg.concurrency if cfg.concurrency > 0 else cfg.max_instances_per_worker
        self.slots = slots
        key = (cfg.arch, slots, max_len, str(self.device))
        self.materialize_s = self.warmup_s = 0.0
        if key not in _IMAGE_CACHE:
            model = build_model(get_config(cfg.arch), device=self.device,
                                seed=weight_seed(cfg.arch))
            _sync(self.device)
            self.materialize_s = time.monotonic() - t0
            # warm-up: the first prefill and decode at serving shapes
            kv0 = SlotCache(model, slots, max_len)
            model.prefill({"tokens": torch.zeros((1, 16), dtype=torch.int32,
                                                 device=self.device)})
            zeros = torch.zeros(slots, dtype=torch.int32, device=self.device)
            model.decode_step(kv0.cache, {"token": zeros, "pos": zeros})
            _sync(self.device)
            self.warmup_s = time.monotonic() - t0 - self.materialize_s
            _IMAGE_CACHE[key] = model
        self.model = _IMAGE_CACHE[key]
        self.kv = SlotCache(self.model, slots, max_len)
        self.cold_start_s = time.monotonic() - t0
        self.last_used = time.monotonic()
        self.sampler = Random(rng_seed)
        self._last_tok = np.zeros(slots, np.int32)   # greedy-decode feedback
        self._slot_meta: Dict[int, object] = {}
        self.generated: Dict[int, list] = {}         # rid -> token ids

    def busy(self) -> int:
        return int(self.kv.active.sum())


@dataclass
class _Pending:
    req: Request
    submit_t: float


class Worker:
    def __init__(self, name: str, store: ConfigStore, registry: ImageRegistry,
                 *, max_len: int = 256, device=None):
        self.name = name
        self.store = store
        self.registry = registry
        self.max_len = max_len
        self.device = resolve_device(device)
        self.instances: Dict[str, List[Instance]] = {}
        self.pending: deque = deque()
        self.telemetry: List[TelemetryRecord] = []
        self.cold_starts = 0
        self._iid = 0

    # ------------------------------------------------------------- state
    def state(self) -> WorkerState:
        return WorkerState(
            worker=self.name, queue_len=len(self.pending),
            inflight=sum(i.busy() for il in self.instances.values() for i in il),
            capacity=max(sum(i.slots for il in self.instances.values()
                             for i in il), 1),
            warm_fns=frozenset(fn for fn, il in self.instances.items() if il))

    def submit(self, req: Request):
        self.pending.append(_Pending(req, time.monotonic()))

    # ---------------------------------------------------------- lifecycle
    def _get_instance(self, cfg: FunctionConfig):
        il = self.instances.setdefault(cfg.name, [])
        for inst in il:
            if inst.kv.free_slots():
                return inst, False
        if len(il) < cfg.max_instances_per_worker:
            self._iid += 1
            inst = Instance(f"{self.name}/i{self._iid}", cfg, rng_seed=self._iid,
                            max_len=self.max_len, device=self.device)
            il.append(inst)
            self.cold_starts += 1
            return inst, True
        return None, False

    def reap_idle(self):
        now = time.monotonic()
        for fn, il in self.instances.items():
            cfg = self.store.get(fn)
            for inst in list(il):
                if inst.busy() == 0 and now - inst.last_used > cfg.idle_timeout_s:
                    il.remove(inst)

    # ------------------------------------------------------------- serve
    def step(self) -> List[RequestResult]:
        """Admit pending into slots, run ONE decode step on every instance
        with active slots, and complete finished sequences."""
        results = []
        # admission
        still = deque()
        while self.pending:
            p = self.pending.popleft()
            cfg = self.store.get(p.req.fn)
            inst, cold = self._get_instance(cfg)
            if inst is None:
                still.append(p)
                continue
            slot = inst.kv.free_slots()[0]
            bl = _bucket(p.req.size)
            toks = np.zeros((1, bl), np.int32)
            payload = np.asarray(p.req.payload if p.req.payload is not None
                                 else np.arange(p.req.size) % 97 + 2)
            toks[0, :p.req.size] = payload[:p.req.size]
            logits, pcache = inst.model.prefill(
                {"tokens": torch.as_tensor(toks, device=self.device)})
            inst.kv.admit(slot, pcache, bl, p.req.rid, cfg.gen_tokens)
            inst._last_tok[slot] = int(torch.argmax(logits[0]))   # syncs the card
            inst.generated[p.req.rid] = [int(inst._last_tok[slot])]
            inst.last_used = time.monotonic()
            self.telemetry.append(TelemetryRecord(
                fn=p.req.fn, t=p.submit_t, queue_len=len(self.pending),
                inflight=inst.busy() - 1, batch_size=inst.busy(),
                cold=cold, prompt_tokens=p.req.size,
                gen_tokens=cfg.gen_tokens,
                fn_cost=get_config(cfg.arch).param_count() / 1e7,
                latency=0.0, ok=True))
            p._telemetry_idx = len(self.telemetry) - 1
            p._cold = cold
            inst._slot_meta[slot] = p
        self.pending = still
        # decode step per instance
        for fn, il in self.instances.items():
            for inst in il:
                if inst.busy() == 0:
                    continue
                tok = torch.as_tensor(inst._last_tok, device=self.device)
                logits, inst.kv.cache = inst.model.decode_step(
                    inst.kv.cache, {"token": tok, "pos": inst.kv.positions()})
                nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
                for s in range(inst.slots):
                    if inst.kv.active[s]:
                        inst._last_tok[s] = nxt[s]
                        rid = int(inst.kv.rid[s])
                        if rid in inst.generated:
                            inst.generated[rid].append(int(nxt[s]))
                inst.kv.advance()
                inst.last_used = time.monotonic()
                for slot in inst.kv.finished_slots():
                    p = inst._slot_meta.pop(slot)
                    inst.kv.release(slot)
                    now = time.monotonic()
                    rec = self.telemetry[p._telemetry_idx]
                    rec.latency = now - p.submit_t
                    results.append(RequestResult(
                        rid=p.req.rid, fn=p.req.fn, ok=True,
                        arrival_t=p.submit_t, start_t=p.submit_t,
                        finish_t=now, cold_start=p._cold,
                        worker=self.name, instance=inst.iid))
        return results

    def drain(self) -> List[RequestResult]:
        out = []
        while self.pending or any(i.busy() for il in self.instances.values()
                                  for i in il):
            out.extend(self.step())
        return out


class Engine:
    """Router tree over real in-process workers, all on one device."""

    def __init__(self, tree: LBNode, store: ConfigStore,
                 registry: ImageRegistry, *, seed: int = 0, max_len: int = 256,
                 device=None):
        self.tree = tree
        self.store = store
        self.view = StateView()
        self.rng = Random(seed)
        self.device = resolve_device(device)
        self.workers = {w: Worker(w, store, registry, max_len=max_len, device=self.device)
                        for w in tree.all_workers()}
        for w in self.workers.values():
            self.view.update(w.state())

    def submit(self, req: Request):
        wid, _ = self.tree.route(req, self.view, self.rng, time.monotonic())
        self.workers[wid].submit(req)
        self.view.update(self.workers[wid].state())

    def run(self) -> List[RequestResult]:
        results = []
        while True:
            progressed = False
            for w in self.workers.values():
                r = w.step()
                if r or w.pending:
                    progressed = True
                results.extend(r)
                self.view.update(w.state())
            if not progressed and not any(
                    i.busy() for w in self.workers.values()
                    for il in w.instances.values() for i in il):
                break
        return results

    def telemetry(self) -> List[TelemetryRecord]:
        out = []
        for w in self.workers.values():
            out.extend(w.telemetry)
        return out
