"""Per-function scheduling substrate for the simulator's workers.

The port's own copy of the JAX package's ``core/scheduling.py``, which holds no
JAX: the port imports nothing of that package.

The seed kept one flat request list and one ``Dict[fn, List[_Instance]]``
per worker, so every dispatch rescanned the whole backlog and every finish
searched every instance on the worker — O(worker) work per event. This
module is the indexed replacement:

- :class:`Instance` — one function replica (warming until ``ready_t``,
  then serving up to ``slots`` concurrent requests).
- :class:`FunctionReplicaSet` — the per-function replica index: ready
  pick, warming free-slot count, next-ready time, free-slot totals.
- :class:`FnQueues` — per-function FIFO queues with a worker-global
  arrival sequence (so cross-function dispatch order is preserved
  exactly) and a deadline heap (so queue timeouts are flushed without
  scanning the backlog).

Dispatch and finish become O(affected function) instead of O(worker):
the simulator merges only *dispatchable* functions by global sequence
number, skipping saturated functions' entire queues in O(1), and looks
instances up through an iid index. Semantics are unchanged — same seed
still yields byte-identical request results (pinned by
``tests/test_scheduling.py``). One documented exception: a request's
queue-timeout deadline is fixed from the ``FunctionConfig`` at enqueue
time, so re-``put()``-ing a config mid-run no longer retimes requests
already queued (the seed re-read the config at every scan).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

UNLIMITED_SLOTS = 10 ** 9      # free-slot stand-in for slots == 0 instances


@dataclass
class Instance:
    """One replica of a function on a worker."""

    iid: str
    fn: str
    slots: int                 # 0 => unlimited (soft)
    busy: int = 0
    last_used: float = 0.0
    ready_t: float = 0.0       # cold start completes
    memory_mb: float = 0.0     # footprint charged against worker capacity

    def has_free_slot(self) -> bool:
        return self.busy < self.slots if self.slots > 0 else True

    def free_slots(self) -> int:
        return (self.slots if self.slots > 0 else UNLIMITED_SLOTS) - self.busy


class FunctionReplicaSet:
    """Replica index for one function on one worker.

    Keeps the instance list plus the per-function reads the dispatch hot
    path needs: densest ready pick, warming free slots, next ready time.
    Instance counts are bounded by the worker's capacity, so these scans
    are O(replicas-of-one-fn), never O(worker). The set also carries the
    function's aggregate memory footprint (``mem_mb``), maintained
    incrementally by :meth:`add`/:meth:`discard` so the placement layer
    never rescans instance lists to account memory.
    """

    __slots__ = ("fn", "instances", "mem_mb")

    def __init__(self, fn: str):
        self.fn = fn
        self.instances: List[Instance] = []
        self.mem_mb = 0.0          # sum of live replicas' memory_mb

    def __len__(self) -> int:
        return len(self.instances)

    def add(self, inst: Instance) -> None:
        self.instances.append(inst)
        self.mem_mb += inst.memory_mb

    def discard(self, inst: Instance) -> None:
        self.instances.remove(inst)
        self.mem_mb -= inst.memory_mb

    def pick(self, now: float) -> Optional[Instance]:
        """Ready instance with a free slot, packing densest first."""
        best = None
        for inst in self.instances:
            if inst.ready_t <= now and inst.has_free_slot():
                if best is None or inst.busy > best.busy:
                    best = inst
        return best

    def warming_free(self, now: float) -> int:
        """Free slots on instances still cold-starting."""
        return sum(i.free_slots() for i in self.instances if i.ready_t > now)

    def next_ready_after(self, now: float) -> Optional[float]:
        return min((i.ready_t for i in self.instances if i.ready_t > now),
                   default=None)

    def ready_free_slots(self, now: float) -> int:
        """Immediately usable warm capacity (the router's warm signal)."""
        return sum(i.free_slots() for i in self.instances
                   if i.ready_t <= now)

    def inflight(self) -> int:
        return sum(i.busy for i in self.instances)

    def idle_ready(self, now: float) -> Optional[Instance]:
        """An idle warm instance, if any — the reap candidate."""
        for inst in self.instances:
            if inst.busy == 0 and inst.ready_t <= now:
                return inst
        return None


class FnQueues:
    """Per-function FIFO queues with a worker-global arrival order.

    Each pushed request is stamped with a monotonically increasing
    ``_wseq`` so a dispatch scan can merge several functions' queues in
    exactly the order a single flat queue would have produced. Queue
    timeouts live in a deadline heap: expired requests are surfaced in
    O(expired log n) instead of rescanning the backlog, and are marked
    dead in place (``_queued = False``) so deque entries are dropped
    lazily when a scan next reaches them.
    """

    __slots__ = ("_q", "_live", "_live_total", "_deadlines", "_seq")

    def __init__(self):
        self._q: Dict[str, deque] = {}
        self._live: Dict[str, int] = {}
        self._live_total = 0
        self._deadlines: list = []     # (deadline, wseq, timeout_s, req)
        self._seq = itertools.count()

    # ------------------------------------------------------------ mutate
    def push(self, req, timeout_s: float) -> None:
        req._wseq = next(self._seq)
        req._queued = True
        self._q.setdefault(req.fn, deque()).append(req)
        self._live[req.fn] = self._live.get(req.fn, 0) + 1
        self._live_total += 1
        heapq.heappush(self._deadlines,
                       (req.arrival_t + timeout_s, req._wseq, timeout_s, req))

    def has_expired(self, now: float) -> bool:
        """O(1) peek so the dispatch hot path can skip the flush."""
        return bool(self._deadlines) and self._deadlines[0][0] <= now

    def pop_expired(self, now: float) -> list:
        """Requests past their queue timeout, in arrival order.

        Mirrors the flat scan's check (``now - arrival_t > timeout_s``,
        strict) exactly; entries whose heap key rounds earlier than the
        exact check are pushed back rather than mis-expired.
        """
        out, putback = [], []
        while self._deadlines and self._deadlines[0][0] <= now:
            entry = heapq.heappop(self._deadlines)
            _, _, timeout_s, req = entry
            if not req._queued:
                continue                       # served/failed/drained already
            if now - req.arrival_t > timeout_s:
                req._queued = False
                self._live[req.fn] -= 1
                self._live_total -= 1
                out.append(req)
            else:
                putback.append(entry)
        for entry in putback:
            heapq.heappush(self._deadlines, entry)
        out.sort(key=lambda r: r._wseq)
        return out

    def drain_all(self) -> list:
        """Remove and return every live request, in arrival order
        (worker failure and branch removal both re-disposition the whole
        queue)."""
        out = [r for q in self._q.values() for r in q if r._queued]
        out.sort(key=lambda r: r._wseq)
        for r in out:
            r._queued = False
        self._q.clear()
        self._live.clear()
        self._live_total = 0
        self._deadlines.clear()
        return out

    # ------------------------------------------------------- scan support
    def scan_head(self, fn: str):
        """Live head of one function's queue (drops dead entries)."""
        q = self._q.get(fn)
        if q is None:
            return None
        while q and not q[0]._queued:
            q.popleft()
        return q[0] if q else None

    def pop_head(self, fn: str) -> None:
        """Detach the current head for processing; pair with
        ``mark_served`` (leaves the queue) or ``restore`` (kept)."""
        self._q[fn].popleft()

    def mark_served(self, req) -> None:
        req._queued = False
        self._live[req.fn] -= 1
        self._live_total -= 1

    def restore(self, fn: str, kept: list) -> None:
        """Put back, in order, the processed-but-kept prefix."""
        if kept:
            self._q[fn].extendleft(reversed(kept))

    # ------------------------------------------------------------- reads
    def __len__(self) -> int:
        return self._live_total

    def depth(self, fn: str) -> int:
        return self._live.get(fn, 0)

    def depths(self) -> Dict[str, int]:
        return {fn: n for fn, n in self._live.items() if n}

    def active_fns(self) -> List[str]:
        return [fn for fn, n in self._live.items() if n]

    def __iter__(self) -> Iterator:
        """Live requests in arrival order (non-destructive)."""
        live = [r for q in self._q.values() for r in q if r._queued]
        live.sort(key=lambda r: r._wseq)
        return iter(live)
