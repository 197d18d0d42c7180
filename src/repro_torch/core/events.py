"""The event engine: the simulator's hot loop, behind a narrow interface.

The port's own copy of the JAX package's ``core/events.py``, which holds no
JAX: the port imports nothing of that package.

The testbed's credibility rests on request volumes an order of magnitude
beyond toy probes (SeBS; Barcelona-Pons & Garcia-Lopez both push past
10M invocations), and at that scale the *event queue* — not the worker
model — becomes the simulator's bottleneck: a single binary heap holding
millions of pre-loaded arrivals pays O(log n) pointer-chasing tuple
comparisons on every push and pop, over a working set far larger than
cache. This module makes the queue a pluggable architectural axis, like
LB policies, placers, and autoscalers:

- :class:`EventEngine` — seq-stamping, pending-event accounting, and the
  ``pop(until=...)`` peek-don't-requeue contract the simulator's
  ``run(until)`` resume path relies on.
- ``single_heap`` (:class:`SingleHeapQueue`) — one ``heapq``; byte
  identical to the pre-split simulator (the golden-digest contract).
- ``sharded`` (:class:`ShardedQueue`) — a calendar queue: time-bucketed
  per-shard heaps drained in bucket order and merged by ``(t, seq)``.
  Pre-loaded arrivals are staged and cut into per-bucket *sorted runs*
  on first pop, so steady-state pops cost O(1)-ish comparisons against
  a cache-hot bucket instead of O(log 10M) against the whole future.

Determinism contract: every backend yields events in exactly ascending
``(t, seq)`` order — the total order a single heap produces — so the
same seed gives byte-identical results on *any* backend (enforced by
``tests/test_events.py`` for the JAX package's copy and by
``tests/test_torch_simulator.py`` across both packages).

Events are plain tuples ``(t, seq, kind, payload)``. ``seq`` is stamped
by the engine from one monotone counter, which is what makes ``(t,
seq)`` a total order: payloads are never compared.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_left, bisect_right
from itertools import repeat as _repeat
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_INF = float("inf")

Event = Tuple[float, int, str, object]

EVENT_BACKENDS: Dict[str, Callable[..., "EventQueue"]] = {}


def register_event_backend(cls):
    """Class decorator: add an EventQueue backend to the registry."""
    EVENT_BACKENDS[cls.kind] = cls
    return cls


def get_event_backend(name: str, **params) -> "EventQueue":
    """Construct a registered event-queue backend by name."""
    if name not in EVENT_BACKENDS:
        raise KeyError(f"event backend {name!r} not registered "
                       f"(have: {sorted(EVENT_BACKENDS)})")
    return EVENT_BACKENDS[name](**params)


def list_event_backends() -> List[str]:
    return sorted(EVENT_BACKENDS)


class EventQueue:
    """Backend interface: a priority queue over ``(t, seq, ...)`` tuples.

    ``push`` never compares payloads (``seq`` is unique), ``pop``/``peek``
    surface the globally smallest ``(t, seq)`` entry. ``peek`` must not
    remove — the engine's ``pop(until)`` peeks first so an event beyond
    the horizon is simply *left in place* (no pop-and-requeue churn).
    """

    kind = "base"

    def push(self, entry: Event) -> None:
        raise NotImplementedError

    def pop(self) -> Event:
        raise NotImplementedError

    def peek(self) -> Optional[Event]:
        raise NotImplementedError

    def pop_until(self, until: Optional[float]) -> Optional[Event]:
        """Pop the head iff it lies at or before ``until`` (None = no
        horizon); otherwise leave the queue untouched and return None.
        One traversal on backends that override it — the engine's hot
        path."""
        entry = self.peek()
        if entry is None or (until is not None and entry[0] > until):
            return None
        return self.pop()

    def push_bulk_run(self, times, seq0: int, kind: str,
                      payloads=None) -> None:
        """Bulk-push one same-kind run: entry ``i`` is ``(times[i],
        seq0 + i, kind, payloads[i])`` (``None`` payloads throughout
        when ``payloads`` is None). Must be order-identical to pushing
        the entries one by one — this reference implementation does
        exactly that; backends override with batch paths."""
        if hasattr(times, "tolist"):           # numpy -> Python floats
            times = times.tolist()
        if payloads is None:
            seq = seq0
            for t in times:
                self.push((t, seq, kind, None))
                seq += 1
        else:
            for seq, (t, p) in enumerate(zip(times, payloads), start=seq0):
                self.push((t, seq, kind, p))

    def pop_batch(self, max_n: int,
                  until: Optional[float] = None) -> List[Event]:
        """Pop up to ``max_n`` events in ``(t, seq)`` order, stopping
        early only at the ``until`` horizon or an empty queue. Greedy
        by contract — every backend returns exactly
        ``min(max_n, available-within-horizon)`` entries, so batch
        *partitions* (not just the concatenated stream) are
        backend-identical."""
        out: List[Event] = []
        while len(out) < max_n:
            entry = self.pop_until(until)
            if entry is None:
                break
            out.append(entry)
        return out

    def __len__(self) -> int:
        raise NotImplementedError


@register_event_backend
class SingleHeapQueue(EventQueue):
    """One ``heapq`` over all pending events — the reference backend.

    Exactly the pre-split simulator's queue: same tuples, same heap, same
    pop order, so every golden digest recorded before the event-engine
    refactor still matches byte for byte.
    """

    kind = "single_heap"

    __slots__ = ("_heap",)

    def __init__(self):
        self._heap: list = []

    def push(self, entry: Event) -> None:
        heapq.heappush(self._heap, entry)

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def peek(self) -> Optional[Event]:
        return self._heap[0] if self._heap else None

    def pop_until(self, until: Optional[float]) -> Optional[Event]:
        heap = self._heap
        if not heap or (until is not None and heap[0][0] > until):
            return None
        return heapq.heappop(heap)

    def push_bulk_run(self, times, seq0: int, kind: str,
                      payloads=None) -> None:
        # heapify-based reference: an empty heap takes the whole run in
        # O(n); otherwise per-entry sift. Either way the heap's pop
        # order is the (t, seq) total order — identical to per-push.
        if hasattr(times, "tolist"):
            times = times.tolist()
        entries = zip(times, range(seq0, seq0 + len(times)), _repeat(kind),
                      payloads if payloads is not None else _repeat(None))
        heap = self._heap
        if heap:
            push = heapq.heappush
            for e in entries:
                push(heap, e)
        else:
            heap.extend(entries)
            heapq.heapify(heap)

    def pop_batch(self, max_n: int,
                  until: Optional[float] = None) -> List[Event]:
        heap = self._heap
        out: List[Event] = []
        pop = heapq.heappop
        if until is None:
            for _ in range(min(max_n, len(heap))):
                out.append(pop(heap))
        else:
            while len(out) < max_n and heap and heap[0][0] <= until:
                out.append(pop(heap))
        return out

    def __len__(self) -> int:
        return len(self._heap)


@register_event_backend
class ShardedQueue(EventQueue):
    """Calendar queue: per-time-bucket shards merged by ``(t, seq)``.

    Two regimes, matching how the simulator actually produces events:

    - **Staged bulk load.** Everything pushed before the first pop (the
      ``sim.load(workload)`` pattern: millions of arrivals, already in
      nearly ascending time order) accumulates in a flat list. The first
      pop *seals* the stage: one adaptive ``sort`` (Timsort is ~O(n) on
      the nearly-sorted stream), a bucket width chosen so each shard
      holds ~``target_per_bucket`` events, and a single pass cutting the
      run into per-bucket sorted lists consumed by index — no heap
      discipline needed for the entire pre-loaded future.
    - **Dynamic events.** Pushes after sealing (finish/poke/enqueue at
      near-``now`` times) go into the destination bucket's *overflow
      heap*. Those heaps stay small — operational events cluster around
      the present — so pushes and pops are a handful of comparisons
      against cache-hot shards instead of O(log total-pending).

    ``pop`` merges the current bucket's sorted run with its overflow
    heap by ``(t, seq)`` and advances through buckets in index order;
    since ``floor(t / width)`` is monotone in ``t``, the drain order is
    exactly ascending ``(t, seq)`` — identical to the single heap. An
    entry pushed behind the bucket currently draining (only possible for
    ``t`` at the bucket boundary, or a caller scheduling in the past,
    which the simulator never does) is clamped into the current bucket,
    where ``(t, seq)`` ordering still places it correctly relative to
    everything not yet popped.

    When the queue fully drains it returns to staging mode, so a
    drain-then-bulk-load cycle (``run()``, then another ``load()``)
    re-tunes the bucket width to the new horizon.
    """

    kind = "sharded"

    __slots__ = ("bucket_s", "target_per_bucket", "_staged", "_bulk",
                 "_width", "_runs", "_heaps", "_active", "_cur",
                 "_cur_end", "_cur_run", "_cur_pos", "_cur_heap", "_len")

    def __init__(self, bucket_s: Optional[float] = None,
                 target_per_bucket: int = 4096):
        self.bucket_s = bucket_s           # None => size from staged span
        self.target_per_bucket = target_per_bucket
        self._staged: Optional[list] = []  # None once sealed
        self._bulk: list = []              # staged columnar runs
        self._width = bucket_s or 0.01
        self._runs: Dict[int, list] = {}   # future idx -> sorted staged slice
        self._heaps: Dict[int, list] = {}  # future idx -> overflow heap
        self._active: list = []            # heap of not-yet-drained idxs
        # the bucket currently draining, held in slots so the hot pop
        # path touches no dicts at all — and pushes into it take a
        # single float compare (t < _cur_end), no division, no dicts
        self._cur: Optional[int] = None
        self._cur_end = -1e300             # (cur + 1) * width
        self._cur_run: Optional[list] = None
        self._cur_pos = 0
        self._cur_heap: Optional[list] = None
        self._len = 0

    # ------------------------------------------------------------ internals
    def _seal(self) -> None:
        """Cut the staged bulk load into per-bucket sorted runs.

        Scalar staged entries keep the original adaptive-sort path
        byte-for-byte. Columnar runs staged via ``push_bulk_run`` take
        the vectorized path: entry tuples are built exactly once, the
        global order comes from one ``np.lexsort`` over ``(t, seq)`` —
        or no sort at all when run concatenation is already globally
        nondecreasing (the multi-stream ascending-ingest common case;
        concat order is seq order because the engine stamps runs
        monotonically) — and bucket cuts come from one vectorized
        index-change scan instead of a per-entry Python loop."""
        staged = self._staged
        bulk = self._bulk
        self._staged = None
        self._bulk = []
        ts = None                          # numpy times iff vector path
        if not bulk:
            if not staged:
                return
            staged.sort()
            entries = staged
        else:
            times = (bulk[0][0] if len(bulk) == 1 else
                     np.concatenate([r[0] for r in bulk]))
            kinds = {r[2] for r in bulk}
            if (not staged and len(kinds) == 1
                    and all(r[3] is None for r in bulk)):
                # column fast path (the pre-loaded-arrivals shape: one
                # kind, no payloads): sort the columns, then build the
                # tuples already in order — no per-entry gather
                seqs = (np.arange(bulk[0][1], bulk[0][1] + len(times))
                        if len(bulk) == 1 else
                        np.concatenate([np.arange(s0, s0 + len(t_arr))
                                        for t_arr, s0, _k, _p in bulk]))
                if not bool(np.all(times[:-1] <= times[1:])):
                    order = np.lexsort((seqs, times))
                    times, seqs = times[order], seqs[order]
                ts = times
                entries = list(zip(times.tolist(), seqs.tolist(),
                                   _repeat(next(iter(kinds))),
                                   _repeat(None)))
            else:
                chunks = [zip(t_arr.tolist(), range(s0, s0 + len(t_arr)),
                              _repeat(kind),
                              pl if pl is not None else _repeat(None))
                          for t_arr, s0, kind, pl in bulk]
                entries = (list(chunks[0]) if len(chunks) == 1 else
                           list(itertools.chain.from_iterable(chunks)))
                if staged:
                    # scalar pushes interleaved with bulk runs while
                    # staging (e.g. an autoscale tick armed before
                    # load_bulk): rare and small — merge through the
                    # adaptive sort
                    entries.extend(staged)
                    entries.sort()
                elif bool(np.all(times[:-1] <= times[1:])):
                    ts = times
                else:
                    seqs = np.concatenate(
                        [np.arange(s0, s0 + len(t_arr))
                         for t_arr, s0, _k, _p in bulk])
                    order = np.lexsort((seqs, times))
                    entries = [entries[i] for i in order.tolist()]
                    ts = times[order]
        if self.bucket_s is None:
            span = entries[-1][0] - entries[0][0]
            buckets = max(1, len(entries) // self.target_per_bucket)
            self._width = max(span / buckets, 1e-9)
        width = self._width
        runs, active = self._runs, self._active
        if ts is not None:
            # C-cast truncation matches int() for every float, so both
            # paths agree on bucket indices
            idx = (ts / width).astype(np.int64)
            starts = [0, *(np.flatnonzero(idx[1:] != idx[:-1]) + 1).tolist()]
            bounds = [*starts, len(entries)]
            for lo, hi in zip(bounds, bounds[1:]):
                runs[int(idx[lo])] = entries[lo:hi]
                active.append(int(idx[lo]))
        else:
            lo = 0
            idx = int(entries[0][0] / width)
            for i, entry in enumerate(entries):
                j = int(entry[0] / width)
                if j != idx:
                    runs[idx] = entries[lo:i]
                    active.append(idx)
                    lo, idx = i, j
            runs[idx] = entries[lo:]
            active.append(idx)
        heapq.heapify(active)

    def _head(self):
        """(head entry, came-from-overflow-heap) for the next live bucket;
        advances the current-bucket slots past exhausted buckets. The
        caller has already checked ``_len > 0``."""
        if self._staged is not None:
            self._seal()
        while True:
            head = None
            run = self._cur_run
            if run is not None:
                p = self._cur_pos
                if p < len(run):
                    head = run[p]
                else:
                    self._cur_run = None
            heap = self._cur_heap
            if heap:
                h0 = heap[0]
                if head is None or h0 < head:
                    return h0, True
                return head, False
            if head is not None:
                return head, False
            # current bucket exhausted: load the next active one
            cur = self._cur = heapq.heappop(self._active)
            self._cur_end = (cur + 1) * self._width
            self._cur_run = self._runs.pop(cur, None)
            self._cur_pos = 0
            self._cur_heap = self._heaps.pop(cur, None)

    def _restage(self) -> None:
        """Fully drained: return to staging so the next bulk load
        re-tunes the bucket width to its own horizon."""
        self._staged = []
        self._bulk = []
        self._runs.clear()
        self._heaps.clear()
        self._active.clear()
        self._cur = None
        self._cur_end = -1e300
        self._cur_run = None
        self._cur_pos = 0
        self._cur_heap = None

    # ------------------------------------------------------------- interface
    def push(self, entry: Event) -> None:
        self._len += 1
        staged = self._staged
        if staged is not None:
            staged.append(entry)
            return
        if entry[0] < self._cur_end:
            # the draining bucket — the overwhelmingly common case for
            # operational (near-now) events. Past-t pushes clamp here
            # too: ``(t, seq)`` ordering still places them correctly
            # among the not-yet-popped entries.
            heap = self._cur_heap
            if heap is None:
                self._cur_heap = [entry]
            else:
                heapq.heappush(heap, entry)
            return
        idx = int(entry[0] / self._width)
        cur = self._cur
        if cur is not None and idx <= cur:
            # float-boundary guard: t >= _cur_end (a rounded product) can
            # still floor-divide into the draining bucket's index; never
            # re-activate a bucket at or behind the drain
            idx = cur + 1
        heaps = self._heaps
        heap = heaps.get(idx)
        if heap is None:
            heaps[idx] = [entry]
            if idx not in self._runs:
                heapq.heappush(self._active, idx)
            return
        heapq.heappush(heap, entry)

    def push_bulk_run(self, times, seq0: int, kind: str,
                      payloads=None) -> None:
        n = len(times)
        if n == 0:
            return
        self._len += n
        if self._staged is not None:
            # staging: keep the run columnar — _seal merges every run
            # (plus any scalar staged entries) without per-entry heap
            # discipline or double tuple builds
            self._bulk.append(
                (np.ascontiguousarray(times, dtype=np.float64), seq0,
                 kind, None if payloads is None else list(payloads)))
            return
        # sealed: near-now follow-on runs (the batched-drain pattern).
        # Small runs route per entry with the draining-bucket fast path
        # inlined; big runs take the vectorized merge below, which keeps
        # follow-ons on the sorted-run slice path instead of feeding the
        # overflow heaps one sift at a time
        if n < 64:
            if hasattr(times, "tolist"):
                times = times.tolist()
            entries = zip(times, range(seq0, seq0 + n), _repeat(kind),
                          payloads if payloads is not None else _repeat(None))
            cur_end = self._cur_end
            cur_heap = self._cur_heap
            hpush = heapq.heappush
            for e in entries:
                if e[0] < cur_end:
                    if cur_heap is None:
                        cur_heap = self._cur_heap = [e]
                    else:
                        hpush(cur_heap, e)
                else:
                    self._len -= 1         # push() re-counts the entry
                    self.push(e)
            return
        self._push_bulk_sealed(times, seq0, kind, payloads)

    def _push_bulk_sealed(self, times, seq0: int, kind: str,
                          payloads) -> None:
        """Vectorized sealed-mode bulk insert: split the run into the
        draining bucket's portion and per-future-bucket pieces (one
        ``astype`` + group scan), then *merge each piece into the
        bucket's sorted run* — one adaptive Timsort per piece, folding
        any overflow heap in along the way — so the subsequent drain
        slices run prefixes wholesale instead of paying a per-entry
        ``heappop`` against a deep overflow heap. Order contract is
        untouched: every bucket still holds ascending ``(t, seq)``."""
        if isinstance(times, np.ndarray):
            ts = np.ascontiguousarray(times, dtype=np.float64)
            tl = ts.tolist()
        else:                              # list in: no numpy round trip
            tl = times if isinstance(times, list) else list(times)
            ts = np.asarray(tl, dtype=np.float64)
        entries = list(zip(tl, range(seq0, seq0 + len(tl)),
                           _repeat(kind),
                           payloads if payloads is not None
                           else _repeat(None)))
        cur = self._cur
        mask_cur = ts < self._cur_end
        k_cur = int(np.count_nonzero(mask_cur))
        if k_cur == len(entries):
            piece, fut_entries, fts = entries, [], None
        elif k_cur == 0:
            piece, fut_entries, fts = [], entries, ts
        elif bool(mask_cur[:k_cur].all()):   # prefix split (sorted run)
            piece, fut_entries = entries[:k_cur], entries[k_cur:]
            fts = ts[k_cur:]
        else:
            sel = np.flatnonzero(mask_cur).tolist()
            piece = [entries[i] for i in sel]
            fut_entries = [e for i, e in enumerate(entries)
                           if not mask_cur[i]]
            fts = ts[~mask_cur]
        if piece:
            run = self._cur_run
            if run is not None and self._cur_pos < len(run):
                piece += run[self._cur_pos:]
            heap = self._cur_heap
            if heap:
                piece += heap
                self._cur_heap = None
            piece.sort()
            self._cur_run = piece
            self._cur_pos = 0
        if not fut_entries:
            return
        b = (fts / self._width).astype(np.int64)
        if cur is not None:
            # float-boundary guard (see push()): never re-activate a
            # bucket at or behind the drain
            np.maximum(b, cur + 1, out=b)
        if bool(np.any(b[:-1] > b[1:])):
            order = np.argsort(b, kind="stable")
            fut_entries = [fut_entries[i] for i in order.tolist()]
            b = b[order]
        starts = [0, *(np.flatnonzero(b[1:] != b[:-1]) + 1).tolist(),
                  len(fut_entries)]
        runs, heaps = self._runs, self._heaps
        for lo, hi in zip(starts, starts[1:]):
            bi = int(b[lo])
            piece = fut_entries[lo:hi]
            run = runs.get(bi)
            heap = heaps.pop(bi, None)
            fresh = run is None and heap is None
            if run is not None:
                piece += run
            if heap:
                piece += heap
            piece.sort()
            runs[bi] = piece
            if fresh:                      # else already in _active
                heapq.heappush(self._active, bi)

    def pop_batch(self, max_n: int,
                  until: Optional[float] = None) -> List[Event]:
        """Batched bucket drain: up to ``max_n`` events in exact
        ``(t, seq)`` order, slicing sorted-run
        *prefixes* wholesale — bounded by the overflow-heap head and the
        ``until`` horizon via bisect — instead of entry-at-a-time
        merges. Greedy like every backend (see the base class): batch
        partitions are backend-identical."""
        out: List[Event] = []
        if self._len == 0:
            return out
        if self._staged is not None:
            self._seal()
        take = min(max_n, self._len)
        while take > 0:
            run = self._cur_run
            p = self._cur_pos
            if run is not None and p >= len(run):
                run = self._cur_run = None
            heap = self._cur_heap
            if run is not None:
                hi = len(run)
                if heap:
                    # run entries strictly before the heap head pop in
                    # run order; (t, seq) never ties so left==right
                    hi = bisect_left(run, heap[0], p, hi)
                if until is not None:
                    # (until, inf) sorts after any (t<=until, seq, ...)
                    hi = bisect_right(run, (until, _INF), p, hi)
                if hi - p > take:
                    hi = p + take
                if hi > p:
                    out.extend(run[p:hi])
                    self._cur_pos = hi
                    self._len -= hi - p
                    take -= hi - p
                    continue
            if heap:
                h0 = heap[0]
                if (run is None or self._cur_pos >= len(run)
                        or h0 < run[self._cur_pos]):
                    if until is not None and h0[0] > until:
                        break
                    out.append(heapq.heappop(heap))
                    if not heap:
                        self._cur_heap = None
                    self._len -= 1
                    take -= 1
                    continue
                break                      # run head next, but > until
            if run is not None:
                break                      # only `until` blocks the run
            if not self._active:
                break
            cur = self._cur = heapq.heappop(self._active)
            self._cur_end = (cur + 1) * self._width
            self._cur_run = self._runs.pop(cur, None)
            self._cur_pos = 0
            self._cur_heap = self._heaps.pop(cur, None)
        if self._len == 0:
            self._restage()
        return out

    def _take(self, entry: Event, from_heap: bool) -> Event:
        self._len -= 1
        if from_heap:
            heap = self._cur_heap
            heapq.heappop(heap)
            if not heap:
                self._cur_heap = None
        else:
            self._cur_pos += 1
        if self._len == 0:
            self._restage()
        return entry

    def pop(self) -> Event:
        if self._len == 0:
            raise IndexError("pop from an empty ShardedQueue")
        entry, from_heap = self._head()
        return self._take(entry, from_heap)

    def pop_until(self, until: Optional[float]) -> Optional[Event]:
        if self._len == 0:
            return None
        entry, from_heap = self._head()
        if until is not None and entry[0] > until:
            return None
        return self._take(entry, from_heap)

    def peek(self) -> Optional[Event]:
        if self._len == 0:
            return None
        return self._head()[0]

    def __len__(self) -> int:
        return self._len


class EventEngine:
    """Seq-stamping event queue over a pluggable backend.

    The engine owns the one monotone ``seq`` counter (what makes ``(t,
    seq)`` a total order across backends) and the pending-event
    accounting the simulator's termination logic reads: kinds listed in
    ``background`` (the autoscaler's self-re-arming tick) are excluded
    from :attr:`pending_real`, so a control loop can ask "is there real
    work left?" without scanning the queue.

    ``pop(until=...)`` peeks before popping: an event beyond the horizon
    is *left in the queue* untouched — same ``(t, seq)``, no
    pop-and-requeue round trip — which is what makes a segmented
    ``run(until=...); run()`` byte-identical to one straight ``run()``
    (including ``events_processed``; pinned by
    ``tests/test_events.py``).
    """

    def __init__(self, backend="single_heap", *,
                 background: Tuple[str, ...] = (), **backend_kw):
        self.queue: EventQueue = (get_event_backend(backend, **backend_kw)
                                  if isinstance(backend, str) else backend)
        self.backend = self.queue.kind
        self.background = frozenset(background)
        self.pending_real = 0              # pending events minus background
        self._seq = 0

    def push(self, t: float, kind: str, payload) -> None:
        if kind not in self.background:
            self.pending_real += 1
        seq = self._seq
        self._seq = seq + 1
        self.queue.push((t, seq, kind, payload))

    def push_bulk(self, times, kind: str, payloads=None) -> int:
        """Bulk-push one same-kind run with contiguous seq stamps:
        entry ``i`` is ``(times[i], seq0 + i, kind, payloads[i])`` —
        byte-identical to pushing them one by one in run order, without
        the per-event call and tuple churn. ``times`` may be a numpy
        array or a list; returns the number pushed."""
        n = len(times)
        if n == 0:
            return 0
        seq0 = self._seq
        self._seq = seq0 + n
        if kind not in self.background:
            self.pending_real += n
        self.queue.push_bulk_run(times, seq0, kind, payloads)
        return n

    def pop(self, until: Optional[float] = None) -> Optional[Event]:
        """Next event in ``(t, seq)`` order, or None if the queue is
        empty or the next event lies beyond ``until`` (left in place)."""
        entry = self.queue.pop_until(until)
        if entry is None:
            return None
        if entry[2] not in self.background:
            self.pending_real -= 1
        return entry

    def pop_batch(self, max_n: int,
                  until: Optional[float] = None) -> List[Event]:
        """Up to ``max_n`` events in ``(t, seq)`` order — the batched
        drain for replay/probe loops whose handlers never schedule
        *before* the end of the batch they are consuming. NOT safe for
        ``Simulator.run()``: its handlers push near-now events (e.g.
        enqueue at ``t + hop_s``) that may sort before later entries of
        an already-popped batch."""
        batch = self.queue.pop_batch(max_n, until)
        if batch:
            bg = self.background
            if bg:
                self.pending_real -= sum(
                    1 for e in batch if e[2] not in bg)
            else:
                self.pending_real -= len(batch)
        return batch

    def peek_t(self) -> Optional[float]:
        entry = self.queue.peek()
        return entry[0] if entry is not None else None

    def __len__(self) -> int:
        return len(self.queue)
