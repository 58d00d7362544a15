"""Event heap of the vectorized fleet engine, deterministic tie-breaking.

The engine schedules every session interaction (probe, bulk chunk,
re-probe-gate consultation, finish bookkeeping) as an event keyed by
``(time_s, slot_id)``.  Keys are compared lexicographically, so two events at
the same simulated instant always pop in slot order — the same tie rule as
the threaded scheduler's ``_FleetClock`` (min clock, ties by tenant id),
which is what makes the two engines interleave identically.

Scalar pushes and pops ride CPython's C-implemented ``heapq`` over ``(time,
slot)`` tuples — profiling the engine at N=2e4 showed a hand-rolled
numpy-scalar sift spending half the run in element access, while ``heapq``'s
tuple comparisons run at C speed.  Batch insertion stays vectorized: the
batch is ``np.lexsort``-ed in one shot and either becomes the heap directly
(empty heap: a sorted array satisfies the heap invariant), is appended and
re-heapified in one O(n+m) C pass (comparable sizes), or sift-pushed when it
is tiny relative to the resident heap — never N Python-level sift-ups over
an unsorted batch.
"""

from __future__ import annotations

import heapq

import numpy as np


class VectorEventHeap:
    """Min-heap over ``(time_s, slot_id)`` keys.

    Pops are globally ordered: strictly by time, and by ascending slot id
    among equal times.  Insertion order never influences pop order, which
    ``tests/test_engine_heap.py`` locks in.
    """

    def __init__(self, capacity: int = 1024):
        # capacity is advisory (list storage grows itself); accepted so
        # callers can express expected fleet size without a special case.
        del capacity
        self._heap: list[tuple[float, int]] = []

    def __len__(self) -> int:
        return len(self._heap)

    # ------------------------------------------------------------------ #
    def push(self, time_s: float, slot_id: int) -> None:
        heapq.heappush(self._heap, (float(time_s), int(slot_id)))

    def push_batch(self, times_s, slot_ids) -> None:
        """Insert many events at once.

        The batch is always lexsorted in one vectorized pass.  On an empty
        heap the sorted batch *is* the heap (a sorted array satisfies the
        heap invariant) — how the engine seeds an admission wave.  On a
        non-empty heap the sorted batch is appended and the whole list
        re-heapified: one O(n+m) C-level pass instead of m sift-ups, unless
        the batch is tiny relative to the resident heap, where m·log(n)
        sifts of presorted events are cheaper than reheapifying n+m.
        """
        times_s = np.asarray(times_s, np.float64)
        slot_ids = np.asarray(slot_ids, np.int64)
        if times_s.shape != slot_ids.shape or times_s.ndim != 1:
            raise ValueError("times_s and slot_ids must be equal-length 1-D")
        if times_s.shape[0] == 0:
            return
        order = np.lexsort((slot_ids, times_s))
        batch = list(zip(times_s[order].tolist(), slot_ids[order].tolist()))
        if not self._heap:
            self._heap = batch
        elif len(batch) * 8 < len(self._heap):
            for ev in batch:
                heapq.heappush(self._heap, ev)
        else:
            self._heap.extend(batch)
            heapq.heapify(self._heap)

    def peek(self) -> tuple[float, int]:
        if not self._heap:
            raise IndexError("peek from an empty VectorEventHeap")
        return self._heap[0]

    def pop(self) -> tuple[float, int]:
        if not self._heap:
            raise IndexError("pop from an empty VectorEventHeap")
        return heapq.heappop(self._heap)
