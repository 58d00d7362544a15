"""Fleet-slot partition rule of the sharded fleet engine.

The JAX package keeps this rule in its ``dist/sharding.py`` beside the
named-axis parameter sharding of its LM stack.  Only the fleet-slot part is
on the fleet path, so that is all this module holds; it keeps the same
module name so a reader finds the counterpart.
"""
from __future__ import annotations

import numpy as np


def slot_shard(slot_id: int, n_shards: int) -> int:
    """Shard owning one fleet slot: cyclic ``slot % n_shards``.

    The single source of the fleet-engine partition rule.  Cyclic (rather
    than contiguous-block) assignment keeps shards balanced as recovery
    re-admissions append new slots at the high end, and needs no
    divisibility negotiation — any fleet size lands within one slot of
    perfectly even.
    """
    return int(slot_id) % int(n_shards)


def slot_partition(n_slots: int, n_shards: int) -> np.ndarray:
    """Vectorized ``slot -> shard`` assignment for a whole admission wave.

    Row ``i`` is ``slot_shard(i, n_shards)``; the sharded fleet engine uses
    it to split event batches across per-shard frontiers.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return np.arange(int(n_slots), dtype=np.int64) % int(n_shards)
