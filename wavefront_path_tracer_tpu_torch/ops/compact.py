"""Deterministic stream compaction of the wavefront queues.

Port of ``wavefront_path_tracer_tpu/ops/compact.py``.  The reference
compacts its ray queues with atomic-counter appends, which makes the
queue order (and with it the shade stage's random draws) depend on
timing.  Here the queue is compacted by a stable sort of the liveness
key instead: survivors keep their relative order at the front of the
queue, so every run gives the same order, the JAX package's own.
"""

from __future__ import annotations

import torch


def compaction_order(keep: torch.Tensor):
    """(order, count): a stable permutation (int64) that puts the lanes
    where ``keep`` is true first, and the number of such lanes as a 0-d
    int64 tensor on ``keep``'s device."""
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    return order, keep.sum()


def compact(keep: torch.Tensor, *arrays):
    """Every array (along dim 0) reordered by ``compaction_order(keep)``;
    returns (count, *arrays).  Lanes at and past ``count`` hold the
    dropped entries in stable order: callers treat them as garbage."""
    order, count = compaction_order(keep)
    return (count, *[a[order] for a in arrays])
