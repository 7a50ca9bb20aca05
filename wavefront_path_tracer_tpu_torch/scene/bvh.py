"""Binned-SAH BVH builder (host-side preprocessing).

The port's own copy of ``wavefront_path_tracer_tpu/scene/bvh.py`` (only
the imports differ; ``tests/test_torch_bvh.py`` holds the tables and the
permutation byte-identical).  It re-expresses the reference's CPU builder
(``wavefront_common/src/bvh.rs``) with numpy-vectorized binning:

* binned SAH over the 3 axes (reference bvh.rs:73-139) with
  surface-area x primitive-count cost (bvh.rs:51-56);
* in-place primitive reordering during subdivision (bvh.rs:175-185) —
  ``build_bvh`` returns the permuted scene exactly like
  ``build_bvh_tree(&mut spheres)``;
* root at node 0, a dummy node at index 1 so children always sit in
  adjacent pairs (bvh.rs:160-162), ``left_first`` doubling as
  first-primitive (leaf) or left-child (internal) index.

Differences (deliberate):

* BINS defaults to 64, not the reference's 4096 — past ~64 bins SAH
  quality is flat and the reference's choice only burns build time;
* leaves are capped at ``max_leaf_size`` primitives (median split when
  SAH declines to split) so the lockstep traversal
  (``ops/bvh_traverse.py``) tests leaf primitives with a fixed-width
  masked step.  The reference's leaf-if-no-gain rule can yield unbounded
  leaves.

A C++ drop-in of this builder (same flat-array output) lives in
``native/``; see ``build_bvh(..., backend="native")``.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import numpy as np

from wavefront_path_tracer_tpu_torch.scene.scene import Scene

# Leaf-size cap shared with the traversal's fixed-width leaf unroll
# (ops/bvh_traverse.py): both sides must agree or hits are skipped.
MAX_LEAF_SIZE = 4


class FlatBVH(NamedTuple):
    aabb_min: np.ndarray     # (K, 3) f32
    aabb_max: np.ndarray     # (K, 3) f32
    left_first: np.ndarray   # (K,) i32: leaf -> first prim; internal -> left child
    prim_count: np.ndarray   # (K,) i32: 0 for internal nodes

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]


def _node_area(lo: np.ndarray, hi: np.ndarray) -> float:
    e = hi - lo
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _best_split(centers, lo_all, hi_all, node_lo, node_hi, bins: int):
    """Vectorized binned-SAH sweep; returns (cost, axis, plane) or None."""
    n = centers.shape[0]
    best = None
    extent = node_hi - node_lo
    for axis in range(3):
        if extent[axis] < 1e-5:
            continue
        scale = bins / extent[axis]
        idx = np.minimum(
            (np.maximum(centers[:, axis] - node_lo[axis], 0.0) * scale).astype(np.int64),
            bins - 1,
        )
        counts = np.bincount(idx, minlength=bins)
        bin_lo = np.full((bins, 3), np.inf, np.float32)
        bin_hi = np.full((bins, 3), -np.inf, np.float32)
        np.minimum.at(bin_lo, idx, lo_all)
        np.maximum.at(bin_hi, idx, hi_all)

        # Prefix (left) and suffix (right) accumulations over bins.
        left_cnt = np.cumsum(counts)[:-1]
        right_cnt = np.cumsum(counts[::-1])[::-1][1:]
        left_lo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
        left_hi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
        right_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
        right_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]

        def areas(lo, hi, cnt):
            e = np.where(cnt[:, None] > 0, hi - lo, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        cost = left_cnt * areas(left_lo, left_hi, left_cnt) + right_cnt * areas(
            right_lo, right_hi, right_cnt
        )
        k = int(np.argmin(cost))
        plane = node_lo[axis] + extent[axis] * (k + 1) / bins
        if best is None or cost[k] < best[0]:
            best = (float(cost[k]), axis, float(plane))
    return best


def build_flat_bvh_aabb(
    lo_all: np.ndarray,
    hi_all: np.ndarray,
    centers: np.ndarray | None = None,
    bins: int = 64,
    max_leaf_size: int = MAX_LEAF_SIZE,
):
    """Build over per-primitive AABBs (any primitive type — spheres,
    triangles, instances); returns (FlatBVH, permutation).

    ``centers`` are the binning keys (default: box centroids; sphere
    callers pass true centers, identical for spheres).
    ``permutation[i]`` is the original index of the i-th primitive in
    BVH order; apply it to all per-primitive tables.
    """
    lo_all = np.asarray(lo_all, np.float32).copy()
    hi_all = np.asarray(hi_all, np.float32).copy()
    n = lo_all.shape[0]
    if centers is None:
        centers = (lo_all + hi_all) * 0.5
    centers = np.asarray(centers, np.float32).copy()
    perm = np.arange(n)

    aabb_min, aabb_max, left_first, prim_count = [], [], [], []

    def push(lo, hi, lf, pc) -> int:
        aabb_min.append(lo)
        aabb_max.append(hi)
        left_first.append(lf)
        prim_count.append(pc)
        return len(aabb_min) - 1

    root_lo = lo_all.min(axis=0)
    root_hi = hi_all.max(axis=0)
    push(root_lo, root_hi, 0, n)
    push(np.zeros(3, np.float32), np.zeros(3, np.float32), 0, 0)  # dummy (bvh.rs:161)

    # Iterative subdivision (the reference recurses, bvh.rs:166-210).
    stack = [0]
    while stack:
        node = stack.pop()
        first, count = left_first[node], prim_count[node]
        if count <= 1:
            continue
        sl = slice(first, first + count)
        c, lo, hi = centers[sl], lo_all[sl], hi_all[sl]
        node_lo, node_hi = aabb_min[node], aabb_max[node]

        split = _best_split(c, lo, hi, node_lo, node_hi, bins)
        leaf_cost = count * _node_area(node_lo, node_hi)
        use_sah = split is not None and split[0] < leaf_cost
        if not use_sah and count <= max_leaf_size:
            continue

        if use_sah:
            _, axis, plane = split
            mask = c[:, axis] < plane
            if not mask.any() or mask.all():
                use_sah = False
        if not use_sah:
            # Median split on the widest axis (leaf-size cap fallback).
            axis = int(np.argmax(node_hi - node_lo))
            order = np.argsort(c[:, axis], kind="stable")
            mask = np.zeros(count, bool)
            mask[order[: count // 2]] = True

        # Partition (stable: lefts keep order, then rights).
        order = np.concatenate([np.flatnonzero(mask), np.flatnonzero(~mask)])
        centers[sl] = c[order]
        lo_all[sl] = lo[order]
        hi_all[sl] = hi[order]
        perm[sl] = perm[sl][order]

        n_left = int(mask.sum())
        lo_l, hi_l = lo_all[first : first + n_left], hi_all[first : first + n_left]
        lo_r, hi_r = lo_all[first + n_left : first + count], hi_all[first + n_left : first + count]
        left = push(lo_l.min(axis=0), hi_l.max(axis=0), first, n_left)
        push(lo_r.min(axis=0), hi_r.max(axis=0), first + n_left, count - n_left)
        left_first[node] = left
        prim_count[node] = 0
        stack.extend([left, left + 1])

    bvh = FlatBVH(
        aabb_min=np.stack(aabb_min).astype(np.float32),
        aabb_max=np.stack(aabb_max).astype(np.float32),
        left_first=np.array(left_first, np.int32),
        prim_count=np.array(prim_count, np.int32),
    )
    return bvh, perm


def build_flat_bvh(
    centers: np.ndarray,
    radii: np.ndarray,
    bins: int = 64,
    max_leaf_size: int = MAX_LEAF_SIZE,
):
    """Sphere wrapper over :func:`build_flat_bvh_aabb`."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    return build_flat_bvh_aabb(
        centers - radii[:, None], centers + radii[:, None], centers,
        bins=bins, max_leaf_size=max_leaf_size,
    )


def build_bvh(scene: Scene, bins: int = 64,
              max_leaf_size: int = MAX_LEAF_SIZE,
              backend: str = "auto"):
    """Build a BVH for a scene; returns (FlatBVH, reordered scene)."""
    if backend in ("native", "auto"):
        try:
            from wavefront_path_tracer_tpu_torch.native import bvh_native

            bvh, perm = bvh_native.build_flat_bvh(
                scene.centers, scene.radii, bins=bins, max_leaf_size=max_leaf_size
            )
            return bvh, scene.permuted(perm)
        except (ImportError, OSError, subprocess.CalledProcessError):
            # auto falls back to the numpy builder on any toolchain issue
            if backend == "native":
                raise
    bvh, perm = build_flat_bvh(scene.centers, scene.radii, bins, max_leaf_size)
    return bvh, scene.permuted(perm)


def bvh_depth(bvh: FlatBVH) -> int:
    """Max depth (root = 1); used to size traversal stacks."""
    depth = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if bvh.prim_count[node] == 0:  # internal (children are adjacent)
            stack.append((int(bvh.left_first[node]), d + 1))
            stack.append((int(bvh.left_first[node]) + 1, d + 1))
    return depth
