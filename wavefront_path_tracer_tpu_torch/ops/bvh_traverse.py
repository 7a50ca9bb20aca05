"""BVH traversal over ray wavefronts, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/bvh_traverse.py``.  The reference
traverses per SIMT thread with a node-struct stack (``extend.wgsl:80-140``);
here the whole batch of rays steps through one masked traversal loop:

* per-lane state is (current node, stack pointer, index stack) held as
  tensors; node fetches are gathers into the flat BVH tables;
* near child first, the far child pushed, as in the reference
  (extend.wgsl:105-138), so nodes are culled in the same order;
* leaves hold at most ``max_leaf_size`` primitives (the builder's
  guarantee), all tested in one masked step of shape (lanes, leaf size);
  the first of the nearest wins, as in the reference's sequential test;
* a lane that is done changes no state in a step (every update is masked
  with ``~done``), so the loop reads the unfinished lanes back only every
  ``CHECK_EVERY`` steps: it ends when none is left, and otherwise goes on
  with the unfinished lanes alone (their results so far written back),
  as the megakernel goes on with its live paths.

Gathers clamp their indices to the table, as XLA's do: a step evaluates
the leaf test at ``left_first + k`` for internal nodes too, where the
index runs past the primitive tables, and masks the result afterwards.
The indices are never negative.  Slab and leaf tests use
``torch.minimum``/``maximum`` and ``amax``/``amin``, which propagate NaN
as ``jnp.minimum`` and ``jnp.max`` do: an axis-parallel ray that starts on
a box's face plane makes ``(lo - origin) / direction`` NaN, and the box is
then missed, as in the reference package.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops.intersect import T_FAR, T_MIN
from wavefront_path_tracer_tpu_torch.ops.triangle import triangle_t
from wavefront_path_tracer_tpu_torch.scene.bvh import FlatBVH, bvh_depth

STACK_DEPTH = 48
SENTINEL = -1
# Traversal steps between host reads of the unfinished lanes.
CHECK_EVERY = 8


def _take(table, idx):
    """``table[idx]`` with ``idx`` clamped to the table's rows."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _dot(a, b):
    """Dot product over the last dim (3), summed in (x + y) + z order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _slab_test(origin, inv_dir, lo, hi, nearest):
    """Slab AABB test (extend.wgsl:164-183): entry t, or T_FAR if missed.
    ``lo``/``hi`` are (..., 3), the rest broadcast against them."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmin <= tmax) & (tmax > 0.0) & (tmin <= nearest)
    return torch.where(hit, tmin, torch.full_like(tmin, T_FAR))


def _leaf_sphere_t(origin, direction, centers, radii, idx):
    """Closest valid t of sphere ``idx`` (clamped) per ray, or T_FAR;
    ``idx`` is (N, K), origin and direction (N, 3).  The quadratic of the
    brute-force intersector (extend.wgsl:185-210)."""
    c = _take(centers, idx)
    r = _take(radii, idx)
    oc = origin[:, None, :] - c
    d = direction[:, None, :]
    a = _dot(d, d)
    b = _dot(d, oc)
    cc = _dot(oc, oc) - r * r
    disc = b * b - a * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    far = torch.full_like(t1, T_FAR)
    t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, far))
    return torch.where(disc >= 0.0, t, far)


def _flat_depth(left_first, prim_count) -> int:
    """Max depth of a flat BVH (host-side; children are adjacent pairs)."""
    return bvh_depth(FlatBVH(None, None,
                             torch.as_tensor(left_first).cpu().numpy(),
                             torch.as_tensor(prim_count).cpu().numpy()))


def check_depth(left_first, prim_count) -> None:
    """Raise unless the tree fits the traversal stack: a deeper tree would
    silently drop far children when the stack overflows."""
    depth = _flat_depth(left_first, prim_count)
    if depth > STACK_DEPTH:
        raise ValueError(
            f"BVH depth {depth} exceeds traversal STACK_DEPTH "
            f"{STACK_DEPTH}; rebuild with a larger stack or a "
            "shallower tree")


def _traverse(leaf_t, origin, direction, bvh_min, bvh_max, bvh_left_first,
              bvh_prim_count, max_leaf_size: int):
    """The shared lockstep traversal; ``leaf_t(origin, direction, idx)``
    gives the (N, K) closest valid t of primitives ``idx`` (T_FAR on a
    miss).  Returns (t (N,), index (N,) int64, hit (N,) bool)."""
    n = origin.shape[0]
    device = origin.device
    lf_tab = bvh_left_first.long()
    pc_tab = bvh_prim_count.long()
    ks = torch.arange(max_leaf_size, device=device)
    pair = torch.arange(2, device=device)

    out_t = torch.full((n,), T_FAR, dtype=torch.float32, device=device)
    out_idx = torch.zeros((n,), dtype=torch.int64, device=device)
    # The working set: the lanes not known to be done, and their state.
    lanes = torch.arange(n, device=device)
    o, d = origin, direction
    inv_dir = 1.0 / direction
    best_t, best_idx = out_t.clone(), out_idx.clone()
    node = torch.zeros((n,), dtype=torch.int64, device=device)
    sp = torch.zeros((n,), dtype=torch.int64, device=device)
    stack = torch.full((n, STACK_DEPTH), SENTINEL, dtype=torch.int32,
                       device=device)
    done = torch.zeros((n,), dtype=torch.bool, device=device)

    step = 0
    while n > 0:
        lf = lf_tab[node]
        pc = pc_tab[node]
        is_leaf = pc > 0
        active = ~done

        # Leaf: the first of the nearest primitives, if nearer than best.
        idx = lf[:, None] + ks
        t_k = leaf_t(o, d, idx)
        valid = (is_leaf & active)[:, None] & (ks < pc[:, None])
        t_k = torch.where(valid, t_k, torch.full_like(t_k, T_FAR))
        k = torch.argmin(t_k, dim=1, keepdim=True)
        t_leaf = torch.gather(t_k, 1, k)[:, 0]
        better = t_leaf < best_t
        best_t = torch.where(better, t_leaf, best_t)
        best_idx = torch.where(better, lf + k[:, 0], best_idx)

        # Internal: order the children near-first, push the far one.
        child = lf[:, None] + pair
        tc = _slab_test(o[:, None, :], inv_dir[:, None, :],
                        _take(bvh_min, child), _take(bvh_max, child),
                        best_t[:, None])
        t_l, t_r = tc[:, 0], tc[:, 1]
        swap = t_l > t_r
        near = torch.where(swap, lf + 1, lf)
        far = torch.where(swap, lf, lf + 1)
        t_near = torch.minimum(t_l, t_r)
        t_far = torch.maximum(t_l, t_r)
        descend = ~is_leaf & active & (t_near < best_t)
        push_far = descend & (t_far < best_t)

        # Push the far child (clamped if the stack would overflow).
        slot = sp.clamp_max(STACK_DEPTH - 1)[:, None]
        top = torch.gather(stack, 1, slot)[:, 0]
        stack.scatter_(1, slot, torch.where(push_far, far.to(torch.int32),
                                            top)[:, None])
        sp = torch.where(push_far, (sp + 1).clamp_max(STACK_DEPTH - 1), sp)

        # Pop for lanes not descending (a leaf, or both children culled).
        need_pop = active & ~descend
        can_pop = need_pop & (sp > 0)
        done = done | (need_pop & (sp == 0))
        popped_sp = (sp - 1).clamp_min(0)
        popped = torch.gather(stack, 1, popped_sp[:, None])[:, 0].long()
        node = torch.where(descend, near, torch.where(can_pop, popped, node))
        sp = torch.where(can_pop, popped_sp, sp)

        step += 1
        if step % CHECK_EVERY:
            continue
        keep = torch.nonzero(~done)[:, 0]          # the host read
        if keep.shape[0] == n:
            continue
        out_t[lanes] = best_t
        out_idx[lanes] = best_idx
        n = keep.shape[0]
        lanes, o, d, inv_dir = lanes[keep], o[keep], d[keep], inv_dir[keep]
        best_t, best_idx = best_t[keep], best_idx[keep]
        node, sp, stack, done = node[keep], sp[keep], stack[keep], done[keep]
    return out_t, out_idx, out_t < T_FAR


def intersect_bvh(origin, direction, centers, radii, bvh_min, bvh_max,
                  bvh_left_first, bvh_prim_count, max_leaf_size: int = 4,
                  check_depth_first: bool = True):
    """Nearest sphere hit via the BVH; the contract of
    ``intersect_bruteforce``: (t (N,), sphere index (N,) int64, hit (N,)
    bool), indices into the BVH-reordered sphere tables.

    The tree's depth is checked against STACK_DEPTH first (a host read
    of the node tables) unless ``check_depth_first`` is false, as for a
    scene whose depth ``renderer.prepare_scene`` checked when it built
    the tree."""
    if check_depth_first:
        check_depth(bvh_left_first, bvh_prim_count)

    def leaf_t(o, d, idx):
        return _leaf_sphere_t(o, d, centers, radii, idx)

    return _traverse(leaf_t, origin, direction, bvh_min, bvh_max,
                     bvh_left_first, bvh_prim_count, max_leaf_size)


def intersect_bvh_triangles(origin, direction, v0, e1, e2, bvh_min, bvh_max,
                            bvh_left_first, bvh_prim_count,
                            max_leaf_size: int = 4):
    """Nearest triangle hit via the BVH (tables in BVH order); the
    contract of ``ops.triangle.intersect_triangles``: (t, tri_idx,
    hit)."""
    def leaf_t(o, d, idx):
        return triangle_t(o[:, None, :], d[:, None, :], _take(v0, idx),
                          _take(e1, idx), _take(e2, idx))

    return _traverse(leaf_t, origin, direction, bvh_min, bvh_max,
                     bvh_left_first, bvh_prim_count, max_leaf_size)
