"""Ray-sphere intersection of the XLA-style engines, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/intersect.py``: a whole batch of
rays against blocks of ``sphere_chunk`` spheres with dense (rays x
spheres) elementwise math, the scene padded with zero-radius spheres,
which never hit.  The per-pair nearest root is order-independent, so the
block sweep picks what the reference's sequential nearest-hit loop
picks: least ``t``, and on a tie the least index (``torch.argmin`` takes
the first least entry, and a later block wins only when strictly
nearer).  No ``t`` is NaN: every NaN fails a comparison and becomes
``T_FAR``.

The three-term dot products are written out in component order,
``(x + y) + z``, on (rays, block) tensors, so no (rays, block, 3)
intermediate is made.
"""

from __future__ import annotations

import torch

T_MIN = 0.001   # shadow epsilon
T_FAR = 1e30    # 'no hit' sentinel


def _sphere_hit_t(origin, direction, centers, radii):
    """Nearest valid hit parameter per (ray, sphere) pair, or T_FAR.

    origin/direction: (N, 3); centers: (B, 3); radii: (B,).  Returns
    (N, B) float32: the near root if it is past T_MIN, else the far
    root (a dielectric's interior).  A zero radius is padding; a
    negative one is an inside-out sphere and hits like its |r|."""
    dx, dy, dz = (direction[:, k:k + 1] for k in range(3))
    ocx = origin[:, 0:1] - centers[None, :, 0]
    ocy = origin[:, 1:2] - centers[None, :, 1]
    ocz = origin[:, 2:3] - centers[None, :, 2]
    a = dx * dx + dy * dy + dz * dz                       # (N, 1)
    b = dx * ocx + dy * ocy + dz * ocz                    # (N, B)
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radii * radii)[None, :]
    del ocx, ocy, ocz
    disc = b * b - a * c
    del c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    del b, sq
    t = torch.where(t1 > T_MIN, t1,
                    torch.where(t2 > T_MIN, t2, torch.full_like(t2, T_FAR)))
    valid = (disc >= 0.0) & (radii[None, :] != 0.0)
    return torch.where(valid, t, torch.full_like(t, T_FAR))


def nearest_in_blocks(hit_t, origin, direction, tables, chunk: int):
    """The nearest of ``tables``' rows for each ray, swept in blocks of
    ``chunk`` rows with ``hit_t(origin, direction, *block)`` giving the
    (N, chunk) parameters; (t (N,), index (N,) int64, hit (N,) bool).
    The tables (each (R, ...)) are padded with zero rows to a whole
    block."""
    n_rows = tables[0].shape[0]
    pad = (-n_rows) % chunk
    if pad:
        tables = [torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                  for t in tables]
    n = origin.shape[0]
    best_t = torch.full((n,), T_FAR, dtype=torch.float32,
                        device=origin.device)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=origin.device)
    for base in range(0, n_rows + pad, chunk):
        t = hit_t(origin, direction,
                  *(tab[base:base + chunk] for tab in tables))
        arg = torch.argmin(t, dim=-1)
        blk_t = torch.gather(t, 1, arg[:, None])[:, 0]
        del t
        better = blk_t < best_t
        best_idx = torch.where(better, arg + base, best_idx)
        best_t = torch.where(better, blk_t, best_t)
    return best_t, best_idx, best_t < T_FAR


def intersect_bruteforce(origin, direction, centers, radii,
                         sphere_chunk: int = 128):
    """Nearest hit over all spheres; (t (N,), sphere index (N,) int64,
    hit (N,) bool).  Peak memory is rays x ``sphere_chunk``."""
    return nearest_in_blocks(_sphere_hit_t, origin, direction,
                             [centers, radii], sphere_chunk)


def sky_color(direction):
    """The background gradient for unit directions: white to
    (0.5, 0.7, 1.0) with the direction's y."""
    a = 0.5 * (direction[..., 1] + 1.0)
    white = 1.0 - a
    return torch.stack([white + a * blue for blue in (0.5, 0.7, 1.0)], -1)
