"""Ray-triangle intersection (Moller-Trumbore) of the XLA-style engines,
on tensors.

Port of ``wavefront_path_tracer_tpu/ops/triangle.py``.  Triangles are
stored as (v0, e1, e2) with e1 = v1 - v0 and e2 = v2 - v0; the test is
two-sided (glass plates need back faces), and geometric normals are
normalize(cross(e1, e2)) under counter-clockwise winding.  The blocks,
the zero-row padding (a degenerate triangle fails the determinant test)
and the nearest rule are those of ``ops/intersect.py``.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops.intersect import (
    T_FAR,
    T_MIN,
    nearest_in_blocks,
)

_EPS_DET = 1e-9


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _mt_t(d, o, v0, e1, e2):
    """Moller-Trumbore on components: ``d``, ``o``, ``v0``, ``e1``,
    ``e2`` are (x, y, z) triples of broadcastable tensors; the hit
    parameter, or T_FAR."""
    px, py, pz = _cross(*d, *e2)
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = torch.abs(det) > _EPS_DET
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    del px, py, pz
    qx, qy, qz = _cross(tx, ty, tz, *e1)
    del tx, ty, tz
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN))
    return torch.where(valid, t, torch.full_like(t, T_FAR))


def _cols(x):
    return x[..., 0], x[..., 1], x[..., 2]


def _tri_hit_t(origin, direction, v0, e1, e2):
    """Hit parameter per (ray, triangle) pair, or T_FAR.  origin and
    direction: (N, 3); v0, e1, e2: (B, 3).  Returns (N, B)."""
    d, o = (tuple(c[:, None] for c in _cols(x)) for x in (direction, origin))
    v0, e1, e2 = (tuple(c[None, :] for c in _cols(x)) for x in (v0, e1, e2))
    return _mt_t(d, o, v0, e1, e2)


def triangle_t(origin, direction, v0, e1, e2):
    """Hit parameter of ONE triangle per ray (all (N, 3)), or T_FAR."""
    return _mt_t(_cols(direction), _cols(origin), _cols(v0), _cols(e1),
                 _cols(e2))


def intersect_triangles(origin, direction, v0, e1, e2, tri_chunk: int = 128):
    """Nearest triangle hit; (t (N,), triangle index (N,) int64, hit
    (N,) bool)."""
    return nearest_in_blocks(_tri_hit_t, origin, direction, [v0, e1, e2],
                             tri_chunk)


def triangle_normals(e1, e2):
    """Unit geometric normals (counter-clockwise winding)."""
    nx, ny, nz = _cross(*_cols(e1), *_cols(e2))
    n = torch.stack([nx, ny, nz], -1)
    return n / torch.sqrt(nx * nx + ny * ny + nz * nz)[..., None]
