"""Texture evaluation of the XLA-style engines, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/texture.py``.  Per-sphere
``tex_kind``: 0 solid (the albedo as stored), 1 checker (the RTIOW 3-D
checker at the hit point picks albedo or albedo2), 2 image (an
equirectangular lookup of the sphere's (u, v) in a stacked (T, H, W, 3)
atlas, at full resolution, nearest texel).  The fused engine samples
images through its LUTs instead (``ops/textures.py``).
"""

from __future__ import annotations

import math

import torch

SOLID = 0
CHECKER = 1
IMAGE = 2


def checker_select(px, py, pz, scale):
    """True where the 3-D checker picks the second colour."""
    s = torch.sin(scale * px) * torch.sin(scale * py) * torch.sin(scale * pz)
    return s < 0.0


def sphere_uv(normal):
    """Equirectangular (u, v) of a unit outward normal: u = phi / 2pi,
    v = theta / pi, theta = acos(-y), phi = atan2(-z, x) + pi."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    theta = torch.acos(torch.clamp(-ny, -1.0, 1.0))
    phi = torch.atan2(-nz, nx) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


def image_lookup(tex_data, tex_id, u, v):
    """Nearest texel of the (T, H, W, 3) atlas, v flipped so that v = 0
    is the bottom row."""
    h, w = tex_data.shape[1], tex_data.shape[2]
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp(((1.0 - v) * h).to(torch.int32), 0, h - 1)
    return tex_data[tex_id.long(), y.long(), x.long()]


def resolve_albedo(albedo, tex_kind, tex_albedo2, tex_scale, tex_id, p,
                   normal, tex_data=None):
    """Textured albedo of (N,) lanes; the albedo as given where
    ``tex_kind`` is 0."""
    sel = checker_select(p[..., 0], p[..., 1], p[..., 2], tex_scale)
    albedo = torch.where(((tex_kind == CHECKER) & sel)[..., None],
                         tex_albedo2, albedo)
    if tex_data is not None:
        u, v = sphere_uv(normal)
        albedo = torch.where((tex_kind == IMAGE)[..., None],
                             image_lookup(tex_data, tex_id, u, v), albedo)
    return albedo
