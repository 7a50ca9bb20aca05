"""Material scattering of the XLA-style engines, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/bsdf.py``.  Every shading event
draws from its own (pixel, frame, sample, bounce) stream in a fixed
order: three unit-ball draws, then one reflectance draw (``_draws``), so
that every engine consumes the same values whatever its materials.  The
three materials are evaluated for every lane and selected by
``mat_type``; returned directions are unit length.

* 0 Lambertian: normal + the unit-ball sample, falling back to the
  normal when that is shorter than 0.001.
* 1 Metal: reflect(d, n) + fuzz * the sample.
* 2 Dielectric: the outward normal flipped inside, Schlick reflectance
  against the reflectance draw, refraction unless total internal
  reflection.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops import rng
from wavefront_path_tracer_tpu_torch.ops.hit import dot3, normalize


def reflect(d, n):
    """Mirror reflection of (N, 3) ``d`` about unit normals ``n``."""
    return d - (2.0 * dot3(d, n))[:, None] * n


def schlick(cosine, eta):
    """Schlick's reflectance approximation."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def _draws(state):
    """The event's fixed draws: a unit direction from three unit-ball
    draws, then the reflectance draw; ((N, 3), (N,)).  Never stratified
    (only the 2-D AA jitter is, ``ops/raygen.py``)."""
    state, sx, sy, sz = rng.sample_unit_sphere(state)
    _, r_reflect = rng.next_f32(state)
    return normalize(torch.stack([sx, sy, sz], -1)), r_reflect


def _lambertian(draws, direction, normal, fuzz, refract_idx):
    s, _ = draws
    d = normal + s
    degenerate = torch.sqrt(dot3(d, d))[:, None] < 0.001
    return normalize(torch.where(degenerate, normal, d))


def _metal(draws, direction, normal, fuzz, refract_idx):
    s, _ = draws
    d = reflect(direction, normal) + fuzz[:, None] * s
    norm = torch.sqrt(dot3(d, d))[:, None]
    return torch.where(norm > 1e-12, d / torch.clamp_min(norm, 1e-12),
                       normal)


def _dielectric(draws, direction, normal, fuzz, refract_idx):
    _, r_reflect = draws
    uv = direction
    cos_theta = torch.clamp_max(dot3(normal, -uv), 1.0)
    outside = cos_theta >= 0.0
    eta = torch.where(outside, 1.0 / refract_idx, refract_idx)
    n_d = torch.where(outside[:, None], normal, -normal)
    cos_theta = torch.where(outside, cos_theta, -cos_theta)
    reflectance = schlick(cos_theta, eta)
    cos_in = dot3(uv, n_d)
    k = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    can_refract = k >= 0.0
    d_refract = (eta[:, None] * uv
                 - (eta * cos_in + torch.sqrt(torch.clamp_min(k, 0.0)))[:, None]
                 * n_d)
    d = torch.where((can_refract & (reflectance <= r_reflect))[:, None],
                    d_refract, reflect(uv, n_d))
    return normalize(d)


_BY_MATERIAL = (_lambertian, _metal, _dielectric)


def _per_material(fn):
    def scatter_one(state, direction, normal, fuzz, refract_idx):
        return fn(_draws(state), direction, normal, fuzz, refract_idx)
    scatter_one.__doc__ = f"One material's scatter ({fn.__name__[1:]})."
    return scatter_one


scatter_lambertian = _per_material(_lambertian)
scatter_metal = _per_material(_metal)
scatter_dielectric = _per_material(_dielectric)
SCATTER_BY_MATERIAL = (scatter_lambertian, scatter_metal, scatter_dielectric)


def scatter_partitioned(state, direction, normal, mat_type, fuzz,
                        refract_idx):
    """Each material's scatter over every lane, selected by
    ``mat_type``; the draws are made once and shared, as they are the
    same values for every material."""
    draws = _draws(state)
    out = torch.zeros_like(direction)
    for m, fn in enumerate(_BY_MATERIAL):
        d_m = fn(draws, direction, normal, fuzz, refract_idx)
        out = torch.where((mat_type == m)[:, None], d_m, out)
    return out


def scatter(state, direction, normal, mat_type, fuzz, refract_idx):
    """(N, 3) unit scattered directions from (N,) RNG states, unit
    incoming directions and unit outward normals (N, 3), int material
    types and (N,) fuzz and refraction indices."""
    return scatter_partitioned(state, direction, normal, mat_type, fuzz,
                               refract_idx)
