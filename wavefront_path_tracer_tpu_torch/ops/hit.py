"""Nearest hit over every primitive type, with its shading inputs: the
hit resolution of the XLA-style engines, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/hit.py`` for the brute-force
sphere sweep.  Normals: a sphere's is (p - c) / |p - c|, negated for a
negative radius (the hollow-bubble trick: (p - c) / r); a triangle's is
its geometric normal for a dielectric (the winding defines outside),
else the one facing the ray (open meshes have no inside).
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops.intersect import (
    intersect_bruteforce,
)
from wavefront_path_tracer_tpu_torch.ops.texture import resolve_albedo
from wavefront_path_tracer_tpu_torch.ops.triangle import intersect_triangles
from wavefront_path_tracer_tpu_torch.scene.scene import DIELECTRIC


def dot3(a, b):
    """Row-wise dot product of (N, 3) tensors, summed in (x + y) + z
    order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def normalize(v):
    """Rows of (N, 3) ``v`` over their length sqrt(x*x + y*y + z*z)."""
    return v / torch.sqrt(dot3(v, v))[:, None]


def check_intersector(config) -> None:
    if config.intersector == "bvh":
        raise NotImplementedError(
            "the BVH intersector is not ported yet (ROADMAP.md queue 1 "
            "item 8: ops/bvh_traverse.py); use intersector='bruteforce'")


def intersect_and_resolve(origin, direction, scene_arrays, config):
    """Nearest hit over the spheres and, when the scene has them, the
    triangles, with the winner's shading inputs: (t, hit, normal (N, 3),
    albedo (N, 3), fuzz, refract_idx, mat_type).  Attributes of lanes
    that hit nothing are garbage; callers mask them with ``hit``."""
    check_intersector(config)
    centers, radii = scene_arrays["centers"], scene_arrays["radii"]
    t, idx, hit = intersect_bruteforce(
        origin, direction, centers, radii,
        sphere_chunk=min(config.sphere_chunk, centers.shape[0]))

    p = origin + t[:, None] * direction
    nvec = (p - centers[idx]) * torch.sign(radii[idx])[:, None]
    normal = normalize(nvec)
    albedo = scene_arrays["albedo"][idx]
    fuzz = scene_arrays["fuzz"][idx]
    refract = scene_arrays["refract_idx"][idx]
    mat = scene_arrays["mat_type"][idx]

    if "tex_kind" in scene_arrays:
        albedo = resolve_albedo(
            albedo, scene_arrays["tex_kind"][idx],
            scene_arrays["tex_albedo2"][idx], scene_arrays["tex_scale"][idx],
            scene_arrays["tex_id"][idx], p, normal,
            scene_arrays.get("tex_data"))

    if "tri_v0" in scene_arrays:
        t_t, tri, hit_t = intersect_triangles(
            origin, direction, scene_arrays["tri_v0"],
            scene_arrays["tri_e1"], scene_arrays["tri_e2"])
        use_tri = t_t < t
        t = torch.where(use_tri, t_t, t)
        hit = hit | hit_t
        n_geo = scene_arrays["tri_normal"][tri]
        tri_mat = scene_arrays["tri_mat_type"][tri]
        toward = dot3(direction, n_geo) > 0.0
        n_facing = torch.where(toward[:, None], -n_geo, n_geo)
        n_tri = torch.where((tri_mat == DIELECTRIC)[:, None], n_geo, n_facing)
        use = use_tri[:, None]
        normal = torch.where(use, n_tri, normal)
        albedo = torch.where(use, scene_arrays["tri_albedo"][tri], albedo)
        fuzz = torch.where(use_tri, scene_arrays["tri_fuzz"][tri], fuzz)
        refract = torch.where(use_tri, scene_arrays["tri_refract"][tri],
                              refract)
        mat = torch.where(use_tri, tri_mat, mat)

    return t, hit, normal, albedo, fuzz, refract, mat
