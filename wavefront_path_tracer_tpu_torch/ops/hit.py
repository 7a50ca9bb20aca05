"""Nearest hit over every primitive type, with its shading inputs: the
hit resolution of the XLA-style engines, on tensors.

Port of ``wavefront_path_tracer_tpu/ops/hit.py``: the spheres by the
brute-force sweep, or with ``intersector="bvh"`` by the BVH traversal
(``ops/bvh_traverse.py``), and the triangles likewise by their sweep, or
by their own BVH when the scene has one (``tri_bvh_*``).  Normals: a
sphere's is (p - c) / |p - c|, negated for a negative radius (the
hollow-bubble trick: (p - c) / r); a triangle's is its geometric normal
for a dielectric (the winding defines outside), else the one facing the
ray (open meshes have no inside).
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops.bvh_traverse import (
    intersect_bvh,
    intersect_bvh_triangles,
)
from wavefront_path_tracer_tpu_torch.ops.intersect import (
    intersect_bruteforce,
)
from wavefront_path_tracer_tpu_torch.ops.texture import resolve_albedo
from wavefront_path_tracer_tpu_torch.ops.triangle import intersect_triangles
from wavefront_path_tracer_tpu_torch.scene.bvh import MAX_LEAF_SIZE
from wavefront_path_tracer_tpu_torch.scene.scene import DIELECTRIC


def dot3(a, b):
    """Row-wise dot product of (N, 3) tensors, summed in (x + y) + z
    order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def normalize(v):
    """Rows of (N, 3) ``v`` over their length sqrt(x*x + y*y + z*z)."""
    return v / torch.sqrt(dot3(v, v))[:, None]


def _intersect_spheres(origin, direction, scene_arrays, config):
    centers, radii = scene_arrays["centers"], scene_arrays["radii"]
    if config.intersector == "bvh":
        # max_leaf_size must match the builder's cap, or the traversal's
        # fixed-width leaf step would skip primitives; prepare_scene
        # checked the depth when it built the tree.
        return intersect_bvh(
            origin, direction, centers, radii, scene_arrays["bvh_min"],
            scene_arrays["bvh_max"], scene_arrays["bvh_left_first"],
            scene_arrays["bvh_prim_count"], max_leaf_size=MAX_LEAF_SIZE,
            check_depth_first=False)
    return intersect_bruteforce(
        origin, direction, centers, radii,
        sphere_chunk=min(config.sphere_chunk, centers.shape[0]))


def _intersect_triangles(origin, direction, scene_arrays):
    tables = [scene_arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2")]
    if "tri_bvh_min" in scene_arrays:
        return intersect_bvh_triangles(
            origin, direction, *tables, scene_arrays["tri_bvh_min"],
            scene_arrays["tri_bvh_max"], scene_arrays["tri_bvh_left_first"],
            scene_arrays["tri_bvh_prim_count"], max_leaf_size=MAX_LEAF_SIZE)
    return intersect_triangles(origin, direction, *tables)


def intersect_and_resolve(origin, direction, scene_arrays, config):
    """Nearest hit over the spheres and, when the scene has them, the
    triangles, with the winner's shading inputs: (t, hit, normal (N, 3),
    albedo (N, 3), fuzz, refract_idx, mat_type).  Attributes of lanes
    that hit nothing are garbage; callers mask them with ``hit``."""
    centers, radii = scene_arrays["centers"], scene_arrays["radii"]
    t, idx, hit = _intersect_spheres(origin, direction, scene_arrays, config)

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
        t_t, tri, hit_t = _intersect_triangles(origin, direction,
                                               scene_arrays)
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
