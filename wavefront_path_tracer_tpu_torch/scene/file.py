"""User scene files (JSON) — define scenes without writing Python.

The reference hardcodes its two scenes in code (scene.rs:12-107); the
builder API here covers programmatic use, and this module covers the
"I just want to describe a scene" path:

    {
      "camera": {                     # optional; wins over CLI camera
        "look_from": [13, 2, 3],
        "look_at": [0, 0, 0],
        "vfov": 20,
        "defocus_angle": 0.6,
        "focus_distance": 10
      },
      "spheres": [
        {"center": [0, -1000, 0], "radius": 1000,
         "material": {"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}},
        {"center": [0, 1, 0], "radius": 1.0,
         "material": {"type": "dielectric", "ior": 1.5}},
        {"center": [4, 1, 0], "radius": 1.0,
         "material": {"type": "metal", "albedo": [0.7, 0.6, 0.5],
                      "fuzz": 0.05}},
        {"center": [-4, 1, 0], "radius": 1.0,
         "material": {"type": "lambertian", "albedo": [0.4, 0.2, 0.1],
                      "texture": {"checker": [0.9, 0.9, 0.9],
                                  "scale": 6.0}}}
      ]
    }

Material types and fields follow the reference's Material ctor
semantics (material.rs:26-36): lambertian {albedo}, metal {albedo,
fuzz (clamped to [0,1])}, dielectric {ior}.  Textures: checker
({"checker": [r,g,b], "scale": s}) or image ({"image": "file.png"},
path relative to the scene file; 8-bit RGB PNG, equirect UV).
Negative radii are allowed (hollow-bubble normal flip).

The port's copy of ``wavefront_path_tracer_tpu/scene/file.py`` (only the
imports differ); ``tests/test_torch_textures.py`` holds the two loaders
to equal scenes, triangles and camera blocks.
"""

from __future__ import annotations

import json

from wavefront_path_tracer_tpu_torch.scene.mesh import MeshSceneBuilder, load_obj


def load_scene_file(path: str):
    """-> (Scene, TriangleSoA | None, camera_dict | None).
    Raises ValueError with the offending entry on malformed input.

    Optional top-level ``"objs"``: a list of
    ``{"path": "mesh.obj", "scale": s, "translate": [x,y,z]}`` entries
    (paths relative to the scene file; materials from the OBJ's MTL
    when present, mapped as in scene/mesh.py:load_obj).
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or ("spheres" not in doc
                                     and "objs" not in doc):
        raise ValueError(f"{path}: expected an object with a 'spheres' "
                         "and/or 'objs' list")

    b = MeshSceneBuilder()
    mat_cache: dict = {}
    img_cache: dict = {}

    def material(spec, i):
        if not isinstance(spec, dict) or "type" not in spec:
            raise ValueError(f"{path}: sphere {i}: material must be an "
                             "object with a 'type'")
        key = json.dumps(spec, sort_keys=True)
        if key in mat_cache:
            return mat_cache[key]
        kind = spec["type"]
        texture = None
        if "texture" in spec:
            t = spec["texture"]
            if isinstance(t, dict) and "checker" in t:
                texture = ("checker", t["checker"],
                           float(t.get("scale", 6.0)))
            elif isinstance(t, dict) and "image" in t:
                # Image textures: an 8-bit RGB PNG next to the scene
                # file (or an absolute path), mapped with the RTIOW
                # equirect UV (ops/texture.py:sphere_uv).
                import os

                from wavefront_path_tracer_tpu_torch.utils.image import read_png

                img_path = t["image"]
                if not os.path.isabs(img_path):
                    img_path = os.path.join(os.path.dirname(path),
                                            img_path)
                if img_path not in img_cache:
                    img_cache[img_path] = \
                        read_png(img_path).astype("float32") / 255.0
                texture = img_cache[img_path]
            else:
                raise ValueError(
                    f"{path}: sphere {i}: texture must be "
                    "{'checker': [r,g,b], 'scale': s} or "
                    "{'image': 'file.png'}")
        if kind in ("lambertian", "metal") and "albedo" not in spec:
            raise ValueError(f"{path}: sphere {i}: {kind} material "
                             "needs an 'albedo' [r,g,b]")
        if kind == "lambertian":
            m = b.lambertian(spec["albedo"], texture=texture)
        elif kind == "metal":
            m = b.metal(spec["albedo"], float(spec.get("fuzz", 0.0)),
                        texture=texture)
        elif kind == "dielectric":
            if texture is not None:
                raise ValueError(f"{path}: sphere {i}: dielectric "
                                 "materials take no texture")
            m = b.dielectric(float(spec.get("ior", 1.5)))
        else:
            raise ValueError(f"{path}: sphere {i}: unknown material type "
                             f"{kind!r} (lambertian | metal | dielectric)")
        mat_cache[key] = m
        return m

    for i, s in enumerate(doc.get("spheres", ())):
        try:
            center = [float(v) for v in s["center"]]
            radius = float(s["radius"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: sphere {i}: need 'center' [x,y,z] "
                             f"and numeric 'radius' ({e})") from e
        if len(center) != 3:
            raise ValueError(f"{path}: sphere {i}: center must have 3 "
                             "components")
        b.sphere(center, radius, material(s.get("material"), i))

    import os

    for i, o in enumerate(doc.get("objs", ())):
        if not isinstance(o, dict) or "path" not in o:
            raise ValueError(f"{path}: objs[{i}] must be an object with "
                             "a 'path'")
        obj_path = o["path"]
        if not os.path.isabs(obj_path):
            obj_path = os.path.join(os.path.dirname(path), obj_path)
        load_obj(obj_path, builder=b, scale=float(o.get("scale", 1.0)),
                 translate=tuple(o.get("translate", (0.0, 0.0, 0.0))))

    cam = doc.get("camera")
    if cam is not None and not isinstance(cam, dict):
        raise ValueError(f"{path}: camera must be an object")
    if b._tris:
        return b.build_mesh_scene() + (cam,)
    return b.build(), None, cam


def apply_camera_dict(cc, cam: dict):
    """Apply a scene-file camera block onto a CameraController.

    Partial blocks keep the controller's CURRENT state for unspecified
    fields: a missing look_from falls back to the current camera
    position, a missing look_at to a point along the current forward
    direction (so orientation is preserved).
    """
    if "look_from" in cam or "look_at" in cam:
        import math

        pos = list(cc.camera.position)
        sp, cp = math.sin(cc.camera.pitch), math.cos(cc.camera.pitch)
        sy, cy = math.sin(cc.camera.yaw), math.cos(cc.camera.yaw)
        fwd = [sp * sy, cp, sp * cy]
        look_from = cam.get("look_from", pos)
        look_at = cam.get("look_at",
                          [p + f for p, f in zip(look_from, fwd)])
        cc.camera = cc.camera.look_at(look_from, look_at)
    if "vfov" in cam:
        cc.vfov_deg = float(cam["vfov"])
    if "defocus_angle" in cam:
        cc.defocus_angle_deg = float(cam["defocus_angle"])
    if "focus_distance" in cam:
        cc.focus_distance = float(cam["focus_distance"])
    return cc
