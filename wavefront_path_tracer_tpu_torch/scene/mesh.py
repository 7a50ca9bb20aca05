"""Triangle meshes and OBJ loading.

The reference's future-work list names "load object files"
(README.md:22-26); BASELINE.json config 5 makes an OBJ scene a target.
This module provides:

* ``MeshScene`` — a Scene extended with SoA triangle tables;
* ``add_mesh`` / primitive helpers (quad, box);
* ``load_obj`` — a minimal OBJ parser (v / f, polygon fan
  triangulation, optional mtllib Kd/Ks/Ni material mapping).

The port's copy of ``wavefront_path_tracer_tpu/scene/mesh.py`` (only the
imports differ), plus ``torus_knot`` from ``examples/gen_obj.py`` and the
knot benchmark scene; ``tests/test_torch_mesh.py`` holds them equal.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from wavefront_path_tracer_tpu_torch.scene.scene import SceneBuilder


class TriangleSoA(NamedTuple):
    v0: np.ndarray        # (T, 3) f32
    e1: np.ndarray        # (T, 3) f32: v1 - v0
    e2: np.ndarray        # (T, 3) f32: v2 - v0
    albedo: np.ndarray    # (T, 3) f32
    fuzz: np.ndarray      # (T,)  f32
    refract_idx: np.ndarray  # (T,) f32
    mat_type: np.ndarray  # (T,)  i32

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


class MeshSceneBuilder(SceneBuilder):
    """SceneBuilder that also accepts triangles."""

    def __init__(self) -> None:
        super().__init__()
        self._tris: list[tuple] = []  # (v0, v1, v2, mat_idx)

    def triangle(self, v0, v1, v2, mat_idx: int) -> None:
        self._tris.append((
            np.asarray(v0, np.float32), np.asarray(v1, np.float32),
            np.asarray(v2, np.float32), mat_idx,
        ))

    def quad(self, corner, edge_u, edge_v, mat_idx: int) -> None:
        """Two triangles spanning corner + edge_u/edge_v."""
        c = np.asarray(corner, np.float32)
        u = np.asarray(edge_u, np.float32)
        v = np.asarray(edge_v, np.float32)
        self.triangle(c, c + u, c + u + v, mat_idx)
        self.triangle(c, c + u + v, c + v, mat_idx)

    def mesh(self, vertices, faces, mat_idx: int) -> None:
        vertices = np.asarray(vertices, np.float32)
        for f in faces:
            self.triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]], mat_idx)

    def build_triangles(self) -> Optional[TriangleSoA]:
        if not self._tris:
            return None
        v0 = np.stack([t[0] for t in self._tris])
        v1 = np.stack([t[1] for t in self._tris])
        v2 = np.stack([t[2] for t in self._tris])
        mat_idx = np.array([t[3] for t in self._tris], np.int32)
        t_albedo = np.stack([m[0] for m in self._materials]).astype(np.float32)
        t_fuzz = np.array([m[1] for m in self._materials], np.float32)
        t_refract = np.array([m[2] for m in self._materials], np.float32)
        t_type = np.array([m[3] for m in self._materials], np.int32)
        return TriangleSoA(
            v0=v0, e1=v1 - v0, e2=v2 - v0,
            albedo=t_albedo[mat_idx], fuzz=t_fuzz[mat_idx],
            refract_idx=t_refract[mat_idx], mat_type=t_type[mat_idx],
        )

    def build_mesh_scene(self):
        """Returns (Scene, TriangleSoA | None).

        A mesh scene needs at least one sphere for the Scene tables; add
        a tiny far-away dark sphere automatically if none was given.
        """
        if not self._spheres:
            m = self.lambertian([0.0, 0.0, 0.0])
            self.sphere([0.0, -1e7, 0.0], 1.0, m)
        return self.build(), self.build_triangles()


def load_obj(path: str, builder: Optional[MeshSceneBuilder] = None,
             default_mat: Optional[int] = None, scale: float = 1.0,
             translate=(0.0, 0.0, 0.0)):
    """Minimal OBJ loader: v / f (fan triangulation), usemtl/mtllib.

    Material mapping from MTL (when present): Ni > 1 -> dielectric(Ni);
    any Ks channel > 0.25 -> metal(Ks, fuzz from Ns); else
    lambertian(Kd).  Returns the builder (chainable).
    """
    b = builder or MeshSceneBuilder()
    if default_mat is None:
        default_mat = b.lambertian([0.73, 0.73, 0.73])
    translate = np.asarray(translate, np.float32)

    mtl_map: dict[str, int] = {}

    def parse_mtl(mtl_path: str) -> None:
        if not os.path.exists(mtl_path):
            return
        name, kd, ks, ns, ni = None, [0.7] * 3, [0.0] * 3, 0.0, 1.0

        def commit():
            if name is None:
                return
            if ni > 1.001:
                mtl_map[name] = b.dielectric(ni)
            elif max(ks) > 0.25:
                fuzz = max(0.0, min(1.0, 1.0 - ns / 1000.0))
                mtl_map[name] = b.metal(ks, fuzz)
            else:
                mtl_map[name] = b.lambertian(kd)

        with open(mtl_path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl":
                    commit()
                    name, kd, ks, ns, ni = parts[1], [0.7] * 3, [0.0] * 3, 0.0, 1.0
                elif parts[0] == "Kd":
                    kd = [float(x) for x in parts[1:4]]
                elif parts[0] == "Ks":
                    ks = [float(x) for x in parts[1:4]]
                elif parts[0] == "Ns":
                    ns = float(parts[1])
                elif parts[0] == "Ni":
                    ni = float(parts[1])
        commit()

    vertices: list[list[float]] = []
    current_mat = default_mat
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                v = np.array([float(x) for x in parts[1:4]], np.float32)
                vertices.append(v * scale + translate)
            elif parts[0] == "mtllib":
                parse_mtl(os.path.join(os.path.dirname(path), parts[1]))
            elif parts[0] == "usemtl":
                current_mat = mtl_map.get(parts[1], default_mat)
            elif parts[0] == "f":
                idx = [int(tok.split("/")[0]) for tok in parts[1:]]
                idx = [i - 1 if i > 0 else len(vertices) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    b.triangle(vertices[idx[0]], vertices[idx[k]],
                               vertices[idx[k + 1]], current_mat)
    return b


def mesh_demo_scene():
    """A small built-in mesh scene: ground sphere + mirror box + glass
    quad + diffuse pyramid (no external assets needed)."""
    b = MeshSceneBuilder()
    ground = b.lambertian([0.5, 0.5, 0.5])
    b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)

    mirror = b.metal([0.8, 0.8, 0.9], 0.02)
    b.quad([-2.5, 0.0, -1.5], [1.5, 0.0, 0.0], [0.0, 2.0, 0.0], mirror)

    red = b.lambertian([0.7, 0.1, 0.1])
    apex = [1.5, 1.6, 0.0]
    base = [[0.7, 0.0, -0.8], [2.3, 0.0, -0.8], [2.3, 0.0, 0.8], [0.7, 0.0, 0.8]]
    for i in range(4):
        b.triangle(base[i], base[(i + 1) % 4], apex, red)
    b.triangle(base[0], base[2], base[1], red)
    b.triangle(base[0], base[3], base[2], red)

    glass = b.dielectric(1.5)
    b.quad([-0.8, 0.0, 1.2], [1.6, 0.0, 0.0], [0.0, 1.4, 0.0], glass)

    blue = b.lambertian([0.1, 0.2, 0.6])
    b.sphere([0.0, 0.5, -0.2], 0.5, blue)
    return b.build_mesh_scene()


def mesh_terrain_scene(n_quads: int = 50, seed: int = 7):
    """Procedural triangle-mesh benchmark scene: an n_quads x n_quads
    displaced terrain grid (2 triangles per quad — 5,000 triangles at
    the default) with mixed materials, plus a ground sphere and a few
    probe spheres.  The triangle-at-scale stress config (BASELINE
    config 5 / reference future work README.md:22-26)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    b = MeshSceneBuilder()
    ground = b.lambertian([0.5, 0.5, 0.5])
    b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)

    mats = [
        b.lambertian([0.6, 0.4, 0.3]),
        b.lambertian([0.3, 0.55, 0.3]),
        b.metal([0.7, 0.7, 0.75], 0.1),
    ]
    extent = 10.0
    xs = np.linspace(-extent, extent, n_quads + 1)
    zs = np.linspace(-extent, extent, n_quads + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    # Smooth rolling height field + jitter keeps AABBs locally tight.
    h = (0.6 * np.sin(gx * 0.7) * np.cos(gz * 0.5)
         + 0.25 * np.sin(gx * 2.1 + 1.0) * np.sin(gz * 1.7)
         + rng.uniform(0.0, 0.08, gx.shape))
    v = np.stack([gx, h + 0.6, gz], axis=-1)
    for i in range(n_quads):
        for j in range(n_quads):
            m = mats[(i * 7 + j * 3) % len(mats)] if (i + j) % 11 else mats[2]
            b.triangle(v[i, j], v[i + 1, j], v[i + 1, j + 1], m)
            b.triangle(v[i, j], v[i + 1, j + 1], v[i, j + 1], m)

    glass = b.dielectric(1.5)
    b.sphere([0.0, 2.2, 0.0], 1.0, glass)
    shiny = b.metal([0.8, 0.7, 0.5], 0.0)
    b.sphere([-4.0, 2.4, -2.0], 1.0, shiny)
    return b.build_mesh_scene()


# --- procedural torus knot -------------------------------------------------
# The port's own copy of ``examples/gen_obj.py:_grid_faces`` and
# ``torus_knot``, so that the knot scenes need no import of ``examples/``.

def _grid_faces(nu: int, nv: int, wrap_u: bool = True, wrap_v: bool = True):
    """Quad-grid triangulation over a (nu, nv) vertex grid."""
    faces = []
    last_u = nu if wrap_u else nu - 1
    last_v = nv if wrap_v else nv - 1
    for i in range(last_u):
        for j in range(last_v):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            faces.append((a, b, c))
            faces.append((a, c, d))
    return np.asarray(faces, np.int64)


def torus_knot(tris: int, p: int = 2, q: int = 3, radius: float = 1.0,
               tube: float = 0.35):
    """(vertices, faces) of a (p,q) torus knot tube with ~tris triangles."""
    # tris = 2 * nu * nv; keep the tube ring at ~1/4 the path samples.
    nv = max(8, int(round(np.sqrt(tris / 8.0))))
    nu = max(16, -(-tris // (2 * nv)))
    t = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    r = radius * (2.0 + np.cos(q * t)) / 3.0
    path = np.stack([r * np.cos(p * t), r * np.sin(p * t),
                     radius * np.sin(q * t) / 3.0], axis=-1)
    # Frenet-ish frame from finite differences (stable enough for a
    # smooth knot; re-orthonormalized per sample).
    tan = np.roll(path, -1, axis=0) - np.roll(path, 1, axis=0)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    nrm = np.cross(tan, ref)
    bad = np.linalg.norm(nrm, axis=-1) < 1e-6
    nrm[bad] = np.cross(tan[bad], np.array([0.0, 1.0, 0.0]))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bin_ = np.cross(tan, nrm)
    theta = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    ring = (np.cos(theta)[:, None, None] * nrm[None]
            + np.sin(theta)[:, None, None] * bin_[None])  # (nv, nu, 3)
    verts = (path[None] + tube * ring).transpose(1, 0, 2).reshape(-1, 3)
    return verts, _grid_faces(nu, nv)


def knot_scene(tris: int = 50000):
    """The knot benchmark scene (``bench.py:bench_once``'s ``mesh_knot``):
    a ground sphere of radius 1000 under a Lambertian torus knot of about
    ``tris`` triangles.  Returns (Scene, TriangleSoA)."""
    b = MeshSceneBuilder()
    b.sphere([0.0, -1000.0, 0.0], 1000.0, b.lambertian([0.5, 0.5, 0.5]))
    v, f = torus_knot(tris)
    b.mesh(v, f, b.lambertian([0.7, 0.3, 0.2]))
    return b.build_mesh_scene()


def knot_camera():
    """The knot scene's view in ``bench.py``: from (0, 1.5, 4) at the
    origin, 40 degrees, no defocus."""
    from wavefront_path_tracer_tpu_torch.scene.camera import CameraController

    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 1.5, 4.0], [0.0, 0.0, 0.0])
    cc.vfov_deg = 40.0
    cc.defocus_angle_deg = 0.0
    return cc
