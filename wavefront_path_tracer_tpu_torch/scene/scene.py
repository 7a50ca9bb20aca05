"""Sphere scenes as structure-of-arrays, built on the host with numpy.

Re-expresses the reference's scene model (``wavefront_common/src/scene.rs``,
``sphere.rs``, ``material.rs``) TPU-first: instead of 32-byte AoS PODs
uploaded to storage buffers, the scene is a pytree of SoA arrays so the
intersector can stream sphere blocks through the VPU/MXU.

Material types (reference material.rs:3-10): 0 Lambertian, 1 Metal,
2 Dielectric.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2


class Scene(NamedTuple):
    """SoA scene tables.  A NamedTuple of arrays == a JAX pytree.

    Sphere tables have length N (number of spheres); material tables have
    length M.  ``mat_albedo/fuzz/refract`` are pre-gathered *per sphere*
    as well (``albedo`` etc.) so the hot path never does a second indexed
    gather through the material table — a TPU-friendly denormalization
    the AoS reference could not afford in its 32-byte structs.
    """

    centers: np.ndarray       # (N, 3) f32
    radii: np.ndarray         # (N,)  f32
    mat_idx: np.ndarray       # (N,)  i32 index into material tables
    mat_type: np.ndarray      # (N,)  i32 in {0, 1, 2}
    albedo: np.ndarray        # (N, 3) f32  per-sphere gathered albedo
    fuzz: np.ndarray          # (N,)  f32  per-sphere gathered fuzz
    refract_idx: np.ndarray   # (N,)  f32  per-sphere gathered ior
    # Normalized material tables (length M), kept for API parity with the
    # reference's separate materials buffer (path_tracer.rs:123-125).
    table_albedo: np.ndarray  # (M, 3) f32
    table_fuzz: np.ndarray    # (M,)  f32
    table_refract: np.ndarray # (M,)  f32
    table_type: np.ndarray    # (M,)  i32
    # Texture tables (ops/texture.py kinds; None when no material is
    # textured, so untextured scenes carry zero extra state).
    tex_kind: np.ndarray | None = None      # (N,) i32 0 solid/1 checker/2 image
    tex_albedo2: np.ndarray | None = None   # (N, 3) f32 checker second color
    tex_scale: np.ndarray | None = None     # (N,)  f32 checker frequency
    tex_id: np.ndarray | None = None        # (N,)  i32 atlas index
    tex_data: np.ndarray | None = None      # (T, H, W, 3) f32 image atlas

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    @property
    def num_materials(self) -> int:
        return self.table_albedo.shape[0]

    def aabbs(self):
        """Per-sphere AABBs (reference sphere.rs:22-26).

        Deliberate deviation: |r|, not r — a negative (inside-out)
        radius would give the reference an inverted, never-hit AABB;
        here such spheres are real geometry (ops/hit.py normal flip).
        """
        r = np.abs(self.radii)[:, None]
        return self.centers - r, self.centers + r

    @property
    def has_textures(self) -> bool:
        return self.tex_kind is not None and bool(np.any(self.tex_kind != 0))

    def permuted(self, order: np.ndarray) -> "Scene":
        """Scene with spheres reordered (BVH builds reorder primitives)."""
        tex = {}
        if self.tex_kind is not None:
            tex = dict(
                tex_kind=self.tex_kind[order],
                tex_albedo2=self.tex_albedo2[order],
                tex_scale=self.tex_scale[order],
                tex_id=self.tex_id[order],
            )
        return self._replace(
            centers=self.centers[order],
            radii=self.radii[order],
            mat_idx=self.mat_idx[order],
            mat_type=self.mat_type[order],
            albedo=self.albedo[order],
            fuzz=self.fuzz[order],
            refract_idx=self.refract_idx[order],
            **tex,
        )


class SceneBuilder:
    """Imperative builder mirroring the reference's Vec<Sphere>/Vec<Material>."""

    def __init__(self) -> None:
        self._spheres: list[tuple] = []   # (center, radius, mat_idx, mat_type)
        self._materials: list[tuple] = [] # (albedo3, fuzz, refract_idx, mat_type, tex)
        self._images: list[np.ndarray] = []

    def _tex(self, texture):
        """Normalize a texture spec: None | ("checker", color2, scale) |
        an (H, W, 3) image array -> (kind, albedo2, scale, tex_id)."""
        if texture is None:
            return (0, np.zeros(3, np.float32), 0.0, 0)
        if isinstance(texture, tuple) and texture and texture[0] == "checker":
            _, color2, scale = texture
            return (1, np.asarray(color2, np.float32), float(scale), 0)
        img = np.asarray(texture, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError("image texture must be (H, W, 3)")
        if self._images and img.shape != self._images[0].shape:
            raise ValueError("all image textures must share one (H, W)")
        self._images.append(img)
        return (2, np.zeros(3, np.float32), 0.0, len(self._images) - 1)

    # Material ctor semantics match reference material.rs:26-36; the
    # optional texture modulates albedo (reference future work).
    def lambertian(self, albedo, texture=None) -> int:
        self._materials.append((np.asarray(albedo, np.float32), 0.0, 0.0,
                                LAMBERTIAN, self._tex(texture)))
        return len(self._materials) - 1

    def metal(self, albedo, fuzz: float, texture=None) -> int:
        fuzz = float(np.clip(fuzz, 0.0, 1.0))
        self._materials.append((np.asarray(albedo, np.float32), fuzz, 0.0,
                                METAL, self._tex(texture)))
        return len(self._materials) - 1

    def dielectric(self, refract_index: float) -> int:
        self._materials.append((np.ones(3, np.float32), 0.0,
                                float(refract_index), DIELECTRIC,
                                (0, np.zeros(3, np.float32), 0.0, 0)))
        return len(self._materials) - 1

    def sphere(self, center, radius: float, mat_idx: int) -> None:
        mat_type = self._materials[mat_idx][3]
        self._spheres.append((np.asarray(center, np.float32), float(radius), mat_idx, mat_type))

    def build(self) -> Scene:
        n = len(self._spheres)
        if n == 0:
            raise ValueError("scene has no spheres")
        centers = np.stack([s[0] for s in self._spheres]).astype(np.float32)
        radii = np.array([s[1] for s in self._spheres], np.float32)
        mat_idx = np.array([s[2] for s in self._spheres], np.int32)
        mat_type = np.array([s[3] for s in self._spheres], np.int32)

        t_albedo = np.stack([m[0] for m in self._materials]).astype(np.float32)
        t_fuzz = np.array([m[1] for m in self._materials], np.float32)
        t_refract = np.array([m[2] for m in self._materials], np.float32)
        t_type = np.array([m[3] for m in self._materials], np.int32)

        tex = {}
        t_kind = np.array([m[4][0] for m in self._materials], np.int32)
        if np.any(t_kind != 0):
            t_a2 = np.stack([m[4][1] for m in self._materials]).astype(np.float32)
            t_scale = np.array([m[4][2] for m in self._materials], np.float32)
            t_tid = np.array([m[4][3] for m in self._materials], np.int32)
            tex = dict(
                tex_kind=t_kind[mat_idx],
                tex_albedo2=t_a2[mat_idx],
                tex_scale=t_scale[mat_idx],
                tex_id=t_tid[mat_idx],
                tex_data=(np.stack(self._images).astype(np.float32)
                          if self._images else None),
            )

        return Scene(
            centers=centers,
            radii=radii,
            mat_idx=mat_idx,
            mat_type=mat_type,
            albedo=t_albedo[mat_idx],
            fuzz=t_fuzz[mat_idx],
            refract_idx=t_refract[mat_idx],
            table_albedo=t_albedo,
            table_fuzz=t_fuzz,
            table_refract=t_refract,
            table_type=t_type,
            **tex,
        )


def book_cover() -> Scene:
    """5-sphere RTIOW cover incl. hollow glass bubble (scene.rs:12-46)."""
    b = SceneBuilder()
    m_ground = b.lambertian([0.8, 0.8, 0.0])
    m_center = b.lambertian([0.1, 0.2, 0.5])
    m_left = b.dielectric(1.50)
    m_right = b.metal([0.8, 0.6, 0.2], 1.0)
    m_bubble = b.dielectric(1.00 / 1.50)

    b.sphere([0.0, -100.5, -1.0], 100.0, m_ground)
    b.sphere([0.0, 0.0, -1.2], 0.5, m_center)
    b.sphere([1.0, 0.0, -1.0], 0.5, m_right)
    b.sphere([-1.0, 0.0, -1.0], 0.5, m_left)
    b.sphere([-1.0, 0.0, -1.0], 0.4, m_bubble)
    return b.build()


def book_one_final(seed: int = 42) -> Scene:
    """Shirley book-1 final scene: ground + 22x22 random grid + 3 big spheres.

    Mirrors reference scene.rs:48-107 but with a *seeded* RNG — the
    reference uses an unseeded thread_rng (util_funcs.rs:6-36) so its
    scenes are non-reproducible; ours are.
    """
    rng = np.random.RandomState(seed)
    b = SceneBuilder()

    b.sphere([0.0, -1000.0, 0.0], 1000.0, b.lambertian([0.5, 0.5, 0.5]))

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rng.rand()
            center = np.array(
                [a + 0.9 * rng.rand(), 0.2, c + 0.9 * rng.rand()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.rand(3) * rng.rand(3)
                b.sphere(center, 0.2, b.lambertian(albedo))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * rng.rand(3)
                fuzz = 0.5 * rng.rand()
                b.sphere(center, 0.2, b.metal(albedo, fuzz))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere([0.0, 1.0, 0.0], 1.0, b.dielectric(1.50))
    b.sphere([-4.0, 1.0, 0.0], 1.0, b.lambertian([0.4, 0.2, 0.1]))
    b.sphere([4.0, 1.0, 0.0], 1.0, b.metal([0.7, 0.6, 0.5], 0.0))
    return b.build()


def procedural_spheres(n: int = 10_000, seed: int = 7, extent: float = 50.0) -> Scene:
    """Large procedural scene for BVH-depth / compaction stress
    (BASELINE.json config 4; no reference analog)."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder()
    b.sphere([0.0, -1000.0, 0.0], 1000.0, b.lambertian([0.5, 0.5, 0.5]))

    centers = np.empty((n, 3), np.float32)
    centers[:, 0] = rng.uniform(-extent, extent, n)
    centers[:, 2] = rng.uniform(-extent, extent, n)
    radii = rng.uniform(0.1, 0.4, n).astype(np.float32)
    centers[:, 1] = radii  # rest on the ground
    kinds = rng.rand(n)
    for i in range(n):
        if kinds[i] < 0.7:
            m = b.lambertian(rng.rand(3))
        elif kinds[i] < 0.9:
            m = b.metal(0.5 + 0.5 * rng.rand(3), 0.5 * rng.rand())
        else:
            m = b.dielectric(1.5)
        b.sphere(centers[i], float(radii[i]), m)
    return b.build()


def cornell_spheres(seed: int = 11) -> Scene:
    """Dielectric/metal-heavy enclosed scene (BASELINE.json config 3).

    A Cornell-style open box built from four giant Lambertian spheres
    (walls look locally flat; no ceiling — the sky gradient is the only
    light in the RTIOW material model) enclosing a dense cluster of
    glass and mirror spheres — stresses long specular bounce chains and
    the per-material shade paths.  No reference analog.
    """
    rng = np.random.RandomState(seed)
    b = SceneBuilder()
    r_wall = 1000.0
    half = 3.0  # box half-extent
    white = b.lambertian([0.73, 0.73, 0.73])
    red = b.lambertian([0.65, 0.05, 0.05])
    green = b.lambertian([0.12, 0.45, 0.15])
    b.sphere([0.0, -r_wall, 0.0], r_wall, white)              # floor y=0
    b.sphere([0.0, half, -r_wall - half], r_wall, white)      # back
    b.sphere([-r_wall - half, half, 0.0], r_wall, red)        # left
    b.sphere([r_wall + half, half, 0.0], r_wall, green)       # right

    for _ in range(60):
        center = [rng.uniform(-0.7, 0.7) * half,
                  rng.uniform(0.1, 1.2) * half,
                  rng.uniform(-0.7, 0.7) * half]
        radius = rng.uniform(0.15, 0.45)
        k = rng.rand()
        if k < 0.45:
            m = b.dielectric(1.5)
        elif k < 0.9:
            m = b.metal(0.6 + 0.4 * rng.rand(3), 0.1 * rng.rand())
        else:
            m = b.lambertian(rng.rand(3))
        b.sphere(center, radius, m)
    return b.build()


def book_checker(seed: int = 42) -> Scene:
    """book_one_final with the classic RTIOW checkered ground plus one
    image-textured sphere (procedural UV test pattern — the image
    plumbing without external assets)."""
    scene = book_one_final(seed)
    del scene
    rng = np.random.RandomState(seed)
    b = SceneBuilder()
    ground = b.lambertian([0.5, 0.5, 0.5],
                          texture=("checker", [0.9, 0.9, 0.9], 3.0))
    b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rng.rand()
            center = np.array(
                [a + 0.9 * rng.rand(), 0.2, c + 0.9 * rng.rand()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.rand(3) * rng.rand(3)
                b.sphere(center, 0.2, b.lambertian(albedo))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * rng.rand(3)
                fuzz = 0.5 * rng.rand()
                b.sphere(center, 0.2, b.metal(albedo, fuzz))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere([0.0, 1.0, 0.0], 1.0, b.dielectric(1.50))
    # UV test pattern: hue by u, brightness by v.
    u = np.linspace(0.0, 1.0, 64)[None, :, None]
    v = np.linspace(0.15, 1.0, 32)[:, None, None]
    img = np.concatenate([u, 1.0 - u, np.full_like(u, 0.35)], -1) * v
    b.sphere([-4.0, 1.0, 0.0], 1.0,
             b.lambertian([1.0, 1.0, 1.0], texture=img.astype(np.float32)))
    b.sphere([4.0, 1.0, 0.0], 1.0, b.metal([0.7, 0.6, 0.5], 0.0))
    return b.build()


def book_bubble() -> Scene:
    """book_cover with the hollow bubble modeled as a NEGATIVE-radius
    sphere (RTIOW's alternative to the reference's inverted-IOR bubble,
    scene.rs:34-37): same image, but exercises the inside-out sphere
    path (flipped normals, sign-only inv_r, far-root retention in
    _t2_elidable) that scene files permit and no other named scene
    reaches."""
    b = SceneBuilder()
    m_ground = b.lambertian([0.8, 0.8, 0.0])
    m_center = b.lambertian([0.1, 0.2, 0.5])
    m_glass = b.dielectric(1.50)
    m_right = b.metal([0.8, 0.6, 0.2], 1.0)

    b.sphere([0.0, -100.5, -1.0], 100.0, m_ground)
    b.sphere([0.0, 0.0, -1.2], 0.5, m_center)
    b.sphere([1.0, 0.0, -1.0], 0.5, m_right)
    b.sphere([-1.0, 0.0, -1.0], 0.5, m_glass)
    b.sphere([-1.0, 0.0, -1.0], -0.4, m_glass)
    return b.build()


_SCENES = {
    "book_cover": book_cover,
    "book_bubble": book_bubble,
    "book_one_final": book_one_final,
    "procedural": procedural_spheres,
    "cornell_spheres": cornell_spheres,
    "book_checker": book_checker,
}


def get_scene(name: str, **kw) -> Scene:
    if name not in _SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_SCENES)}")
    return _SCENES[name](**kw)


# Sensible default viewpoints per named scene, used by the CLI/REPL
# when the user passes no camera flags (the reference hardcodes ONE
# camera for its one scene, main.rs:23-32; interior scenes like
# cornell_spheres are unviewable from it).
SCENE_CAMERAS = {
    "book_cover": {"look_from": [-2.0, 2.0, 1.0],
                   "look_at": [0.0, 0.0, -1.0],
                   "vfov": 35.0, "defocus_angle": 0.0},
    "book_bubble": {"look_from": [-2.0, 2.0, 1.0],
                    "look_at": [0.0, 0.0, -1.0],
                    "vfov": 35.0, "defocus_angle": 0.0},
    "cornell_spheres": {"look_from": [0.0, 2.5, 9.5],
                        "look_at": [0.0, 1.7, 0.0],
                        "vfov": 36.0, "defocus_angle": 0.0},
    "mesh_terrain": {"look_from": [14.0, 6.0, 14.0],
                     "look_at": [0.0, 0.5, 0.0],
                     "vfov": 30.0, "defocus_angle": 0.0},
}
