"""Textures of the fused kernels: the host bake of the image LUTs, and the
plain PyTorch version of the texture step of the persistent body.

Port of ``wavefront_path_tracer_tpu/models/fused.py:_bake_image_luts``
(137) and of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
``_acos_approx`` (274), ``_atan2_approx`` (283), ``_apply_image_textures``
(298) and the checker select of the persistent body (2694-2702).  The
kernels' side is ``csrc/common.cuh`` (``apply_textures``).

After shade, for a hit:

- **checker**: ``sin(s px) sin(s py) sin(s pz) < 0`` selects the winner's
  second albedo; a checker scale ``s`` of 0 (a solid sphere, a triangle)
  never selects;
- **then image**: a sphere winner with an image slot takes the texel of
  its LUT at the equirect UV of the hit point, with the reference's
  polynomial acos/atan2 (the same float32 constants, the same order of
  operations), decoded from one 10:10:10 word.

The TPU evaluated each LUT as a select tree over immediates, per tile
that saw the sphere; here the LUT is a device table of int32 words,
``(image spheres, h * w)``, read one word per hit (book_checker: 2048
words, 8 KB, held by L1).  It is the same function with the same
values.  The reference identifies the image sphere by exact equality of
the winner's centre and 1/r with the LUT's; the port reads the winner's
slot, which :func:`image_luts` gives every sphere by that same rule, so
a sphere that shares its centre and signed radius with an image sphere
takes its texture too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_PI = 3.1415927
_HALF_PI = 1.5707963
_F32_PI = float(np.float32(_PI))
_F32_HALF_PI = float(np.float32(_HALF_PI))
_INV_2PI = float(np.float32(1.0 / (2.0 * _PI)))
_INV_PI = float(np.float32(1.0 / _PI))
_INV_1023 = float(np.float32(1.0 / 1023.0))
_MASK10 = 1023

# Texture events of the plain version (hits whose winner has a checker
# scale, hits on an image sphere), for the operation counts of a bound;
# the kernels count nothing.
EVENTS = {"checker": 0, "image": 0}


def bake_image_luts(scene_arrays, centers, lut_max: int = 2048):
    """The reference's ``_bake_image_luts``: per image-textured sphere (in
    scene order), (cx, cy, cz, 1/r, lut), the sphere's image mean-pooled
    to at most ``lut_max`` texels, halving only dimensions above 1 and
    dropping an odd last column or row.  ``1/r`` is a float64 Python
    float, rounded to float32 where it meets the kernel."""
    if "tex_data" not in scene_arrays:
        return ()
    kind = np.asarray(scene_arrays["tex_kind"])
    tid = np.asarray(scene_arrays["tex_id"])
    data = np.asarray(scene_arrays["tex_data"], np.float32)
    radii = np.asarray(scene_arrays["radii"])
    imgs = []
    for i in np.nonzero(kind == 2)[0]:
        lut = data[int(tid[i])]
        while lut.shape[0] * lut.shape[1] > lut_max:
            h, w = lut.shape[:2]
            if w > 1 and (w >= h or h == 1):
                lut = lut[:, : w // 2 * 2].reshape(
                    h, w // 2, 2, 3).mean(axis=2)
            else:
                lut = lut[: h // 2 * 2].reshape(
                    h // 2, 2, w, 3).mean(axis=1)
        imgs.append((float(centers[i, 0]), float(centers[i, 1]),
                     float(centers[i, 2]), 1.0 / float(radii[i]), lut))
    return tuple(imgs)


def pack_lut(lut) -> np.ndarray:
    """(h * w,) int32 words of a LUT, row-major: each channel clipped to
    [0, 1] and rounded to a 1/1023 grid in float64, ``r << 20 | g << 10
    | b`` (``_apply_image_textures``, pallas_kernels.py:346-349)."""
    q = np.clip(np.asarray(lut[..., :3], np.float64), 0.0, 1.0)
    q = np.round(q * 1023.0).astype(np.int64)
    packed = (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]
    return packed.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ImageLuts:
    """The image LUTs of a scene on one device: ``centres`` (slots, 4)
    float32 rows (centre xyz, 1/r), ``words`` (slots, h * w) int32 packed
    texels.  Every LUT has the one (h, w): the scene builder requires one
    image shape.  No slots: (0, 4) and (0, 1) tables."""

    centres: torch.Tensor
    words: torch.Tensor
    h: int
    w: int

    @property
    def n_slots(self) -> int:
        return self.centres.shape[0]

    def to(self, device) -> "ImageLuts":
        return dataclasses.replace(self, centres=self.centres.to(device),
                                   words=self.words.to(device))

    @staticmethod
    def empty() -> "ImageLuts":
        return ImageLuts(torch.zeros((0, 4)),
                         torch.zeros((0, 1), dtype=torch.int32), 1, 1)


def image_luts(scene_arrays, lut_max: int) -> tuple[ImageLuts, np.ndarray]:
    """(:class:`ImageLuts` on the CPU, per-sphere slot: int32, -1 for a
    sphere that takes no image texture) of a scene.  A sphere's slot is
    that of the last image sphere whose float32 centre and 1/r (rounded
    once from float64) equal its own: the reference's winner identity
    (``_apply_image_textures``, pallas_kernels.py:322-325, where a later
    LUT overwrites an earlier one)."""
    centers = np.asarray(scene_arrays["centers"])
    slot = np.full(centers.shape[0], -1, np.int32)
    luts = bake_image_luts(scene_arrays, centers, lut_max=lut_max)
    if not luts:
        return ImageLuts.empty(), slot
    c32 = centers.astype(np.float32)
    inv_r = (1.0 / np.asarray(scene_arrays["radii"]).astype(np.float64)
             ).astype(np.float32)
    images = np.nonzero(np.asarray(scene_arrays["tex_kind"]) == 2)[0]
    for k, i in enumerate(images):
        slot[(c32 == c32[i]).all(axis=1) & (inv_r == inv_r[i])] = k
    h, w = luts[0][4].shape[:2]
    centres = np.array([lut[:4] for lut in luts], np.float32)
    words = np.stack([pack_lut(lut[4]) for lut in luts])
    return (ImageLuts(torch.from_numpy(centres), torch.from_numpy(words),
                      int(h), int(w)), slot)


def acos_approx(x):
    """``_acos_approx`` (A&S 4.4.45) in its float32 order of operations."""
    a = torch.abs(x)
    base = torch.sqrt(torch.clamp_min(1.0 - a, 0.0)) * (
        1.5707288 + a * (-0.2121144 + a * (0.0742610 - 0.0187293 * a)))
    return torch.where(x < 0.0, _F32_PI - base, base)


def atan2_approx(y, x):
    """``_atan2_approx`` (A&S 4.4.49 core) in its float32 order of
    operations, with an IEEE division."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    z = torch.minimum(ax, ay) / torch.clamp_min(mx, 1e-30)
    z2 = z * z
    at = z * (0.9998660 + z2 * (-0.3302995 + z2 * (
        0.1801410 + z2 * (-0.0851330 + 0.0208351 * z2))))
    at = torch.where(ay > ax, _F32_HALF_PI - at, at)
    at = torch.where(x < 0.0, _F32_PI - at, at)
    return torch.where(y < 0.0, -at, at)


def texel_index(luts: ImageLuts, cx, cy, cz, inv_r, p_x, p_y, p_z):
    """Row-major texel index of the hit points on spheres (cx, cy, cz,
    1/r): the equirect UV, then ``clip(int((1 - v) h), 0, h - 1) * w +
    clip(int(u w), 0, w - 1)`` with truncating conversions."""
    nx = (p_x - cx) * inv_r
    ny = (p_y - cy) * inv_r
    nz = (p_z - cz) * inv_r
    u = (atan2_approx(-nz, nx) + _F32_PI) * _INV_2PI
    v = acos_approx(torch.clamp(-ny, -1.0, 1.0)) * _INV_PI
    h, w = luts.h, luts.w
    yi = ((1.0 - v) * h).to(torch.int64).clamp(0, h - 1)
    xi = (u * w).to(torch.int64).clamp(0, w - 1)
    return yi * w + xi


def decode(words):
    """Albedo rgb of 10:10:10 words, on their raw bits (int64 masks, since
    CPU torch has no uint32 shifts)."""
    words = words.to(torch.int64)
    return tuple(((words >> s) & _MASK10).to(torch.float32) * _INV_1023
                 for s in (20, 10, 0))


def apply_textures(luts: ImageLuts, a2r, a2g, a2b, scale, slot, p_x, p_y,
                   p_z, ar, ag, ab):
    """The texture step for hit rays (``_persistent_impl``, pallas_kernels
    .py:2694-2707): the checker select, then the image texel for winners
    with a slot (int64, -1 = none).  Returns the albedo (ar, ag, ab)."""
    EVENTS["checker"] += int((scale != 0.0).sum())
    sel = (torch.sin(scale * p_x) * torch.sin(scale * p_y)
           * torch.sin(scale * p_z)) < 0.0
    ar = torch.where(sel, a2r, ar)
    ag = torch.where(sel, a2g, ag)
    ab = torch.where(sel, a2b, ab)
    img = torch.nonzero(slot >= 0)[:, 0]
    EVENTS["image"] += img.numel()
    if img.numel():
        s = slot[img]
        c = luts.centres[s]
        idx = texel_index(luts, c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                          p_x[img], p_y[img], p_z[img])
        tr, tg, tb = decode(luts.words[s, idx])
        ar, ag, ab = (v.index_put((img,), t)
                      for v, t in ((ar, tr), (ag, tg), (ab, tb)))
    return ar, ag, ab
