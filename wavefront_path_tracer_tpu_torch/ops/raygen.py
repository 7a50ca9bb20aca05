"""Primary-ray generation on tensors: the segment path's raygen.

Port of ``wavefront_path_tracer_tpu/ops/raygen.py``: one (pixel, frame,
sample) stream, slot :data:`RAYGEN_STREAM`, drives the AA jitter and the
thin-lens draws; directions are unit length.  The persistent kernels
carry their own raygen (``ops/fused_kernels.raygen_tile``, from the
packed camera); this one works from the view and inverse projection
matrices, as the reference's XLA raygen does.

The 4x4 products are written out elementwise in float32, in a fixed
order (:func:`_apply_mat`): no ``matmul``, so no TF32 or reduced-
precision path on the card can touch them.  The reference computes them
as an XLA dot, whose summation order and multiply-add contraction are
its own, so the two agree to a few ulps, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops import rng

RAYGEN_STREAM = 0  # bounce slot 0 of the per-event RNG streams


def _apply_mat(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` (N, k) through the matrix ``m`` (j, k): out[:, j] =
    sum_k v[:, k] * m[j, k], summed in k order in float32 (one product
    and k - 1 sums over all j at once)."""
    prod = v[:, None, :] * m[None, :, :]
    acc = prod[..., 0]
    for k in range(1, m.shape[1]):
        acc = acc + prod[..., k]
    return acc


def _f32(m, device) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(m, np.float32)).to(device)


def generate_rays(pixel_idx: torch.Tensor, width: int, height: int, frame,
                  sample, cam, view, inv_proj, sampler: str = "random"):
    """Primary rays of the pixels ``pixel_idx`` (int64, on the target
    device) for one sample: (origin (N, 3), unit direction (N, 3)),
    float32.  ``cam`` is the :class:`GPUCamera`; ``view`` (world from
    camera) and ``inv_proj`` are 4x4 matrices, taken in float32.  Passed
    as tensors on the target device they are not copied, so nothing here
    waits for the device.  A pinhole ray starts at the view matrix's
    translation column, the float32 camera position (the reference takes
    ``cam.position``, the same value).

    ``sampler="stratified"`` remaps the two AA uniforms onto a 4x4
    stratum grid cycling with the sample index, with the same draws.
    """
    device = pixel_idx.device
    f32 = torch.float32
    view = _f32(view, device)
    inv_proj = _f32(inv_proj, device)
    x = (pixel_idx % width).to(f32)
    y = (pixel_idx // width).to(f32)

    state = rng.stream_state(pixel_idx, frame, sample, RAYGEN_STREAM)
    if sampler == "stratified":
        state, u1 = rng.next_f32(state)
        state, u2 = rng.next_f32(state)
        s = int(sample) & rng.MASK32
        u1 = (float(s & 3) + u1) * 0.25
        u2 = (float((s >> 2) & 3) + u2) * 0.25
        r_aa = torch.sqrt(u1)
        alpha = rng.TWO_PI * u2
        ox, oy = r_aa * torch.cos(alpha), r_aa * torch.sin(alpha)
    else:
        state, ox, oy = rng.sample_unit_disk(state)

    # NDC with y flipped, then unprojected through inv_proj @ (ndc, 1, 1).
    ndc_x = 2.0 * ((x + ox) / float(width)) - 1.0
    ndc_y = 2.0 * (1.0 - (y + oy) / float(height)) - 1.0
    ones = torch.ones_like(ndc_x)
    pp = _apply_mat(inv_proj, torch.stack([ndc_x, ndc_y, ones, ones], -1))
    pp = pp[:, :3] / pp[:, 3:4]

    rot = view[:3, :3]
    if cam.defocus_radius > 0.0:
        # Thin lens: jitter the origin on the lens disk and retarget
        # through the focal plane.
        state, lx, ly = rng.sample_unit_disk(state)
        dr = float(cam.defocus_radius)
        p_lens = torch.stack([dr * lx, dr * ly, torch.zeros_like(lx)], -1)
        origin = _apply_mat(rot, p_lens) + view[:3, 3]
        tf = float(cam.focus_distance) / pp[:, 2:3]
        pp = tf * pp - p_lens
    else:
        origin = view[:3, 3].expand(pp.shape).clone()
    d = _apply_mat(rot, pp)
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    return origin, d / norm[:, None]
