"""The fused persistent-lane render: scene packing, the plain PyTorch
version, and the wrapper that launches the CUDA kernel.

Port of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
``pack_scene`` (3296), ``_raygen_tile`` (461), ``_intersect_tile`` (106),
``_shade_tile`` (167) and ``fused_render_persistent`` (3098) with its body
``_persistent_impl`` (2451).  The kernel is ``csrc/persistent.cu``.  The
plain segment loop of ``_segment_impl`` (2785), over any nearest-hit
function, is here too (:func:`segment_reference`).

Planes follow the reference layout: (R, 128) tensors of lanes, where
``pix`` and ``soff`` hold 32-bit words in ``torch.int32`` storage, and
``xs``, ``ys`` and ``valid`` are float32.  ``salts`` are four host ints
[frame, sample_base, max_bounces, samples per lane]; ``cam_params`` is a
(24,) float32 tensor on the planes' device (layout: :func:`raygen_tile`).
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.rng import (
    BOUNCE_STRIDE,
    MASK32,
    RR_SALT,
    SAMPLE_STRIDE,
    as_u32,
    jenkins_hash,
    mul32,
    next_f32,
    next_u32,
)
from wavefront_path_tracer_tpu_torch.ops.textures import apply_textures

T_MIN = 0.001
T_FAR = 1e30
LANES = 128
_TWO_PI = 2.0 * 3.1415927
_SPHERE_BLOCK = 64
_LANE_CHUNK = 131072   # lanes per pass of the plain version (bounds memory)

# Kernel launches by fused_render_persistent on a CUDA tensor (of which
# WARP_LAUNCHES in loop form LOOP_WARP).
LAUNCHES = 0
WARP_LAUNCHES = 0

# The persistent kernel's loop forms (csrc/persistent.cu), both with the
# plain version's results: LOOP_LANE runs each lane's samples and bounces
# on its own thread (common.cuh trace_lane); LOOP_WARP, the default, runs
# the warp's lanes in step (trace_warp): each trip, every lane with a ray
# sweeps the table together, and a lane starts its next sample on the trip
# after its path ends.
LOOP_LANE, LOOP_WARP = 0, 1

# Lanes of a warp, in lane order.  A warp runs its loop until its last
# lane is done, so the ``iterations`` counter counts each warp's largest
# ray count: the reference's lockstep loop trips (``niter``), for a warp
# of 32 lanes where a TPU tile held tile_rows x 128 = 1024.
WARP = 32


def warp_max(lane_rays: torch.Tensor) -> torch.Tensor:
    """Each warp's loop trips from a plane of per-lane ray counts in
    lane order: the largest count of each group of :data:`WARP` lanes
    (the last group padded with zeros), in the plane's dtype."""
    flat = lane_rays.reshape(-1)
    pad = -flat.numel() % WARP
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, WARP).amax(dim=1)


def warp_trips(lane_rays: torch.Tensor) -> torch.Tensor:
    """The warps' loop trips summed (a 0-d int64 tensor): the
    ``iterations`` counter of a persistent launch."""
    return warp_max(lane_rays.to(torch.int64)).sum()


def sample_trips(per_sample_rays: torch.Tensor) -> torch.Tensor:
    """The loop trips of a warp loop whose lanes regroup at every sample
    end, from ``per_sample_rays`` (S, lanes): each lane's rays in each of
    its S samples, in lane order.  Each sample costs each warp its
    largest per-lane ray count in that sample; the sum over samples and
    warps (a 0-d int64 tensor).  Beside :func:`warp_trips` of the summed
    rays (the trips of ``common.cuh`` trace_warp, where a lane starts its
    next sample on the next trip) it is the count model of the two loop
    forms: never fewer trips, and equal at one sample."""
    rays = per_sample_rays.to(torch.int64)
    return sum((warp_max(r).sum() for r in rays),
               torch.zeros((), dtype=torch.int64, device=rays.device))


def sample_rays(intersect, salts, cam_params, pix, xs, ys, valid, soff,
                **kw) -> torch.Tensor:
    """(samples, lanes) int64: each lane's rays in each of its samples, in
    the flat planes' lane order, from :func:`persistent_reference` over
    ``intersect`` run one sample at a time (``salts`` [frame, sample_base,
    max_bounces, n]: sample s is the run with [frame, sample_base + s,
    max_bounces, 1]).  ``kw`` goes to :func:`persistent_reference`."""
    frame, sample_base, max_bounces, n_samples = _salts(salts)
    n_lanes = pix.numel()
    out = torch.zeros((n_samples, n_lanes), dtype=torch.int64,
                      device=pix.device)
    for s in range(n_samples):
        row = out[s]

        def observe(lanes, row=row):
            row.index_add_(0, lanes, torch.ones_like(lanes))

        persistent_reference(intersect, (frame, sample_base + s, max_bounces,
                                         1), cam_params, pix, xs, ys, valid,
                             soff, observe=observe, **kw)
    return out


def pack_scene(scene_arrays, pad_to: int = 8, device="cpu") -> torch.Tensor:
    """Scene SoA tables -> one (S, 16) float32 table on ``device``.

    Columns: 0-2 centre xyz, 3 radius, 4-6 albedo rgb, 7 fuzz, 8 ior,
    9 mat_type (as f32), 10-15 reserved.  S is the sphere count rounded
    up to ``pad_to``; padding rows are NaN, so no nearest-hit compare
    can pick them.  Byte-identical to the reference ``pack_scene``.
    """
    def host(key):
        v = scene_arrays[key]
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        return np.asarray(v)

    centers = host("centers")
    n = centers.shape[0]
    s = ((n + pad_to - 1) // pad_to) * pad_to
    packed = np.full((s, 16), np.nan, np.float32)
    packed[:n, 0:3] = centers
    packed[:n, 3] = host("radii")
    packed[:n, 4:7] = host("albedo")
    packed[:n, 7] = host("fuzz")
    packed[:n, 8] = host("refract_idx")
    packed[:n, 9] = host("mat_type").astype(np.float32)
    return torch.from_numpy(packed).to(device)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def raygen_tile(xs, ys, pix, frame, sample, cam, sampler: str = "random"):
    """Primary rays for lanes (the reference ``_raygen_tile``).

    ``pix`` and ``sample`` are int64 tensors of 32-bit words; ``cam`` is
    the (24,) float32 camera: [0:9] view rotation row-major, [9:12]
    position, [12] w_scale, [13] h_scale, [14] z_far, [15] defocus
    radius, [16] focus distance, [17] width, [18] height.
    Returns (ox, oy, oz, dx, dy, dz) with a unit direction.
    """
    state = jenkins_hash(as_u32(pix) ^ jenkins_hash(as_u32(frame)))
    state = jenkins_hash((state + mul32(as_u32(sample), SAMPLE_STRIDE))
                         & MASK32)
    state, u1 = next_f32(state)
    state, u2 = next_f32(state)
    state, u3 = next_f32(state)
    state, u4 = next_f32(state)
    if sampler == "stratified":
        sample = as_u32(sample)
        u1 = (_f32(sample & 3) + u1) * 0.25
        u2 = (_f32((sample >> 2) & 3) + u2) * 0.25

    r_aa = torch.sqrt(u1)
    a_aa = _TWO_PI * u2
    ox_j = r_aa * torch.cos(a_aa)
    oy_j = r_aa * torch.sin(a_aa)
    ndc_x = 2.0 * ((xs + ox_j) / cam[17]) - 1.0
    ndc_y = 2.0 * (1.0 - (ys + oy_j) / cam[18]) - 1.0

    zf = cam[14]
    ppx = cam[12] * ndc_x * zf
    ppy = cam[13] * ndc_y * zf
    ppz = torch.full_like(ppx, 1.0) * zf

    dr = cam[15]
    r_l = torch.sqrt(u3)
    a_l = _TWO_PI * u4
    plx = dr * (r_l * torch.cos(a_l))
    ply = dr * (r_l * torch.sin(a_l))
    tf = cam[16] / ppz
    ppx = tf * ppx - plx
    ppy = tf * ppy - ply
    ppz = tf * ppz

    r = cam[:9]
    ox = r[0] * plx + r[1] * ply + cam[9]
    oy = r[3] * plx + r[4] * ply + cam[10]
    oz = r[6] * plx + r[7] * ply + cam[11]
    dx = r[0] * ppx + r[1] * ppy + r[2] * ppz
    dy = r[3] * ppx + r[4] * ppy + r[5] * ppz
    dz = r[6] * ppx + r[7] * ppy + r[8] * ppz
    inv = torch.rsqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-37))
    return ox, oy, oz, dx * inv, dy * inv, dz * inv


def intersect_tile(scene_packed, n_spheres: int, ox, oy, oz, dx, dy, dz):
    """Nearest hit of each ray over the table (the reference
    ``_intersect_tile``).

    Spheres are swept in table order in blocks; inside a block the
    per-sphere ``t`` is first made NaN-free (a NaN row, like a miss,
    gives ``T_FAR``, because NaN fails every compare) and the first
    minimal index wins, and across blocks a block's minimum replaces the
    running best only when strictly smaller.  That is the reference's
    strict ``t < best_t`` walk: the first index wins ties and a padding
    row never wins.  Returns (best_t, cx, cy, cz, 1/r, albedo rgb, fuzz,
    ior, mat_type); a miss carries (T_FAR, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0).
    """
    n_rows = min(scene_packed.shape[0], (n_spheres + 7) // 8 * 8)
    a_q = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a_q
    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    col = lambda v: v[:, None]  # noqa: E731
    for lo in range(0, n_rows, _SPHERE_BLOCK):
        blk = scene_packed[lo:lo + _SPHERE_BLOCK]
        cx, cy, cz, r = blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3]
        ocx = col(ox) - cx
        ocy = col(oy) - cy
        ocz = col(oz) - cz
        b_q = col(dx) * ocx + col(dy) * ocy + col(dz) * ocz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_q * b_q - col(a_q) * c_q
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b_q - sq) * col(inv_a)
        t2 = (-b_q + sq) * col(inv_a)
        t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, T_FAR))
        t = torch.where(disc >= 0.0, t, T_FAR)
        k = torch.argmin(t, dim=1)
        t_k = torch.gather(t, 1, k[:, None])[:, 0]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, k + lo, best_i)
    hit = best_i >= 0
    row = scene_packed[best_i.clamp_min(0)]
    miss_row = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0,
                             0.0], dtype=torch.float32, device=ox.device)
    row = torch.where(hit[:, None], row[:, :10], miss_row)
    inv_r = torch.where(hit, 1.0 / row[:, 3], 1.0)
    return (best_t, row[:, 0], row[:, 1], row[:, 2], inv_r,
            row[:, 4], row[:, 5], row[:, 6], row[:, 7], row[:, 8], row[:, 9])


def shade_tile(pix, frame, sample, bounce, ox, oy, oz, dx, dy, dz,
               best_t, b_cx, b_cy, b_cz, b_inv_r, b_fuzz, b_ior, b_mt,
               b_nx=None, b_ny=None, b_nz=None, b_is_tri=None):
    """Branchless RTIOW shading (the reference ``_shade_tile``): hit
    point and unit scattered direction, from the stream of event slot
    ``bounce + 1``.  Triangle winners (``b_is_tri`` > 0) take their
    geometric normal, flipped toward the ray unless dielectric."""
    base = jenkins_hash(as_u32(pix) ^ jenkins_hash(as_u32(frame)))
    state = jenkins_hash(
        (base + mul32(as_u32(sample), SAMPLE_STRIDE)
         + mul32(as_u32(bounce) + 1, BOUNCE_STRIDE)) & MASK32)
    state, _ = next_u32(state)   # ball-radius draw: unused, advances
    state, u2 = next_f32(state)
    state, u3 = next_f32(state)
    state, r_reflect = next_f32(state)

    cos_th = 1.0 - 2.0 * u2
    sin_th = torch.sqrt(torch.clamp_min(1.0 - cos_th * cos_th, 0.0))
    phi = _TWO_PI * u3
    sx = sin_th * torch.cos(phi)
    sy = sin_th * torch.sin(phi)
    sz = cos_th

    p_x = ox + best_t * dx
    p_y = oy + best_t * dy
    p_z = oz + best_t * dz
    nx = (p_x - b_cx) * b_inv_r
    ny = (p_y - b_cy) * b_inv_r
    nz = (p_z - b_cz) * b_inv_r
    n_norm = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-37))
    nx, ny, nz = nx * n_norm, ny * n_norm, nz * n_norm
    if b_is_tri is not None:
        is_tri = b_is_tri > 0
        d_dot_tn = dx * b_nx + dy * b_ny + dz * b_nz
        flip = (d_dot_tn > 0.0) & (b_mt != 2.0)   # dielectrics self-flip
        nx = torch.where(is_tri, torch.where(flip, -b_nx, b_nx), nx)
        ny = torch.where(is_tri, torch.where(flip, -b_ny, b_ny), ny)
        nz = torch.where(is_tri, torch.where(flip, -b_nz, b_nz), nz)

    lx, ly, lz = nx + sx, ny + sy, nz + sz
    degen = lx * lx + ly * ly + lz * lz < 1e-6
    lx = torch.where(degen, nx, lx)
    ly = torch.where(degen, ny, ly)
    lz = torch.where(degen, nz, lz)

    d_dot_n = dx * nx + dy * ny + dz * nz
    mx = (dx - 2.0 * d_dot_n * nx) + b_fuzz * sx
    my = (dy - 2.0 * d_dot_n * ny) + b_fuzz * sy
    mz = (dz - 2.0 * d_dot_n * nz) + b_fuzz * sz

    cos_theta = torch.clamp_max(-d_dot_n, 1.0)
    outside = cos_theta >= 0.0
    eta = torch.where(outside, 1.0 / b_ior, b_ior)
    fnx = torch.where(outside, nx, -nx)
    fny = torch.where(outside, ny, -ny)
    fnz = torch.where(outside, nz, -nz)
    cos_theta = torch.abs(cos_theta)
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    one_m = 1.0 - cos_theta
    om2 = one_m * one_m
    reflectance = r0 + (1.0 - r0) * om2 * om2 * one_m
    cos_in = dx * fnx + dy * fny + dz * fnz
    kk = 1.0 - eta * eta * (1.0 - cos_in * cos_in)
    coef = eta * cos_in + torch.sqrt(torch.clamp_min(kk, 0.0))
    take_refract = (kk >= 0.0) & (reflectance <= r_reflect)
    gx = torch.where(take_refract, eta * dx - coef * fnx,
                     dx - 2.0 * cos_in * fnx)
    gy = torch.where(take_refract, eta * dy - coef * fny,
                     dy - 2.0 * cos_in * fny)
    gz = torch.where(take_refract, eta * dz - coef * fnz,
                     dz - 2.0 * cos_in * fnz)

    is_metal = b_mt == 1.0
    is_glass = b_mt == 2.0
    ndx = torch.where(is_glass, gx, torch.where(is_metal, mx, lx))
    ndy = torch.where(is_glass, gy, torch.where(is_metal, my, ly))
    ndz = torch.where(is_glass, gz, torch.where(is_metal, mz, lz))
    inv_len = torch.rsqrt(torch.clamp_min(ndx * ndx + ndy * ndy + ndz * ndz,
                                          1e-24))
    return p_x, p_y, p_z, ndx * inv_len, ndy * inv_len, ndz * inv_len


def _salts(salts) -> tuple[int, int, int, int]:
    vals = [int(v) & MASK32 for v in salts]
    if len(vals) != 4:
        raise ValueError(f"salts must hold 4 values, got {len(vals)}")
    return tuple(vals)


def persistent_reference(
        intersect, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", images=None, hinted: bool = False,
        observe=None, probe=frozenset(), lane_counts: bool = False):
    """The plain persistent-lane loop, over any nearest-hit function.

    ``intersect(ox, oy, oz, dx, dy, dz)`` returns the
    :func:`intersect_tile` tuple, extended with the triangle winner's
    (nx, ny, nz, is_tri) in a scene with triangles, followed by the
    per-ray supers and clusters entered (int64 tensors, or None without
    culling).  With ``images`` (the scene's ``ops/textures.ImageLuts``)
    the scene is textured: the tuple always carries the triangle fields
    and then the winner's (albedo2 rgb, checker scale, image slot), and
    the texture step runs after shade.  With ``hinted`` the intersect
    takes a fifth argument, each ray's winner hint (int64: its lane's
    state, -1 at the lane's start), and returns the rays' new hints
    before the counters; the lane keeps it across samples.  The loop
    runs in lockstep, samples outside and bounces inside, over the flat
    lanes of a chunk, keeping only the live paths at each bounce.  Every
    (pixel, sample, bounce) stream, formula and rounding is the CUDA
    kernels' (``csrc/common.cuh``), and each lane sums its samples in the
    same order, so on the card the two agree bit for bit.  Returns
    (rad_r, rad_g, rad_b, stats) with stats = [rays, iterations, supers,
    clusters] as int64, iterations by :func:`warp_trips` of each lane's
    rays.  ``observe(lanes)``, where given, is called before each
    intersect call with the lanes (int64 indices into the flat planes)
    whose rays it traces, in the order of its rays.  With
    ``lane_counts`` a fifth value follows: each lane's [rays, supers,
    clusters] as a (3, *pix.shape) int64 tensor, the counters the
    kernels keep a lane.

    ``probe`` (names of ``ops/stage_probes.py``) duplicates the loop's
    stages as the kernels' probes do (``csrc/common.cuh`` trace_warp and
    bounce_finish): ``dbl_raygen`` and ``dbl_shade`` run raygen or shade
    a second time from xs or the origin plus 0 and take the mean of the
    two equal results, ``dbl_accum`` adds the sky contribution as two
    halves, the second plus 0 (rounding unlike one add), and
    ``dbl_loopcond`` takes the loop's condition twice.  The intersect's
    own probes are the intersect's.
    """
    frame, sample_base, max_bounces, n_samples = _salts(salts)
    shape = pix.shape
    device = pix.device
    pix_f = pix.reshape(-1).to(torch.int64) & MASK32
    soff_f = soff.reshape(-1).to(torch.int64) & MASK32
    xs_f, ys_f = xs.reshape(-1), ys.reshape(-1)
    valid_f = valid.reshape(-1) > 0
    n_lanes = pix_f.shape[0]
    acc = torch.zeros((n_lanes, 3), dtype=torch.float32, device=device)
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    lane_rays = torch.zeros(n_lanes, dtype=torch.int64, device=device)
    lane_cull = torch.zeros((2, n_lanes), dtype=torch.int64, device=device)
    hints = torch.full((n_lanes,), -1, dtype=torch.int64, device=device)

    for lo in range(0, n_lanes, _LANE_CHUNK):
        lanes = torch.nonzero(valid_f[lo:lo + _LANE_CHUNK])[:, 0] + lo
        for s in range(n_samples):
            live = lanes
            p = pix_f[live]
            sample = (sample_base + soff_f[live] + s) & MASK32
            ray = raygen_tile(xs_f[live], ys_f[live], p, frame, sample,
                              cam_params, sampler=sampler)
            if "dbl_raygen" in probe:
                ray2 = raygen_tile(xs_f[live] + 0.0, ys_f[live], p, frame,
                                   sample, cam_params, sampler=sampler)
                ray = tuple(0.5 * (a + b) for a, b in zip(ray, ray2))
            ox, oy, oz, dx, dy, dz = ray
            thr = torch.ones((live.shape[0], 3), dtype=torch.float32,
                             device=device)
            bounce = 0
            while _trip(live, probe):
                counts[0] += live.numel()
                lane_rays.index_add_(0, live, torch.ones_like(live))
                if observe is not None:
                    observe(live)
                if hinted:
                    *fields, hint, supers, clusters = intersect(
                        ox, oy, oz, dx, dy, dz, hints[live])
                    hints[live] = hint
                else:
                    *fields, supers, clusters = intersect(ox, oy, oz, dx,
                                                          dy, dz)
                (best_t, b_cx, b_cy, b_cz, b_inv_r, b_ar, b_ag, b_ab,
                 b_fuzz, b_ior, b_mt) = fields[:11]
                tri_fields = fields[11:15]
                tex_fields = fields[15:]
                if supers is not None:
                    counts[1] += supers.sum()
                    counts[2] += clusters.sum()
                    if lane_counts:
                        lane_cull[0].index_add_(0, live, supers)
                        lane_cull[1].index_add_(0, live, clusters)
                hit = best_t < T_FAR
                miss = ~hit
                sky_a = 0.5 * (dy[miss] + 1.0)
                sky = torch.stack([(1.0 - sky_a) + sky_a * 0.5,
                                   (1.0 - sky_a) + sky_a * 0.7,
                                   (1.0 - sky_a) + sky_a * 1.0], dim=-1)
                con = thr[miss] * sky
                if clamp > 0.0:
                    con = torch.clamp_max(con, clamp)
                # Gather, add, scatter rather than index_add_: CUDA's float
                # atomics flush subnormals to zero.  Lanes are unique here.
                idx = live[miss]
                if "dbl_accum" in probe:
                    acc[idx] = acc[idx] + con * 0.5
                    acc[idx] = acc[idx] + (con * 0.5 + 0.0)
                else:
                    acc[idx] = acc[idx] + con

                keep = torch.nonzero(hit)[:, 0]
                sel = lambda v: v[keep]  # noqa: E731
                live, p, sample, thr = sel(live), sel(p), sel(sample), sel(thr)
                ox, oy, oz, dx, dy, dz = map(sel, (ox, oy, oz, dx, dy, dz))
                winner = tuple(map(sel, (best_t, b_cx, b_cy, b_cz, b_inv_r,
                                         b_fuzz, b_ior, b_mt, *tri_fields)))
                shaded = shade_tile(p, frame, sample, bounce, ox, oy, oz, dx,
                                    dy, dz, *winner)
                if "dbl_shade" in probe:
                    shaded2 = shade_tile(p, frame, sample, bounce, ox + 0.0,
                                         oy, oz, dx, dy, dz, *winner)
                    shaded = tuple(0.5 * (a + b)
                                   for a, b in zip(shaded, shaded2))
                ox, oy, oz, dx, dy, dz = shaded
                albedo = tuple(map(sel, (b_ar, b_ag, b_ab)))
                if images is not None:
                    # ox, oy, oz now hold the hit points.
                    albedo = apply_textures(images, *map(sel, tex_fields),
                                            ox, oy, oz, *albedo)
                thr = thr * torch.stack(albedo, dim=-1)
                bounce += 1
                if rr_start and bounce >= rr_start:
                    base = jenkins_hash(p ^ jenkins_hash(as_u32(frame)))
                    st = jenkins_hash(
                        ((base + mul32(sample, SAMPLE_STRIDE)
                          + mul32(as_u32(bounce), BOUNCE_STRIDE))
                         & MASK32) ^ RR_SALT)
                    _, u_rr = next_f32(st)
                    keep_p = torch.clamp(thr.max(dim=-1).values,
                                         rr_floor, 1.0)
                    survive = u_rr < keep_p
                    thr = torch.where(survive[:, None],
                                      thr * (1.0 / keep_p)[:, None], thr)
                    keep = torch.nonzero(survive)[:, 0]
                    live, p, sample, thr = (sel(live), sel(p), sel(sample),
                                            sel(thr))
                    ox, oy, oz, dx, dy, dz = map(sel, (ox, oy, oz, dx, dy,
                                                      dz))
                if bounce >= max_bounces:
                    break

    rad = acc.reshape(*shape, 3)
    stats = torch.stack([counts[0], warp_trips(lane_rays), counts[1],
                         counts[2]])
    if lane_counts:
        lanes = torch.cat([lane_rays[None], lane_cull]).reshape(3, *shape)
        return rad[..., 0], rad[..., 1], rad[..., 2], stats, lanes
    return rad[..., 0], rad[..., 1], rad[..., 2], stats


def _trip(live: torch.Tensor, probe) -> bool:
    """Whether the loop goes on: some path is live.  Under the
    ``dbl_loopcond`` probe the condition is taken a second time, as the
    kernels take the trip vote twice (the plain loop is not a warp's, so
    this only keeps the stage's work)."""
    go = live.numel() > 0
    if "dbl_loopcond" in probe:
        go = go & (live.numel() + 0 > 0)
    return go


# The state of the segment path (the reference's _SEG_STATE planes, with
# the bounce counter moved to the integer planes): SEG_STATE float32 rows
# of o xyz, d xyz, throughput rgb, radiance rgb, alive, and SEG_IDS int32
# rows of pix, sample, bounce, slot (32-bit words).  SEG_COUNTS int32
# rows of rays, supers and clusters entered per lane, and the loop trips
# of warp w (lanes w * WARP to w * WARP + WARP - 1) at entry w of row 3.
SEG_STATE = 13
SEG_IDS = 4
SEG_COUNTS = 4


def segment_reference(intersect, salts, ids, state, counts, *,
                      rr_start: int = 0, rr_floor: float = 0.05,
                      clamp: float = 0.0, images=None):
    """The plain segment loop (the reference's ``_segment_impl``), over
    any nearest-hit function: at most ``k_iters`` bounces of every live
    lane's path, from the state ``state`` (SEG_STATE, N) float32 and
    ``ids`` (SEG_IDS, N) int32, which it updates in place; ``counts``
    (SEG_COUNTS, N) int32 gains each lane's rays, supers and clusters
    entered, and each warp's loop trips in this launch (the largest of
    its lanes' rays in this launch) at the warp's entry of row 3.

    ``salts`` are [frame, max_bounces, k_iters, 0].  ``intersect`` and
    ``images`` are as for :func:`persistent_reference` (no winner hint).
    Per ray, the arithmetic and its order are :func:`persistent_reference`'s
    and the kernels' (``csrc/common.cuh`` bounce_step): a miss adds
    throughput x sky to the lane's radiance and ends it; a hit shades,
    scatters and runs roulette from ``rr_start``; a path ends after
    ``max_bounces`` surface events.  A lane's bounce counter stops where
    its path ends.  Returns (ids, state, counts)."""
    frame, max_bounces, k_iters, _ = _salts(salts)
    live = torch.nonzero(state[12] > 0)[:, 0]
    p = ids[0, live].to(torch.int64) & MASK32
    sample = ids[1, live].to(torch.int64) & MASK32
    bounce = ids[2, live].to(torch.int64)
    ox, oy, oz, dx, dy, dz = (state[k, live] for k in range(6))
    thr = state[6:9, live].T
    base = jenkins_hash(p ^ jenkins_hash(as_u32(frame)))
    launch_rays = torch.zeros_like(counts[0])
    for _ in range(k_iters):
        if not live.numel():
            break
        counts[0, live] += 1
        launch_rays[live] += 1
        *fields, supers, clusters = intersect(ox, oy, oz, dx, dy, dz)
        (best_t, b_cx, b_cy, b_cz, b_inv_r, b_ar, b_ag, b_ab,
         b_fuzz, b_ior, b_mt) = fields[:11]
        tri_fields = fields[11:15]
        tex_fields = fields[15:]
        if supers is not None:
            counts[1, live] += supers.to(torch.int32)
            counts[2, live] += clusters.to(torch.int32)
        hit = best_t < T_FAR
        miss = ~hit
        sky_a = 0.5 * (dy[miss] + 1.0)
        sky = torch.stack([(1.0 - sky_a) + sky_a * 0.5,
                           (1.0 - sky_a) + sky_a * 0.7,
                           (1.0 - sky_a) + sky_a * 1.0])
        con = thr[miss].T * sky
        if clamp > 0.0:
            con = torch.clamp_max(con, clamp)
        idx = live[miss]
        state[9:12, idx] = state[9:12, idx] + con
        state[12, idx] = 0.0

        keep = torch.nonzero(hit)[:, 0]
        sel = lambda v: v[keep]  # noqa: E731
        live, p, sample, bounce, base, thr = map(
            sel, (live, p, sample, bounce, base, thr))
        ox, oy, oz, dx, dy, dz = shade_tile(
            p, frame, sample, bounce, *map(sel, (ox, oy, oz, dx, dy, dz)),
            *map(sel, (best_t, b_cx, b_cy, b_cz, b_inv_r, b_fuzz, b_ior,
                       b_mt, *tri_fields)))
        albedo = tuple(map(sel, (b_ar, b_ag, b_ab)))
        if images is not None:
            albedo = apply_textures(images, *map(sel, tex_fields),
                                    ox, oy, oz, *albedo)
        thr = thr * torch.stack(albedo, dim=-1)
        bounce = bounce + 1
        go_on = bounce < max_bounces
        if rr_start:
            st = jenkins_hash(
                ((base + mul32(sample, SAMPLE_STRIDE)
                  + mul32(bounce, BOUNCE_STRIDE)) & MASK32) ^ RR_SALT)
            _, u_rr = next_f32(st)
            keep_p = torch.clamp(thr.max(dim=-1).values, rr_floor, 1.0)
            active = bounce >= rr_start
            survive = u_rr < keep_p
            thr = torch.where((active & survive)[:, None],
                              thr * (1.0 / keep_p)[:, None], thr)
            go_on = go_on & (survive | ~active)
        for k, v in enumerate((ox, oy, oz, dx, dy, dz)):
            state[k, live] = v
        state[6:9, live] = thr.T
        state[12, live] = go_on.to(torch.float32)
        ids[2, live] = bounce.to(torch.int32)

        keep = torch.nonzero(go_on)[:, 0]
        live, p, sample, bounce, base, thr = map(
            sel, (live, p, sample, bounce, base, thr))
        ox, oy, oz, dx, dy, dz = map(sel, (ox, oy, oz, dx, dy, dz))
    trips = warp_max(launch_rays)
    counts[3, :trips.shape[0]] += trips
    return ids, state, counts


def check_segment(ids, state, counts, tables):
    """Validate the segment state and ``tables`` (as for
    :func:`check_inputs`); returns the one device they all lie on."""
    n = state.shape[-1]
    for name, t, rows, dtype in (("state", state, SEG_STATE, torch.float32),
                                 ("ids", ids, SEG_IDS, torch.int32),
                                 ("counts", counts, SEG_COUNTS,
                                  torch.int32)):
        if (t.shape != (rows, n) or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({rows}, {n}) "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_tables(tables)
    devices = {t.device for t in (ids, state, counts)}
    devices |= {t.device for t, _cols, _dtype in tables.values()}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {devices}")
    return devices.pop()


def fused_render_persistent_reference(
        scene_packed, n_spheres, salts, cam_params, pix, xs, ys, valid, soff,
        *, rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random"):
    """Plain PyTorch version of the persistent-lane kernel: the
    :func:`persistent_reference` loop over :func:`intersect_tile`.  Same
    arguments and results as :func:`fused_render_persistent`."""
    n_spheres = int(n_spheres)

    def intersect(ox, oy, oz, dx, dy, dz):
        return intersect_tile(scene_packed, n_spheres, ox, oy, oz, dx, dy,
                              dz) + (None, None)

    return persistent_reference(
        intersect, salts, cam_params, pix, xs, ys, valid, soff,
        rr_start=rr_start, rr_floor=rr_floor, clamp=clamp, sampler=sampler)


def check_inputs(cam_params, planes, tables):
    """Validate the lane planes, the camera and ``tables`` ({name:
    (tensor, columns, dtype)}: contiguous 2-D tables); returns the one
    device they all lie on."""
    pix, xs, ys, valid, soff = planes
    shape = pix.shape
    if len(shape) != 2 or shape[1] != LANES:
        raise ValueError(f"planes must be (R, {LANES}), got {tuple(shape)}")
    for name, t, dtype in (("pix", pix, torch.int32), ("xs", xs, torch.float32),
                           ("ys", ys, torch.float32),
                           ("valid", valid, torch.float32),
                           ("soff", soff, torch.int32)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} plane of "
                             f"shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _check_tables(tables)
    if (cam_params.shape != (24,) or cam_params.dtype != torch.float32
            or not cam_params.is_contiguous()):
        raise ValueError("cam_params must be a contiguous (24,) float32 "
                         "tensor")
    devices = {t.device for t in (cam_params, *planes)}
    devices |= {t.device for t, _cols, _dtype in tables.values()}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {devices}")
    return devices.pop()


def _check_tables(tables) -> None:
    for name, (t, cols, dtype) in tables.items():
        if (t.dim() != 2 or t.shape[1] != cols or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (N, {cols}) "
                             f"{dtype} table, got {t.dtype} "
                             f"{tuple(t.shape)}")


def check_aligned(**tensors) -> None:
    """Raise unless every non-empty tensor starts on a 16-byte boundary
    (the kernels read tables as float4 / int2)."""
    for name, t in tensors.items():
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_render_persistent(
        scene_packed, n_spheres, salts, cam_params, pix, xs, ys, valid, soff,
        *, rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", loop: int = LOOP_WARP):
    """All samples x all bounces of every lane, persistent lanes.

    Returns (rad_r, rad_g, rad_b, stats): radiance sums over the lane's
    samples as (R, 128) float32 planes in lane order, and an int64
    tensor [rays, iterations, 0, 0].  ``iterations`` counts loop trips
    per warp (:func:`warp_trips` of each lane's rays: a warp of 32 lanes
    where the TPU kernel's lockstep tile held 1024); the last two slots
    are the cull counters, zero without culling.

    ``loop`` picks the kernel's loop form (:data:`LOOP_WARP` or
    :data:`LOOP_LANE`); both give the same results.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/persistent.cu`` on the current stream; any other device
    raises.  The kernel's results are bit-identical to the plain
    version's.  The TPU kernel's tile rows and lane rotation only
    schedule lanes on the TPU, so they have no counterpart here.
    """
    global LAUNCHES, WARP_LAUNCHES
    planes = (pix, xs, ys, valid, soff)
    device = check_inputs(cam_params, planes,
                          {"scene_packed": (scene_packed, 16, torch.float32)})
    if sampler not in ("random", "stratified"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if loop not in (LOOP_LANE, LOOP_WARP):
        raise ValueError(f"unknown loop form {loop}")
    if device.type == "cpu":
        return fused_render_persistent_reference(
            scene_packed, n_spheres, salts, cam_params, *planes,
            rr_start=rr_start, rr_floor=rr_floor, clamp=clamp,
            sampler=sampler)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_render_persistent runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import load_library

    frame, sample_base, max_bounces, n_samples = _salts(salts)
    check_aligned(scene_packed=scene_packed)
    n_rows = min(scene_packed.shape[0], (int(n_spheres) + 7) // 8 * 8)
    lib = load_library()
    rad_r = torch.empty_like(xs)
    rad_g = torch.empty_like(xs)
    rad_b = torch.empty_like(xs)
    rays = torch.empty(pix.shape, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_persistent_launch(
            scene_packed.data_ptr(), n_rows, int(loop), cam_params.data_ptr(),
            pix.data_ptr(), xs.data_ptr(), ys.data_ptr(), valid.data_ptr(),
            soff.data_ptr(), rad_r.data_ptr(), rad_g.data_ptr(),
            rad_b.data_ptr(), rays.data_ptr(), pix.numel(),
            frame, sample_base, max_bounces, n_samples,
            int(rr_start), float(rr_floor), float(clamp),
            int(sampler == "stratified"), stream)
    if rc != 0:
        raise RuntimeError(f"persistent kernel launch failed (loop {loop}): "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    WARP_LAUNCHES += loop == LOOP_WARP
    total = rays.sum(dtype=torch.int64)
    zero = torch.zeros_like(total)
    return rad_r, rad_g, rad_b, torch.stack([total, warp_trips(rays), zero,
                                             zero])
