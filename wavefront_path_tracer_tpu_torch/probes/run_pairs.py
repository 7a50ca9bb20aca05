"""The intersect-loop designs of ``exp/micro_r2.py``'s ``run_pairs`` (line
273) on the card: wrappers over ``csrc/probe_designs.cu`` and their plain
PyTorch versions.

Per ray of the module's six (8, 128) planes: the nearest of the 400
spheres, ``reps`` times; each rep nudges dx and adds one value per ray
into an accumulator, the (N,) float32 output.  23 designs in three
groups, each computing its reference kernel's function:

- ray major, over ``packed`` (400, 16), the generic quadratic
  (``micro_r2.quadratic``), ``dxm = dxm + 1e-6`` kept on the ray:
  ``A`` (baked, ten attribute selects), ``B`` (baked, (t, index) carry),
  ``C2`` (two selects), ``C3`` ((t, index)), ``C5`` and ``C45`` (ten
  selects; C5 not unrolled) add t + attr0 + attr9; ``C4`` (two selects)
  adds t + attr0 + attr1; ``Q`` adds t alone, ``Q2`` the same with the
  square root replaced by disc * 0.5 (another function, as the reference
  has it), ``Q4`` and ``Q8`` Q's function in 4 or 8 interleaved chains;
- sphere major, over ``PACKED_SM`` (400, 24), the slimmed quadratic, a
  scalar bump added to dx: ``C6`` and ``A2`` add t + index (the pair
  ceiling's function: ``pair_ceiling.pair_sweep``), ``C6d`` and ``A2d``
  t + (attr0 + attr9), ``C7`` t + attr0 + ... + attr9 (ten selects);
  ``C`` the generic quadratic over ``packed`` in blocks of 8 (a block's
  tie keeps its highest j, blocks merge with a strict <), adding
  (t + attr0) + attr9;
- tile gated, over ``packed``, the generic quadratic, t alone: ``W``
  (25 fake boxes, each gating 16 spheres on ``any(live)`` over the whole
  1024-ray tile with each lane's current t), ``W0`` (ungated), ``W2``
  (W's gates over empty bodies: adds T_FAR), ``W5`` and ``W6`` (all 25
  gates first with cap T_FAR, as per-box votes or one OR-ed bitmask),
  ``W7`` (W5's form over x/y boxes offset by c * 0.5, the device table).

A sphere-major design runs 8 lanes to a ray (the TPU's 8 spheres on
sublanes) or, for C6d and C7, also one lane a ray; C45, C6d and C7 read
their table from device memory through L1, from shared memory or from the
constant bank (``PLACES``).  Gpairs/s counts reps x 400 x rays, as
``run_pairs`` does, gated designs included.  The kernels carry 4 rays a
thread (a tile-gated block: 256 threads for the 1024-ray tile); a ray's
output depends on its own ray (and its tile's gates) alone.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.probes import _slope
from wavefront_path_tracer_tpu_torch.probes import micro_r2 as m
from wavefront_path_tracer_tpu_torch.probes import pair_ceiling as pc

RAY_MAJOR = ("A", "B", "C2", "C3", "C4", "C5", "C45", "Q", "Q2", "Q4", "Q8")
SPHERE_MAJOR = ("C6", "A2", "C6d", "A2d", "C7", "C")
TILE_GATED = ("W", "W0", "W2", "W5", "W6", "W7")
DESIGNS = RAY_MAJOR + SPHERE_MAJOR + TILE_GATED
# csrc/probe_designs.cu's numbering (A2d is C6d over the constant bank;
# C6 and A2 are probe_pairs.cu's pair ceiling).
KERNEL_IDS = {name: k for k, name in enumerate(
    ("A", "B", "C2", "C3", "C4", "C5", "C45", "Q", "Q2", "Q4", "Q8",
     "C6d", "C7", "C", "W", "W0", "W2", "W5", "W6", "W7"))}
KERNEL_IDS["A2d"] = KERNEL_IDS["C6d"]
PLACE_IDS = {"global": 0, "shared": 1, "const": 2}
# Each design's table places (the first is its default: the constant bank
# for the TPU's baked designs, device memory for its dynamic ones).
_BAKED = ("A", "B", "Q", "Q2", "Q4", "Q8", "A2", "A2d", "W", "W0", "W2",
          "W5", "W6")
PLACES = {d: ("const",) if d in _BAKED else ("global",) for d in DESIGNS}
PLACES.update({"C45": ("global", "shared", "const"),
               "C6d": ("global", "shared", "const"),
               "C7": ("global", "shared", "const")})
# Lanes a ray (the first is the default).
LANES = {d: (1,) for d in DESIGNS}
LANES.update({"C6d": (8, 1), "A2d": (8,), "C7": (8, 1), "C": (8,)})
# The table a design reads: micro_r2.PACKED_SM (24 columns) or packed (16).
SM_TABLE = ("C6", "A2", "C6d", "A2d", "C7")
REPS = (50, 350)
# FP32 operations a pair: the generic quadratic (micro_r2.quadratic: ocx
# 3, b 5, c 6, disc 2, max and sqrt 2, roots 3) and the slimmed one.
FLOPS_PAIR = {"generic": 21, "slim": 18}

# Kernel launches on CUDA tensors by design_sweep, by (design, place,
# lanes) (C6 and A2 count in pair_ceiling.LAUNCHES).
LAUNCHES = {(d, p, n): 0 for d in DESIGNS if d not in ("C6", "A2")
            for p in PLACES[d] for n in LANES[d]}


def table_for(design: str, device="cpu") -> torch.Tensor:
    """The table ``design`` reads, on ``device``."""
    tab = m.PACKED_SM if design in SM_TABLE else m.packed
    return torch.from_numpy(tab).to(device)


def flops_pair(design: str) -> int:
    """FP32 operations of one of ``design``'s pairs."""
    slim = design in ("C6", "A2", "C6d", "A2d", "C7")
    return FLOPS_PAIR["slim" if slim else "generic"]


def fake_sqrt_t(ox, oy, oz, dx, dy, dz, tab):
    """kernel_q2's test: micro_r2.quadratic with disc * 0.5 for the
    square root; (N, S) t."""
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in (ox, oy, oz, dx, dy, dz))
    cx, cy, cz, r = (tab[:, k][None, :] for k in range(4))
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b_q = dx * ocx + dy * ocy + dz * ocz
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b_q * b_q - c_q
    sq = disc * 0.5
    t1 = -b_q - sq
    t2 = -b_q + sq
    t = torch.where(t1 > m.T_MIN, t1, torch.where(t2 > m.T_MIN, t2, m.T_FAR))
    return torch.where(disc >= 0.0, t, m.T_FAR)


def _attr(tab, idx, col):
    """Column ``col`` of the winners' rows, 0 where nothing was hit."""
    return torch.where(idx >= 0, tab[idx.clamp_min(0), col], 0.0)


def _block_min(t):
    """kernel_c's carry: per block of 8 the minimum and its highest j,
    blocks merged with a strict < in order; (best t, index or -1)."""
    n, s = t.shape
    tb = t.view(n, s // 8, 8)
    bmin = tb.min(dim=2).values
    j = torch.arange(8, device=t.device)
    jhi = torch.where(tb == bmin[:, :, None], j, -1).max(dim=2).values
    best = bmin.min(dim=1).values
    k = torch.arange(s // 8, device=t.device)
    kfirst = torch.where(bmin == best[:, None], k, s).min(dim=1).values
    idx = kfirst * 8 + jhi.gather(1, kfirst[:, None].clamp_max(s // 8 - 1))[:, 0]
    return best, torch.where(best < m.T_FAR, idx, -1)


def _box_live(c, ox, oy, oz, dxm, dy, dz, cap, w7: bool):
    """The fake slab test of make_kernel_when / when2 / w7 (x/y only and
    offsets c * 0.5 for W7)."""
    lox = -10.0 + c * 0.5 if w7 else -10.0 + c
    hix = -8.0 + c * 0.5 if w7 else -8.0 + c
    tx0 = (lox - ox) / dxm
    tx1 = (hix - ox) / dxm
    tmin = torch.minimum(tx0, tx1)
    tmax = torch.maximum(tx0, tx1)
    ty0 = (-1.0 - oy) * dy
    ty1 = (1.0 - oy) * dy
    tmin = torch.maximum(tmin, torch.minimum(ty0, ty1))
    tmax = torch.minimum(tmax, torch.maximum(ty0, ty1))
    if not w7:
        tz0 = (-10.0 - oz) * dz
        tz1 = (-8.0 - oz) * dz
        tmin = torch.maximum(tmin, torch.minimum(tz0, tz1))
        tmax = torch.minimum(tmax, torch.maximum(tz0, tz1))
    return (tmin <= tmax) & (torch.maximum(tmin, torch.zeros_like(tmin))
                             < cap)


def _tile_any(live):
    """any(live) over each tile of 1024 rays, back on the rays."""
    return live.view(-1, m.ROWS * 128).any(dim=1).repeat_interleave(
        m.ROWS * 128)


def _tile_gated_rep(design, tab, ox, oy, oz, dxm, dy, dz, size):
    """One rep of a tile-gated design over clusters of ``size`` spheres:
    (each ray's t, the pairs its tiles' entered clusters test)."""
    far = torch.full_like(ox, m.T_FAR)
    t = far
    n_cl = tab.shape[0] // size
    tested = 0
    enter = None
    if design in ("W5", "W6", "W7"):
        enter = [_tile_any(_box_live(c, ox, oy, oz, dxm, dy, dz, far,
                                     design == "W7")) for c in range(n_cl)]
    for c in range(n_cl):
        if design == "W0":
            e = None
        elif enter is not None:
            e = enter[c]
        else:
            e = _tile_any(_box_live(c, ox, oy, oz, dxm, dy, dz, t, False))
        if design == "W2":
            continue
        tested += size * (ox.shape[0] if e is None else int(e.sum()))
        tc = m.generic_t(ox, oy, oz, dxm, dy, dz,
                         tab[c * size:(c + 1) * size]).min(dim=1).values
        better = tc < t if e is None else e & (tc < t)
        t = torch.where(better, tc, t)
    return t, tested


# FP32 operations of one fake box test: x 4 (subtract, divide) and its
# min/max 2, y and z 4 each (subtract, multiply) and 4 min/max each, the
# cap's max 1; W7 tests x and y only.
FLOPS_BOX = {"W": 23, "W7": 15}


def tested_work(design: str, tab, rays) -> tuple:
    """(pairs tested, box-test FP32 operations) in the first rep of
    ``design`` over ``rays``: every pair for the ungated designs; for the
    tile-gated ones, 16 spheres for each ray of each tile that enters a
    cluster, and 25 box tests a ray (none for W0).  Gpairs/s counts every
    pair, as run_pairs does; this is the work a spec check may count."""
    if design not in TILE_GATED:
        return tab.shape[0] * rays.shape[1], 0
    pairs = 0
    for lo in range(0, rays.shape[1], m._CHUNK):
        ox, oy, oz, dx0, dy, dz = rays[:, lo:lo + m._CHUNK]
        pairs += _tile_gated_rep(design, tab, ox, oy, oz, dx0 + 1e-6, dy, dz,
                                 m.CLUSTER_SIZE)[1]
    boxes = 0 if design == "W0" else tab.shape[0] // m.CLUSTER_SIZE
    flops = FLOPS_BOX["W7" if design == "W7" else "W"]
    return pairs, boxes * flops * rays.shape[1]


def design_reference(tab, rays, reps: int, design: str):
    """Plain PyTorch version of :func:`design_sweep` over any table of a
    multiple of 16 rows (the tile-gated designs: clusters of
    ``micro_r2.CLUSTER_SIZE`` rows, whose boxes c = 0, 1, ... each gate
    one cluster): each rep one (N, S) matrix of the pairs' arithmetic in
    the kernels' order, then the minimum under the design's tie rule (the
    first for a strict-< carry; kernel_c's for C), the winner's
    attributes gathered, added in the reference's order."""
    if design in ("C6", "A2"):
        return pc.pair_sweep_reference(tab, rays, reps)
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=rays.device)
    second = 5 if design == "C4" else 13
    for lo in range(0, rays.shape[1], m._CHUNK):
        ox, oy, oz, dx0, dy, dz = rays[:, lo:lo + m._CHUNK]
        acc = torch.zeros_like(ox)
        dxm = dx0
        bump = torch.zeros((), dtype=torch.float32, device=rays.device)
        for _ in range(reps):
            if design in RAY_MAJOR or design in TILE_GATED:
                dxm = dxm + 1e-6
            else:
                bump = bump + 1e-6
            if design in TILE_GATED:
                acc = acc + _tile_gated_rep(design, tab, ox, oy, oz, dxm,
                                            dy, dz, m.CLUSTER_SIZE)[0]
            elif design in RAY_MAJOR:
                fn = fake_sqrt_t if design == "Q2" else m.generic_t
                best, idx = m._first_min(fn(ox, oy, oz, dxm, dy, dz, tab))
                if design.startswith("Q"):
                    acc = acc + best
                else:
                    acc = (acc + best + _attr(tab, idx, 4)
                           + _attr(tab, idx, second))
            elif design == "C":
                best, idx = _block_min(m.generic_t(ox, oy, oz, dx0 + bump,
                                                   dy, dz, tab))
                acc = acc + ((best + _attr(tab, idx, 4))
                             + _attr(tab, idx, 13))
            else:
                t = m.slim_t(m.slim_ray(ox, oy, oz, dx0 + bump, dy, dz), tab)
                best, idx = m._first_min(t)
                if design == "C7":
                    v = best
                    for q in range(10):
                        v = v + _attr(tab, idx, 4 + q)
                    acc = acc + v
                else:
                    acc = acc + (best + (_attr(tab, idx, 4)
                                         + _attr(tab, idx, 13)))
        out[lo:lo + ox.shape[0]] = acc
    return out


def design_sweep(tab, rays, reps: int, design: str, place: str | None = None,
                 lanes: int | None = None):
    """``design``'s function (module docstring) over ``tab`` (the design's
    table, :func:`table_for`) and ``rays`` ((6, N) float32, N a multiple
    of 1024): (N,) float32.

    On CPU tensors this is the plain version (any multiple of 16
    spheres); on CUDA tensors it launches the design's kernel with the
    table in ``place`` and ``lanes`` lanes a ray (defaults: the first of
    :data:`PLACES` and :data:`LANES`), bit-identical to the plain
    version; C6 and A2 run the pair ceiling's kernels.  Any other device
    raises."""
    if design not in DESIGNS:
        raise ValueError(f"design is one of {DESIGNS}")
    place = PLACES[design][0] if place is None else place
    lanes = LANES[design][0] if lanes is None else lanes
    if place not in PLACES[design] or lanes not in LANES[design]:
        raise ValueError(f"{design} runs with the table in {PLACES[design]} "
                         f"and {LANES[design]} lanes a ray")
    _slope.check_rays(rays)
    cols = 24 if design in SM_TABLE else 16
    if (tab.dim() != 2 or tab.shape[1] != cols or tab.shape[0] % 16
            or tab.dtype != torch.float32 or not tab.is_contiguous()):
        raise ValueError(f"tab must be a contiguous (S, {cols}) float32 "
                         f"table, S a multiple of 16")
    if rays.shape[1] % (m.ROWS * 128):
        raise ValueError("rays must be whole tiles of 1024")
    dev = _slope.one_device(tab, rays)
    if design in ("C6", "A2"):
        return pc.pair_sweep(tab, rays, reps, design)
    if dev.type == "cpu":
        return design_reference(tab, rays, reps, design)
    if tab.shape[0] != m.S:
        raise ValueError(f"the kernel sweeps {m.S} spheres")
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=dev)
    _slope.launch("wpt_probe_design_launch", tab.data_ptr(), cols,
                  rays.data_ptr(), rays.shape[1], int(reps),
                  KERNEL_IDS[design], PLACE_IDS[place], lanes,
                  out.data_ptr())
    LAUNCHES[(design, place, lanes)] += 1
    return out


def forms(design: str) -> list:
    """Every (place, lanes) form ``design`` runs in."""
    return [(p, n) for p in PLACES[design] for n in LANES[design]]


def measure(design: str, place=None, lanes=None, reps=REPS,
            device="cuda") -> dict:
    """Slope-time :func:`design_sweep` on the card at full width
    (micro_r2.RAY_COPIES copies of the 1024 rays): Gpairs/s, the FP32
    rate its pairs imply, the slope window and copy 0's checksum at 2
    reps."""
    place = PLACES[design][0] if place is None else place
    lanes = LANES[design][0] if lanes is None else lanes
    tab = table_for(design, device)
    rays = m.ray_planes(device, m.RAY_COPIES)
    sl = _slope.slope(lambda r: design_sweep(tab, rays, r, design, place,
                                             lanes), *reps)
    pairs = m.S * rays.shape[1]
    rate = pairs / sl["unit_s"]
    tested, box_flops = tested_work(design, tab, rays)
    out = design_sweep(tab, rays, 2, design, place, lanes)
    return {"design": design, "place": place, "lanes": lanes,
            "reps": [sl["lo"], sl["hi"]], "gpairs": rate / 1e9,
            "gpairs_tested": tested / sl["unit_s"] / 1e9,
            "fp32_rate": (tested * flops_pair(design) + box_flops)
            / sl["unit_s"],
            "ns_per_rep": sl["unit_s"] * 1e9,
            "window_ms": sl["window_s"] * 1e3,
            "single_lo_gpairs": sl["lo"] * pairs / sl["lo_s"] / 1e9,
            "checksum": float(out[:m.ROWS * 128].double().sum())}
