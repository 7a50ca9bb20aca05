"""Slope-timed triangle-pair test forms on the card (the port of
``exp/tripair.py``, its ``measure`` at line 233).

    python -m wavefront_path_tracer_tpu_torch.probes.tripair \
        [--reps-lo 20] [--reps-hi 220] [--device cuda|cpu]

Four forms of the pair test, each carrying the whole winner (11 fields,
13 when packed) over 512 random unit-scale triangles (``build_tables``,
seed 7, byte for byte the reference's):

- ``T1``: two-sided Moller-Trumbore, the port's pair (``tri_mt``);
- ``T1p``: T1 with albedo and material packed 16:16 in an int32 table;
- ``T2``: the matrix form, rows of inv([e1, e2, n]) (``tri_mx``);
- ``T2p``: T2 packed.

Rep i sweeps the table half that i % 2 names and moves the origins by
i * 1e-7; the carry runs across reps, and the output is the sum of its
fields.  Rays: the reference's (seed 3), repeated to fill the card.
Printed: each form's Gpairs/s by slope, and the matrix/MT, pack and
combined ratios of ``tripair.py:283-284``, beside the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes import _slope
from wavefront_path_tracer_tpu_torch.probes.micro_r2 import RAY_COPIES

T_MIN = 0.001
T_FAR = 1e30
NTRI = 512            # triangles in the table (64 blocks of 8)
ROWS = 8              # production compute shape (8, 128)
FORMS = ("T1", "T1p", "T2", "T2p")
REPS = (20, 220)
# FP32 operations a pair (adds, muls, one IEEE divide; compares and
# selects not counted): T1 as chip_smoke.py's FLOPS_TRI, T2 sx 3, hd 5,
# h0 5, the divide 1, u 12, v 12, u + v 1.
FLOPS_PAIR = {"T1": 46, "T1p": 46, "T2": 39, "T2p": 39}
_CHUNK = 16384         # rays per pass of the plain version

# Kernel launches on CUDA tensors by tripair_sweep, by form.
LAUNCHES = {f: 0 for f in FORMS}


def build_tables(seed=7):
    """Random unit-scale triangles -> (mt_table, mx_table, pk_table).

    mt_table cols: v0 e1 e2 nrm alb fz io mt  (production layout)
    mx_table cols: v0 r0 r1 r2  alb fz io mt  (rows of inv([e1,e2,n]))
    pk_table cols: (r16|g16), (b16|mat)       int32
    """
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-4, 4, (NTRI, 3)).astype(np.float64)
    e1 = rs.uniform(-1, 1, (NTRI, 3)).astype(np.float64)
    e2 = rs.uniform(-1, 1, (NTRI, 3)).astype(np.float64)
    n = np.cross(e1, e2)
    alb = rs.uniform(0, 1, (NTRI, 3))
    fz = rs.uniform(0, 1, NTRI)
    io = np.full(NTRI, 1.5)
    mt = rs.randint(0, 3, NTRI).astype(np.float64)

    mt_tab = np.concatenate(
        [v0, e1, e2, n, alb, fz[:, None], io[:, None], mt[:, None]],
        axis=1).astype(np.float32)

    minv = np.linalg.inv(np.stack([e1, e2, n], axis=2))  # rows solve
    mx_tab = np.concatenate(
        [v0, minv[:, 0], minv[:, 1], minv[:, 2],
         alb, fz[:, None], io[:, None], mt[:, None]],
        axis=1).astype(np.float32)

    q = np.clip(np.round(alb * 65535.0), 0, 65535).astype(np.int64)
    pk1 = (q[:, 0] << 16) | q[:, 1]
    pk2 = (q[:, 2] << 16) | mt.astype(np.int64)
    pk = np.stack([pk1, pk2], axis=1)
    pk = np.where(pk >= (1 << 31), pk - (1 << 32), pk).astype(np.int32)
    return mt_tab, mx_tab, pk


def ray_planes(device="cpu", copies: int = 1) -> torch.Tensor:
    """The reference's rays (RandomState(3): origins in [-6, 6]^3, unit
    normal directions, rounded once to float32) as a (6, 1024 x copies)
    float32 tensor, the 1024 repeated ``copies`` times."""
    rs = np.random.RandomState(3)
    o = [rs.uniform(-6, 6, (ROWS, 128)).astype(np.float32)
         for _ in range(3)]
    dd = rs.normal(size=(3, ROWS, 128))
    dd /= np.linalg.norm(dd, axis=0, keepdims=True)
    planes = np.stack([p.reshape(-1) for p in o]
                      + [p.astype(np.float32).reshape(-1) for p in dd])
    return torch.from_numpy(np.tile(planes, (1, copies))).to(device)


def _mt_t(ox, oy, oz, dx, dy, dz, tab):
    """tri_mt's t for (N,) rays against (T, 18) rows: (N, T)."""
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in (ox, oy, oz, dx, dy, dz))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tab[:, k][None, :] for k in range(9))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1e-9
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > T_MIN)
    return torch.where(valid, tt, T_FAR)


def _mx_t(ox, oy, oz, dx, dy, dz, tab):
    """tri_mx's t for (N,) rays against (T, 18) rows: (N, T)."""
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in (ox, oy, oz, dx, dy, dz))
    (v0x, v0y, v0z, r0x, r0y, r0z, r1x, r1y, r1z,
     r2x, r2y, r2z) = (tab[:, k][None, :] for k in range(12))
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    hd = r2x * dx + r2y * dy + r2z * dz
    h0 = r2x * sx + r2y * sy + r2z * sz
    ok = torch.abs(hd) > 1e-12
    tt = -h0 / torch.where(ok, hd, 1.0)
    u = (r0x * sx + r0y * sy + r0z * sz) + tt * (r0x * dx + r0y * dy
                                                 + r0z * dz)
    v = (r1x * sx + r1y * sy + r1z * sz) + tt * (r1x * dx + r1y * dy
                                                 + r1z * dz)
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > T_MIN)
    return torch.where(valid, tt, T_FAR)


def tripair_reference(tab, pk, rays, reps: int, form: str):
    """Plain PyTorch version of :func:`tripair_sweep` over any table of a
    multiple of 16 triangles: each rep one (N, T / 2) matrix of the
    pairs' arithmetic in the kernel's order; a ray's carry takes the
    first triangle of the rep's minimum where it beats the carried t,
    which is what the kernel's strict-< carry does pair by pair."""
    matrix, packed = form.startswith("T2"), form.endswith("p")
    half = tab.shape[0] // 2
    t_of = _mx_t if matrix else _mt_t
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=rays.device)
    for lo in range(0, rays.shape[1], _CHUNK):
        ox0, oy, oz, dx, dy, dz = rays[:, lo:lo + _CHUNK]
        n = ox0.shape[0]
        best = torch.full((n,), T_FAR, dtype=torch.float32,
                          device=rays.device)
        fields = torch.zeros((n, 10), dtype=torch.float32,
                             device=rays.device)
        pks = torch.zeros((n, 2), dtype=torch.int32, device=rays.device)
        for i in range(reps):
            base = (i % 2) * half
            rows = tab[base:base + half]
            ox = ox0 + torch.tensor(float(i), dtype=torch.float32) * 1e-7
            tt = t_of(ox, oy, oz, dx, dy, dz, rows)
            t_min = tt.min(dim=1).values
            cols = torch.arange(half, device=rays.device)
            first = torch.where(tt == t_min[:, None], cols, half).min(
                dim=1).values
            take = t_min < best
            row = rows[first]
            # Carry order: ar ag ab fz io mt nx ny nz it.
            new = torch.stack([row[:, 12], row[:, 13], row[:, 14],
                               row[:, 15], row[:, 16], row[:, 17],
                               row[:, 9], row[:, 10], row[:, 11],
                               torch.ones_like(t_min)], dim=1)
            if packed:
                new[:, [0, 1, 2, 5]] = fields[:, [0, 1, 2, 5]]
                pks = torch.where(take[:, None], pk[base + first], pks)
            fields = torch.where(take[:, None], new, fields)
            best = torch.where(take, t_min, best)
        acc = best
        for k in range(10):
            acc = acc + fields[:, k]
        if packed:
            acc = acc + pks[:, 0].to(torch.float32) * 1e-9
            acc = acc + pks[:, 1].to(torch.float32) * 1e-9
        out[lo:lo + n] = acc
    return out


def tripair_sweep(tab, pk, rays, reps: int, form: str = "T1"):
    """The triangle-pair probe's function for ``form`` (T1, T1p: ``tab`` the
    Moller-Trumbore table; T2, T2p: the matrix table), ``tab`` (T, 18)
    float32 and ``pk`` (T, 2) int32 with T a multiple of 16, ``rays``
    (6, N) float32: (N,) float32, the sum of each ray's carry after
    ``reps`` reps.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/probe_tripair.cu``, bit-identical to the plain version; any
    other device raises."""
    if form not in FORMS:
        raise ValueError(f"form is one of {FORMS}")
    _slope.check_rays(rays)
    for name, t, cols, dtype in (("tab", tab, 18, torch.float32),
                                 ("pk", pk, 2, torch.int32)):
        if (t.dim() != 2 or t.shape[1] != cols or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (T, {cols}) "
                             f"{dtype} table")
    n_tri = tab.shape[0]
    if pk.shape[0] != n_tri or n_tri % 16 or not n_tri:
        raise ValueError("tab and pk need the same multiple of 16 rows")
    dev = _slope.one_device(tab, pk, rays)
    if dev.type == "cpu":
        return tripair_reference(tab, pk, rays, reps, form)
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=dev)
    _slope.launch("wpt_probe_tripair_launch", tab.data_ptr(), pk.data_ptr(),
                  n_tri, rays.data_ptr(), rays.shape[1], int(reps),
                  FORMS.index(form), out.data_ptr())
    LAUNCHES[form] += 1
    return out


def tables(device="cpu") -> dict:
    """{form: (tab, pk)} on ``device``."""
    mt_tab, mx_tab, pk = (torch.from_numpy(a).to(device)
                          for a in build_tables())
    return {f: (mx_tab if f.startswith("T2") else mt_tab, pk) for f in FORMS}


def measure(form: str, reps=REPS, device="cuda") -> dict:
    """Slope-time :func:`tripair_sweep` on the card at full width."""
    tab, pk = tables(device)[form]
    rays = ray_planes(device, RAY_COPIES)
    sl = _slope.slope(lambda r: tripair_sweep(tab, pk, rays, r, form),
                      *reps)
    pairs = (NTRI // 2) * rays.shape[1]
    rate = pairs / sl["unit_s"]
    out = tripair_sweep(tab, pk, rays, 2, form)
    return {"form": form, "reps": [sl["lo"], sl["hi"]],
            "gpairs": rate / 1e9,
            "fp32_rate": rate * FLOPS_PAIR[form],
            "window_ms": sl["window_s"] * 1e3,
            "checksum": float(out[:ROWS * 128].double().sum())}


def run(argv=None) -> list:
    """The probe as its command line runs it: prints its table and
    returns its readings (the plain versions' checksums with
    ``--device cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps-lo", type=int, default=REPS[0])
    ap.add_argument("--reps-hi", type=int, default=REPS[1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _slope.device(args.device)
    if dev.type == "cpu":
        rays = ray_planes()
        readings = []
        for form, (tab, pk) in tables().items():
            out = tripair_sweep(tab, pk, rays, 2, form)
            checksum = float(out.double().sum())
            print(f"{form} plain version, 2 reps, 1024 rays: checksum "
                  f"{checksum!r} (times: not measured on the CPU)")
            readings.append({"form": form, "checksum": checksum})
        return readings
    card = _slope.card()
    readings = []
    for form in FORMS:
        r = measure(form, (args.reps_lo, args.reps_hi), dev)
        readings.append(r)
        print(f"{form:4s} {r['gpairs']:8.2f} Gpairs/s "
              f"({r['fp32_rate'] / 1e12:.2f} TFLOP/s FP32, slope window "
              f"{r['window_ms']:.1f} ms) [{card}]", flush=True)
        print(json.dumps(r), flush=True)
    rates = {r["form"]: r["gpairs"] for r in readings}
    print(f"matrix/MT: {rates['T2'] / rates['T1']:.3f}x   pack effect (MT): "
          f"{rates['T1p'] / rates['T1']:.3f}x   combined: "
          f"{rates['T2p'] / rates['T1']:.3f}x [{card}]")
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
