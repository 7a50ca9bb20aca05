"""The port's Hopper probes (``wavefront_path_tracer_tpu_torch/probes/``)
on the CPU: their module data and triangle tables byte for byte against
``exp/``, and each probe's plain version against the ``exp/`` Pallas
kernel in interpret mode at reduced sizes (the exp modules' globals set
with monkeypatch; no file of ``exp/`` is edited).  The kernels themselves
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wavefront_path_tracer_tpu_torch.probes import _slope
from wavefront_path_tracer_tpu_torch.probes import hbm_bw as thb
from wavefront_path_tracer_tpu_torch.probes import micro_r2 as tm
from wavefront_path_tracer_tpu_torch.probes import pair_ceiling as tpc
from wavefront_path_tracer_tpu_torch.probes import tripair as ttp

torch.set_num_threads(2)

EXP = Path(__file__).resolve().parents[1] / "exp"
if str(EXP) not in sys.path:
    sys.path.insert(0, str(EXP))

import hbm_bw as jhb  # noqa: E402
import micro_r2 as jm  # noqa: E402
import pair_ceiling as jpc  # noqa: E402
import tripair as jtp  # noqa: E402

FULL = pl.BlockSpec(memory_space=pltpu.VMEM)
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)


def _interpret(kernel, n_smem_first, ins):
    """The exp kernel through pl.pallas_call in interpret mode: its
    (8, 128) output flattened in lane order."""
    specs = [SMEM] * n_smem_first + [FULL] * (len(ins) - n_smem_first)
    fn = pl.pallas_call(kernel, in_specs=specs, out_specs=FULL,
                        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                        interpret=True)
    return np.asarray(fn(*ins)).reshape(-1)


def _ray_ins():
    return [jnp.asarray(x) for x in (jm.ox0, jm.oy0, jm.oz0,
                                     jm.dx0, jm.dy0, jm.dz0)]


def _near_spheres(n):
    """The ``n`` spheres nearest the rays' origins (the unit cube), in
    their table order: at S = 32 the first 32 spheres miss every ray of
    row 0, these do not."""
    gap = np.linalg.norm(jm.centers, axis=1) - jm.radii
    return np.sort(np.argsort(gap)[:n])


# --- module data, byte for byte --------------------------------------------------

@pytest.mark.parametrize("name", ["centers", "radii", "attrs", "packed",
                                  "PACKED_SM", "ox0", "oy0", "oz0", "dx0",
                                  "dy0", "dz0"])
def test_micro_r2_data_byte_identical(name):
    port, ref = getattr(tm, name), getattr(jm, name)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


def test_micro_r2_constants_and_sph_identical():
    assert (tm.S, tm.ROWS, tm.T_MIN, tm.T_FAR) == (jm.S, jm.ROWS, jm.T_MIN,
                                                   jm.T_FAR)
    assert tm.SPH == jm.SPH
    rays = tm.ray_planes().numpy()
    for k, plane in enumerate((jm.ox0, jm.oy0, jm.oz0, jm.dx0, jm.dy0,
                               jm.dz0)):
        assert rays[k].tobytes() == plane.reshape(-1).tobytes()
    # Copies repeat the 1024 rays; 132 x 2048 threads in all.
    many = tm.ray_planes(copies=3).numpy()
    assert np.array_equal(many[:, 2048:], rays)
    assert tm.RAY_COPIES * 1024 == 132 * 2048


def test_tripair_tables_and_rays_byte_identical():
    for port, ref in zip(ttp.build_tables(), jtp.build_tables()):
        assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    rs = np.random.RandomState(3)
    o = [np.asarray(jnp.asarray(rs.uniform(-6, 6, (8, 128)), jnp.float32))
         for _ in range(3)]
    dd = rs.normal(size=(3, 8, 128))
    dd /= np.linalg.norm(dd, axis=0, keepdims=True)
    d = [np.asarray(jnp.asarray(x, jnp.float32)) for x in dd]
    rays = ttp.ray_planes().numpy()
    for k, plane in enumerate(o + d):
        assert rays[k].tobytes() == plane.reshape(-1).tobytes()


def test_gated_patterns_match_reference_draws():
    """The entry patterns are run_gated's (micro_r2.py:1109-1111): W8 12
    of 25 conds on every row, C8 37 of 200 (cluster, row) conds, and C9's
    row masks hold the same bits."""
    for pattern, (n_conds, entered, _g) in tm.PATTERNS.items():
        rs = np.random.RandomState(7)
        cond = np.zeros(n_conds, np.int32)
        cond[rs.choice(n_conds, entered, replace=False)] = 1
        table = tm.cond_table(pattern)
        assert table.shape == (200,) and table.dtype == np.int32
        if pattern == "W8":
            assert np.array_equal(table.reshape(25, 8), np.repeat(
                cond[:, None], 8, axis=1))
        else:
            assert np.array_equal(table, cond)
            masks = np.zeros(25, np.int32)
            for ci in np.nonzero(cond)[0]:
                masks[ci // 8] |= 1 << (ci % 8)
            bits = (masks[:, None] >> np.arange(8)) & 1
            assert np.array_equal(bits.reshape(-1), table)
    assert tm.pairs_per_rep("W8", 1024) == 12 * 16 * 1024
    assert tm.pairs_per_rep("C8", 1024) == 37 * 16 * 128


# --- plain versions against the exp kernels in interpret mode ----------------------

def _pair_case(monkeypatch, n=16):
    idx = _near_spheres(n)
    sub = np.ascontiguousarray(jm.PACKED_SM[idx])
    monkeypatch.setattr(jm, "S", n)
    monkeypatch.setattr(jm, "PACKED_SM", sub)
    return sub


@pytest.mark.parametrize("variant", ["C6", "A2"])
def test_pair_ceiling_matches_jax(monkeypatch, variant):
    """pair_ceiling's C6 and A2 kernels (make_dyn_reps_kernel) over the
    16 nearest spheres, 2 reps, against the port's plain version: the
    same winners, so each ray's sum of t_min + i_min agrees to 1e-3
    (XLA:CPU contracts the quadratic's multiply-adds and the port does
    not: t moves by ulps, while a winner flip moves i by at least 1);
    misses (2e30) agree exactly."""
    sub = _pair_case(monkeypatch)
    ins = [np.array([2], np.int32)] + _ray_ins()
    if variant == "C6":
        ins.insert(1, jnp.asarray(sub))
    ref = _interpret(jpc.make_dyn_reps_kernel(variant == "A2"), 1, ins)
    port = tpc.pair_sweep(torch.from_numpy(sub), tm.ray_planes(), 2,
                          variant).numpy()
    hit = ref < 1e29
    assert 100 < hit.sum() < ref.size
    np.testing.assert_array_equal(port[~hit], ref[~hit])
    np.testing.assert_allclose(port[hit], ref[hit], rtol=0, atol=1e-3)


@pytest.mark.parametrize("form", ["T1", "T1p", "T2", "T2p"])
def test_tripair_matches_jax(monkeypatch, form):
    """tripair's four forms (make_kernel with tri_mt / tri_mx) over 32
    triangles, 2 reps (both table halves), against the port's plain
    version: the sums of the 11-13 carried fields agree to 1e-4 relative
    where a triangle was hit (t moves by ulps under XLA:CPU's contracted
    multiply-adds; a winner flip moves the summed albedo, normal and
    material by far more) and exactly where none was."""
    monkeypatch.setattr(jtp, "NTRI", 32)
    monkeypatch.setattr(ttp, "NTRI", 32)
    mt_tab, mx_tab, pk = jtp.build_tables()
    tab = mx_tab if form.startswith("T2") else mt_tab
    body = jtp.tri_mx if form.startswith("T2") else jtp.tri_mt
    rays = ttp.ray_planes()
    ins = ([np.array([2], np.int32), jnp.asarray(tab), jnp.asarray(pk)]
           + [jnp.asarray(p.reshape(8, 128)) for p in rays.numpy()])
    ref = _interpret(jtp.make_kernel(body, form.endswith("p")), 1, ins)
    port = ttp.tripair_sweep(torch.from_numpy(tab), torch.from_numpy(pk),
                             rays, 2, form).numpy()
    hit = ref < 1e29
    assert 10 < hit.sum() < ref.size
    np.testing.assert_array_equal(port[~hit], ref[~hit])
    np.testing.assert_allclose(port[hit], ref[hit], rtol=1e-4, atol=0)


@pytest.mark.parametrize("form", ["T1", "T1p", "T2", "T2p"])
def test_tripair_reference_permutes_with_the_rays(form):
    """A ray's output depends on that ray alone: permuting the rays
    (1,000 of them, over the 16,384-ray chunks of the plain version too)
    permutes tripair_reference's output bit for bit, which is what lets
    a kernel carry several rays a thread in any grouping."""
    tab, pk = ttp.tables()[form]
    rays = ttp.ray_planes(copies=17)[:, 1000:18408].contiguous()
    perm = torch.from_numpy(np.random.RandomState(11).permutation(
        rays.shape[1]))
    out = ttp.tripair_reference(tab, pk, rays, 2, form)
    moved = ttp.tripair_reference(tab, pk, rays[:, perm].contiguous(), 2,
                                  form)
    assert bool((out < 1e29).any())
    assert torch.equal(moved.view(torch.int32), out[perm].view(torch.int32))


def _gated_case(monkeypatch, n_clusters=4):
    idx = _near_spheres(n_clusters * 16)
    sub = np.ascontiguousarray(jm.PACKED_SM[idx])
    monkeypatch.setattr(jm, "S", n_clusters * 16)
    monkeypatch.setattr(jm, "REPS", 2)
    monkeypatch.setattr(jm, "SPH", [tuple(float(v) for v in row)
                                    for row in sub[:, :14]])
    return sub


@pytest.mark.parametrize("kernel", ["W8", "C8", "C9"])
def test_gated_matches_jax(monkeypatch, kernel):
    """run_gated's kernels (make_kernel_w8, make_kernel_c8,
    make_kernel_c9) over 2 clusters (W8) or 1 (C8, C9) of the nearest
    spheres, 2 reps, entry patterns drawn as run_gated draws them (1 of 2
    cluster conds; 3 of 8 (cluster, row) conds), against the port's plain version: the
    winner's t + attr0 + attr9 summed over reps agrees to 1e-4 relative
    where a sphere was hit (t moves by ulps under XLA:CPU's contracted
    multiply-adds and C9 adds its two attributes in another order; a
    winner flip moves the attributes by far more), exactly where none
    was."""
    pattern = "W8" if kernel == "W8" else "C8"
    n_cl, entered = (2, 1) if kernel == "W8" else (1, 3)
    sub = _gated_case(monkeypatch, n_cl)
    table = tm.cond_table(pattern, n_clusters=n_cl, entered=entered)
    if kernel == "W8":
        cond = tm.entry_pattern(n_cl, entered)
        ins = [cond] + _ray_ins()
        ref = _interpret(jm.make_kernel_w8(entered, n_clusters=n_cl), 1,
                         ins)
    else:
        cond = tm.entry_pattern(n_cl * 8, entered)
        if kernel == "C9":
            masks = np.zeros(n_cl, np.int32)
            for ci in np.nonzero(cond)[0]:
                masks[ci // 8] |= 1 << (ci % 8)
            maker, scalars = jm.make_kernel_c9(n_clusters=n_cl), masks
        else:
            maker = jm.make_kernel_c8(entered, n_clusters=n_cl)
            scalars = cond
        ins = [jnp.asarray(sub), scalars] + _ray_ins()
        specs = [FULL, SMEM] + [FULL] * 6
        fn = pl.pallas_call(maker, in_specs=specs, out_specs=FULL,
                            out_shape=jax.ShapeDtypeStruct((8, 128),
                                                           jnp.float32),
                            interpret=True)
        ref = np.asarray(fn(*ins)).reshape(-1)
    port = tm.gated_sweep(torch.from_numpy(sub), torch.from_numpy(table),
                          tm.ray_planes(), 2, pattern).numpy()
    hit = ref < 1e29
    assert 10 < hit.sum() < ref.size
    np.testing.assert_array_equal(port[~hit], ref[~hit])
    np.testing.assert_allclose(port[hit], ref[hit], rtol=1e-4, atol=0)


@pytest.mark.parametrize("fmas", [0, 64])
def test_stream_matches_jax(fmas):
    """hbm_bw's stream_kernel on a (64, 128) buffer in four 8 KB chunks,
    2 passes, against the port's plain version and the float64 sums: both
    within the stated float32 summation bound (hbm_bw.tolerance: the
    reference sums on one core, one block)."""
    data = np.random.RandomState(0).rand(64, 128).astype(np.float32)
    kernel = functools.partial(jhb.stream_kernel, chunk_rows=16, n_chunks=4,
                               compute_iters=fmas)
    fn = pl.pallas_call(kernel, in_specs=[SMEM, pl.BlockSpec(
        memory_space=pltpu.HBM)], out_specs=FULL,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(fn(np.array([2], np.int32), jnp.asarray(data)))
    t = torch.from_numpy(data)
    port = thb.stream(t, 2, fmas, 8).numpy()
    exact = thb.exact_sums(t, 2).numpy()
    bound = thb.tolerance(t, 2, 8, 1)
    assert 0 < bound < 1e-3
    assert np.abs(port - exact).max() <= bound
    assert np.abs(ref - exact).max() <= bound
    assert np.abs(port - ref).max() <= 2 * bound


def test_stream_plain_chain_term():
    """The chain's closed form is the recurrence it replaces (float64),
    and the chain adds x * 1e-30 to every accumulator entry."""
    x, a = 0.1, thb._FMA_A
    for _ in range(1000):
        x = x * a + 0.5
    assert thb.chain_value(1000) == pytest.approx(x, rel=1e-9)
    data = torch.zeros((32, 128))
    assert float(thb.stream(data, 3, 512, 8).max()) == pytest.approx(
        thb.chain_value(3 * 2 * 512) * 1e-30, rel=1e-6)


# --- entry points, wrappers ----------------------------------------------------------

MODULES = {"pair_ceiling": tpc, "tripair": ttp, "hbm_bw": thb,
           "micro_r2": tm}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_runs_plain_on_cpu(name, capsys):
    assert MODULES[name].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plain version" in out and "not measured" in out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_raises_without_a_card(name, monkeypatch):
    """No card and no ``--device cpu``: the probe raises, and does not
    fall back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        MODULES[name].main([])


def test_wrappers_check_their_inputs(monkeypatch):
    rays = tm.ray_planes()
    tab = torch.from_numpy(tm.PACKED_SM)
    with pytest.raises(ValueError, match="rays"):
        tpc.pair_sweep(tab, rays[:5].contiguous(), 1)
    with pytest.raises(ValueError, match="rays"):
        tpc.pair_sweep(tab, rays.double(), 1)
    with pytest.raises(ValueError, match="variant"):
        tpc.pair_sweep(tab, rays, 1, "C7")
    with pytest.raises(ValueError, match="tab"):
        tpc.pair_sweep(tab[:, :16].contiguous(), rays, 1)
    cond = torch.from_numpy(tm.cond_table("C8"))
    with pytest.raises(ValueError, match="cond"):
        tm.gated_sweep(tab, cond.float(), rays, 1, "C8")
    with pytest.raises(ValueError, match="gating"):
        tm.gated_sweep(tab, cond, rays, 1, "C8", "warp")
    mt_tab, _mx, pk = (torch.from_numpy(a) for a in ttp.build_tables())
    with pytest.raises(ValueError, match="multiple of 16"):
        ttp.tripair_sweep(mt_tab[:40], pk[:40], rays, 1)
    with pytest.raises(ValueError, match="form"):
        ttp.tripair_sweep(mt_tab, pk, rays, 1, "T3")
    with pytest.raises(ValueError, match="chunk_kb"):
        thb.stream(torch.zeros(64, 128), 1, 0, 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        thb.stream(torch.zeros(40, 128), 1, 0, 8)
    with pytest.raises(ValueError, match="device"):
        _slope.device("tpu")
    # On a card, csrc/probe_pairs.cu's blocks cover whole copies of the
    # 1024 rays: any other count is refused before a launch (the plain
    # versions above take it).
    cond = torch.from_numpy(tm.cond_table("C8"))
    part = rays[:, :1000].contiguous()
    assert tpc.pair_sweep(tab, part, 1).shape == (1000,)

    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(_slope, "one_device",
                        lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(_slope, "launch", no_launch)
    for variant in tpc.VARIANTS:
        with pytest.raises(ValueError, match="whole copies of 1024"):
            tpc.pair_sweep(tab, part, 1, variant)
    for pattern, gating in [("C8", "thread"), ("W8", "worklist")]:
        with pytest.raises(ValueError, match="whole copies of 1024"):
            tm.gated_sweep(tab, cond, part, 1, pattern, gating)


def test_sqrt_rn_is_defined_once_in_the_shared_header():
    """The branchless square root that both sphere-pair probe sources
    sweep with, and that the smoke checks against sqrtf on all 2^32
    floats, has one definition: csrc/probe_math.cuh's, which
    probe_pairs.cu and probe_designs.cu include; neither calls nvcc's
    sqrtf in a sweep."""
    csrc = Path(tpc.__file__).resolve().parents[1] / "csrc"
    defined = [p.name for p in sorted(csrc.glob("*.cu*"))
               if "float sqrt_rn(float" in p.read_text()]
    assert defined == ["probe_math.cuh"]
    for name in ("probe_pairs.cu", "probe_designs.cu"):
        src = (csrc / name).read_text()
        assert '#include "probe_math.cuh"' in src
    pairs = (csrc / "probe_pairs.cu").read_text()
    assert "sqrtf(" not in pairs
    # probe_designs.cu calls sqrtf only to check sqrt_rn against it.
    designs = (csrc / "probe_designs.cu").read_text()
    assert designs.count("sqrtf(x)") == 1 and designs.count("sqrtf(") == 1
    math = (csrc / "probe_math.cuh").read_text()
    assert math.count("sqrt_rn(") == 3     # its definition and two calls


def test_plain_versions_launch_nothing():
    tm.gated_sweep(torch.from_numpy(tm.PACKED_SM),
                   torch.from_numpy(tm.cond_table("W8")), tm.ray_planes(),
                   1, "W8", "vote")
    tpc.pair_sweep(torch.from_numpy(tm.PACKED_SM), tm.ray_planes(), 1, "A2")
    thb.stream(torch.zeros(32, 128), 1, 0, 8, "plain")
    assert not any(tpc.LAUNCHES.values())
    assert not any(ttp.LAUNCHES.values())
    assert not any(thb.LAUNCHES.values())
    assert not any(tm.LAUNCHES.values())
