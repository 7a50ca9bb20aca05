"""The intersect-loop designs of ``exp/micro_r2.py``'s ``run_pairs``
(``wavefront_path_tracer_tpu_torch/probes/run_pairs.py``) on the CPU:
each design's plain version against its ``exp/`` Pallas kernel in
interpret mode over 16 or 32 of the spheres nearest the rays, 2 reps (the
exp module loaded as this file's own module object, its globals set with
monkeypatch; no file of ``exp/`` is edited).  The kernels run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wavefront_path_tracer_tpu_torch.probes import micro_r2 as tm
from wavefront_path_tracer_tpu_torch.probes import run_pairs as trp

torch.set_num_threads(2)

EXP = Path(__file__).resolve().parents[1] / "exp"


def _load_reference():
    """``exp/micro_r2.py`` as a module object of this file's own.  Its
    kernels read the module's globals (S, REPS, SPH, packed, PACKED_SM)
    when they are traced, and tests/test_torch_probes.py and
    tests/test_torch_issue_mm.py set those of the ``micro_r2`` module that
    they import; here no other file's use of that shared module object,
    in whatever order a worker runs the files, reaches the references."""
    spec = importlib.util.spec_from_file_location("micro_r2_run_pairs",
                                                  EXP / "micro_r2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jm = _load_reference()

FULL = pl.BlockSpec(memory_space=pltpu.VMEM)


def _near(n):
    """The ``n`` spheres nearest the rays' origins, in table order (as
    tests/test_torch_probes.py picks them: the first spheres miss)."""
    gap = np.linalg.norm(jm.centers, axis=1) - jm.radii
    return np.sort(np.argsort(gap)[:n])


# The tile-gated designs' (clusters, spheres a cluster) here: their boxes
# c = 0, 1, ... open on these rays only from c = 7 (W) or 13 (W7) on.
GATED = {"W": (12, 2), "W0": (12, 2), "W2": (12, 2), "W5": (12, 2),
         "W6": (12, 2), "W7": (16, 8)}


def _kernel(design, n):
    """The exp kernel of ``design`` over ``n`` spheres and whether it
    takes a table (False, True or "sm"), as run_pairs calls it."""
    n_cl, size = GATED.get(design, (0, 0))
    return {
        "A": (jm.kernel_a, False), "B": (jm.kernel_b, False),
        "C2": (jm.kernel_c2, True), "C3": (jm.kernel_c3, True),
        "C4": (jm.make_kernel_c45(True, 2), True),
        "C5": (jm.make_kernel_c45(False, 10), True),
        "C45": (jm.make_kernel_c45(True, 10), True),
        "Q": (jm.kernel_q, False), "Q2": (jm.kernel_q2, False),
        "Q4": (jm.make_kernel_qn(4), False),
        "Q8": (jm.make_kernel_qn(8), False),
        "C6": (jm.make_kernel_c6(False), "sm"),
        "A2": (jm.make_kernel_a2(False), False),
        "C6d": (jm.make_kernel_c6(True), "sm"),
        "A2d": (jm.make_kernel_a2(True), False),
        "C7": (jm.make_kernel_c7(10), "sm"),
        "C": (jm.kernel_c, True),
        "W": (jm.make_kernel_when(n_cl, size, True), False),
        "W0": (jm.make_kernel_when(n_cl, size, False), False),
        "W2": (jm.make_kernel_when(n_cl, 0, True), False),
        "W5": (jm.make_kernel_when2(n_cl, size, "pre"), False),
        "W6": (jm.make_kernel_when2(n_cl, size, "pack"), False),
        "W7": (jm.make_kernel_w7(n_cl, size), True),
    }[design]


def _run_pairs_interpret(monkeypatch, design, n):
    """run_pairs's call of ``design``'s kernel over the ``n`` nearest
    spheres at REPS 2 in interpret mode; (reference output flattened in
    lane order, the port's table of those spheres)."""
    idx = _near(n)
    packed = np.ascontiguousarray(jm.packed[idx])
    sm = np.ascontiguousarray(jm.PACKED_SM[idx])
    monkeypatch.setattr(jm, "S", n)
    monkeypatch.setattr(jm, "REPS", 2)
    monkeypatch.setattr(jm, "packed", packed)
    monkeypatch.setattr(jm, "PACKED_SM", sm)
    monkeypatch.setattr(jm, "SPH", [tuple(float(v) for v in row)
                                    for row in packed[:, :14]])
    kernel, table = _kernel(design, n)
    ins = [jnp.asarray(x) for x in (jm.ox0, jm.oy0, jm.oz0,
                                    jm.dx0, jm.dy0, jm.dz0)]
    if table == "sm":
        ins = [jnp.asarray(sm)] + ins
    elif table:
        ins = [jnp.asarray(packed)] + ins
    fn = pl.pallas_call(kernel, in_specs=[FULL] * len(ins), out_specs=FULL,
                        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                        interpret=True)
    ref = np.asarray(fn(*ins)).reshape(-1)
    port_tab = sm if design in trp.SM_TABLE else packed
    return ref, torch.from_numpy(port_tab)


@pytest.mark.parametrize("design", [d for d in trp.DESIGNS
                                    if d not in ("C6", "A2")])
def test_design_matches_jax(monkeypatch, design):
    """Each design's plain version against its exp kernel over 16 spheres
    (the tile-gated designs: 12 boxes gating 2 spheres each, W7 16 of 8,
    so that boxes open on these rays; W2 gates empty bodies), 2 reps: within
    1e-5 relative where a sphere was hit (XLA:CPU contracts the
    quadratic's multiply-adds, so t moves by ulps; a winner flip moves
    the summed attributes by far more) and exactly where none was.  C6
    and A2 are the pair ceiling's function, held in
    tests/test_torch_probes.py."""
    n_cl, size = GATED.get(design, (2, 8))
    ref, tab = _run_pairs_interpret(monkeypatch, design, n_cl * size)
    if design in trp.TILE_GATED:      # design_sweep takes 16-row multiples
        monkeypatch.setattr(tm, "CLUSTER_SIZE", size)
        port = trp.design_reference(tab, tm.ray_planes(), 2, design).numpy()
    else:
        port = trp.design_sweep(tab, tm.ray_planes(), 2, design).numpy()
    far = ref >= 1e29
    if design != "W2":
        assert 50 < (~far).sum()
    np.testing.assert_array_equal(port[far], ref[far])
    np.testing.assert_allclose(port[~far], ref[~far], rtol=1e-5, atol=0)


def test_designs_that_share_a_function():
    """B, C2, C3, C5 and C45 compute A's function; Q4, Q8 and W0 Q's; A2d
    C6d's (the plain versions bit for bit, full table, 1024 rays)."""
    rays = tm.ray_planes()
    tab = trp.table_for("A")
    sm = trp.table_for("C6d")
    out = {d: trp.design_sweep(sm if d in trp.SM_TABLE else tab, rays, 2,
                               d).view(torch.int32)
           for d in ("A", "B", "C2", "C3", "C5", "C45", "Q", "Q4", "Q8",
                     "W0", "C6d", "A2d")}
    for same, ref in ((("B", "C2", "C3", "C5", "C45"), "A"),
                      (("Q4", "Q8", "W0"), "Q"), (("A2d",), "C6d")):
        for d in same:
            assert torch.equal(out[d], out[ref]), d


def test_tile_gates_follow_the_tile():
    """W's gate is any(live) over the whole tile of 1024 rays: a lane that
    is not live still sweeps the cluster when another lane enters it, so
    W equals W0 (every cluster) on every ray of a tile whose gates all
    open, and W2 adds T_FAR each rep."""
    rays = tm.ray_planes()
    tab = trp.table_for("W")
    w = trp.design_sweep(tab, rays, 2, "W")
    w0 = trp.design_sweep(tab, rays, 2, "W0")
    w2 = trp.design_sweep(tab, rays, 2, "W2")
    assert torch.all(w2 == 2 * np.float32(1e30))
    assert torch.all(w >= w0)
    # Two copies of the tile give two equal halves.
    two = trp.design_sweep(tab, tm.ray_planes(copies=2), 1, "W5")
    assert torch.equal(two[:1024], two[1024:])


def test_design_wrapper_checks_and_counts():
    rays = tm.ray_planes()
    tab = trp.table_for("A")
    with pytest.raises(ValueError, match="design"):
        trp.design_sweep(tab, rays, 1, "C8")
    with pytest.raises(ValueError, match="table in"):
        trp.design_sweep(tab, rays, 1, "A", place="shared")
    with pytest.raises(ValueError, match="lanes"):
        trp.design_sweep(trp.table_for("C7"), rays, 1, "C7", lanes=4)
    with pytest.raises(ValueError, match=r"\(S, 24\)"):
        trp.design_sweep(tab, rays, 1, "C7")
    with pytest.raises(ValueError, match="tiles of 1024"):
        trp.design_sweep(tab, rays[:, :512].contiguous(), 1, "A")
    trp.design_sweep(tab, rays, 1, "C45", "shared")
    assert not any(trp.LAUNCHES.values())
    assert len(trp.DESIGNS) == 23
    assert {k for k, _p, _n in trp.LAUNCHES} == set(trp.DESIGNS) - {"C6",
                                                                    "A2"}


def test_command_lines_take_the_reference_names(capsys, monkeypatch):
    """micro_r2's command line takes exp/micro_r2.py's variant names (W
    runs W, W0 and W2; C6 C6 and C6d) and micro_slope's its defaults;
    ``--device cpu`` runs the plain versions; an unknown name is refused;
    without a card and without ``--device cpu`` both raise."""
    from wavefront_path_tracer_tpu_torch.probes import micro_slope

    got = tm.run(["W", "C6", "C9", "--device", "cpu"])
    assert [r.get("design", r.get("pattern")) for r in got] == [
        "W", "W0", "W2", "C6", "C6d", "C8"]
    got = micro_slope.run(["--device", "cpu"])
    assert [r.get("design", r.get("pattern")) for r in got] == [
        "C45", "C7", "W8", "C8"]
    out = capsys.readouterr().out
    assert "plain version" in out and "not measured" in out
    with pytest.raises(SystemExit):
        tm.run(["Z9", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tm.main, micro_slope.main):
        with pytest.raises(RuntimeError, match="needs CUDA"):
            main([])


@pytest.mark.parametrize("design", trp.DESIGNS)
def test_design_output_follows_its_ray(design):
    """A ray's output does not depend on where it stands among the rays:
    the 1024 rays of one tile permuted give the output permuted, bit for
    bit, at 2 reps over the full table (the kernels carry several rays a
    thread and may group them in any order; a tile-gated design's gates
    see the same tile)."""
    rays = tm.ray_planes()
    perm = torch.from_numpy(np.random.default_rng(21).permutation(
        rays.shape[1]))
    tab = trp.table_for(design)
    out = trp.design_reference(tab, rays, 2, design)
    moved = trp.design_reference(tab, rays[:, perm].contiguous(), 2, design)
    assert torch.equal(moved.view(torch.int32), out[perm].view(torch.int32))
    assert design == "W2" or bool((out < 1e29).any())
