"""The recluster segment kernels' two forms, on the CPU.

``csrc/dynculled.cu``'s and ``csrc/baked.cu``'s segment kernels run a
segment with each lane on its own thread (``common.cuh`` trace_segment,
``sweep=SWEEP_SERIAL``) or with the warp's lanes in step
(trace_segment_warp, the shipped ``SWEEP_COOP``): one loop of trips while
some lane of the warp is live and fewer than k_iters trips have run,
every lane calling the intersect with its ``live`` flag, the culled
sweeps voting per cluster and the unculled one staging its triangle rows
a warp at a time.  The kernels run only on the card (``chip_smoke.py``
phases seg, segfull and segform; ``tests/test_torch_cuda.py``).  Here: the
wrappers' form argument, a torch emulation of the in-step loop over the
warp sweeps' emulations (``tests/test_torch_coop_sweep.py``,
``tests/test_torch_loop_forms.py``) held bit for bit to
``segment_reference`` (radiance, state, ids and the four count rows, row
3's trips per warp included), and the segment divergence count held to
the plain version's counters.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_coop_sweep import _bake, _dyn_case, coop_sweep
from tests.test_torch_coop_sweep import dyn_coop_sweep
from tests.test_torch_loop_forms import _terrain_bake, staged_sweep
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.scene import CameraController
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

WARP = 32


def _state(cc, w, h, n_pad, seed, dead=0.0, bounces=0):
    """(ids, state, counts) of one sample's primary rays over a w x h
    image in block order (``models/fused.py`` ``segment_state``), padded
    to ``n_pad`` lanes (dead at entry), with a share ``dead`` of the
    pixel lanes dead at entry too, the paths' bounce counters drawn from
    0 .. ``bounces`` - 1 where it is given (as if earlier segments had
    run), and counters that already hold something (a launch adds to
    them)."""
    cfg = RenderConfig(width=w, height=h, engine="fused")
    perm, _ = tfused._block_perm(w, h, 32)
    ids, state = tfused.segment_state(
        torch.from_numpy(perm.astype(np.int64)), n_pad, cfg, 3, 1,
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h))
    rng = np.random.default_rng(seed)
    kill = torch.from_numpy(rng.uniform(size=n_pad) < dead)
    state[12, kill] = 0.0
    if bounces:
        ids[2] = torch.from_numpy(
            rng.integers(0, bounces, size=n_pad).astype(np.int32))
    counts = torch.from_numpy(
        rng.integers(0, 5, size=(tfk.SEG_COUNTS, n_pad)).astype(np.int32))
    return ids, state, counts


def _padded(v, n):
    return torch.cat([v, v.new_zeros(n - v.shape[0])])


def segment_in_step(isect_warps, salts, ids, state, counts, **kw):
    """``common.cuh`` trace_segment_warp emulated: the warps (32 lanes in
    lane order, the last one ragged and padded with lanes that are not in)
    run one loop of trips; a warp takes a trip while some lane of it is
    live and fewer than k_iters trips have run, so its trips are the
    loop's own.  In a trip every live lane traces one ray, its bounce
    (shade, scatter, roulette, the state's update) the plain version's
    (``segment_reference`` of one bounce), and the nearest hits come from
    ``isect_warps(rays, live)``, the warp sweeps over every lane of the
    padded warps with each lane's ``live`` flag, returning the plain
    intersect's tuple for every lane.  Lanes dead at entry are never
    live.  Row 3 gains each warp's trips."""
    frame, max_bounces, k_iters, _ = tfk._salts(salts)
    n = state.shape[1]
    n_warps = -(-n // WARP)
    trips = torch.zeros(n_warps, dtype=torch.int32)
    step_counts = torch.zeros_like(counts)

    def intersect(*rays):
        live = torch.nonzero(state[12] > 0)[:, 0]
        full = [_padded(state[k].clone(), n_warps * WARP) for k in range(6)]
        for f, v in zip(full, rays):
            f[live] = v
        on = torch.zeros(n_warps * WARP, dtype=torch.bool)
        on[live] = True
        return tuple(None if f is None else f[live]
                     for f in isect_warps(full, on))

    for _ in range(k_iters):
        warp_live = _padded(state[12] > 0, n_warps * WARP).reshape(
            n_warps, WARP).any(dim=1)
        if not warp_live.any():
            break
        trips += warp_live.to(torch.int32)
        tfk.segment_reference(intersect, (frame, max_bounces, 1, 0), ids,
                              state, step_counts, **kw)
    counts[:3] += step_counts[:3]
    counts[3, :n_warps] += trips
    return ids, state, counts


def _culled_warps(baked):
    def isect(rays, on):
        t, i, _, supers, clusters, _ = coop_sweep(baked, rays, 8, 12,
                                                  live=on.numpy())
        return tbk._winner(baked, torch.from_numpy(t), torch.from_numpy(i)) \
            + (torch.from_numpy(supers), torch.from_numpy(clusters))
    return isect


def _dyn_warps(tab):
    def isect(rays, on):
        t, i, supers, clusters, _ = dyn_coop_sweep(tab, rays, 8, 12,
                                                   live=on.numpy())
        return tdk._winner(tab, torch.from_numpy(t), torch.from_numpy(i)) \
            + (torch.from_numpy(supers), torch.from_numpy(clusters))
    return isect


def _staged_warps(baked):
    def isect(rays, on):
        return staged_sweep(baked, rays, on)[0] + (None, None)
    return isect


def _same(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


# name -> (tables, warp sweeps, plain segment, camera, w, h, lanes, salts,
# options, share dead at entry)
def _case(name):
    book = CameraController.book_one_final()
    if name in ("culled-dead", "culled-ragged", "culled-kcut",
                "culled-roulette", "culled-doubled"):
        baked = _bake("book_one_final", 16,
                      copies=2 if name == "culled-doubled" else 1)
        spec = {"culled-dead": ((0, 50, 2, 0), {}, 0.3, 128),
                "culled-ragged": ((0, 50, 4, 0), {}, 0.0, 150),
                "culled-kcut": ((0, 6, 4, 0), {}, 0.1, 128),
                "culled-roulette": ((0, 50, 8, 0),
                                    {"rr_start": 1, "rr_floor": 0.3,
                                     "clamp": 0.5}, 0.1, 140),
                "culled-doubled": ((0, 50, 4, 0), {}, 0.0, 128)}[name]
        return (baked, _culled_warps(baked), tbk.fused_segment_baked_reference,
                book, 16, 8, *spec)
    if name in ("dyn-tri-flat", "dyn-tri-rolled"):
        tab, cc = _dyn_case(name[4:])
        return (tab, _dyn_warps(tab), tdk.fused_segment_dynculled_reference,
                cc, 16, 8, (0, 50, 4, 0), {"rr_start": 2}, 0.2, 150)
    baked = _terrain_bake("ragged")        # 50 triangle rows: chunk of 18
    return (baked, _staged_warps(baked), tbk.fused_segment_baked_reference,
            book, 16, 8, (0, 50, 4, 0), {}, 0.2, 150)


@pytest.mark.parametrize("name", [
    "culled-dead", "culled-ragged", "culled-kcut", "culled-roulette",
    "culled-doubled", "dyn-tri-flat", "dyn-tri-rolled", "unculled-staged"])
def test_in_step_segment_equals_plain_version(name):
    """The emulated in-step segment gives ``segment_reference``'s state,
    ids and counters bit for bit, row 3's trips included (the loop's own
    trips are the largest ray count of the warp's lanes in the launch);
    lanes dead at entry are left as they were; the cases take lanes dead
    at entry (random ones and the padding of a ragged last warp), k_iters
    below and above the paths' length, roulette and the clamp, the
    doubled book's exact ties, triangles in flat and rolled dynamic
    sweeps, and the unculled sweep's staged triangle rows (50 rows: a
    ragged last chunk of 32)."""
    (tables, warps, plain, cc, w, h, salts, opts, dead,
     n_pad) = _case(name)
    ids, state, counts = _state(cc, w, h, n_pad, len(name), dead,
                                salts[1] if name == "culled-kcut" else 0)
    entered = state[12] > 0
    before = (ids.clone(), state.clone(), counts.clone())
    want = plain(tables, salts, ids.clone(), state.clone(), counts.clone(),
                 **opts)
    got = segment_in_step(warps, salts, ids.clone(), state.clone(),
                          counts.clone(), **opts)
    assert _same(got, want)
    for now, then in zip(got, before):
        assert torch.equal(now[:3, ~entered], then[:3, ~entered])
    rays = (got[2][0] - before[2][0]).to(torch.int64)
    trips = (got[2][3] - before[2][3]).to(torch.int64)
    n_warps = -(-n_pad // WARP)
    assert torch.equal(trips[:n_warps], tfk.warp_max(rays))
    assert not trips[n_warps:].any()
    k_iters, max_bounces = salts[2], salts[1]
    still = got[1][12] > 0
    ended = entered & ~still
    assert ended.any()
    assert still.any() or not name.startswith("culled-") \
        or name == "culled-roulette"
    assert int(trips.max()) == int(rays.max()) <= k_iters
    assert int(rays.max()) == k_iters or name == "culled-roulette"
    if n_pad % WARP:
        assert not entered[-(n_pad % WARP):].any()
    if name == "culled-kcut":             # cut by k_iters, or at the end
        assert (got[0][2][ended] == max_bounces).any()
        assert (still & (rays == k_iters)).any()
    if name == "culled-roulette":
        assert (got[0][2][ended] < k_iters).any()


@pytest.mark.parametrize("kind", ["baked", "dynculled"])
def test_segment_sweep_form_is_checked_and_changes_nothing_on_cpu(kind):
    """Both segment wrappers take the form as one keyword argument,
    refuse an unknown one, and on the CPU run the plain version whatever
    the form; no kernel launch is counted."""
    if kind == "baked":
        tables, cc = _bake("book_one_final", 16), \
            CameraController.book_one_final()
        fn, mod = tbk.fused_segment_baked, tbk
    else:
        tables, cc = _dyn_case("tri-flat")
        fn, mod = tdk.fused_segment_dynculled, tdk
    ids, state, counts = _state(cc, 16, 8, 128, 1, 0.1)
    salts = (0, 50, 2, 0)
    outs = [fn(tables, salts, ids.clone(), state.clone(), counts.clone(),
               **({} if sweep is None else {"sweep": sweep}))
            for sweep in (None, mod.SWEEP_SERIAL, mod.SWEEP_COOP)]
    for out in outs[1:]:
        assert _same(out, outs[0])
    with pytest.raises(ValueError, match="sweep form"):
        fn(tables, salts, ids, state, counts, sweep=mod.SWEEP_COOP + 1)
    assert tbk.LAUNCHES["segment_culled"] == 0
    assert tbk.COOP_LAUNCHES["segment_culled"] == 0
    assert tdk.SEGMENT_LAUNCHES == tdk.SEGMENT_COOP_LAUNCHES == 0


def test_fold_steps_hand_made():
    """Two trips of a 4-lane warp over clusters of 3 and 5 items, and one
    of another warp, at G = 2 (two rays a pass) and T = 2: the serial form
    runs each union cluster once; the shipped one folds a cluster of at
    most 2 entering lanes in ceil(m / 2) passes of ceil(size / 2) steps,
    and the cluster that 3 lanes entered serially."""
    keys = torch.tensor([0, 0, 0, 1, 1, 5])
    entered = torch.tensor([[1, 1], [1, 1], [1, 0], [0, 1], [0, 0], [1, 1]],
                           dtype=torch.bool)
    got = tbk.fold_steps(keys, entered, [3, 5], group=2, t_max=2, warp=4)
    # trip 0: cluster 0 by 3 lanes (serial, 3), cluster 1 by 2 (1 pass of
    # 3 steps); trip 1: cluster 1 by 1 (1 pass, 3 steps); trip 5: both by
    # 1 (1 pass of 2, 1 pass of 3).
    assert got == {"serial_steps": 3 + 5 + 5 + 3 + 5,
                   "coop_steps": 3 + 3 + 3 + 2 + 3,
                   "coop_passes": 4, "reach": 4 / 5}


def _counting_run(tables, salts, ids, state, counts):
    def run(segment):
        segment(tables, salts, ids, state, counts)
    return run


@pytest.mark.parametrize("kind", ["culled", "dyn-rolled"])
def test_segment_divergence_matches_counters(kind):
    """One launch of hand-made lanes (the book's primary rays, a tenth
    dead at entry, a ragged last warp) counted by ``segment_divergence``:
    its rays, trips, supers and clusters agree with what the plain
    version adds to the counters (row 3's trips per warp included), the
    spy leaves the plain version's results as they are, and the fold's
    pair steps lie between the useful and the issued lane-pairs' share."""
    if kind == "culled":
        tables, cc = _bake("book_one_final", 16), \
            CameraController.book_one_final()
        module, plain = tbk, tbk.fused_segment_baked_reference
    else:
        tables, cc = _dyn_case("rolled")
        module, plain = tdk, tdk.fused_segment_dynculled_reference
    ids, state, counts = _state(cc, 16, 8, 150, 7, 0.1)
    salts = (0, 50, 4, 0)
    want = plain(tables, salts, ids.clone(), state.clone(), counts.clone())
    got_state = (ids.clone(), state.clone(), counts.clone())
    launches = module.segment_divergence(tables,
                                         _counting_run(tables, salts,
                                                       *got_state))
    assert _same(got_state, want)
    (rep,) = launches
    added = (want[2] - counts).sum(dim=1).tolist()
    assert rep["k_iters"] == 4 and rep["launch"] == 0
    assert rep["live_lanes"] == int((state[12] > 0).sum())
    assert rep["rays"] == added[0] and rep["trips"] == added[3]
    assert round(rep["clusters_per_ray"] * rep["rays"]) == added[2]
    if kind != "culled":
        assert round(rep["supers_per_ray"] * rep["rays"]) == added[1] > 0
        assert rep["super_boxes_per_ray"] == tables.n_supers
    assert rep["coop_steps"] < rep["serial_steps"]
    assert rep["serial_steps"] * WARP == rep["issued_pairs"]
    assert 0.0 < rep["reach"] <= 1.0
    assert sum(rep["entering_lanes"]) > 0
    assert tbk._take.__name__ == "_take" and tdk.torch is torch


def test_segment_divergence_command_on_cpu(capsys):
    """``profile_frame --row NAME --recluster 2 --divergence LANES --spp N
    --device cpu`` counts a row's segments from the plain version on the
    host: one block of the knot at 1 spp, six launches summed by schedule
    index, each sum's model ratio below 1 where clusters were entered."""
    from wavefront_path_tracer_tpu_torch import profile_frame

    assert profile_frame.main(["--row", "knot50k_dynamic", "--divergence",
                               "1024", "--spp", "1", "--recluster", "2",
                               "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["schedule"] == [2, 2, 4, 8, 16, 18] and rep["pixels"] == 1024
    assert len(rep["launches"]) == 6 and len(rep["by_index"]) == 6
    total = rep["total"]
    assert total["rays"] == sum(b["rays"] for b in rep["by_index"]) >= 1024
    assert total["rays"] == sum(x["rays"] for x in rep["launches"])
    assert rep["by_index"][0]["trips"] == 1024 // WARP * 2
    assert 0.0 < total["model_coop_over_serial"] < 1.0
    assert total["coop_steps"] < total["serial_steps"]
