"""The culled bakes' hierarchy parameters (``ops/bake.py`` ``bake_culled``:
super_factor, super_gate, global_radius_factor, refresh, pack_attrs) and
the dynamic tables' cluster sizes against the JAX package, renders over
them through the plain versions, and the hierarchy sweeps of
``probes/`` on the CPU.

The reference's closure keeps its hierarchy in its cells
(``sph_hier``: clusters, supers and the slab; ``shift``; ``global_rows``),
so the super ranges and the sweep order are held to them directly."""

import json

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dyn_tables as dt
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.probes import (
    _hier,
    cullstats,
    dynnocull,
    dynsweep,
    knotbench,
    meshscale,
    rr_floor_sweep,
    super_gate,
    sweep10k,
)
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")
HINT = np.array([13.0, 2.0, 3.0])


def _arrays(scene, tris=None):
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    if tris is not None:
        a.update(tri_v0=tris.v0, tri_e1=tris.e1, tri_e2=tris.e2,
                 tri_albedo=tris.albedo, tri_fuzz=tris.fuzz,
                 tri_refract=tris.refract_idx, tri_mat_type=tris.mat_type)
    return a


def _cell(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _check_hierarchy(port, ref, gate):
    """Metadata as ``test_torch_bake._check_meta``, the shift, and the
    sphere hierarchy's sweep: the item order (globals, then each cluster
    in the reference's sweep order), the cluster boxes and ranges, and
    the super boxes and ranges where the sweep is two-level."""
    assert port.n_globals == ref.n_globals
    assert port.n_clusters == ref.n_clusters
    assert port.n_supers == ref.n_supers
    assert port.n_clustered_items == ref.n_clustered_items
    assert port.pack_attrs == ref.pack_attrs
    assert [(list(lo), list(hi)) for lo, hi in port.cluster_aabbs] == [
        (list(lo), list(hi)) for lo, hi in ref.cluster_aabbs]
    shift = _cell(ref, "shift")
    np.testing.assert_array_equal(port.consts.numpy()[0:3],
                                  np.asarray(shift, np.float32))
    clusters, supers, _slab = _cell(ref, "sph_hier")
    two_level = len(clusters) > gate
    sweep = [c for s in supers for c in s[2]] if two_level else clusters
    centres = [row[0:3] for row in _cell(ref, "global_rows")]
    for cluster in sweep:
        centres += [row[0:3] for row in cluster[2]]
    np.testing.assert_array_equal(port.items.numpy()[:, 8:11],
                                  np.asarray(centres, np.float32).reshape(
                                      -1, 3))
    boxes = port.cluster_boxes.numpy()
    assert boxes[:, [0, 1, 2, 4, 5, 6]].tolist() == [
        list(np.float32(lo)) + list(np.float32(hi))
        for lo, hi, *_ in sweep]
    sup = port.super_ranges.numpy().tolist()
    if two_level:
        first = np.cumsum([0] + [len(s[2]) for s in supers[:-1]])
        assert sup == [[int(k), len(s[2])] for k, s in zip(first, supers)]
        assert port.super_boxes.numpy()[:, [0, 1, 2, 4, 5, 6]].tolist() == [
            list(np.float32(lo)) + list(np.float32(hi))
            for lo, hi, _ in supers]
    else:
        assert sup == [] and port.super_boxes.shape == (0, 8)


@pytest.mark.parametrize("factor,gate", [(8, 48), (8, 0), (4, 0), (16, 0)])
def test_super_factor_and_gate_match_reference(factor, gate):
    a = _arrays(get_scene("book_one_final"))
    port = bake.bake_culled(a, 16, camera_hint=HINT, super_factor=factor,
                            super_gate=gate)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=16,
                                     camera_hint=HINT, super_factor=factor,
                                     super_gate=gate)
    _check_hierarchy(port, ref, gate)
    assert port.n_clusters == 31
    assert port.n_supers == -(-31 // factor)
    assert (port.super_ranges.shape[0] > 0) == (gate < 31)


@pytest.mark.parametrize("factor", [10.0, 3.0, 0.0])
def test_global_radius_factor_matches_reference(factor):
    a = _arrays(get_scene("book_one_final"))
    port = bake.bake_culled(a, 16, camera_hint=HINT,
                            global_radius_factor=factor)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=16,
                                     camera_hint=HINT,
                                     global_radius_factor=factor)
    _check_hierarchy(port, ref, bake.SUPER_GATE)
    # 10: the ground; 3: the ground and the three big spheres; 0: every
    # sphere of positive radius, so no cluster at all.
    expected = {10.0: 1, 3.0: 4, 0.0: len(a["radii"])}[factor]
    assert port.n_globals == expected
    if factor == 0.0:
        assert port.n_clusters == 0 and port.n_supers == 0


@pytest.mark.parametrize("factor,gate", [(8, 48), (4, 48), (8, 100)])
def test_procedural_two_level_matches_reference(factor, gate):
    a = _arrays(get_scene("procedural", n=120, seed=3))
    hint = np.array([-2.0, 2.0, 1.0])
    port = bake.bake_culled(a, 2, camera_hint=hint, super_factor=factor,
                            super_gate=gate)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=2,
                                     camera_hint=hint, super_factor=factor,
                                     super_gate=gate)
    _check_hierarchy(port, ref, gate)
    assert (port.super_ranges.shape[0] > 0) == (port.n_clusters > gate)


@pytest.mark.parametrize("pack", [True, "16", "10", False])
def test_pack_attrs_matches_reference(pack):
    a = _arrays(get_scene("procedural", n=96, seed=3))
    port = bake.bake_culled(a, 8, pack_attrs=pack)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=8,
                                     pack_attrs=pack)
    assert port.pack_attrs == ref.pack_attrs
    width = ref.pack_attrs
    items = port.items.numpy()
    idx = [np.nonzero((a["centers"] == c).all(axis=1))[0][0]
           for c in items[:, 8:11]]
    if width is None:
        np.testing.assert_array_equal(items[:, 12:15], a["albedo"][idx])
        return
    words = [jpk._pack_albedo_mat(*a["albedo"][i], a["mat_type"][i], width)
             for i in idx]
    pks = [np.array([w[k] for w in words], np.int32)
           for k in range(len(words[0]))]
    decoded = np.stack([np.asarray(v) for v in
                        jpk._unpack_albedo_mat(pks, width)], axis=1)
    np.testing.assert_array_equal(items[:, 12:15].view(np.int32),
                                  decoded[:, 0:3].view(np.int32))
    np.testing.assert_array_equal(items[:, 17], decoded[:, 3])


def test_parameters_refused():
    a = _arrays(get_scene("book_cover"))
    with pytest.raises(ValueError, match="super_factor"):
        bake.bake_culled(a, 16, super_factor=0)
    with pytest.raises(ValueError, match="refresh"):
        bake.bake_culled(a, 16, refresh=0)
    with pytest.raises(ValueError, match="pack_attrs"):
        bake.bake_culled(a, 16, pack_attrs="12")


def _same_tables(x, y):
    for f in ("items", "cluster_boxes", "cluster_ranges", "super_boxes",
              "super_ranges", "tri_items", "tri_cluster_boxes",
              "tri_cluster_ranges", "tri_super_boxes", "tri_super_ranges",
              "consts", "tex_items"):
        a, b = getattr(x, f), getattr(y, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes(), f
    assert (x.n_globals, x.n_clusters, x.n_supers, x.cluster_aabbs) == (
        y.n_globals, y.n_clusters, y.n_supers, y.cluster_aabbs)


def test_refresh_leaves_tables_byte_identical():
    """The port's sweep culls each ray against its own nearest hit at
    every cluster: the reference's cap refresh has nothing to batch."""
    a = _arrays(get_scene("procedural", n=120, seed=3))
    default = bake.bake_culled(a, 2, camera_hint=HINT)
    assert bake.REFRESH == 16
    for refresh in (999, 16, 4):
        _same_tables(bake.bake_culled(a, 2, camera_hint=HINT,
                                      refresh=refresh), default)


def test_sweeps_bake_through_the_render_paths_caches():
    """The defaults stay 8, 48, 10.0 and 16; a sweep's default
    configuration is the render path's own bake (``models/fused.py``),
    and a bake or table with other parameters is a cache entry of its
    own, equal to a direct bake from the quantized hint (no stale bake)."""
    assert (bake.SUPER_FACTOR, bake.SUPER_GATE, bake.GLOBAL_RADIUS_FACTOR,
            bake.REFRESH) == (8, 48, 10.0, 16)
    cc = CameraController.book_one_final()
    fr = _hier.frame(get_scene("book_one_final"), cc, "cpu", width=16,
                     height=8, spp=1, intersector="baked",
                     baked_clusters=16)
    eye = tfused._concrete_eye(cc.view_matrix())
    mine, _ = _hier.bake(fr, 16)
    assert mine is tfused._baked_scene(fr.arrays, 16, camera_pos=eye)
    assert _hier.bake(fr, 16, super_factor=8, refresh=16)[0] is mine
    two, _ = _hier.bake(fr, 16, super_gate=0, super_factor=4)
    assert two is not mine and two.super_ranges.shape[0] == 8
    _, hint = tfused._quantized_hint(fr.host["centers"], eye)
    _same_tables(two, bake.bake_culled(fr.host, 16, camera_hint=hint,
                                       super_gate=0, super_factor=4))
    with pytest.raises(ValueError, match="unculled"):
        tfused._baked_scene(fr.arrays, 0, super_gate=0)
    tab, _ = _hier.dynamic(fr, 16)
    assert tab is tfused._dyn_tables(fr.arrays, 16, camera_pos=eye)
    nocull, _ = _hier.dynamic(fr, 16, 0.0)
    assert nocull is not tab and nocull.n_clusters == 0


DYN_CASES = {
    "book8": lambda: (_arrays(get_scene("book_one_final")), 8, 10.0),
    "book32": lambda: (_arrays(get_scene("book_one_final")), 32, 10.0),
    "book64": lambda: (_arrays(get_scene("book_one_final")), 64, 10.0),
    "book_all_global": lambda: (_arrays(get_scene("book_one_final")), 16,
                                0.0),
    "bubble_all_global": lambda: (_arrays(get_scene("book_bubble")), 8,
                                  0.0),
    "terrain8": lambda: (_arrays(*mesh_terrain_scene(n_quads=18)), 8,
                         10.0),
}


@pytest.mark.parametrize("name", sorted(DYN_CASES))
def test_pack_culled_scene_byte_identical(name):
    a, cs, factor = DYN_CASES[name]()
    port = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=HINT,
                                global_radius_factor=factor)
    ref = jpk.pack_culled_scene(a, cluster_size=cs, camera_hint=HINT,
                                global_radius_factor=factor)
    for p, r in zip(port[:8], ref[:8]):
        assert p.dtype == r.dtype and p.shape == r.shape
        assert p.tobytes() == r.tobytes()
    assert port[8:] == ref[8:]
    ngb, ncl, nsup, ntc, ntsup, _ = port[8:]
    if name == "book8":
        assert ncl == 61 and nsup == 0          # flat, below 64
    if name == "terrain8":
        assert ntc > dt._DYN_UNROLL_CLUSTERS and ntsup > 0   # rolled
    if name == "book_all_global":
        assert ncl == 0 and ngb * 8 >= len(a["radii"])
    if name == "bubble_all_global":
        # The inside-out sphere is not global at factor 0; the rest of
        # the scene is too small to cluster, so all go global.
        assert ncl == 0 and ngb * 8 >= len(a["radii"])


SMALL = dict(width=64, height=36, spp=2, max_bounces=8)


def _cover():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    return cc


def _render(fr, tables):
    radiance, rays, stats = _hier.render(fr, tables)
    img = torch.empty_like(radiance)
    img[fr.pix] = radiance
    return img.numpy() / fr.config.samples_per_pixel, rays, stats


def test_two_level_render_matches_flat():
    fr = _hier.frame(get_scene("book_one_final"),
                     CameraController.book_one_final(), "cpu",
                     intersector="baked", baked_clusters=16, **SMALL)
    flat, _ = _hier.bake(fr, 16)
    two, _ = _hier.bake(fr, 16, super_gate=0, super_factor=4)
    assert two.super_ranges.shape[0] == 8
    img_f, rays_f, st_f = _render(fr, flat)
    img_t, rays_t, st_t = _render(fr, two)
    check_parity(img_t, img_f, rays_t, rays_f)
    assert st_f[1] == 0 and st_t[1] > 0          # supers entered
    assert st_t[2] > 0


def test_all_global_dynamic_render_matches_clustered():
    """The all-global table's conditioning shift is the median of every
    centre (the ground's too), not of the clustered ones (x -0.0665
    against -0.1329 on the book), so its quadratic rounds otherwise and
    a few paths take another hit; at 2 spp one such path is half its
    pixel (display RMSE 0.0084, 0.4% of pixels diverged), so the rule is
    applied at 8 spp, where a path is an eighth."""
    fr = _hier.frame(get_scene("book_one_final"),
                     CameraController.book_one_final(), "cpu",
                     intersector="bruteforce", baked_clusters=16,
                     **{**SMALL, "spp": 8})
    clustered, _ = _hier.dynamic(fr, 16)
    nocull, _ = _hier.dynamic(fr, 16, 0.0)
    assert nocull.n_clusters == 0 and nocull.n_tri_clusters == 0
    img_c, rays_c, st_c = _render(fr, clustered)
    img_n, rays_n, st_n = _render(fr, nocull)
    check_parity(img_n, img_c, rays_n, rays_c)
    assert st_n[1:] == [0, 0] and st_c[2] > 0


def test_two_level_render_matches_jax_megakernel():
    """A gate-0 bake of supers of 4 over 60 clusters of 2 against the
    JAX package's XLA megakernel (the reference's own cross-engine
    rule)."""
    scene = get_scene("procedural", n=120, seed=3)
    cc = _cover()
    cfg = RenderConfig(width=SMALL["width"], height=SMALL["height"],
                       samples_per_pixel=2, samples_per_frame=2,
                       max_bounces=8, engine="megakernel")
    mk = jax_render(scene, cc, cfg)
    fr = _hier.frame(scene, cc, "cpu", intersector="baked",
                     baked_clusters=2, **SMALL)
    baked, _ = _hier.bake(fr, 2, super_gate=0, super_factor=4)
    img, rays, stats = _render(fr, baked)
    assert stats[1] > 0
    check_parity(img, mk.accumulated.reshape(-1, 3) / 2)


def test_lane_counts_sum_to_the_launch():
    fr = _hier.frame(get_scene("book_one_final"),
                     CameraController.book_one_final(), "cpu",
                     intersector="baked", baked_clusters=16, width=16,
                     height=8, spp=1, max_bounces=8)
    planes = tfused.lane_planes(fr.pix, 16, fr.config.tile_rows)
    salts = (0, 0, 8, 1)
    baked, _ = _hier.bake(fr, 16, super_gate=0)
    tab, _ = _hier.dynamic(fr, 8)
    for launch, tables in ((tbk.fused_render_baked, baked),
                           (tdk.fused_render_dynculled, tab)):
        plain = launch(tables, salts, fr.cam_params, *planes)
        *rad, stats, lanes = launch(tables, salts, fr.cam_params, *planes,
                                    lane_counts=True)
        assert torch.equal(stats, plain[3])
        assert all(torch.equal(x, y) for x, y in zip(rad, plain[:3]))
        assert lanes.shape == (3, *planes[0].shape)
        assert lanes.dtype == torch.int64
        assert lanes[0].sum() == stats[0] and lanes[1].sum() == stats[2]
        assert lanes[2].sum() == stats[3]
        assert lanes[:, planes[3] == 0].sum() == 0     # padding lanes


# --- the sweeps, at tiny sizes on the CPU ---------------------------------

TINY = ["--device", "cpu", "--width", "16", "--height", "8", "--spp", "1",
        "--reps", "1"]


def _records(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_super_gate_sweep_runs(capsys):
    assert super_gate.main(TINY + ["--configs", "48x8,0x8,0x4,0x16"]) == 0
    out = capsys.readouterr().out
    recs = _records(out)
    assert [r["two_level"] for r in recs] == [False, True, True, True]
    assert [r["supers"] for r in recs] == [4, 4, 8, 2]
    assert len({r["checksum"] for r in recs}) == 1   # the same hits
    assert "gate=0 super_factor=4:" in out and "Mrays/s" in out
    assert super_gate.main(TINY + ["--configs", "48x8,0x4",
                                   "--global-radius-factor", "10,3,0"]) == 0
    out = capsys.readouterr().out
    recs = _records(out)
    assert [(r["global_radius_factor"], r["globals"]) for r in recs] == [
        (10.0, 1), (10.0, 1), (3.0, 4), (3.0, 4), (0.0, 486), (0.0, 486)]
    assert "gate=0 super_factor=4 global_radius_factor=3:" in out


def test_sweep10k_sweep_runs(capsys):
    assert sweep10k.main(TINY + ["--scene", "book_one_final",
                                 "--configs", "16x8,32x16"]) == 0
    out = capsys.readouterr().out
    recs = _records(out)
    assert [r["clusters"] for r in recs] == [31, 16]
    assert all(r["bake_seconds"] > 0 and r["build_seconds"] == 0
               for r in recs)
    assert "cluster 32 x super 16: bake" in out


def test_dynsweep_sweep_runs(capsys):
    assert dynsweep.main(TINY + ["--clusters", "8,64"]) == 0
    recs = _records(capsys.readouterr().out)
    assert [r["clusters"] for r in recs] == [61, 8]
    assert recs[0]["globals"] == 1


def test_dynnocull_sweep_runs(capsys):
    assert dynnocull.main(TINY) == 0
    recs = _records(capsys.readouterr().out)
    assert recs[0]["clusters"] == 0 and recs[0]["clusters_entered"] == 0
    assert recs[0]["globals"] == 486 and recs[1]["clusters"] == 31


@pytest.mark.parametrize("intersector,scene,clusters", [
    ("baked", "book_one_final", 4), ("bruteforce", "procedural", 8)])
def test_cullstats_sweep_runs(capsys, intersector, scene, clusters):
    argv = TINY[:-2] + ["--intersector", intersector, "--scene", scene,
                        "--clusters", str(clusters)]
    rec = cullstats.run(cullstats.build_parser().parse_args(argv))
    out = capsys.readouterr().out
    assert rec["warps"] == 4                  # 128 pixels, 32 a warp
    assert rec["clusters_entered"] > 0 and 0 < rec["clusters_share"] < 1
    assert "clusters entered:" in out and "warp " in out
    # 122 baked clusters (above the gate), 1,251 dynamic ones (rolled):
    # both sweeps are two-level.
    assert rec["two_level"] and rec["supers_entered"] > 0
    assert "supers entered:" in out


def test_meshscale_sweep_runs(capsys):
    assert meshscale.main(["200", "--device", "cpu", "--width", "16",
                           "--height", "8", "--spp", "1", "--reps",
                           "1"]) == 0
    out = capsys.readouterr().out
    rec = _records(out)[0]
    assert rec["tris"] > 0 and rec["rays"] > 0
    assert "cold" in out and "warm" in out


def test_knotbench_sweep_runs(capsys):
    assert knotbench.main(["300", "16x8", "1", "recluster=2", "--device",
                           "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    rec = _records(out)[0]
    assert rec["extra"] == {"recluster": 2}
    assert rec["clusters_entered"] > 0 and "Mrays/s" in out


def test_rr_floor_sweep_sweep_runs(capsys, tmp_path):
    # A golden of the incumbent's own render at 16x9: it passes its gate.
    cfg = RenderConfig(width=16, height=9, samples_per_pixel=2,
                       samples_per_frame=2, rr_start_bounce=5,
                       rr_floor=0.05, **rr_floor_sweep.BASE)
    img = torch_render(get_scene("book_one_final"),
                       CameraController.book_one_final(), cfg,
                       device="cpu").image
    golden = tmp_path / "g.npz"
    np.savez(golden, image=img.astype(np.float32))
    assert rr_floor_sweep.main(
        ["--device", "cpu", "--golden", str(golden), "--gate-spp", "2",
         "--gate-spf", "2", "--time-size", "16x8", "--time-spp", "1",
         "--reps", "1"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out.splitlines()[-1])
    assert res["rr5_f0.05"]["rmse"] == 0.0 and res["rr5_f0.05"]["t"] > 0
    assert "rr3_f0.25" in res
    assert "gate rr=3 floor=0.25" in out
