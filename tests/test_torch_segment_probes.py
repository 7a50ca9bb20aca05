"""The stage probes that complete the port's set, on the CPU (plain
versions): ``dbl_entry2``, ``dbl_cond2`` and ``hint_count`` on the baked
culled kernel, and the segment kernels' probe points (their intersect's).
Each probed render against the unprobed one, on book_cover and on a small
textured mesh; the JAX package's render with the same ``PROBE`` against
the port's probed plain render; where each name is accepted and where it
is refused; and the segment probes' timer on a tiny frame."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import prepare_scene as jax_prepare
from wavefront_path_tracer_tpu_torch import bench
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.probes import _stage, iterprobe
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    MeshSceneBuilder,
    get_scene,
)
from wavefront_path_tracer_tpu_torch.scene.scene import SceneBuilder
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

# 16x8 is one row of 128 lanes, padded to tile_rows = 8 rows: 896 padding
# lanes.
TINY = RenderConfig(width=16, height=8, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused")
PATHS = {
    "culled": {"intersector": "baked", "baked_clusters": 4},
    "segment_culled": {"intersector": "baked", "baked_clusters": 4,
                       "recluster": 2},
    "segment_dynculled": {"intersector": "bruteforce", "baked_clusters": 8,
                          "recluster": 2},
}
SEGMENT_CASES = [(kind, name)
                 for kind in ("segment_culled", "segment_dynculled")
                 for name in stage_probes.KERNEL_PROBES[kind]]


def _camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _uv_image(w=8, h=4):
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    v = np.linspace(0.2, 1.0, h)[:, None, None]
    return (np.concatenate([u, 1.0 - u, np.full_like(u, 0.4)], -1)
            * v).astype(np.float32)


def _add_spheres(b, n, textured=True):
    """A ground and ``n`` small spheres in rows before the camera's
    target, Lambertian, metal and glass: clusters for the culled sweeps to
    enter.  ``textured``: the ground and a third of the spheres checker
    textured, one with an image texture."""
    checker = ({"texture": ("checker", [0.9, 0.9, 0.9], 3.0)} if textured
               else {})
    b.sphere([0.0, -100.5, -1.0], 100.0,
             b.lambertian([0.5, 0.5, 0.5], **checker))
    rng = np.random.RandomState(4)
    for k in range(n):
        c = [-1.5 + 0.5 * (k % 7), -0.3, -2.2 + 0.45 * (k // 7)]
        if textured and k == n // 2:
            mat = b.lambertian([1.0, 1.0, 1.0], texture=_uv_image())
        elif k % 3 == 0:
            mat = b.lambertian(rng.rand(3), **(
                {"texture": ("checker", rng.rand(3), 10.0)} if textured
                else {}))
        elif k % 3 == 1:
            mat = b.metal(0.5 + 0.5 * rng.rand(3), 0.2)
        else:
            mat = b.dielectric(1.5)
        b.sphere(c, 0.2, mat)


def _texmesh():
    """The textured spheres and a wall of 2x2 quads (8 triangles, two
    materials) behind them."""
    b = MeshSceneBuilder()
    _add_spheres(b, 21)
    mats = (b.lambertian([0.8, 0.3, 0.2]), b.metal([0.8, 0.8, 0.9], 0.1))
    for i in range(2):
        for j in range(2):
            b.quad([-1.5 + 1.5 * i, -0.5 + 0.8 * j, -2.8 - 0.2 * i],
                   [1.5, 0.0, 0.0], [0.0, 0.8, 0.1], mats[(i + j) % 2])
    return b.build_mesh_scene()


def _clustered():
    """21 small untextured spheres on a ground: clusters of 4 for the JAX
    package's culled closure, small enough to trace in interpret mode
    quickly."""
    b = SceneBuilder()
    _add_spheres(b, 21, textured=False)
    return b.build()


def _scene(name):
    if name == "texmesh":
        return _texmesh()
    if name == "clustered":
        return _clustered(), None
    return get_scene(name), None


def _render(scene_name, cfg, probe=(), arrays_out=None):
    """(radiance words, [rays, iterations, supers, clusters]) of the
    port's fused render over every pixel in block order, segmented where
    ``cfg.recluster`` asks for it."""
    scene, tris = _scene(scene_name)
    cc = _camera()
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    view = cc.view_matrix()
    tables = tfused.scene_tables(cfg, arrays, view)
    perm, _ = tfused._block_perm(cfg.width, cfg.height, 32)
    pix = torch.from_numpy(perm.astype(np.int64))
    fn = (tfused.render_pixels_recluster if cfg.recluster
          else tfused.render_pixels)
    rad, rays, stats = fn(
        pix, arrays, cc.gpu_camera(), view,
        cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0,
        cfg.samples_per_pixel, with_stats=True, probe=probe, **tables)
    if arrays_out is not None:
        arrays_out.update(tables)
    return rad.view(torch.int32), [int(rays)] + [int(stats[k]) for k in (
        "iterations", "supers_entered", "clusters_entered")]


_BASES = {}


def _base(scene_name, cfg):
    key = (scene_name, repr(cfg))
    if key not in _BASES:
        _BASES[key] = _render(scene_name, cfg)
    return _BASES[key]


@pytest.mark.parametrize("scene_name", ["book_cover", "texmesh"])
@pytest.mark.parametrize("kind,name", SEGMENT_CASES)
def test_segment_probe_equals_unprobed(kind, name, scene_name):
    """A segmented render with a segment kernel's probe keeps the
    unprobed render's radiance words and counters (the mesh's clusters
    entered, book_cover's globals alone)."""
    cfg = TINY.replace(**PATHS[kind])
    words, stats = _render(scene_name, cfg, name)
    base_words, base_stats = _base(scene_name, cfg)
    assert stats == base_stats
    assert torch.equal(words, base_words)
    assert (stats[3] > 0) == (scene_name == "texmesh")


@pytest.mark.parametrize("scene_name", ["book_cover", "texmesh"])
@pytest.mark.parametrize("name", ["dbl_entry2", "dbl_cond2"])
def test_culled_probe_equals_unprobed(name, scene_name):
    cfg = TINY.replace(**PATHS["culled"])
    words, stats = _render(scene_name, cfg, name)
    base_words, base_stats = _base(scene_name, cfg)
    assert stats == base_stats
    assert torch.equal(words, base_words)


@pytest.mark.parametrize("scene_name", ["clustered", "texmesh"])
def test_hint_count_counts_the_prepass(monkeypatch, scene_name):
    """With the winner hint, hint_count keeps the radiance words, rays,
    iterations and clusters, and adds to supers exactly the prepass
    entries: the rays that reached the intersect with a hinted cluster,
    counted here from the plain version's calls.  (book_cover's bake has
    no cluster, so no hint: hint_count is refused there.)"""
    cfg = TINY.replace(winner_hint=True, **PATHS["culled"])
    intersect = tbk.culled_intersect_reference
    entries = []

    def spy(*args, hint=None, **kwargs):
        if hint is not None:
            entries.append(int((hint >= 0).sum()))
        return intersect(*args, hint=hint, **kwargs)

    monkeypatch.setattr(tbk, "culled_intersect_reference", spy)
    tables = {}
    base_words, base_stats = _render(scene_name, cfg, arrays_out=tables)
    assert tables["baked"].winner_hint
    prepass = sum(entries)
    words, stats = _render(scene_name, cfg, "hint_count")
    assert torch.equal(words, base_words)
    assert stats[2] == base_stats[2] + prepass
    assert stats[:2] + stats[3:] == base_stats[:2] + base_stats[3:]
    assert prepass > 0


@pytest.mark.parametrize("name", ["dbl_entry2", "dbl_cond2", "hint_count"])
def test_jax_probe_render_matches_port(name):
    """The JAX package's render with PROBE = {name} (baked/4 on 22
    spheres, clustered, Pallas in interpret mode, a fresh bake so that the
    probe is traced, the winner hint on for hint_count) against the
    port's probed plain render, under the parity rule."""
    hint = name == "hint_count"
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=4, engine="fused",
                       intersector="baked", baked_clusters=4,
                       winner_hint=hint)
    scene = _clustered()
    cc = _camera()
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(cfg.width, cfg.height)
    jarrays = jax_prepare(scene, cfg)
    sargs = tuple(np.asarray(jarrays[k]) for k in (
        "centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type"))
    pix = np.arange(cfg.num_pixels, dtype=np.uint32)
    jpk.PROBE = frozenset({name})
    try:
        baked = jpk.baked_culled_intersect(
            *sargs, cluster_size=4, camera_hint=np.asarray(view)[:3, 3],
            winner_hint=hint)
        baked.image_textures = None
        j_rad, j_rays = jfused.render_pixels(
            jnp.asarray(pix), jarrays, cc.gpu_camera(), jnp.asarray(view),
            jnp.asarray(inv_proj), cfg, jnp.uint32(0), jnp.uint32(0), 2,
            baked)
        j_rad, j_rays = np.asarray(j_rad), float(j_rays)
    finally:
        jpk.PROBE = frozenset()
    arrays = prepare_scene(scene, cfg, "cpu")
    tables = tfused.scene_tables(cfg, arrays, view)
    assert tables["baked"].winner_hint == hint
    assert tables["baked"].cluster_boxes.shape[0] > 0
    t_rad, t_rays = tfused.render_pixels(
        torch.from_numpy(pix.astype(np.int64)), arrays, cc.gpu_camera(),
        view, inv_proj, cfg, 0, 0, 2, probe=name, **tables)
    check_parity(t_rad.numpy() / 2, j_rad / 2, float(t_rays), j_rays)


@pytest.mark.parametrize("kernel", [*stage_probes.KERNEL_PROBES,
                                    "persistent"])
def test_probe_points_by_kernel(kernel):
    """Each name of PROBES is accepted, with its bit, on exactly the
    kernels that have its point: dbl_entry2 and dbl_cond2 on the culled
    kernel and the culled segment, hint_count on the hinted culled kernel
    alone, a segment no loop probe, the unculled segment and the
    brute-force kernel none."""
    have = stage_probes.KERNEL_PROBES.get(kernel, ())
    for name, bit in stage_probes.PROBES.items():
        if name in have:
            assert stage_probes.probe_bits(name, kernel) == bit
        else:
            with pytest.raises(ValueError, match="no probe point"):
                stage_probes.probe_bits(name, kernel)
    new = {"dbl_entry2", "dbl_cond2"} & set(have)
    assert bool(new) == (kernel in ("culled", "segment_culled"))
    assert ("hint_count" in have) == (kernel == "culled_hint")
    if kernel.startswith("segment_"):
        assert not set(stage_probes.LOOP) & set(have)


def test_segment_probes_refused_through_the_wrappers():
    """The wrappers refuse, before anything runs: a loop probe on either
    segment kernel, any probe on the unculled segment, a probe in the
    segment's serial form, hint_count on a bake without the hint and
    another probe on one with it."""
    for kind, extra, name in (
            ("segment_culled", {}, "dbl_raygen"),
            ("segment_dynculled", {}, "dbl_loopcond"),
            ("segment_culled", {"baked_clusters": 0}, "dbl_entry"),
            ("segment_culled", {"baked_clusters": 0}, "dbl_raygen"),
            ("culled", {}, "hint_count"),
            ("culled", {"winner_hint": True}, "hint_count")):
        cfg = TINY.replace(samples_per_pixel=1, **{**PATHS[kind], **extra})
        with pytest.raises(ValueError, match="no probe point"):
            _render("book_cover", cfg, name)
    cc = _camera()
    cfg = TINY.replace(samples_per_pixel=1, **PATHS["segment_culled"])
    scene, tris = _texmesh()
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    baked = tfused.scene_tables(cfg, arrays, cc.view_matrix())["baked"]
    n_pad = 1024
    ids, state = tfused.segment_state(
        torch.arange(cfg.num_pixels), n_pad, cfg, 0, 0, cc.gpu_camera(),
        cc.view_matrix(), cc.inverse_projection(cfg.width, cfg.height))
    counts = torch.zeros((4, n_pad), dtype=torch.int32)
    with pytest.raises(ValueError, match="shipped form"):
        tbk.fused_segment_baked(baked, (0, 8, 2, 0), ids, state, counts,
                                sweep=tbk.SWEEP_SERIAL, probe="dbl_entry2")
    cfg = cfg.replace(**PATHS["segment_dynculled"])
    tab = tfused.scene_tables(cfg, arrays, cc.view_matrix())["dyn"]
    with pytest.raises(ValueError, match="shipped form"):
        tdk.fused_segment_dynculled(tab, (0, 8, 2, 0), ids, state, counts,
                                    sweep=tbk.SWEEP_SERIAL,
                                    probe="dyn_dbl_cond")
    hinted = TINY.replace(samples_per_pixel=1, winner_hint=True,
                          **PATHS["culled"])
    with pytest.raises(ValueError, match="culled_hint kernel has no probe "
                                         "point for .'dbl_entry'"):
        _render("texmesh", hinted, "dbl_entry")


def test_iterprobe_takes_the_new_names(capsys):
    """probes/iterprobe.py runs dbl_entry2 and dbl_cond2 on the CPU and
    refuses hint_count on its unhinted render with probe_bits' message."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert iterprobe.main(["--device", "cpu", "--width", "16",
                               "--height", "8", "--spp", "1", "--reps", "1",
                               "--clusters", "4", "--scene", "book_cover",
                               "--variants", "full,dbl_entry2,dbl_cond2"]
                              ) == 0
    lines = [ln for ln in out.getvalue().splitlines() if "Mrays/s" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "full", "dbl_entry2", "dbl_cond2"]
    assert iterprobe.main(["--device", "cpu", "--variants",
                           "full,hint_count"]) == 2
    err = capsys.readouterr().err
    with pytest.raises(ValueError) as exc:
        stage_probes.probe_bits("hint_count", "culled")
    assert str(exc.value) in err


@pytest.mark.parametrize("kind", ["segment_culled", "segment_dynculled"])
def test_segment_shares_on_the_cpu(kind):
    """probes/_stage.py segment_shares at 16x8@1 spp, reps=1: the base's
    counters, a positive base time and one (probe, base, probe) turn a
    probe, every probed frame held to the base's."""
    cfg = TINY.replace(samples_per_pixel=1, samples_per_frame=1,
                       **PATHS[kind])
    scene, tris = _texmesh()
    cc = _camera()
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    probes = stage_probes.KERNEL_PROBES[kind]
    stats, base, turns = _stage.segment_shares(
        arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg, probes, 1,
        reps=1)
    assert stats == _base("texmesh", cfg)[1]
    assert base > 0 and [t[0] for t in turns] == list(probes)
    assert all(t_base >= base and t_probe > 0
               for _p, t_base, t_probe in turns)


def test_segment_shares_refuse_a_changed_frame(monkeypatch):
    """A probed frame whose counters differ from the base's raises."""
    frame = _stage.segment_frame

    def altered(*args, **kwargs):
        rad, stats, ms = frame(*args, **kwargs)
        if stage_probes.probe_names(args[-1] if len(args) > 8 else
                                    kwargs.get("probe", ())):
            stats = stats[:2] + [stats[2] + 1] + stats[3:]
        return rad, stats, ms

    monkeypatch.setattr(_stage, "segment_frame", altered)
    cfg = TINY.replace(samples_per_pixel=1, samples_per_frame=1,
                       **PATHS["segment_culled"])
    cc = _camera()
    arrays = prepare_scene(get_scene("book_cover"), cfg, "cpu")
    with pytest.raises(RuntimeError, match="counted"):
        _stage.segment_shares(arrays, cc.gpu_camera(), cc.view_matrix(),
                              cc.inverse_projection(16, 8), cfg,
                              ["dbl_cond"], 1, reps=1)
    with pytest.raises(ValueError, match="recluster"):
        _stage.segment_shares(arrays, cc.gpu_camera(), cc.view_matrix(),
                              cc.inverse_projection(16, 8),
                              cfg.replace(recluster=0), ["dbl_cond"], 1)


def test_launch_counts_cover_the_segment_probes():
    """bench.reset_launches and read_launches cover the new probe
    kernels' counts, as "kernel/probe"."""
    tbk.PROBE_LAUNCHES["segment_culled"]["dbl_entry2"] = 2
    tbk.PROBE_LAUNCHES["culled_hint"]["hint_count"] = 1
    tdk.SEGMENT_PROBE_LAUNCHES["dyn_dbl_cond"] = 3
    launches = bench.read_launches()
    assert launches["segment_culled/dbl_entry2"] == 2
    assert launches["culled_hint/hint_count"] == 1
    assert launches["segment_dynculled/dyn_dbl_cond"] == 3
    bench.reset_launches()
    launches = bench.read_launches()
    assert not any(launches[k] for k in launches if "/" in k)


# Entry functions that ptxas named when nvcc (CUDA 12.8) built csrc/ for
# sm_90a: the shipped culled segment kernel and one probe kernel of each
# kernel kind.
MANGLED = {
    ("dynculled", True, True, 128):
        "_ZN3wpt3dyn16dynculled_kernelINS_10LaneParamsELb1ELb1ENS_5Sweep"
        "ILi8ELi12EEELi128EEEvT_NS0_12DynIntersectIXT0_EXT1_ET2_XT3_EEEPKfSA_",
    ("segment_dynculled", False, True, 64):
        "_ZN3wpt3dyn16dynculled_kernelINS_9SegParamsELb0ELb1ENS_5SweepILi8"
        "ELi12EEELi64EEEvT_NS0_12DynIntersectIXT0_EXT1_ET2_XT3_EEEPKfSA_",
    ("culled", False, True, 512):
        "_ZN3wpt5baked19baked_culled_kernelINS_10LaneParamsELb0ELb1ELb0ENS_"
        "5SweepILi8ELi12EEELi512EEEvT_NS0_15CulledIntersectIXT0_EXT1_EXT2_"
        "ET3_XT4_EEEPKf",
    ("culled_hint", True, False, 2048):
        "_ZN3wpt5baked19baked_culled_kernelINS_10LaneParamsELb1ELb0ELb1ENS_"
        "5SweepILi8ELi12EEELi2048EEEvT_NS0_15CulledIntersectIXT0_EXT1_EXT2_"
        "ET3_XT4_EEEPKf",
    ("segment_culled", False, False, 0):
        "_ZN3wpt5baked19baked_culled_kernelINS_9SegParamsELb0ELb0ELb0ENS_5"
        "SweepILi8ELi12EEELi0EEEvT_NS0_15CulledIntersectIXT0_EXT1_EXT2_ET3_"
        "XT4_EEEPKf",
    ("segment_culled", True, True, 1024):
        "_ZN3wpt5baked19baked_culled_kernelINS_9SegParamsELb1ELb1ELb0ENS_5"
        "SweepILi8ELi12EEELi1024EEEvT_NS0_15CulledIntersectIXT0_EXT1_EXT2_"
        "ET3_XT4_EEEPKf",
    ("unculled", True, False, 1):
        "_ZN3wpt5baked21baked_unculled_kernelINS_10LaneParamsELb1ELb0ELb1E"
        "Li1EEEvT_NS0_17UnculledIntersectIXT0_EXT1_EEE",
}


@pytest.mark.parametrize("key", list(MANGLED), ids=lambda k: "-".join(
    str(v) for v in k))
def test_kernel_symbol_names_the_built_kernels(key):
    """stage_probes.kernel_symbol picks out the compiler's name of each
    kind's instantiation (the smoke finds probe kernels' SASS and ptxas
    lines by it), and no other of the table's names."""
    sym = stage_probes.kernel_symbol(*key)
    assert sym in MANGLED[key]
    assert [k for k, name in MANGLED.items() if sym in name] == [key]
