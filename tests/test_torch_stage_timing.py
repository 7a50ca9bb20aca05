"""The fused engine's differential stage probes on the CPU (plain
versions): every probe's render against the unprobed one, the port's
``stage_timing`` against the JAX package's (labels, order, refusals), one
probed JAX render against the port's probed render, and the refusals of
names the port does not have."""

import contextlib
import io
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import prepare_scene as jax_prepare
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.probes import dynprobe, iterprobe
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# 16x8 is one row of 128 lanes, padded to tile_rows = 8 rows: 896 padding
# lanes.
TINY = RenderConfig(width=16, height=8, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused")
KERNELS = {
    "culled": {"intersector": "baked", "baked_clusters": 16},
    "dynculled": {"intersector": "bruteforce", "baked_clusters": 16},
    "unculled": {"intersector": "baked", "baked_clusters": 0},
}
CASES = [(kind, name) for kind in KERNELS
         for name in stage_probes.KERNEL_PROBES[kind]]
# dbl_accum adds the sky term as two halves: each miss rounds up to three
# times instead of once, at most 1.5 ulp of the sum a sample; the bound is
# that with a margin of five.
ACCUM_RTOL_PER_SAMPLE = 1e-6


def _cover_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _scene(name):
    if name == "terrain":
        return mesh_terrain_scene(n_quads=4)
    return get_scene(name), None


def _render(scene_name, cfg, probe=()):
    """(radiance words, [rays, iterations, supers, clusters]) of the
    port's fused render over every pixel in block order."""
    scene, tris = _scene(scene_name)
    cc = _cover_camera()
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    view = cc.view_matrix()
    tables = tfused.scene_tables(cfg, arrays, view)
    perm, _ = tfused._block_perm(cfg.width, cfg.height, 32)
    pix = torch.from_numpy(perm.astype(np.int64))
    rad, rays, stats = tfused.render_pixels(
        pix, arrays, cc.gpu_camera(), view,
        cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0,
        cfg.samples_per_pixel, with_stats=True, probe=probe, **tables)
    return rad, [int(rays)] + [int(stats[k]) for k in (
        "iterations", "supers_entered", "clusters_entered")]


_BASES = {}


def _base(scene_name, kind):
    key = (scene_name, kind)
    if key not in _BASES:
        _BASES[key] = _render(scene_name, TINY.replace(**KERNELS[kind]))
    return _BASES[key]


def _check_probe(scene_name, kind, name):
    rad, stats = _render(scene_name, TINY.replace(**KERNELS[kind]), name)
    base_rad, base_stats = _base(scene_name, kind)
    assert stats == base_stats
    if name == "dbl_accum":
        torch.testing.assert_close(
            rad, base_rad, atol=1e-7,
            rtol=ACCUM_RTOL_PER_SAMPLE * TINY.samples_per_pixel)
    else:
        assert torch.equal(rad.view(torch.int32), base_rad.view(torch.int32))
    return stats


@pytest.mark.parametrize("kind,name", CASES)
def test_probe_equals_unprobed_book_cover(kind, name):
    _check_probe("book_cover", kind, name)


@pytest.mark.parametrize("scene_name", ["terrain", "book_checker"])
@pytest.mark.parametrize("kind,name", [
    ("culled", "dbl_entry"), ("culled", "dbl_cond"),
    ("dynculled", "dyn_dbl_entry"), ("dynculled", "dyn_dbl_cond")])
def test_probe_equals_unprobed_mesh_and_textures(scene_name, kind, name):
    # book_cover's spheres are all globals at 16 a cluster; these scenes
    # have clusters for the entry and cond probes to duplicate.
    assert _check_probe(scene_name, kind, name)[3] > 0


def _jax_stage_labels(monkeypatch, cfg):
    """The JAX package's ``stage_timing`` labels for ``cfg`` on
    book_cover, with its renders and bakes replaced by stubs (only its
    stage lists run)."""
    cc = _cover_camera()
    arrays = jax_prepare(get_scene("book_cover"), cfg)
    monkeypatch.setattr(jfused, "render_pixels",
                        lambda *a, **k: (None, jnp.float32(1.0)))
    monkeypatch.setattr(jfused, "_bake_image_luts", lambda *a, **k: None)
    monkeypatch.setattr(jfused, "_static_image_luts", lambda *a, **k: None)
    monkeypatch.setattr(jfused, "_dyn_tables",
                        lambda *a, **k: (None, (0,) * 6))
    for fn in ("baked_culled_intersect", "baked_intersect"):
        monkeypatch.setattr(jpk, fn, lambda *a, **k: SimpleNamespace())
    _base_s, rows = jfused.stage_timing(
        arrays, cc.gpu_camera(), jnp.asarray(cc.view_matrix()),
        jnp.asarray(cc.inverse_projection(cfg.width, cfg.height)), cfg,
        n_samples=1, reps=1)
    return [r[0] for r in rows]


@pytest.mark.parametrize("kind", list(KERNELS))
def test_stage_labels_equal_jax(monkeypatch, kind):
    cfg = TINY.replace(**KERNELS[kind])
    arrays = prepare_scene(get_scene("book_cover"), cfg, "cpu")
    port = [label for label, _probe in tfused.stage_stages(cfg, arrays)]
    port.append("other (winner selects, unprobed)")
    assert port == _jax_stage_labels(monkeypatch, cfg)


@pytest.mark.parametrize("extra", [
    {"intersector": "bruteforce", "baked_clusters": 0},
    {"intersector": "bvh", "baked_clusters": 16},
    {"intersector": "auto", "baked_clusters": 16}])
def test_stage_refusals_equal_jax(extra):
    cfg = TINY.replace(**extra)
    cc = _cover_camera()
    view, inv_proj = (cc.view_matrix(),
                      cc.inverse_projection(cfg.width, cfg.height))
    with pytest.raises(NotImplementedError) as ref:
        jfused.stage_timing(jax_prepare(get_scene("book_cover"), cfg),
                            cc.gpu_camera(), jnp.asarray(view),
                            jnp.asarray(inv_proj), cfg, n_samples=1)
    with pytest.raises(NotImplementedError) as port:
        tfused.stage_timing(prepare_scene(get_scene("book_cover"), cfg,
                                          "cpu"),
                            cc.gpu_camera(), view, inv_proj, cfg,
                            n_samples=1)
    assert str(port.value) == str(ref.value)


def test_stage_timing_once():
    """One call at 16x8@1 spp, reps=1: the JAX package's rows, shares at
    least 0, and the residual row closing the budget."""
    cfg = TINY.replace(samples_per_pixel=1, samples_per_frame=1,
                       **KERNELS["culled"])
    cc = _cover_camera()
    arrays = prepare_scene(get_scene("book_cover"), cfg, "cpu")
    base, rows = tfused.stage_timing(
        arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg, n_samples=1,
        reps=1)
    assert base > 0
    assert [r[0] for r in rows] == [
        "generate (raygen)", "extend: primitive tests", "extend: cull conds",
        "shade (BSDF)", "miss (sky accumulate)", "loop bookkeeping",
        "other (winner selects, unprobed)"]
    assert all(share >= 0 for _label, _s, share in rows)
    probed = sum(r[2] for r in rows[:-1])
    assert rows[-1][2] == max(0.0, 1.0 - probed)
    assert sum(r[2] for r in rows) >= 1.0 - 1e-12
    for _label, seconds, share in rows:
        assert seconds == pytest.approx(base * share)


def test_jax_probe_render_matches_port():
    """The JAX package's render with PROBE = {"dbl_entry"} (baked/4,
    Pallas in interpret mode, a fresh bake so that the probe is traced)
    against the port's probed plain render, under the parity rule."""
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=8, engine="fused",
                       intersector="baked", baked_clusters=4)
    scene = get_scene("book_cover")
    cc = _cover_camera()
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(cfg.width, cfg.height)
    jarrays = jax_prepare(scene, cfg)
    sargs = tuple(np.asarray(jarrays[k]) for k in (
        "centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type"))
    pix = np.arange(cfg.num_pixels, dtype=np.uint32)
    jpk.PROBE = frozenset({"dbl_entry"})
    try:
        baked = jpk.baked_culled_intersect(
            *sargs, cluster_size=4, camera_hint=np.asarray(view)[:3, 3])
        baked.image_textures = None
        j_rad, j_rays = jfused.render_pixels(
            jnp.asarray(pix), jarrays, cc.gpu_camera(), jnp.asarray(view),
            jnp.asarray(inv_proj), cfg, jnp.uint32(0), jnp.uint32(0), 2,
            baked)
        j_rad, j_rays = np.asarray(j_rad), float(j_rays)
    finally:
        jpk.PROBE = frozenset()
    arrays = prepare_scene(scene, cfg, "cpu")
    t_rad, t_rays = tfused.render_pixels(
        torch.from_numpy(pix.astype(np.int64)), arrays, cc.gpu_camera(),
        view, inv_proj, cfg, 0, 0, 2, probe="dbl_entry",
        **tfused.scene_tables(cfg, arrays, view))
    check_parity(t_rad.numpy() / 2, j_rad / 2, float(t_rays), j_rays)


def test_unknown_and_refused_probes_raise():
    for name in ("dbl_bogus", *stage_probes.NOT_PORTED):
        with pytest.raises(ValueError, match=re.escape(repr(name))):
            stage_probes.probe_bits(name, "culled")
    with pytest.raises(ValueError, match="one probe at a time"):
        stage_probes.probe_bits(("dbl_shade", "dbl_raygen"), "culled")
    with pytest.raises(ValueError, match="no probe point"):
        stage_probes.probe_bits("dyn_dbl_entry", "culled")
    with pytest.raises(ValueError, match="no probe point"):
        stage_probes.probe_bits("dbl_entry", "unculled")
    with pytest.raises(ValueError, match="no probe point"):
        stage_probes.probe_bits("dbl_raygen", "persistent")
    assert stage_probes.probe_bits((), "persistent") == 0

    # Through the wrappers, on every path, before anything runs.
    cfg = TINY.replace(samples_per_pixel=1)
    for extra, name in (({"baked_clusters": 0}, "dbl_raygen"),
                        (KERNELS["culled"], "dbl_bogus"),
                        (KERNELS["culled"], "dbl_scope"),
                        (KERNELS["dynculled"], "dbl_entry"),
                        (KERNELS["unculled"], "dbl_cond"),
                        (KERNELS["culled"], ("dbl_entry", "dbl_cond"))):
        with pytest.raises(ValueError):
            _render("book_cover", cfg.replace(**extra), name)


def test_probes_run_in_the_shipped_form_only():
    cfg = TINY.replace(samples_per_pixel=1, **KERNELS["culled"])
    cc = _cover_camera()
    # book_one_final has clusters, so its bake can carry the winner hint.
    arrays = prepare_scene(get_scene("book_one_final"), cfg, "cpu")
    baked = tfused.scene_tables(cfg, arrays, cc.view_matrix())["baked"]
    planes = tfused.lane_planes(torch.arange(cfg.num_pixels), cfg.width, 1)
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg))
    with pytest.raises(ValueError, match="shipped form"):
        tbk.fused_render_baked(baked, (0, 0, 4, 1), cam, *planes,
                               sweep=tbk.SWEEP_SERIAL, probe="dbl_entry")
    hinted = tfused._baked_scene(arrays, 16, cc.view_matrix()[:3, 3],
                                 winner_hint=True)
    assert hinted.winner_hint
    with pytest.raises(ValueError, match="culled_hint kernel has no probe "
                                         "point for .'dbl_entry'"):
        tbk.fused_render_baked(hinted, (0, 0, 4, 1), cam, *planes,
                               probe="dbl_entry")
    cfg = cfg.replace(**KERNELS["dynculled"])
    tab = tfused.scene_tables(cfg, arrays, cc.view_matrix())["dyn"]
    with pytest.raises(ValueError, match="shipped form"):
        tdk.fused_render_dynculled(tab, (0, 0, 4, 1), cam, *planes,
                                   sweep=tbk.SWEEP_SERIAL,
                                   probe="dyn_dbl_cond")


def test_probe_bits_equal_the_kernels():
    """ops/stage_probes.py's bits are csrc/common.cuh's."""
    src = (ROOT / "wavefront_path_tracer_tpu_torch/csrc/common.cuh"
           ).read_text()
    bits = {m[1]: 1 << int(m[2]) for m in re.finditer(
        r"constexpr int (k(?:D(?:bl|yn)|Hint)\w+) = 1 << (\d+);", src)}
    camel = {name: "k" + "".join(p.capitalize() for p in name.split("_"))
             for name in stage_probes.PROBES}
    assert {camel[n]: b for n, b in stage_probes.PROBES.items()} == bits
    assert len(set(stage_probes.PROBES.values())) == 12


@pytest.mark.parametrize("script", [iterprobe, dynprobe])
def test_probe_scripts_refuse_unported_names(script, capsys):
    for name in stage_probes.NOT_PORTED:
        assert script.main(["--device", "cpu", "--variants",
                            f"full,{name}"]) == 2
        assert repr(name) in capsys.readouterr().err


def test_probe_scripts_run_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dynprobe.main(["--device", "cpu", "--width", "16",
                              "--height", "8", "--spp", "1", "--reps", "1",
                              "--variants", "full,dyn_dbl_global"]) == 0
        assert iterprobe.main(["--device", "cpu", "--width", "16",
                               "--height", "8", "--spp", "1", "--reps", "1",
                               "--scene", "book_cover",
                               "--variants", "full,dbl_cond"]) == 0
    lines = [ln for ln in out.getvalue().splitlines() if "Mrays/s" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "full", "dyn_dbl_global", "full", "dbl_cond"]
    assert all("plain versions" in ln for ln in lines)


@pytest.mark.parametrize("change,match", [
    ("radiance", "changed the render's radiance"),
    ("counters", "counted"),
    ("accum_within", None),
    ("accum_beyond", "changed the render's radiance")])
def test_time_probes_refuse_a_changed_render(monkeypatch, change, match):
    """time_probes holds each probed render to the base's: radiance words
    and counters bit for bit, dbl_accum's radiance within its tolerance;
    a probe that changes either raises."""
    render = tfused.render_pixels

    def altered(*args, probe=frozenset(), **kwargs):
        radiance, rays, stats = render(*args, probe=probe, **kwargs)
        if not stage_probes.probe_names(probe):
            return radiance, rays, stats
        if change == "counters":
            return radiance, rays, {**stats, "iterations":
                                    stats["iterations"] + 1}
        scale = {"radiance": 1.0 + 2 ** -20, "accum_within": 1.0 + 2 ** -22,
                 "accum_beyond": 1.0 + 1e-4}[change]
        return radiance * scale, rays, stats

    monkeypatch.setattr(tfused, "render_pixels", altered)
    cfg = TINY.replace(samples_per_pixel=1, samples_per_frame=1,
                       **KERNELS["culled"])
    probe = "dbl_accum" if change.startswith("accum") else "dbl_cond"
    cc = _cover_camera()
    args = (prepare_scene(get_scene("book_cover"), cfg, "cpu"),
            cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(cfg.width, cfg.height), cfg, [probe])
    if match is None:
        rays, _base, turns = tfused.time_probes(*args, n_samples=1, reps=1)
        assert rays > 0 and [t[0] for t in turns] == [probe]
    else:
        with pytest.raises(RuntimeError, match=match):
            tfused.time_probes(*args, n_samples=1, reps=1)


@pytest.mark.parametrize("change,ok", [
    ("none", False), ("supers_by_prepass", True), ("supers_beyond", False),
    ("supers_below", False), ("clusters", False), ("radiance", False)])
def test_check_probe_render_takes_hint_counts_difference(change, ok):
    """hint_count's render must count more supers than the base's, by at
    least one and at most its clusters entered (each prepass entry is
    one), and nothing else may differ; the same supers difference fails
    any other probe, and equal counts pass it."""
    rad = torch.ones(8, 3)
    base = [100, 10, 5, 40]
    stats = {"none": base, "supers_by_prepass": [100, 10, 30, 40],
             "supers_beyond": [100, 10, 46, 40],
             "supers_below": [100, 10, 4, 40],
             "clusters": [100, 10, 30, 41], "radiance": base}[change]
    probed = rad * (1.0 + 2 ** -20) if change == "radiance" else rad
    check = lambda probe: tfused._check_probe_render(  # noqa: E731
        probe, probed, stats, rad, base, 1)
    if ok:
        check("hint_count")
    else:
        with pytest.raises(RuntimeError):
            check("hint_count")
    if change == "supers_by_prepass":
        with pytest.raises(RuntimeError, match="counted"):
            check("dbl_cond2")
    if change == "none":
        check("dbl_cond2")


def test_launch_counts_cover_the_probe_kernels():
    """bench.reset_launches and read_launches cover every probe kernel's
    count, as "kernel/probe"."""
    from wavefront_path_tracer_tpu_torch import bench

    tbk.PROBE_LAUNCHES["culled"]["dbl_entry"] = 3
    tdk.PROBE_LAUNCHES["dyn_dbl_global"] = 2
    launches = bench.read_launches()
    assert launches["culled/dbl_entry"] == 3
    assert launches["dynculled/dyn_dbl_global"] == 2
    bench.reset_launches()
    launches = bench.read_launches()
    probe_keys = {f"{kind}/{name}"
                  for kind, names in stage_probes.KERNEL_PROBES.items()
                  for name in names}
    assert len(probe_keys) == 27 and probe_keys <= set(launches)
    assert not any(launches[k] for k in probe_keys)
