"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip without
one.  This file imports no JAX, so on a machine without JAX it runs
without the suite's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.probes import run_pairs as trp
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene, render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    knot_camera,
    knot_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _planes(width, height, device):
    perm, _ = tfused._block_perm(width, height, 32)
    perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
    return perm_t, tfused.lane_planes(perm_t, width, 8)


@pytest.mark.parametrize("opts", [
    {},
    {"rr_start": 2, "clamp": 0.5, "sampler": "stratified"},
])
def test_kernel_matches_plain(device, opts):
    scene = get_scene("book_cover")
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=96, height=54, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(96, 54),
        cfg)).to(device)
    _, planes = _planes(96, 54, device)
    table = tfk.pack_scene(arrays, device=device)
    salts = (0, 0, 50, 4)
    before = tfk.LAUNCHES
    k = tfk.fused_render_persistent(table, 5, salts, cam, *planes, **opts)
    torch.cuda.synchronize()
    assert tfk.LAUNCHES == before + 1
    p = tfk.fused_render_persistent_reference(table, 5, salts, cam, *planes,
                                              **opts)
    # Built without FMA contraction, the kernel is bit-identical.
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(k[3][0]) == int(p[3][0])


def test_render_on_cuda_launches_kernel(device):
    before = tfk.LAUNCHES
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=4,
                       samples_per_frame=2, max_bounces=12, engine="fused")
    res = render(get_scene("book_cover"), CameraController.book_one_final(),
                 cfg, device=device)
    assert tfk.LAUNCHES == before + 2
    assert res.accumulated_dev.device.type == "cuda"
    assert np.isfinite(res.accumulated).all() and res.image.mean() > 0.05


def test_wrapper_rejects_cpu_cuda_mix(device):
    scene = get_scene("book_cover")
    table = tfk.pack_scene({k: getattr(scene, k) for k in (
        "centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")})
    _, planes = _planes(16, 16, device)
    cam = torch.zeros(24, device=device)
    with pytest.raises(ValueError, match="one device"):
        tfk.fused_render_persistent(table, 5, (0, 0, 4, 1), cam, *planes)


@pytest.mark.parametrize("clusters", [16, 2, 0],
                         ids=["culled16", "culled2", "unculled"])
def test_baked_kernel_matches_plain(device, clusters):
    """Radiance words, rays and both cull counters bit-identical."""
    scene = get_scene("book_one_final")
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    eye = tfused._concrete_eye(cc.view_matrix())
    baked = (bake.bake_culled(arrays, clusters, camera_hint=eye,
                              device=device) if clusters
             else bake.bake_unculled(arrays, device=device))
    cfg = RenderConfig(width=64, height=36, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(64, 36),
        cfg)).to(device)
    _, planes = _planes(64, 36, device)
    salts = (0, 0, 50, 2)
    key = "culled" if clusters else "unculled"
    before = tbk.LAUNCHES[key]
    k = tbk.fused_render_baked(baked, salts, cam, *planes)
    torch.cuda.synchronize()
    assert tbk.LAUNCHES[key] == before + 1
    p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert k[3].tolist() == p[3].tolist()
    if clusters:
        assert int(k[3][3]) > 0
    assert clusters != 2 or int(k[3][2]) > 0


@pytest.mark.parametrize("case", ["headline", "doubled", "hint"])
def test_culled_sweep_matches_plain_at_full_width(device, case):
    """The headline's culled kernel at full lane width (1920x1080@1spp,
    block order) in its shipped sweep form (a vote per cluster, the rays of
    few entering lanes shared by the warp) and in the serial form:
    radiance words and all four counters bit-identical to the plain
    version.  "doubled" holds every sphere twice, so that a hit on one is
    an exact tie of two items, which the smaller index must win; "hint"
    runs the winner hint."""
    scene = get_scene("book_one_final")
    if case == "doubled":
        scene = scene.permuted(np.repeat(np.arange(scene.num_spheres), 2))
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    eye = tfused._concrete_eye(cc.view_matrix())
    baked = bake.bake_culled(arrays, 16, camera_hint=eye,
                             winner_hint=case == "hint", device=device)
    w, h = 1920, 1080
    cfg = RenderConfig(width=w, height=h, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h),
        cfg)).to(device)
    _, planes = _planes(w, h, device)
    salts = (0, 0, 50, 1)
    p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    for sweep in (tbk.SWEEP_COOP, tbk.SWEEP_SERIAL):
        k = tbk.fused_render_baked(baked, salts, cam, *planes, sweep=sweep)
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert k[3].tolist() == p[3].tolist()
    assert int(p[3][3]) > 0


@pytest.mark.parametrize("case", ["terrain", "knot", "book_checker",
                                  "doubled"])
def test_dynculled_sweep_matches_plain_at_full_width(device, case):
    """The dynamic culled kernel in clusters of 16 at its rows' full lane
    width (1 spp, block order) in its shipped sweep form (the warp's lanes
    in step, a vote per cluster, the rays of few entering lanes shared by
    the warp) and in the serial form: radiance words and all four counters
    bit-identical to the plain version.  terrain (5,000 triangles: 313
    clusters in 20 supers) and the 50k knot (196 supers) at 800x448,
    rolled triangle sweeps; book_checker (textured, a flat sphere sweep of
    31 clusters) at 1920x1080; "doubled" holds every sphere of
    book_one_final twice (a rolled sphere sweep at clusters of 8; every
    sphere hit an exact tie of two rows, which the smaller index must win)
    at 800x448."""
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser

    tris, cc, cs, (w, h) = None, CameraController.book_one_final(), 16, (
        800, 448)
    if case == "terrain":
        scene, tris = mesh_terrain_scene()
    elif case == "knot":
        (scene, tris), cc = knot_scene(50000), knot_camera()
    elif case == "book_checker":
        scene, (w, h) = get_scene("book_checker"), (1920, 1080)
        cc = build_camera(build_parser().parse_args(["--scene",
                                                     "book_checker"]))
    else:
        scene = get_scene("book_one_final")
        scene, cs = scene.permuted(np.repeat(np.arange(scene.num_spheres),
                                             2)), 8
    cfg = RenderConfig(width=w, height=h, engine="fused")
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = tfused._concrete_eye(cc.view_matrix())
    tab = tfused._dyn_tables(arrays, cs, camera_pos=eye)
    assert tab.textured == (case == "book_checker")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h),
        cfg)).to(device)
    _, planes = _planes(w, h, device)
    salts = (0, 0, 50, 1)
    p = tdk.fused_render_dynculled_reference(tab, salts, cam, *planes)
    for sweep in (tdk.SWEEP_COOP, tdk.SWEEP_SERIAL):
        before = (tdk.LAUNCHES, tdk.COOP_LAUNCHES)
        k = tdk.fused_render_dynculled(tab, salts, cam, *planes, sweep=sweep)
        torch.cuda.synchronize()
        assert (tdk.LAUNCHES, tdk.COOP_LAUNCHES) == (
            before[0] + 1, before[1] + (sweep == tdk.SWEEP_COOP))
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert k[3].tolist() == p[3].tolist()
    assert int(p[3][3]) > 0
    assert (int(p[3][2]) > 0) == (case != "book_checker")


@pytest.mark.parametrize("case", ["persistent/book", "unculled/book",
                                  "unculled/book_checker",
                                  "unculled/terrain"])
def test_unculled_loops_match_plain_at_full_width(device, case):
    """The two unculled kernels at their rows' full lane width (1 spp,
    block order) in both loop forms (the warp's lanes in step, the shipped
    form, the unculled kernel's triangle rows staged; each lane on its own
    thread):
    radiance words and all four counters bit-identical to the plain
    version.  The persistent (brute-force) kernel and the unculled baked
    kernel on book_one_final at 1920x1080, the unculled on book_checker
    (textured) at 1920x1080 and on terrain (5,000 triangles) at 800x448."""
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser

    kind, name = case.split("/")
    tris, cc, (w, h) = None, CameraController.book_one_final(), (1920, 1080)
    if name == "terrain":
        (scene, tris), (w, h) = mesh_terrain_scene(), (800, 448)
    elif name == "book_checker":
        scene = get_scene("book_checker")
        cc = build_camera(build_parser().parse_args(["--scene",
                                                     "book_checker"]))
    else:
        scene = get_scene("book_one_final")
    cfg = RenderConfig(width=w, height=h, engine="fused")
    arrays = prepare_scene(scene, cfg, device, tris)
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h),
        cfg)).to(device)
    _, planes = _planes(w, h, device)
    salts = (0, 0, 50, 1)
    if kind == "persistent":
        table, n = arrays["scene_packed"], len(scene.radii)
        p = tfk.fused_render_persistent_reference(table, n, salts, cam,
                                                  *planes)
        forms = (tfk.LOOP_WARP, tfk.LOOP_LANE)
        counts = lambda: (tfk.LAUNCHES, tfk.WARP_LAUNCHES)  # noqa: E731
        run = lambda f: tfk.fused_render_persistent(  # noqa: E731
            table, n, salts, cam, *planes, loop=f)
    else:
        baked = tfused._baked_scene(arrays, 0)
        assert baked.textured == (name == "book_checker")
        p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
        forms = (tbk.SWEEP_COOP, tbk.SWEEP_SERIAL)
        counts = lambda: (tbk.LAUNCHES["unculled"],  # noqa: E731
                          tbk.COOP_LAUNCHES["unculled"])
        run = lambda f: tbk.fused_render_baked(  # noqa: E731
            baked, salts, cam, *planes, sweep=f)
    for form in forms:
        before = counts()
        k = run(form)
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + (form == forms[0]))
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert k[3].tolist() == p[3].tolist()


@pytest.mark.parametrize("case", ["terrain/dyn16", "knot1120/dyn16",
                                  "procedural1200/dyn16", "terrain/culled8",
                                  "terrain/unculled"])
def test_mesh_kernels_match_plain(device, case):
    """The dynamic culled kernel (flat and rolled sweeps, triangles and
    spheres) and the baked kernels on triangles: radiance words and all
    four counters bit-identical."""
    scene_name, path = case.split("/")
    cc = CameraController.book_one_final()
    tris = None
    if scene_name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=20)
    elif scene_name == "knot1120":
        (scene, tris), cc = knot_scene(1120), knot_camera()
    else:
        scene = get_scene("procedural", n=1200, seed=3)
    cfg = RenderConfig(width=64, height=36, engine="fused")
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = tfused._concrete_eye(cc.view_matrix())
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(64, 36),
        cfg)).to(device)
    _, planes = _planes(64, 36, device)
    salts = (0, 0, 50, 2)
    if path == "dyn16":
        tab = tfused._dyn_tables(arrays, 16, camera_pos=eye)
        before = tdk.LAUNCHES
        k = tdk.fused_render_dynculled(tab, salts, cam, *planes)
        torch.cuda.synchronize()
        assert tdk.LAUNCHES == before + 1
        p = tdk.fused_render_dynculled_reference(tab, salts, cam, *planes)
    else:
        clusters = 8 if path == "culled8" else 0
        baked = tfused._baked_scene(arrays, clusters, camera_pos=eye)
        key = "culled" if clusters else "unculled"
        before = tbk.LAUNCHES[key]
        k = tbk.fused_render_baked(baked, salts, cam, *planes)
        torch.cuda.synchronize()
        assert tbk.LAUNCHES[key] == before + 1
        p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert k[3].tolist() == p[3].tolist()
    if path != "unculled":
        assert int(k[3][3]) > 0
    if scene_name != "terrain":
        assert int(k[3][2]) > 0              # rolled supers entered


def test_mesh_render_on_cuda(device):
    scene, tris = mesh_terrain_scene(n_quads=10)
    before = tdk.LAUNCHES
    cfg = RenderConfig(width=48, height=27, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=12, engine="fused",
                       baked_clusters=16)
    res = render(scene, CameraController.book_one_final(), cfg, tris,
                 device=device)
    assert tdk.LAUNCHES == before + 1
    assert np.isfinite(res.accumulated).all() and res.image.mean() > 0.05


@pytest.mark.parametrize("case", ["book_checker/culled16",
                                  "book_checker/culled16_hint",
                                  "book_checker/unculled",
                                  "book_checker/dyn16",
                                  "book_checker/culled16_lut512",
                                  "scene_json/culled16"])
def test_textured_kernels_match_plain(device, case):
    """The textured instantiations (checker fields, the image LUT, the
    winner hint): radiance words and all four counters bit-identical."""
    from pathlib import Path

    from wavefront_path_tracer_tpu_torch.scene import load_scene_file

    scene_name, path = case.split("/")
    cc = CameraController.book_one_final()
    if scene_name == "book_checker":
        scene = get_scene("book_checker")
    else:
        scene, _tris, _cam = load_scene_file(str(
            Path(__file__).resolve().parents[1] / "examples" / "scene.json"))
    cfg = RenderConfig(width=64, height=36, engine="fused")
    arrays = prepare_scene(scene, cfg, device)
    eye = tfused._concrete_eye(cc.view_matrix())
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(64, 36),
        cfg)).to(device)
    _, planes = _planes(64, 36, device)
    salts = (0, 0, 50, 2)
    if path == "dyn16":
        tab = tfused._dyn_tables(arrays, 16, camera_pos=eye)
        assert tab.textured
        before = tdk.LAUNCHES
        k = tdk.fused_render_dynculled(tab, salts, cam, *planes)
        torch.cuda.synchronize()
        assert tdk.LAUNCHES == before + 1
        p = tdk.fused_render_dynculled_reference(tab, salts, cam, *planes)
    else:
        clusters = 0 if path == "unculled" else 16
        baked = tfused._baked_scene(
            arrays, clusters, camera_pos=eye, winner_hint="hint" in path,
            lut_max=512 if "lut512" in path else 8192)
        assert baked.textured and baked.winner_hint == ("hint" in path)
        key = "culled" if clusters else "unculled"
        before = tbk.LAUNCHES[key]
        k = tbk.fused_render_baked(baked, salts, cam, *planes)
        torch.cuda.synchronize()
        assert tbk.LAUNCHES[key] == before + 1
        p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert k[3].tolist() == p[3].tolist()


@pytest.mark.parametrize("case", ["book_one_final/culled16",
                                  "book_one_final/unculled",
                                  "terrain/dyn16", "book_checker/culled16",
                                  "book_checker/dyn16"])
def test_segment_kernels_match_plain(device, case):
    """The recluster segment kernels against their plain versions on the
    same CUDA tensors: a whole segmented render (recluster 2, roulette
    from bounce 3) with radiance words and counters bit-identical, one
    launch a segment."""
    scene_name, path = case.split("/")
    cc = CameraController.book_one_final()
    tris = None
    if scene_name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=20)
    else:
        scene = get_scene(scene_name)
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=50, engine="fused",
                       recluster=2, rr_start_bounce=3)
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = tfused._concrete_eye(cc.view_matrix())
    if path == "dyn16":
        tables = {"dyn": tfused._dyn_tables(arrays, 16, camera_pos=eye)}
        plain = tdk.fused_segment_dynculled_reference
        launches = lambda: tdk.SEGMENT_LAUNCHES  # noqa: E731
    else:
        clusters = 0 if path == "unculled" else 16
        tables = {"baked": tfused._baked_scene(arrays, clusters,
                                               camera_pos=eye)}
        plain = tbk.fused_segment_baked_reference
        key = "segment_culled" if clusters else "segment_unculled"
        launches = lambda: tbk.LAUNCHES[key]  # noqa: E731
    perm, _ = _planes(64, 36, device)
    args = (perm, arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(64, 36), cfg, 0, 0, 2)
    before = launches()
    k = tfused.render_pixels_recluster(*args, with_stats=True, **tables)
    torch.cuda.synchronize()
    assert launches() == before + 2 * len(tfused._segment_schedule(2, 50))
    p = tfused._recluster(plain, tfused.coherence_order,
                          *tables.values(), *args, True)
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert int(k[1]) == int(p[1])
    assert {n: int(v) for n, v in k[2].items()} == {
        n: int(v) for n, v in p[2].items()}
    assert path == "unculled" or int(k[2]["clusters_entered"]) > 0


@pytest.mark.parametrize("form", ["serial", "coop"])
@pytest.mark.parametrize("case", ["book_one_final/culled16",
                                  "doubled/culled16",
                                  "book_one_final/unculled",
                                  "terrain/culled16", "terrain/unculled",
                                  "terrain/dyn16", "book_checker/dyn16"])
def test_segment_forms_match_plain(device, case, form):
    """Each form of the segment kernels (``serial``: each lane on its own
    thread; ``coop``: the warp's lanes in step, the shipped form) against
    the plain versions on the same CUDA tensors: a whole segmented render
    (recluster 2, roulette from bounce 3) with radiance words and the four
    counters, row 3's trips per warp included, bit-identical; the book
    with every sphere twice (exact ties), terrain's triangles (the
    unculled form stages them a warp at a time), a textured dynamic
    table.  Each launch is counted in the form asked for."""
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import SWEEP_COOP
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
        SWEEP_SERIAL,
    )

    scene_name, path = case.split("/")
    cc = CameraController.book_one_final()
    tris = None
    if scene_name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=20)
    elif scene_name == "doubled":
        book = get_scene("book_one_final")
        scene = book.permuted(np.repeat(np.arange(book.num_spheres), 2))
    else:
        scene = get_scene(scene_name)
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=50, engine="fused",
                       recluster=2, rr_start_bounce=3)
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = tfused._concrete_eye(cc.view_matrix())
    sweep = SWEEP_COOP if form == "coop" else SWEEP_SERIAL
    if path == "dyn16":
        tables = tfused._dyn_tables(arrays, 16, camera_pos=eye)
        kernel, plain = tdk.fused_segment_dynculled, \
            tdk.fused_segment_dynculled_reference
        launches = lambda: (tdk.SEGMENT_LAUNCHES,  # noqa: E731
                            tdk.SEGMENT_COOP_LAUNCHES)
    else:
        clusters = 0 if path == "unculled" else 16
        tables = tfused._baked_scene(arrays, clusters, camera_pos=eye)
        kernel, plain = tbk.fused_segment_baked, \
            tbk.fused_segment_baked_reference
        key = "segment_culled" if clusters else "segment_unculled"
        launches = lambda: (tbk.LAUNCHES[key],  # noqa: E731
                            tbk.COOP_LAUNCHES[key])

    def segment(*args, **kw):
        return kernel(*args, sweep=sweep, **kw)

    perm, _ = _planes(64, 36, device)
    args = (tables, perm, arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(64, 36), cfg, 0, 0, 2, True)
    before = launches()
    k = tfused._recluster(segment, tfused.coherence_order, *args)
    torch.cuda.synchronize()
    n = 2 * len(tfused._segment_schedule(2, 50))
    assert launches() == (before[0] + n, before[1] + n * (form == "coop"))
    p = tfused._recluster(plain, tfused.coherence_order, *args)
    assert torch.equal(k[0].view(torch.int32), p[0].view(torch.int32))
    assert int(k[1]) == int(p[1])
    assert {n: int(v) for n, v in k[2].items()} == {
        n: int(v) for n, v in p[2].items()}
    assert path == "unculled" or int(k[2]["clusters_entered"]) > 0


def test_recluster_loop_never_waits_for_the_card(device):
    """Given its matrices on the card, the segmented render issues its
    raygen, sorts, launches and scatters without one call that waits for
    the device (CUDA's sync debug mode raises on such a call)."""
    scene = get_scene("book_one_final")
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=50, engine="fused",
                       recluster=2)
    arrays = prepare_scene(scene, cfg, device)
    baked = tfused._baked_scene(arrays, 16, camera_pos=tfused._concrete_eye(
        cc.view_matrix()))
    perm, _ = _planes(64, 36, device)
    view, inv_proj = (torch.as_tensor(m, dtype=torch.float32, device=device)
                      for m in (cc.view_matrix(),
                                cc.inverse_projection(64, 36)))
    tfused.render_pixels_recluster(perm, arrays, cc.gpu_camera(), view,
                                   inv_proj, cfg, 0, 0, 2, baked=baked)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rad, rays = tfused.render_pixels_recluster(
            perm, arrays, cc.gpu_camera(), view, inv_proj, cfg, 0, 0, 2,
            baked=baked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(rays) > 0 and bool(torch.isfinite(rad).all())


@pytest.mark.parametrize("change", [
    {"intersector": "baked", "baked_clusters": 16},
    {"intersector": "bruteforce", "baked_clusters": 16},
], ids=["culled16", "dyn16"])
def test_recluster_invariance_on_card(device, change):
    """Recluster 1 and recluster 2 render the same bits on the card, and
    the segmented render matches the persistent one by the statistical
    rule."""
    from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

    scene, tris = mesh_terrain_scene(n_quads=10)
    cfg = RenderConfig(width=96, height=54, samples_per_pixel=4,
                       samples_per_frame=4, max_bounces=50, engine="fused",
                       **change)
    cc = CameraController.book_one_final()
    out = {k: render(scene, cc, cfg.replace(recluster=k), tris,
                     device=device) for k in (0, 1, 2)}
    assert np.array_equal(out[1].accumulated.view(np.int32),
                          out[2].accumulated.view(np.int32))
    assert out[1].rays_traced == out[2].rays_traced
    check_parity(out[2].accumulated / 4, out[0].accumulated / 4,
                 out[2].rays_traced, out[0].rays_traced)


PROBE_CASES = (["pair/C6", "pair/A2"]
               + [f"gated/{p}/{g}" for p in ("W8", "C8")
                  for g in ("thread", "vote", "worklist")]
               + [f"tripair/{f}" for f in ("T1", "T1p", "T2", "T2p")])


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_kernels_match_plain(device, case):
    """Each probe kernel against its plain version on the same CUDA
    tensors, 2 reps over the reference's 1024 rays and over two copies
    of them: bit-identical, one launch a call."""
    from wavefront_path_tracer_tpu_torch.probes import micro_r2 as pm
    from wavefront_path_tracer_tpu_torch.probes import pair_ceiling as pc
    from wavefront_path_tracer_tpu_torch.probes import tripair as tp

    kind, *rest = case.split("/")
    for copies in (1, 2):
        if kind == "tripair":
            rays = tp.ray_planes(device, copies)
            tab, pk = tp.tables(device)[rest[0]]
            args = (tab, pk, rays, 2)
            fn = lambda: tp.tripair_sweep(*args, rest[0])  # noqa: E731
            plain = lambda: tp.tripair_reference(*args, rest[0])  # noqa
            launches = lambda: tp.LAUNCHES[rest[0]]  # noqa: E731
        else:
            rays = pm.ray_planes(device, copies)
            tab = torch.from_numpy(pm.PACKED_SM).to(device)
            if kind == "pair":
                fn = lambda: pc.pair_sweep(tab, rays, 2, rest[0])  # noqa
                plain = lambda: pc.pair_sweep_reference(tab, rays, 2)  # noqa
                launches = lambda: pc.LAUNCHES[rest[0]]  # noqa: E731
            else:
                pattern, gating = rest
                cond = torch.from_numpy(pm.cond_table(pattern)).to(device)
                fn = lambda: pm.gated_sweep(  # noqa: E731
                    tab, cond, rays, 2, pattern, gating)
                plain = lambda: pm.gated_reference(  # noqa: E731
                    tab, cond, rays, 2, pm.PATTERNS[pattern][2])
                launches = lambda: pm.LAUNCHES[(pattern, gating)]  # noqa
        before = launches()
        k = fn()
        torch.cuda.synchronize()
        assert launches() == before + 1
        p = plain()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
        assert bool((k < 1e29).any())
        if copies == 2:
            assert torch.equal(k[:1024], k[1024:])


@pytest.mark.parametrize("kind", ["plain", "async"])
def test_stream_kernels_within_bound(device, kind):
    """The stream kernels against the float64 sums within the stated
    float32 summation bound, at each chunk size."""
    from wavefront_path_tracer_tpu_torch.probes import hbm_bw as hb

    data = hb.make_data(8, device)
    exact = hb.exact_sums(data, 3)
    for chunk_kb in hb.CHUNKS_KB:
        out = hb.stream(data, 3, 64, chunk_kb, kind)
        torch.cuda.synchronize()
        grid = hb.stream_grid(kind, chunk_kb, data.shape[0])
        bound = hb.tolerance(data, 3, chunk_kb, grid)
        assert float((out.double() - exact).abs().max()) <= bound


DESIGN_CASES = [f"{d}/{p}/{n}" for d, p, n in trp.LAUNCHES]


@pytest.mark.parametrize("case", DESIGN_CASES)
def test_design_kernels_match_plain(device, case):
    """Each run_pairs design in each of its forms (table place, lanes a
    ray) against its plain version on the same CUDA tensors, 2 reps over
    the reference's 1024 rays and over two copies: bit-identical, one
    launch a call."""
    from wavefront_path_tracer_tpu_torch.probes import micro_r2 as pm
    from wavefront_path_tracer_tpu_torch.probes import run_pairs as rp

    design, place, lanes = case.split("/")
    lanes = int(lanes)
    tab = rp.table_for(design, device)
    for copies in (1, 2):
        rays = pm.ray_planes(device, copies)
        before = rp.LAUNCHES[(design, place, lanes)]
        k = rp.design_sweep(tab, rays, 2, design, place, lanes)
        torch.cuda.synchronize()
        assert rp.LAUNCHES[(design, place, lanes)] == before + 1
        p = rp.design_reference(tab, rays, 2, design)
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
        assert design == "W2" or bool((k < 1e29).any())
        if copies == 2:
            assert torch.equal(k[:1024], k[1024:])


def test_design_sqrt_matches_sqrtf(device):
    """probe_designs.cu's branchless square root against sqrtf on every
    one of the 2^32 floats (NaN against NaN)."""
    from wavefront_path_tracer_tpu_torch.probes import _slope

    count = torch.zeros(1, dtype=torch.int64, device=device)
    _slope.launch("wpt_probe_sqrt_mismatches", count.data_ptr())
    torch.cuda.synchronize()
    assert int(count.item()) == 0


def test_sin_fast_matches_sinf(device):
    """fastmath.cuh's sinf_fast against sinf on every float that it
    claims (|x| < kSinFastMax, or NaN: +-0 and the subnormals among
    them; the texture step's checker sends inf and larger arguments to
    sinf), of the 2^32 (NaN against NaN)."""
    from wavefront_path_tracer_tpu_torch.probes import _slope, texstep

    count = torch.zeros(2, dtype=torch.int64, device=device)
    _slope.launch("wpt_probe_sin_mismatches", count.data_ptr())
    torch.cuda.synchronize()
    assert count.tolist() == [texstep.SIN_FAST_CLAIMED, 0]


@pytest.mark.parametrize("form", ["f32", "f32_fma", "bf16x2", "bf16",
                                  "bf16x2_fma", "i16", "i8"])
def test_issue_kernels_match_plain(device, form):
    """bf16_issue's chains at 2 reps over two copies of the block, bit for
    bit against the plain version (the fused forms against their own, one
    rounding a multiply-add)."""
    from wavefront_path_tracer_tpu_torch.probes import bf16_issue as bi

    x = bi.make_x(form, 2, device)
    k = bi.chains(x, 2, form)
    torch.cuda.synchronize()
    p = bi.chains_reference(x, 2, form)
    assert torch.equal(k, p)
    assert torch.equal(k[:256], k[256:])


@pytest.mark.parametrize("row", range(7))
def test_mma_kernels_within_bound(device, row):
    """matmul_bench's rows at 8 products: every cluster copy the same,
    copy 0 within the stated bound of the plain version."""
    from wavefront_path_tracer_tpu_torch.probes import matmul_r2 as mr

    a, b = mr.inputs(device)[row]
    k = mr.matmul(a, b, 8, row)
    torch.cuda.synchronize()
    p = mr.matmul_reference(a, b, 8, row)
    assert k.shape[0] == mr.copies(row) >= 1
    assert bool((k == k[:1]).all())
    err = (k[0] - p).abs()
    assert bool((err <= mr.tolerance(a, b, 8, row, p)).all())
