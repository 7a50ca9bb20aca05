"""Command-line renderer for the PyTorch port.

Port of ``python -m wavefront_path_tracer_tpu.cli``, flag for flag: the
fused engine with the brute-force and the baked intersects
(``--clusters N|auto`` culls either: the baked sweep, or the dynamic
culled sweep over runtime tables for brute force), the megakernel oracle
(``--engine megakernel``) and the wavefront engine (``--engine
wavefront``), both of which take brute force or the BVH (``--intersector
bvh``) over every sphere and triangle, on sphere scenes, textured scenes
(``--scene book_checker``, ``--scene-file``, ``--tex-lut``) and triangle
meshes (``--scene mesh_demo|mesh_terrain``, ``--obj``), with the winner
hint (``--winner-hint``) or the segmented re-clustering path
(``--recluster K``), on a torch device (``--device``, or ``--platform``
as the reference names it).  ``--stage-timing`` reports the wavefront
engine's per-stage times or the fused engine's in-kernel counters each
frame, and after the render of the fused engine with ``--intersector
baked`` its differential per-stage table (``models/fused.py``
``stage_timing``); ``--profile-dir`` writes a ``torch.profiler`` trace of
the first frame.  The app layer: ``--tonemap``, ``--until-delta``, ``--preview``
(a PNG rewritten every frame, with an auto-refresh page beside it),
``--preview-term``, ``--serve PORT`` (a live window over HTTP,
``utils/preview_server.py``), ``--interactive`` (``app.py``), ``--aov``
(``aov.py``), ``--checkpoint`` and ``--resume``.  The accumulator stays
on the device; a frame that is shown, served or saved is copied to the
host once.

Example (the headline configuration)::

    python -m wavefront_path_tracer_tpu_torch.cli --device cuda \\
        --scene book_one_final --width 1920 --height 1080 --spp 32 \\
        --spf 32 --intersector baked --clusters 16 --out render.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# --platform (the reference's JAX platform flag) -> torch device type.
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wavefront_path_tracer_tpu_torch",
        description="Path tracer, PyTorch/CUDA port (fused engine, "
                    "megakernel oracle and wavefront engine)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; there "
                        "is no fallback to the CPU)")
    p.add_argument("--engine", default="fused",
                   choices=["fused", "megakernel", "wavefront"],
                   help="fused: the hand-written kernels; megakernel: the "
                        "plain PyTorch oracle; wavefront: the reference's "
                        "queue-based architecture in plain PyTorch")
    p.add_argument("--scene", default="book_one_final",
                   help="book_cover | book_one_final | book_bubble | "
                        "book_checker | procedural | cornell_spheres | "
                        "mesh_demo | mesh_terrain")
    p.add_argument("--scene-file", default=None, metavar="JSON",
                   help="render a user scene file (scene/file.py format; "
                        "overrides --scene)")
    p.add_argument("--scene-seed", type=int, default=42)
    p.add_argument("--obj", default=None,
                   help="render an OBJ file (triangle mesh over a ground "
                        "sphere; traced with intersector 'baked' or the "
                        "dynamic culled path)")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--spheres", type=int, default=10000,
                   help="sphere count for --scene procedural")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=225)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--spf", type=int, default=1, help="samples per frame batch")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--frame", type=int, default=0, help="RNG frame salt")
    p.add_argument("--intersector", default="bruteforce",
                   choices=["bruteforce", "bvh", "baked", "auto"],
                   help="bruteforce sweeps the sphere table (with "
                        "--clusters, the dynamic culled tables); baked "
                        "sweeps the scene baked into visit-ordered tables; "
                        "auto picks baked below 2000 primitives; bvh "
                        "traverses a BVH (wavefront and megakernel "
                        "engines)")
    p.add_argument("--clusters", default=0, metavar="N|auto",
                   type=lambda v: -1 if v == "auto" else int(v),
                   help="leaf cluster size for culling (0 = none; auto = "
                        "16 below 2000 primitives, 32 above; a multiple of "
                        "8 for bruteforce)")
    p.add_argument("--sampler", default="random",
                   choices=("random", "stratified"))
    p.add_argument("--tex-lut", type=int, default=None, metavar="TEXELS",
                   help="texel budget per image-texture LUT (default: the "
                        "RenderConfig default)")
    p.add_argument("--winner-hint", action="store_true",
                   help="baked culled: test each lane's last winner "
                        "cluster first, to tighten the cull cap")
    p.add_argument("--recluster", type=int, default=0, metavar="K",
                   help="re-sort live rays by origin Morton cell x "
                        "direction octant every K bounces (segment "
                        "lengths double after the second; 0 = off, at "
                        "most 2); needs baked or --clusters")
    p.add_argument("--rr", type=int, default=0, metavar="BOUNCE",
                   help="Russian roulette from this surface event (0 = off)")
    p.add_argument("--rr-floor", type=float, default=0.05, metavar="P")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="per-sample radiance clamp (0 = off)")
    p.add_argument("--block-tiles", type=int, default=32,
                   help="NxN pixel blocks per lane group (0 = linear order)")
    p.add_argument("--look-from", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--vfov", type=float, default=None)
    p.add_argument("--defocus-angle", type=float, default=None)
    p.add_argument("--focus-distance", default=None,
                   help="thin-lens focus distance, or 'auto'")
    p.add_argument("--tonemap", default="gamma2",
                   choices=("gamma2", "reinhard", "aces"),
                   help="display transform of every image written: gamma2 "
                        "(the reference's display pass), or reinhard/aces "
                        "(then the same gamma-2 encode)")
    p.add_argument("--out", default="render.png")
    p.add_argument("--until-delta", type=float, default=0.0, metavar="D",
                   help="stop early once the display image changes by less "
                        "than D (mean abs per channel) between frame "
                        "batches; --spp stays the hard cap")
    p.add_argument("--aov", default=None, metavar="PREFIX",
                   help="also write first-hit AOV passes (albedo / normal / "
                        "depth + raw npz) as PREFIX.*.png, at min(spp, 16) "
                        "samples")
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="rewrite this PNG after every frame batch and write "
                        "an auto-refresh HTML viewer next to it")
    p.add_argument("--preview-term", action="store_true",
                   help="draw the converging image in the terminal (24-bit "
                        "ANSI half-blocks) after every frame")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live render window over HTTP (frames "
                        "pushed as they converge; 0 picks a free port); "
                        "with --interactive the page's keyboard steers the "
                        "camera")
    p.add_argument("--serve-host", default="127.0.0.1", metavar="ADDR",
                   help="bind address for --serve (default loopback: the "
                        "endpoints carry no auth)")
    p.add_argument("--interactive", action="store_true",
                   help="live watch-and-steer session: renders "
                        "continuously, w/a/s/d q/e move and i/k/j/l look "
                        "between frame batches with accumulation restart")
    p.add_argument("--checkpoint", default=None,
                   help="npz accumulation checkpoint to write each frame")
    p.add_argument("--resume", default=None,
                   help="npz checkpoint to resume accumulation from")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--platform", default=None,
                   help="the reference's platform flag: cpu renders on the "
                        "CPU, gpu or cuda on the card (overrides --device)")
    p.add_argument("--stage-timing", action="store_true",
                   help="per-stage observability, as the reference's "
                        "per-sample us report (path_tracer.rs:364): "
                        "generate/extend/shade/miss/compact wall us on the "
                        "wavefront engine (host-stepped), in-kernel "
                        "iteration/cull counters on the fused engine")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity, Chrome format) of the first frame into "
                        "this directory")
    return p


def check_args(args) -> None:
    """Resolve ``--platform`` into ``args.device``; raise for a platform
    this port has not and for what the reference itself refuses."""
    if args.platform is not None:
        if args.platform not in PLATFORMS:
            raise ValueError(
                f"--platform {args.platform!r} is not a platform of this "
                f"port: {', '.join(PLATFORMS)}")
        args.device = PLATFORMS[args.platform]
    if args.engine == "fused" and args.intersector == "bvh":
        # The reference's own refusal (its cli.py:275-279).
        raise NotImplementedError(
            "--engine fused has no bvh intersector, as in the reference; "
            "use --intersector baked or bruteforce, or --engine wavefront "
            "or megakernel")


def resolve_intersector(intersector: str, clusters: int, scene,
                        triangles=None, engine: str = "fused"):
    """Resolve ``auto`` and the triangle upgrade as the reference CLI
    does (its ``resolve_intersector``, cli.py:183-217): for the fused
    engine, baked below 2000 primitives (spheres and triangles), with
    clusters sized by count when none were asked for, and the
    brute-force path above; a mesh with no clusters goes to baked, since
    the plain brute-force kernel is spheres-only.  The megakernel takes
    brute force.  Returns (intersector, clusters, notes)."""
    notes = []
    if intersector == "auto" and engine != "fused":
        intersector = "bruteforce"
        notes.append("note: --intersector auto -> bruteforce")
    if intersector == "auto":
        n_prims = len(scene.radii) + (
            len(triangles.v0) if triangles is not None else 0)
        intersector = "baked" if n_prims < 2000 else "bruteforce"
        if clusters == 0:
            clusters = -1
        notes.append(f"note: --intersector auto -> {intersector}"
                     + (" (clusters auto)" if clusters == -1 else ""))
    if (triangles is not None and engine == "fused"
            and intersector != "baked" and clusters == 0):
        intersector = "baked"
        notes.append("note: triangle scene with --engine fused and no "
                     "--clusters -> using intersector=baked")
    return intersector, clusters, notes


def build_camera(args, file_cam=None):
    """The reference CLI's camera, field by field: explicit flag > the
    scene file's camera block > the named scene's default view (none for
    a scene file) > the reference camera (cli.py:286-322)."""
    from wavefront_path_tracer_tpu_torch.scene import (
        SCENE_CAMERAS,
        CameraController,
    )

    scene_cam = {} if args.scene_file else SCENE_CAMERAS.get(args.scene, {})
    file_cam = file_cam or {}
    ref_cam = {"look_from": [13.0, 2.0, 3.0], "look_at": [0.0, 0.0, 0.0],
               "vfov": 20.0, "defocus_angle": 0.6}

    def cam_field(name, cli_value):
        if cli_value is not None:
            return cli_value
        for layer in (file_cam, scene_cam, ref_cam):
            if name in layer:
                return layer[name]
        return None

    look_from = cam_field("look_from", args.look_from)
    look_at = cam_field("look_at", args.look_at)
    if args.focus_distance is not None:
        focus = args.focus_distance
    else:
        focus = file_cam.get("focus_distance",
                             scene_cam.get("focus_distance", 10.0))
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at(look_from, look_at)
    cc.vfov_deg = float(cam_field("vfov", args.vfov))
    cc.defocus_angle_deg = float(cam_field("defocus_angle",
                                           args.defocus_angle))
    if str(focus).lower() == "auto":
        cc.focus_distance = float(np.linalg.norm(
            np.asarray(look_at, np.float64)
            - np.asarray(look_from, np.float64)))
    else:
        cc.focus_distance = float(focus)
    return cc


def build_scene(args):
    """(scene, triangles | None, file camera block | None) from parsed
    arguments, as the reference CLI's ``build_scene`` (cli.py:220-251)."""
    from wavefront_path_tracer_tpu_torch.scene import (
        MeshSceneBuilder,
        get_scene,
        load_obj,
        load_scene_file,
        mesh_demo_scene,
        mesh_terrain_scene,
    )

    if args.scene_file:
        return load_scene_file(args.scene_file)
    if args.obj:
        b = MeshSceneBuilder()
        ground = b.lambertian([0.5, 0.5, 0.5])
        b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)
        load_obj(args.obj, builder=b, scale=args.obj_scale)
        return b.build_mesh_scene() + (None,)
    if args.scene == "mesh_demo":
        return mesh_demo_scene() + (None,)
    if args.scene == "mesh_terrain":
        return mesh_terrain_scene(seed=args.scene_seed) + (None,)
    kwargs = {}
    if args.scene == "book_one_final":
        kwargs["seed"] = args.scene_seed
    elif args.scene == "procedural":
        kwargs = {"n": args.spheres, "seed": args.scene_seed}
    return get_scene(args.scene, **kwargs), None, None


def run(argv=None):
    """Parse, render and write the PNG; returns (renderer, last result).
    The result is None when nothing was rendered (a resumed checkpoint
    that already met the spp budget).  Raises NotImplementedError for
    what the reference refuses too."""
    args = build_parser().parse_args(argv)
    check_args(args)

    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.profiling import KernelTimer

    scene, triangles, file_cam = build_scene(args)
    intersector, clusters, notes = resolve_intersector(
        args.intersector, args.clusters, scene, triangles, args.engine)
    if not args.quiet:
        for note in notes:
            print(note, file=sys.stderr)
    overrides = {}
    if args.tex_lut is not None:
        overrides["tex_lut_max"] = args.tex_lut
    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, samples_per_frame=args.spf,
        max_bounces=args.max_bounces, frame=args.frame,
        engine=args.engine, intersector=intersector, baked_clusters=clusters,
        block_tiles=args.block_tiles, winner_hint=args.winner_hint,
        recluster=args.recluster, sampler=args.sampler,
        rr_start_bounce=args.rr, rr_floor=args.rr_floor, clamp=args.clamp,
        stop_delta=args.until_delta, **overrides,
    )
    camera = build_camera(args, file_cam)
    server = None
    if args.serve is not None:
        from wavefront_path_tracer_tpu_torch.utils.preview_server import (
            PreviewServer,
        )

        server = PreviewServer(port=args.serve, host=args.serve_host)
        if not args.quiet:
            print(f"live render window: http://localhost:{server.port}/",
                  file=sys.stderr)
    if args.preview:
        from wavefront_path_tracer_tpu_torch.utils.preview import (
            write_preview_html,
        )

        html = write_preview_html(args.preview)
        if not args.quiet:
            print(f"live preview: open {html}", file=sys.stderr)
    try:
        if args.interactive:
            return _run_interactive(args, scene, triangles, camera, cfg,
                                    server)
        stage_timer = None
        if args.stage_timing:
            if cfg.engine == "megakernel":
                print("note: --stage-timing reports on the wavefront and "
                      "fused engines only", file=sys.stderr)
            else:
                stage_timer = KernelTimer()
        renderer = Renderer(scene, camera, cfg, triangles,
                            device=args.device, stage_timer=stage_timer)
        result = _render_loop(args, renderer, server)
        if result is not None and args.aov:
            from wavefront_path_tracer_tpu_torch.aov import (
                render_aovs,
                write_aovs,
            )

            paths = write_aovs(args.aov, render_aovs(
                scene, camera, cfg, triangles,
                spp=min(cfg.samples_per_pixel, 16), frame=cfg.frame,
                scene_arrays=renderer.scene_arrays))
            if not args.quiet:
                print(f"wrote AOVs: {', '.join(paths)}", file=sys.stderr)
        return renderer, result
    finally:
        if server is not None:
            server.close()


def _checkpoint_meta(args, cfg) -> dict:
    """What a checkpoint must match to be resumed (the reference CLI's
    metadata guard, its cli.py:395-410): a scene file by absolute path,
    so that --resume cannot blend checkpoints of another user scene."""
    return {
        "width": cfg.width, "height": cfg.height,
        "scene": (f"file:{os.path.abspath(args.scene_file)}"
                  if args.scene_file else args.scene),
        "engine": cfg.engine, "frame": cfg.frame,
    }


def _render_loop(args, renderer, server):
    """The progressive frame loop: every frame batch goes to the preview
    PNG, the live window, the terminal and the checkpoint as asked; the
    final image to ``--out``.  Returns the last result, or None when the
    budget was already met."""
    import torch

    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform,
        load_checkpoint,
        save_checkpoint,
        write_png,
    )
    from wavefront_path_tracer_tpu_torch.utils.preview import (
        term_preview_frame,
    )
    from wavefront_path_tracer_tpu_torch.utils.profiling import (
        FramesPerSecond,
        trace_to,
    )

    cfg = renderer.config
    meta = _checkpoint_meta(args, cfg)
    if args.resume:
        acc, samples, frame = load_checkpoint(args.resume, expect_meta=meta)
        renderer._accum = torch.from_numpy(np.ascontiguousarray(
            acc.reshape(-1, 3), np.float32)).to(renderer.device)
        renderer.progress.accumulated_samples = samples
        renderer.progress.frame = frame
        if not args.quiet:
            print(f"resumed at {samples} spp", file=sys.stderr)
    stage_timer = renderer.stage_timer
    fps = FramesPerSecond()
    t_start = time.perf_counter()
    rays = 0.0
    busy = 0.0
    result = None
    first_frame = True
    while True:
        if first_frame and args.profile_dir:
            with trace_to(args.profile_dir):
                r = renderer.render_frame()
        else:
            r = renderer.render_frame()
        first_frame = False
        if r is None:
            break
        result = r
        fps.update()
        rays += r.rays_traced
        busy += r.wall_time_s
        status = (f"{r.samples}/{cfg.samples_per_pixel} spp  "
                  f"{r.mrays_per_s:8.1f} Mrays/s")
        if args.preview or server is not None or args.preview_term:
            # r.accumulated: the frame's one copy to the host.
            image = display_transform(r.accumulated, r.samples, args.tonemap)
            if args.preview:
                write_png(args.preview, image)
            if server is not None:
                server.publish(image, samples=r.samples,
                               target_spp=cfg.samples_per_pixel,
                               mrays_per_s=r.mrays_per_s,
                               fps=fps.get_avg_fps(),
                               frame=renderer.progress.frame, done=False)
            if args.preview_term:
                term_preview_frame(image, status)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, r.accumulated.reshape(-1, 3),
                            renderer.progress.accumulated_samples,
                            renderer.progress.frame, meta=meta)
        if not args.quiet:
            print(status, file=sys.stderr)
            if stage_timer is not None and stage_timer.averages_us():
                print(f"         kernels: {stage_timer.report()}",
                      file=sys.stderr)
            if r.kernel_stats:
                print(f"         fused: {kernel_counters(r)}",
                      file=sys.stderr)
    if result is None:
        print("nothing to render (SPP budget already met)", file=sys.stderr)
        return None
    final = display_transform(result.accumulated, result.samples,
                              args.tonemap)
    write_png(args.out, final)
    if server is not None:
        # Final present: open viewer tabs show "done" before the exit.
        server.publish(final, samples=result.samples,
                       target_spp=cfg.samples_per_pixel,
                       mrays_per_s=result.mrays_per_s,
                       fps=fps.get_avg_fps(),
                       frame=renderer.progress.frame, done=True)
    if not args.quiet:
        total = time.perf_counter() - t_start
        print(f"wrote {args.out}: {cfg.width}x{cfg.height} @ "
              f"{result.samples} spp in {total:.2f}s on {renderer.device} "
              f"({rays / max(busy, 1e-9) / 1e6:.1f} Mrays/s)",
              file=sys.stderr)
        if args.profile_dir:
            print(f"wrote a torch.profiler trace of the first frame to "
                  f"{args.profile_dir}", file=sys.stderr)
    if (stage_timer is not None and cfg.engine == "fused"
            and cfg.intersector == "baked"):
        # The differential per-stage breakdown (the reference's cli.py:
        # 527-547): each stage duplicated in a probe kernel of its own,
        # the time it adds its share.  Runs after the render.
        from wavefront_path_tracer_tpu_torch.models.fused import (
            stage_timing,
        )

        camera = renderer.camera
        n_samples = min(cfg.samples_per_pixel, 32)
        base, rows = stage_timing(
            renderer.scene_arrays, camera.gpu_camera(),
            camera.view_matrix(),
            camera.inverse_projection(cfg.width, cfg.height), cfg,
            n_samples=n_samples)
        print_stage_table(base, rows, n_samples)
    elif stage_timer is not None and cfg.engine == "fused" and not args.quiet:
        print("note: the fused differential stage breakdown needs "
              "--intersector baked; in-kernel iteration/cull counters "
              "were reported per frame above", file=sys.stderr)
    return result


def print_stage_table(base: float, rows: list, n_samples: int,
                      file=None) -> None:
    """``stage_timing``'s result as the reference's CLI prints it (its
    cli.py:536-547), to stderr by default, with two notes it lacks: a
    probed share below the between-call drift (``STAGE_DRIFT``) is marked
    "*" as not resolved, and a sum of probed shares above 100% is named
    (each share is the stage's marginal cost, and those overlap)."""
    from wavefront_path_tracer_tpu_torch.models.fused import STAGE_DRIFT

    file = sys.stderr if file is None else file
    print(f"fused stage timing (differential probes, {n_samples} spp):",
          file=file)
    probed = rows[:-1]           # the last row is the unprobed residual
    for i, (label, seconds, share) in enumerate(rows):
        mark = " *" if i < len(probed) and share < STAGE_DRIFT else ""
        print(f"  {label:34s} {seconds * 1e3:8.2f} ms  {share:6.1%}{mark}",
              file=file)
    print(f"  {'base render':34s} {base * 1e3:8.2f} ms", file=file)
    if any(share < STAGE_DRIFT for _l, _s, share in probed):
        print(f"  * below the {STAGE_DRIFT:.0%} between-call drift of a "
              f"kernel's time: not resolved", file=file)
    total = sum(share for _l, _s, share in probed)
    if total > 1.0:
        print(f"  the probed shares sum to {total:.1%}: each is its "
              f"stage's marginal cost, and they overlap", file=file)


def _run_interactive(args, scene, triangles, camera, cfg, server):
    """``--interactive``: the live session (``app.interactive_loop``),
    then the final image from the accumulator to ``--out``."""
    from wavefront_path_tracer_tpu_torch.app import (
        InteractiveSession,
        final_image,
        interactive_loop,
    )
    from wavefront_path_tracer_tpu_torch.utils.image import write_png

    session = InteractiveSession(scene, camera, cfg, triangles,
                                 device=args.device)
    interactive_loop(session, out_png=args.preview or args.out,
                     show_term=args.preview_term or None,
                     publish=server.publish if server else None,
                     key_source=server.pop_keys if server else None,
                     tonemap=args.tonemap)
    final = final_image(session, args.tonemap)
    if final is not None:
        samples = session.renderer.progress.accumulated_samples
        write_png(args.out, final)
        if server:
            server.publish(final, samples=samples, done=True)
        if not args.quiet:
            print(f"wrote {args.out} @ {samples} spp", file=sys.stderr)
    return session.renderer, None


def kernel_counters(result) -> str:
    """The fused engine's in-kernel counters of a frame, per loop trip of
    a warp (``iterations`` counts the trips of each 32-lane warp)."""
    ks = result.kernel_stats
    iters = max(1.0, ks["iterations"])
    line = (f"{ks['iterations']:.0f} warp-iters  "
            f"{result.rays_traced / (32.0 * iters):6.1%} lane-occupancy")
    if ks["clusters_entered"]:
        line += (f"  {ks['clusters_entered'] / iters:.1f} clusters/iter  "
                 f"{ks['supers_entered'] / iters:.1f} supers/iter")
    return line


def main(argv=None) -> int:
    """Exit code: 0, or 1 when nothing was rendered (a resumed
    checkpoint that already met the spp budget), as the reference."""
    args = build_parser().parse_args(argv)
    renderer, result = run(argv)
    return 1 if result is None and not args.interactive else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        sys.exit(2)
