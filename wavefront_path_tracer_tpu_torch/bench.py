"""Benchmark runner of the port: Mrays/s on the Shirley book-1 final
scene, plus the three tracked mesh rows, on the CUDA card.

    python -m wavefront_path_tracer_tpu_torch.bench [--all] [...]

Port of the root ``bench.py`` (the JAX package's).  Prints ONE JSON line:

  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N,
   "pairs_per_s": ..., "device_utilization": ..., "utilization_note": ...,
   "mesh": {key: {"config", "value", "unit", ...}}, ...}

The metric is rays processed by extend+shade per second (live rays
summed over bounces over the wall time of one render of ``--spp``
samples, synchronised with the card before and after), against the
BASELINE.json target of 1,000 Mrays/s.  Each row warms up once at the
same sample count, then takes three timed runs; ``value`` is the least
wall time's rate, and ``device_seconds`` holds each run's CUDA-event
time.  A fused row also carries:

* ``counters``: {rays, iterations (loop trips per warp of 32 lanes),
  supers_entered, clusters_entered} of the kernel
  (``models/fused.render_samples_with_stats``), and ``lane_occupancy`` =
  rays / (32 x iterations);
* ``forms``: the launch counts of the three timed runs by kernel and by
  form (``read_launches``); a row whose launches did not all take the
  shipped form fails, and so does a row on the card that launched no
  kernel;
* ``pairs_per_s`` and ``device_utilization``: the primitive pairs that
  the rays asked for (every global item per traced ray, plus each
  entered cluster's items; ``pair_counts``), at the H100's measured pair
  ceilings (``PAIR_CEILING``), over the wall time.

Failures are never hidden behind a stored number.  The default
invocation is an orchestrator that runs the bench in a fresh worker
process (``--worker``), retrying a worker that crashes or hangs (on
Linux a worker dies with its orchestrator); every
failed attempt is printed to stderr and counted in the line as
``failed_attempts``.  When every attempt fails, the line has ``"value":
null``, an ``error`` and, apart under ``last_good``, the port's last
good record (``golden/LAST_GOOD_BENCH_TORCH.json``, written only after a
headline run on a CUDA card), and the bench exits 1.  A mesh row or an
``--all`` configuration that fails keeps its ``{"error": ...}`` entry and
the bench exits 1.

``--mesh TILESxSAMPLES`` renders the headline through
``parallel.render_samples_sharded`` over ``make_mesh(TILES * SAMPLES,
sample_axis=SAMPLES)`` on the CUDA cards (one device under ``--device
cpu``); a mesh larger than the devices present is refused, naming their
count.  As in the reference, the row's config ends in ``/meshTxS``, no
mesh-scene row runs, and it has no kernel counters and no utilization;
``device_seconds`` is the first card's CUDA-event time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time


BASELINE_MRAYS = 1000.0
# The pair-issue ceilings measured on an NVIDIA H100 80GB HBM3 at 700 W
# by the port's probes: C6, a sphere pair read through L1
# (probes/pair_ceiling.py), and T1, a Moller-Trumbore triangle pair
# (probes/tripair.py); pairs per second.
PAIR_CEILING = {"sphere": 562.55e9, "triangle": 334.07e9}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_GOOD_PATH = os.path.join(ROOT, "golden", "LAST_GOOD_BENCH_TORCH.json")
RETRY_DELAY_S = 5.0
# The orchestrator's PID, in the environment of each worker it starts.
ORCHESTRATOR_ENV = "WPT_BENCH_ORCHESTRATOR"
PR_SET_PDEATHSIG = 1
TIMED_RUNS = 3

# Driver-tracked mesh rows (key, scene, w, h, spp, intersector), all
# fused/cull16: the production baked terrain path, the dynamic-culled
# terrain path, and the 50k-triangle torus knot (the incoherent-ray
# stress scene; small spp).  The reference bench's rows, letter for
# letter.
MESH_ROWS = [
    ("terrain_baked", "mesh_terrain", 800, 448, 32, "baked"),
    ("terrain_dynamic", "mesh_terrain", 800, 448, 32, "bruteforce"),
    ("knot50k_dynamic", "mesh_knot50k", 800, 448, 8, "bruteforce"),
]

# The shipped form's launch count of each kernel that has forms
# (read_launches' keys).
SHIPPED = {"persistent": "persistent_warp", "culled": "culled_coop",
           "unculled": "unculled_coop", "dynculled": "dynculled_coop",
           "segment_culled": "segment_culled_coop",
           "segment_unculled": "segment_unculled_coop",
           "segment_dynculled": "segment_dynculled_coop"}


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    fk.LAUNCHES = 0
    fk.WARP_LAUNCHES = 0
    dk.LAUNCHES = 0
    dk.COOP_LAUNCHES = 0
    dk.SEGMENT_LAUNCHES = 0
    dk.SEGMENT_COOP_LAUNCHES = 0
    for counts in (bk.LAUNCHES, bk.COOP_LAUNCHES, *bk.PROBE_LAUNCHES.values(),
                   dk.PROBE_LAUNCHES, dk.SEGMENT_PROBE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch counts, those of its shipped form
    under the ``SHIPPED`` names, and those of its stage probes' kernels
    (``ops/stage_probes.py``) as "kernel/probe"."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    return {"persistent": fk.LAUNCHES, "persistent_warp": fk.WARP_LAUNCHES,
            **bk.LAUNCHES,
            **{f"{k}_coop": v for k, v in bk.COOP_LAUNCHES.items()},
            "dynculled": dk.LAUNCHES, "dynculled_coop": dk.COOP_LAUNCHES,
            "segment_dynculled": dk.SEGMENT_LAUNCHES,
            "segment_dynculled_coop": dk.SEGMENT_COOP_LAUNCHES,
            **{f"{kind}/{probe}": n
               for kind, counts in bk.PROBE_LAUNCHES.items()
               for probe, n in counts.items()},
            **{f"dynculled/{probe}": n
               for probe, n in dk.PROBE_LAUNCHES.items()},
            **{f"segment_dynculled/{probe}": n
               for probe, n in dk.SEGMENT_PROBE_LAUNCHES.items()}}


def require_shipped(label: str, kind: str, launches: dict) -> None:
    """Raise unless every launch of ``kind``'s kernel was its shipped
    form."""
    if kind in SHIPPED and launches[SHIPPED[kind]] != launches[kind]:
        raise AssertionError(f"{label} launched the {kind} kernel in "
                             f"another form than the shipped one: "
                             f"{launches}")


def fused_kernel(intersector: str, clusters: int) -> str:
    """The kernel (``read_launches`` key) that a fused render with this
    intersector and resolved cluster size launches."""
    if intersector == "baked":
        return "culled" if clusters > 0 else "unculled"
    return "dynculled" if clusters > 0 else "persistent"


def knot_tris(scene_name: str) -> int:
    """Triangle budget encoded in a knot scene name: 'mesh_knot' (the
    50k default) or 'mesh_knot<N>k'.  Malformed names (a bare numeric
    suffix, a missing count) are errors, not silent 50k fallbacks — a
    typo'd MESH_ROWS entry must fail, not record a mislabeled row."""
    m = re.fullmatch(r"mesh_knot(?:(\d+)k)?", scene_name)
    if m is None:
        raise ValueError(
            f"bad knot scene name {scene_name!r}: expected "
            "'mesh_knot' or 'mesh_knot<N>k' (e.g. mesh_knot50k)")
    return int(m.group(1)) * 1000 if m.group(1) else 50000


def build_scene(scene_name: str):
    """(scene, triangles | None, camera) of a bench scene name, as the
    reference bench builds them: the book camera, except the knot's own
    view (framing the knot at the origin)."""
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
        knot_camera,
        knot_scene,
        mesh_demo_scene,
        mesh_terrain_scene,
    )

    cc = CameraController.book_one_final()
    if scene_name == "mesh_demo":
        return mesh_demo_scene() + (cc,)
    if scene_name == "mesh_terrain":
        return mesh_terrain_scene() + (cc,)
    if scene_name.startswith("mesh_knot"):
        return knot_scene(knot_tris(scene_name)) + (knot_camera(),)
    return get_scene(scene_name), None, cc


def pair_counts(intersector: str, clusters: int, arrays, camera_pos,
                config, stats: dict) -> dict:
    """The primitive pairs that a fused render's rays asked for, by pair
    type: {"sphere": n, "triangle": n}.

    Every traced ray tests the global items (with brute force or an
    unculled bake: every primitive), and each cluster a ray enters costs
    that cluster's items: ``clusters_entered`` (summed over rays, the
    winner hint's prepass included) times the mean real items of a
    cluster of its hierarchy, from the tables the render swept
    (``models/fused._baked_scene`` or ``_dyn_tables``; padding rows are
    not counted).  Cluster entries of two hierarchies (spheres and
    triangles both clustered) cannot be told apart: ValueError."""
    from wavefront_path_tracer_tpu_torch.models import fused

    rays = float(stats["rays"])
    entered = float(stats["clusters_entered"])
    n_sph = int(arrays["centers"].shape[0])
    n_tri = int(arrays["tri_v0"].shape[0]) if "tri_v0" in arrays else 0
    if intersector == "baked":
        b = fused._baked_scene(arrays, clusters, camera_pos=camera_pos,
                               winner_hint=config.winner_hint,
                               lut_max=config.tex_lut_max)
        if clusters == 0:
            return {"sphere": rays * b.n_items,
                    "triangle": rays * b.n_triangles}
        globals_ = b.n_globals
        hierarchies = {
            kind: float(ranges[:, 1].sum()) / ranges.shape[0]
            for kind, ranges in (("sphere", b.cluster_ranges),
                                 ("triangle", b.tri_cluster_ranges))
            if ranges.shape[0]}
    elif clusters > 0:
        t = fused._dyn_tables(arrays, clusters, camera_pos=camera_pos,
                              lut_max=config.tex_lut_max)
        globals_ = int((~t.spheres[:t.n_globals, 0].isnan()).sum())
        hierarchies = {}
        if t.n_clusters:
            hierarchies["sphere"] = (n_sph - globals_) / t.n_clusters
        if t.n_tri_clusters:
            hierarchies["triangle"] = n_tri / t.n_tri_clusters
    else:
        return {"sphere": rays * n_sph, "triangle": 0.0}
    if len(hierarchies) > 1:
        raise ValueError("cluster entries of the sphere and the triangle "
                         "hierarchies cannot be told apart")
    pairs = {"sphere": rays * globals_, "triangle": 0.0}
    for kind, per_cluster in hierarchies.items():
        pairs[kind] += entered * per_cluster
    return pairs


def parse_mesh(spec):
    """(tiles, samples) of a ``--mesh`` value such as ``4x2``; None for
    None."""
    if spec is None:
        return None
    m = re.fullmatch(r"(\d+)[xX](\d+)", spec)
    if m is None or min(int(m.group(1)), int(m.group(2))) < 1:
        raise ValueError(f"--mesh {spec!r}: expected TILESxSAMPLES, e.g. 4x2")
    return int(m.group(1)), int(m.group(2))


def make_bench_mesh(mesh_spec, device):
    """The mesh of ``--mesh``: over the CUDA cards, or over ``device``
    alone when it is not a card; raises when it needs more devices than
    are present."""
    from wavefront_path_tracer_tpu_torch.parallel.sharding import make_mesh

    tiles, samples = mesh_spec
    return make_mesh(tiles * samples, sample_axis=samples,
                     devices=None if device.type == "cuda" else [device])


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bench_once(scene_name: str, width: int, height: int, spp: int,
               engine: str, intersector: str, max_bounces: int = 50,
               clusters: int = 0, block_tiles: int = 32, lane_split: int = 1,
               rotate_cols: int = 1, rr_start: int = 0,
               winner_hint: bool = False, device="cuda",
               mesh_spec=None) -> dict:
    """One row: a warm-up render of ``spp`` samples, then ``TIMED_RUNS``
    timed ones, sharded over ``mesh_spec`` (tiles, samples) when given;
    the row's dict (see the module docstring)."""
    import torch

    from wavefront_path_tracer_tpu_torch.models import fused, get_engine
    from wavefront_path_tracer_tpu_torch.renderer import (
        prepare_scene,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    device = resolve_device(device)
    cuda = device.type == "cuda"
    cfg = RenderConfig(
        width=width, height=height, samples_per_pixel=spp,
        samples_per_frame=spp, max_bounces=max_bounces,
        engine=engine, intersector=intersector,
        baked_clusters=clusters, block_tiles=block_tiles,
        lane_split=lane_split, lane_rotate_cols=rotate_cols,
        rr_start_bounce=rr_start, winner_hint=winner_hint,
    )
    scene, triangles, cc = build_scene(scene_name)
    arrays = prepare_scene(scene, cfg, device, triangles)
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(width, height)
    cam = cc.gpu_camera()
    eng = get_engine(engine)
    eng.check_supported(cfg, arrays)
    mesh = make_bench_mesh(mesh_spec, device) if mesh_spec else None

    def run():
        if mesh is not None:
            from wavefront_path_tracer_tpu_torch.parallel.sharding import (
                render_samples_sharded,
            )

            return render_samples_sharded(mesh, arrays, cam, view, inv_proj,
                                          cfg, 0, 0, spp) + (None,)
        if engine == "fused":
            return fused.render_samples_with_stats(
                arrays, cam, view, inv_proj, cfg, 0, 0, spp)
        return eng.render_samples(arrays, cam, view, inv_proj, cfg, 0, 0,
                                  spp) + (None,)

    cards = ([d for d in mesh.distinct_devices() if d.type == "cuda"]
             if mesh is not None else [device] if cuda else [])

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    run()                      # warm-up: bakes, tables, the kernel build
    sync()
    reset_launches()
    seconds, device_seconds = [], []
    for _ in range(TIMED_RUNS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        _rad, rays, stats = run()
        if cuda:
            end.record()
        sync()
        seconds.append(time.perf_counter() - t0)
        if cuda:
            device_seconds.append(start.elapsed_time(end) / 1e3)
    launches = read_launches()
    rays = float(rays)
    dt = min(seconds)
    config = (f"{width}x{height}@{spp}spp/{engine}/{intersector}"
              + (f"/cull{clusters}" if clusters else "")
              + (f"/mesh{mesh_spec[0]}x{mesh_spec[1]}" if mesh_spec else ""))
    row = {
        "scene": scene_name, "config": config, "device": str(device),
        "rays": rays, "seconds": dt, "run_seconds": seconds,
        "device_seconds": device_seconds if cuda else None,
        "mrays_per_s": rays / dt / 1e6,
        "counters": {"rays": rays}, "forms": {},
        "pairs": None, "pairs_per_s": None, "device_utilization": None,
    }
    if stats is None:
        return row
    counters = {"rays": rays, **{k: float(v) for k, v in stats.items()}}
    row["counters"] = counters
    row["lane_occupancy"] = rays / (32.0 * max(counters["iterations"], 1.0))
    resolved = fused._resolve_clusters(cfg, arrays)
    kind = fused_kernel(intersector, resolved)
    row["forms"] = {k: v for k, v in launches.items() if v}
    require_shipped(config, kind, launches)
    if cuda and not launches[kind]:
        raise AssertionError(f"{config} launched no {kind} kernel: "
                             f"{launches}")
    try:
        pairs = pair_counts(intersector, resolved, arrays,
                            fused._concrete_eye(view), cfg, counters)
    except ValueError as exc:       # reported beside the row, not a failure
        row["utilization_skipped"] = str(exc)
        return row
    total = pairs["sphere"] + pairs["triangle"]
    at_ceiling = sum(pairs[k] / PAIR_CEILING[k] for k in pairs)
    row.update(pairs=pairs, pairs_per_s=total / dt,
               device_utilization=at_ceiling / dt)
    return row


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m wavefront_path_tracer_tpu_torch.bench",
        description="Mrays/s of the port on the card: the headline and "
                    "the tracked mesh rows, as one JSON line")
    p.add_argument("--scene", default="book_one_final")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    # Default batch IS the BASELINE convergence workload (1000 spp at
    # 1080p in one dispatch); small-spp numbers are tail-bound.
    p.add_argument("--spp", type=int, default=1000)
    p.add_argument("--engine", default="fused")
    p.add_argument("--intersector", default="baked")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--clusters", type=int, default=16,
                   help="fused: leaf cluster size for culling (0 disables)")
    p.add_argument("--block-tiles", type=int, default=32,
                   help="fused: NxN pixel blocks per lane group (0 = linear)")
    p.add_argument("--lane-split", type=int, default=1,
                   help="fused: split each pixel's samples over K lanes")
    p.add_argument("--rotate-cols", type=int, default=1,
                   help="fused: column phases for lane rotation (a TPU "
                        "scheduling knob; accepted)")
    p.add_argument("--rr", type=int, default=0,
                   help="Russian roulette start bounce (0 = off)")
    p.add_argument("--winner-hint", action="store_true",
                   help="fused/baked culled: winner-cluster shortlist")
    p.add_argument("--mesh", default=None, metavar="TILESxSAMPLES",
                   help="shard the headline over a tiles x samples mesh of "
                        "the CUDA cards (one device under --device cpu), "
                        "e.g. 4x2; no mesh rows, no counters")
    p.add_argument("--all", action="store_true",
                   help="sweep fused/baked, fused/bruteforce, wavefront and "
                        "megakernel (bvh and bruteforce); the plain engines "
                        "take spp // 8 samples and render about 0.6 Mrays/s "
                        "on an H100, so at the default 1080p@1000spp they "
                        "take hours: give --all a small size")
    p.add_argument("--no-mesh-row", action="store_true",
                   help="skip the tracked mesh-scene sub-record")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; there is no fallback "
                        "to the CPU)")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)  # internal: run the bench here
    p.add_argument("--attempts", type=int, default=3,
                   help="orchestrator: fresh worker processes to try")
    p.add_argument("--timeout", type=int, default=1500,
                   help="orchestrator: seconds per worker attempt "
                        "(covers the kernel build and the runs)")
    return p


def _all_rows(args) -> list:
    """``--all``: each engine and intersector once; a configuration that
    fails keeps its error."""
    rows = []
    for engine, intersectors in (
        ("fused", ("baked", "bruteforce")),
        ("wavefront", ("bvh", "bruteforce")),
        ("megakernel", ("bvh", "bruteforce")),
    ):
        for intersector in intersectors:
            # The plain engines are thousands of times slower: a smaller
            # (rate-equivalent) sample budget, as in the reference.
            spp = args.spp if engine == "fused" else max(1, args.spp // 8)
            clusters = args.clusters if engine == "fused" else 0
            try:
                r = bench_once(args.scene, args.width, args.height, spp,
                               engine, intersector, args.max_bounces,
                               clusters=clusters, device=args.device)
            except Exception as e:  # keep sweeping; the run fails at the end
                print(f"{engine}/{intersector}: FAILED {e!r}",
                      file=sys.stderr)
                rows.append({"config": f"{engine}/{intersector}",
                             "error": repr(e)})
                continue
            print(f"{r['config']}: {r['mrays_per_s']:.1f} Mrays/s "
                  f"({r['rays']/1e6:.0f} Mrays in {r['seconds']:.2f}s)",
                  file=sys.stderr)
            rows.append(r)
    return rows


def _line(result: dict) -> dict:
    """The JSON line's fields of a headline row."""
    value = result["mrays_per_s"]
    out = {
        "metric": (f"Mrays/sec/chip extend+shade ({result['config']}, "
                   f"{result['scene']})"),
        "value": round(value, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(value / BASELINE_MRAYS, 4),
    }
    for key in ("seconds", "run_seconds", "device_seconds", "counters",
                "lane_occupancy", "forms", "pairs", "pairs_per_s",
                "device_utilization", "utilization_skipped"):
        if result.get(key) is not None:
            out[key] = result[key]
    return out


def worker_main(args) -> int:
    """Run the bench in this process and print its line; 1 when a mesh
    row or an --all configuration failed."""
    import torch

    from wavefront_path_tracer_tpu_torch.renderer import resolve_device

    device = resolve_device(args.device)
    card = card_name() if device.type == "cuda" else "cpu"
    failed = False
    if args.all:
        rows = _all_rows(args)
        ok = [r for r in rows if "error" not in r]
        failed = len(ok) < len(rows)
        if not ok:
            raise RuntimeError(f"every --all configuration failed: {rows}")
        result = max(ok, key=lambda r: r["mrays_per_s"])
    else:
        result = bench_once(args.scene, args.width, args.height, args.spp,
                            args.engine, args.intersector, args.max_bounces,
                            clusters=args.clusters,
                            block_tiles=args.block_tiles,
                            lane_split=args.lane_split,
                            rotate_cols=args.rotate_cols, rr_start=args.rr,
                            winner_hint=args.winner_hint, device=device,
                            mesh_spec=parse_mesh(args.mesh))

    print(f"timing: {result['rays']/1e6:.0f} Mrays in "
          f"{result['seconds']:.2f}s", file=sys.stderr)
    out = _line(result)
    out["card"] = card
    out["device"] = {"type": device.type,
                     "name": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
    if out.get("device_utilization") is not None:
        out["utilization_note"] = (
            "primitive pairs the rays asked for (global items per ray + "
            "entered clusters' items) at the H100's measured issue "
            "ceilings, C6 562.55 Gpairs/s for sphere pairs "
            "(probes/pair_ceiling.py) and T1 334.07 for triangle pairs "
            "(probes/tripair.py), both measured on an NVIDIA H100 80GB "
            f"HBM3 at 700 W; this run: {card}")
    if args.all:
        out["all"] = rows
    if (not args.no_mesh_row and not args.all and args.mesh is None
            and args.scene == "book_one_final"):
        # The tracked mesh rows (BASELINE measurement config 5: OBJ mesh
        # scenes) catch large-scene regressions the sphere headline cannot
        # see; a failed row keeps its error and fails the run.
        out["mesh"] = {}
        for key, m_scene, mw, mh, mspp, m_int in MESH_ROWS:
            try:
                m = bench_once(m_scene, mw, mh, mspp, "fused", m_int,
                               args.max_bounces, clusters=16, device=device)
            except Exception as e:
                print(f"mesh row {key}: FAILED {e!r}", file=sys.stderr)
                out["mesh"][key] = {"error": f"mesh row failed: {e!r}"}
                failed = True
                continue
            print(f"mesh row {key} {m['config']}: "
                  f"{m['mrays_per_s']:.2f} Mrays/s", file=sys.stderr)
            row = _line(m)
            out["mesh"][key] = {
                "config": f"{m['config']}, {m['scene']}",
                **{k: v for k, v in row.items()
                   if k not in ("metric", "vs_baseline")}}
    print(json.dumps(out))
    return 1 if failed else 0


def _is_headline(args) -> bool:
    """The record worth keeping: the default run on a CUDA card."""
    defaults = build_parser().parse_args([])
    return (not args.all and args.device.startswith("cuda")
            and all(getattr(args, k) == getattr(defaults, k) for k in (
                "scene", "width", "height", "spp", "engine", "intersector",
                "max_bounces", "clusters", "block_tiles", "lane_split",
                "rotate_cols", "rr", "winner_hint", "no_mesh_row", "mesh")))


def _last_good():
    """The port's last good record, or why there is none."""
    try:
        with open(LAST_GOOD_PATH) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        return {"none": f"no last good record: {e}"}


def orchestrate(args, argv) -> int:
    """Run the bench in fresh worker processes; print one JSON line.
    A worker that prints a line has a result (a failed row included), so
    it is not retried; one that crashes or hangs is."""
    cmd = [sys.executable, "-m", "wavefront_path_tracer_tpu_torch.bench",
           "--worker"] + [a for a in argv if a != "--worker"]
    failures = []
    for attempt in range(max(1, args.attempts)):
        if attempt:
            delay = RETRY_DELAY_S * attempt
            print(f"bench: retrying in {delay:.0f}s in a fresh process",
                  file=sys.stderr)
            time.sleep(delay)
        try:
            proc = subprocess.run(
                cmd, stdout=subprocess.PIPE, stderr=None,
                timeout=args.timeout, text=True, cwd=ROOT,
                env=dict(os.environ, **{ORCHESTRATOR_ENV: str(os.getpid())}))
        except subprocess.TimeoutExpired:
            failures.append(f"worker hang: no result within {args.timeout}s")
        else:
            line = None
            for ln in (proc.stdout or "").splitlines():
                ln = ln.strip()
                if ln.startswith("{") and ln.endswith("}"):
                    line = ln
            if line is not None:
                rec = json.loads(line)
                rec["failed_attempts"] = len(failures)
                if proc.returncode == 0 and _is_headline(args):
                    _record_last_good(rec)
                print(json.dumps(rec))
                return 0 if proc.returncode == 0 else 1
            failures.append(f"worker rc={proc.returncode}, no JSON line")
        print(f"bench attempt {attempt + 1} failed: {failures[-1]}",
              file=sys.stderr)
    print(json.dumps({
        "metric": "Mrays/sec/chip extend+shade", "value": None,
        "unit": "Mrays/s", "vs_baseline": None,
        "error": f"all {len(failures)} bench attempts failed: "
                 + "; ".join(failures),
        "failed_attempts": len(failures),
        "last_good": _last_good()}))
    return 1


def _record_last_good(rec: dict) -> None:
    """Keep a headline record that the card produced (never read back
    into ``value``)."""
    if not (rec.get("value") or 0) > 0:
        return
    try:
        os.makedirs(os.path.dirname(LAST_GOOD_PATH), exist_ok=True)
        with open(LAST_GOOD_PATH, "w") as f:
            json.dump(dict(rec, recorded_at=time.strftime(
                "%Y-%m-%d %H:%M:%S %Z")), f, indent=1)
    except OSError as e:
        print(f"last good record not written: {e}", file=sys.stderr)


def _die_with_orchestrator() -> None:
    """In a worker that the orchestrator started (Linux), have the kernel
    kill this process when the orchestrator dies, so that a killed bench
    leaves no render running on the card."""
    parent = os.environ.get(ORCHESTRATOR_ENV)
    if parent is None or not sys.platform.startswith("linux"):
        return
    import ctypes

    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != int(parent):
        raise SystemExit("bench worker: its orchestrator has ended")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.worker:
        _die_with_orchestrator()
    if args.mesh is not None:
        # Refused here, before any worker starts: a mesh that this machine
        # cannot hold, or a malformed one.
        from wavefront_path_tracer_tpu_torch.renderer import resolve_device

        try:
            make_bench_mesh(parse_mesh(args.mesh),
                            resolve_device(args.device))
        except (ValueError, RuntimeError) as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from e
    if args.worker:
        return worker_main(args)
    return orchestrate(args, argv)


if __name__ == "__main__":
    sys.exit(main())
