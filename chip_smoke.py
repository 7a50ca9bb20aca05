"""Drive the PyTorch/CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from ``csrc/`` with nvcc, one process
   per source, all started together;
3. kernels vs plain: each kernel against its plain PyTorch version on
   the same CUDA tensors (book_one_final, 160x90, block lane order with
   padding lanes, 4 spp, 50 bounces, the CLI's default view): the
   persistent-lane kernel (default, and roulette/clamp/stratified AA/
   lane_split=2), the baked kernel culled in clusters of 16 (the same
   two option sets), culled in clusters of 2 (243 clusters, so the
   two-level sweep) and unculled.  Radiance words and the counters
   [rays, iterations, supers, clusters] must be bit-identical (the
   kernels are built without FMA contraction);
4. golden gate: ``render()`` of book_one_final at 400x225, 1000 spp,
   against ``golden/oracle_book_400x225_1000spp.npz``, display RMSE
   < 1e-3, with the brute-force intersector and with baked/cull16;
5. main paths: the CLI at 1920x1080, 32 spp in one frame, 50 bounces,
   for the brute-force path, the headline path (``--intersector baked
   --clusters 16``) and the unculled baked path, each warmed up and then
   timed, with the launch counts set to 0 just before the timed run and
   read just after;
6. full size: the checks of phase 3 at the main paths' planes (1920x1080,
   block order): the persistent kernel at 1 and 4 samples per lane, the
   two baked kernels at 1; the plain versions' times there; and each
   kernel's time at 32 samples per lane beside its bound.

The last two lines of standard output are a JSON object describing the
kernels and ``{"ok": true, "device": {...}}``.  Larger outputs (the
1080p PNGs, a JSON of all measurements) go to ``OUT_DIR``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
GOLDEN = os.path.join(ROOT, "golden", "oracle_book_400x225_1000spp.npz")
GOLDEN_GATE = 1e-3
MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP = 1920, 1080, 32
SOURCE = "wavefront_path_tracer_tpu_torch/csrc/"
REPLACES = "wavefront_path_tracer_tpu/ops/pallas_kernels.py:"

# The port's kernels: their entries in the kernels line, and the CLI
# flags of the path that runs each.
KERNELS = {
    "persistent": {"name": "fused_render_persistent",
                   "source": SOURCE + "persistent.cu",
                   "replaces": REPLACES + "3098",
                   "argv": ["--intersector", "bruteforce"]},
    "culled": {"name": "fused_render_baked/baked_culled_intersect",
               "source": SOURCE + "baked.cu",
               "replaces": REPLACES + "3157",
               "argv": ["--intersector", "baked", "--clusters", "16"]},
    "unculled": {"name": "fused_render_baked/baked_intersect",
                 "source": SOURCE + "baked.cu",
                 "replaces": REPLACES + "3157",
                 "argv": ["--intersector", "baked", "--clusters", "0"]},
}

# The bound's inputs: H100 SXM peak rates at 700 W.
PEAK_FP32 = 67e12          # FLOP/s, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12       # B/s, HBM3
# FP32 operations counted from the sources (adds, multiplies, divides,
# square roots, min/max; compares and selects not counted):
FLOPS_PAIR = {
    "persistent": 24,      # persistent.cu TableIntersect: the full quadratic
    "unculled": 21,        # baked.cu UnculledIntersect, far root not taken
    "culled": 17,          # baked.cu CulledIntersect::test, far root not taken
}
FLOPS_BOX = 24             # box_range (22) and the cond's max and min
FLOPS_RAY = 120            # shade, throughput and miss (common.cuh), per ray
FLOPS_RAY_CULLED = 38      # shifted origin, dd_o, oo2, 1/d, the slab test


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, smi


def phase_build() -> float:
    from wavefront_path_tracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, report, _ = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    log(f"[build] {path.relative_to(ROOT)} from "
        f"{[p.name for p in _build.sources()]} in {seconds:.2f} s")
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return seconds


def _time_ms(fn, reps: int):
    """(mean ms per call by CUDA events, the last call's result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _scene_arrays(scene, device):
    from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch

    return scene_arrays_to_torch(
        {k: getattr(scene, k) for k in ("centers", "radii", "albedo", "fuzz",
                                        "refract_idx", "mat_type")}, device)


class Case:
    """One kernel's inputs at one shape, built as models/fused.py builds
    them, with the kernel, its plain version and its launch counter."""

    def __init__(self, kind, clusters, scene, cc, width, height, spp, split,
                 kw, device):
        from wavefront_path_tracer_tpu_torch.models import fused
        from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
        from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

        self.kind, self.spp, self.split = kind, spp, split
        self.n_pixels = width * height
        cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=50,
                           engine="fused")
        arrays = _scene_arrays(scene, device)
        perm, _ = fused._block_perm(width, height, 32)
        self.perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        self.planes = fused.lane_planes(self.perm_t, width, cfg.tile_rows,
                                        split, spp // split)
        cam = torch.from_numpy(fused.camera_params(
            cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(width, height), cfg)).to(device)
        salts = (0, 0, 50, spp // split)
        if kind == "persistent":
            table = arrays["scene_packed"]
            n = len(scene.radii)
            self.table_bytes = table.numel() * 4
            self.n_rows = min(table.shape[0], (n + 7) // 8 * 8)
            self.kernel = lambda: fk.fused_render_persistent(
                table, n, salts, cam, *self.planes, **kw)
            self.plain = lambda: fk.fused_render_persistent_reference(
                table, n, salts, cam, *self.planes, **kw)
            self.launches = lambda: fk.LAUNCHES
        else:
            baked = fused._baked_scene(arrays, clusters,
                                       camera_pos=fused._concrete_eye(
                                           cc.view_matrix()))
            self.baked = baked
            self.table_bytes = sum(
                t.numel() * t.element_size()
                for t in (baked.items, baked.cluster_boxes,
                          baked.cluster_ranges, baked.super_boxes,
                          baked.super_ranges, baked.consts))
            self.kernel = lambda: bk.fused_render_baked(
                baked, salts, cam, *self.planes, **kw)
            self.plain = lambda: bk.fused_render_baked_reference(
                baked, salts, cam, *self.planes, **kw)
            self.launches = lambda: bk.LAUNCHES[kind]

    def image(self, out):
        """(P, 3) sample-averaged radiance in natural pixel order."""
        lanes = torch.stack([r.reshape(-1) for r in out[:3]], dim=-1)
        lanes = lanes[:self.n_pixels * self.split].reshape(
            self.split, self.n_pixels, 3).sum(dim=0)
        img = torch.empty_like(lanes)
        img[self.perm_t] = lanes
        return (img / self.spp).cpu().numpy()

    def bound(self, stats) -> dict:
        """The least time the card could take for this launch's work: the
        larger of its bytes over the memory rate and its FP32 operations
        over the FP32 rate (each input read once, each output written
        once; the pairs and boxes that this run's rays needed)."""
        rays, _iters, supers, clusters = (float(v) for v in stats)
        n_lanes = self.planes[0].numel()
        counters = 1 if self.kind == "persistent" else 3
        n_bytes = (n_lanes * 4 * (5 + 3 + counters) + 24 * 4
                   + self.table_bytes)
        if self.kind == "persistent":
            pairs = rays * self.n_rows
            ops = pairs * FLOPS_PAIR["persistent"] + rays * FLOPS_RAY
        elif self.kind == "unculled":
            pairs = rays * self.baked.n_items
            ops = pairs * FLOPS_PAIR["unculled"] + rays * FLOPS_RAY
        else:
            b = self.baked
            pairs = rays * b.n_globals + clusters * b.mean_cluster_size
            if b.super_ranges.shape[0]:
                boxes = (rays * b.super_ranges.shape[0]
                         + supers * b.n_clusters / b.super_ranges.shape[0])
            else:
                boxes = rays * b.n_clusters
            ops = (pairs * FLOPS_PAIR["culled"] + boxes * FLOPS_BOX
                   + rays * (FLOPS_RAY + FLOPS_RAY_CULLED))
        t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FP32
        return {"pairs": pairs, "ops": ops, "bytes": n_bytes,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _check(label, case, reps: int = 0) -> dict:
    """The kernel against its plain version on the same CUDA tensors:
    radiance words and all four counters bit-identical.  With ``reps``,
    also the CUDA-event times of the kernel (mean of ``reps`` calls) and
    of the plain version (one call)."""
    from wavefront_path_tracer_tpu_torch.utils.parity import parity_report

    before = case.launches()
    k = case.kernel()
    torch.cuda.synchronize()
    if case.launches() != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    plain_ms, p = _time_ms(case.plain, 1)
    stats_k, stats_p = k[3].tolist(), p[3].tolist()
    bit_exact = stats_k == stats_p and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(k[:3], p[:3]))
    rep = parity_report(case.image(k), case.image(p))
    rep.update(case=label, kernel=case.kind, stats_kernel=stats_k,
               stats_plain=stats_p, bit_exact=bit_exact)
    if reps:
        rep["kernel_ms"], _ = _time_ms(case.kernel, reps)
        rep["plain_ms"] = plain_ms
        rep.update(case.bound(stats_k))
    log(f"[kernel-vs-plain] {label}: {json.dumps(rep)}")
    if not bit_exact:
        raise AssertionError(f"{label}: kernel and plain version differ")
    if case.kind == "culled" and not stats_k[3] > 0:
        raise AssertionError(f"{label}: no cluster was entered")
    return rep


def _smoke_scene():
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    # The CLI's default scene and view (thin lens on).
    return (get_scene("book_one_final", seed=42),
            build_camera(build_parser().parse_args([])))


def phase_kernel_vs_plain(device) -> list[dict]:
    scene, cc = _smoke_scene()
    opts = {"rr_start": 3, "clamp": 0.5, "sampler": "stratified"}
    cases = [
        ("persistent 160x90@4spp default", "persistent", 0, {}, 1),
        ("persistent 160x90@4spp rr3/clamp0.5/stratified/split2",
         "persistent", 0, opts, 2),
        ("culled16 160x90@4spp default", "culled", 16, {}, 1),
        ("culled16 160x90@4spp rr3/clamp0.5/stratified/split2", "culled",
         16, opts, 2),
        ("culled2 (two-level) 160x90@4spp default", "culled", 2, {}, 1),
        ("unculled 160x90@4spp default", "unculled", 0, {}, 1),
    ]
    out = []
    for label, kind, clusters, kw, split in cases:
        case = Case(kind, clusters, scene, cc, 160, 90, 4, split, kw, device)
        out.append(_check(label, case))
    two_level = out[4]["stats_kernel"]
    if not two_level[2] > 0:
        raise AssertionError("the two-level case entered no super")
    return out


def phase_golden(device) -> dict:
    from wavefront_path_tracer_tpu_torch.renderer import render
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    z = np.load(GOLDEN, allow_pickle=False)
    meta = {"scene": "book_one_final", "width": 400, "height": 225,
            "spp": 1000, "max_bounces": 50, "engine": "megakernel",
            "intersector": "bruteforce"}
    stored = json.loads(str(z["meta"]))
    if stored != meta:
        raise AssertionError(f"golden meta {stored} != expected {meta}")
    out = {}
    for label, kw in (("bruteforce", {}),
                      ("baked/cull16", {"intersector": "baked",
                                        "baked_clusters": 16})):
        cfg = RenderConfig(width=400, height=225, samples_per_pixel=1000,
                           samples_per_frame=200, max_bounces=50,
                           engine="fused", **kw)
        t0 = time.perf_counter()
        res = render(get_scene("book_one_final"),
                     CameraController.book_one_final(), cfg, device=device)
        seconds = time.perf_counter() - t0
        err = rmse(res.image, z["image"])
        log(f"[golden] {label}: book_one_final 400x225@1000spp display "
            f"RMSE {err!r} (gate {GOLDEN_GATE}) in {seconds:.2f} s, "
            f"{res.rays_traced:.0f} rays")
        if not err < GOLDEN_GATE:
            raise AssertionError(f"golden RMSE {err} >= {GOLDEN_GATE}")
        out[label] = {"rmse": err, "seconds": seconds,
                      "rays": res.rays_traced}
    return out


def _reset_launches():
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    fk.LAUNCHES = 0
    bk.LAUNCHES.update(culled=0, unculled=0)


def _read_launches() -> dict:
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    return {"persistent": fk.LAUNCHES, **bk.LAUNCHES}


def phase_main_paths(device, smi: str) -> dict:
    """Each path through the CLI: warm-up, then a timed run whose launch
    counts are read alone; that path's kernel must have run."""
    from wavefront_path_tracer_tpu_torch import cli

    out = {}
    for kind, spec in KERNELS.items():
        out_png = os.path.join(OUT_DIR, f"smoke_1080p_{kind}.png")
        argv = ["--device", device.type, "--scene", "book_one_final",
                "--width", str(MAIN_WIDTH), "--height", str(MAIN_HEIGHT),
                "--spp", str(MAIN_SPP), "--spf", str(MAIN_SPP),
                "--max-bounces", "50", *spec["argv"], "--out", out_png,
                "--quiet"]
        cli.run(argv)                                  # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        _, result = cli.run(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        img = result.accumulated / result.samples
        if launches[kind] < 1:
            raise AssertionError(f"the {kind} path launched no {kind} kernel")
        if not np.isfinite(img).all() or not img.mean() > 0.01:
            raise AssertionError(f"bad 1080p image ({kind}): mean "
                                 f"{img.mean()}")
        mrays = result.rays_traced / result.wall_time_s / 1e6
        log(f"[main-path] {kind} ({' '.join(spec['argv'])}): cli "
            f"{MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp, 50 bounces: "
            f"{seconds:.3f} s end to end, render {result.wall_time_s:.3f} s, "
            f"{result.rays_traced:.0f} rays, {mrays:.1f} Mrays/s, "
            f"launches {launches}, image mean {img.mean():.4f} [{smi}]")
        out[kind] = {"seconds_end_to_end": seconds,
                     "render_seconds": result.wall_time_s,
                     "rays": result.rays_traced, "mrays_per_s": mrays,
                     "launches": launches[kind], "all_launches": launches,
                     "image_mean": float(img.mean())}
    return out


def phase_full_size(device, smi: str) -> dict:
    """The checks of phase 3 at the main paths' planes, the plain
    versions' times there, and each kernel's time at MAIN_SPP samples per
    lane beside its bound."""
    scene, cc = _smoke_scene()
    checks = {kind: [] for kind in KERNELS}
    for kind, clusters, spp in (("persistent", 0, 1), ("persistent", 0, 4),
                                ("culled", 16, 1), ("unculled", 0, 1)):
        case = Case(kind, clusters, scene, cc, MAIN_WIDTH, MAIN_HEIGHT, spp,
                    1, {}, device)
        rep = _check(f"{kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp default",
                     case, reps=5)
        log(f"[timing] {kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp "
            f"book_one_final, 50 bounces: kernel {rep['kernel_ms']!r} ms, "
            f"plain {rep['plain_ms']!r} ms, bound {rep['bound_ms']!r} ms "
            f"({rep['bound_by']}) [{smi}]")
        checks[kind].append(rep)
    timed = {}
    for kind, clusters in (("persistent", 0), ("culled", 16),
                           ("unculled", 0)):
        case = Case(kind, clusters, scene, cc, MAIN_WIDTH, MAIN_HEIGHT,
                    MAIN_SPP, 1, {}, device)
        case.kernel()                                  # warm-up
        ms, out = _time_ms(case.kernel, 3)
        stats = out[3].tolist()
        rep = {"kernel_ms": ms, "stats": stats, **case.bound(stats),
               "clusters_per_ray": stats[3] / stats[0]}
        log(f"[timing] {kind} {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp "
            f"book_one_final, 50 bounces: kernel {ms!r} ms, bound "
            f"{rep['bound_ms']!r} ms ({rep['bound_by']}), rays {stats[0]}, "
            f"supers {stats[2]}, clusters {stats[3]} "
            f"({rep['clusters_per_ray']:.4f} per ray) [{smi}]")
        timed[kind] = rep
    return {"checks": checks, "timed": timed}


def main() -> int:
    name, smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    build_s = phase_build()
    parity = phase_kernel_vs_plain(device)
    golden = phase_golden(device)
    main_paths = phase_main_paths(device, smi)
    full = phase_full_size(device, smi)

    head, brute = main_paths["culled"], full["timed"]
    log(f"[headline] baked/cull16 cli {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}"
        f"spp: render {head['render_seconds']:.3f} s, "
        f"{head['mrays_per_s']:.1f} Mrays/s, "
        f"{brute['culled']['clusters_per_ray']:.4f} clusters entered per "
        f"ray; kernel {brute['culled']['kernel_ms']!r} ms vs brute-force "
        f"kernel {brute['persistent']['kernel_ms']!r} ms at that shape; "
        f"1080p@1spp kernel {full['checks']['culled'][0]['kernel_ms']!r} ms "
        f"vs plain {full['checks']['culled'][0]['plain_ms']!r} ms [{smi}]")

    record = {"card": smi, "device": name, "build_seconds": build_s,
              "parity": parity, "golden": golden, "main_paths": main_paths,
              "full_size": full,
              "seconds_total": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    kernels = []
    for kind, spec in KERNELS.items():
        reps = [r for r in parity if r["kernel"] == kind]
        reps += full["checks"][kind]
        main_check = full["checks"][kind][0]       # 1080p@1spp
        kernels.append({
            "name": spec["name"], "route": "cuda",
            "source": spec["source"], "replaces": spec["replaces"],
            "launches": main_paths[kind]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in reps),
            "ms": main_check["kernel_ms"],
            "plain_ms": main_check["plain_ms"],
            "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"],
            "library_ms": None,
        })
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
