"""Drive the PyTorch/CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (nonzero exit):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain: the persistent-lane kernel against its plain PyTorch
   version on the same CUDA tensors (book_one_final, 160x90, block lane
   order with padding lanes, 4 spp, 50 bounces, thin lens; then roulette,
   clamp, stratified AA and lane_split=2).  Radiance and rays must be
   bit-identical (the kernel is built without FMA contraction), and so
   within the statistical parity rule of ``utils/parity.py``;
4. golden gate: ``render()`` of book_one_final at 400x225, 1000 spp,
   against ``golden/oracle_book_400x225_1000spp.npz``: display RMSE < 1e-3;
5. main path: the CLI entry at 1920x1080, 32 spp, 50 bounces, warmed up
   and then timed; launch counts are read from that run alone;
6. full size: the checks of phase 3, and the kernel's and the plain
   version's times, at the main path's planes (1920x1080, block order,
   default CLI view) with 1 and with 32 samples per lane.

The last two lines of standard output are a JSON object describing the
kernels and ``{"ok": true, "device": {...}}``.  Larger outputs (the
1080p PNG, a JSON of all measurements) go to ``chiprun_out/``.
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
KERNEL_SOURCE = "wavefront_path_tracer_tpu_torch/csrc/persistent.cu"
KERNEL_REPLACES = "wavefront_path_tracer_tpu/ops/pallas_kernels.py:3098"
GOLDEN_GATE = 1e-3
MAIN_WIDTH, MAIN_HEIGHT, MAIN_SPP = 1920, 1080, 32


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
    log(f"[build] {path.relative_to(ROOT)} in {seconds:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
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


def _inputs(scene, cc, width, height, spp, split, device):
    """Scene table, camera and lane planes as models/fused.py builds them."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops.fused_kernels import pack_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50, engine="fused")
    arrays = {"centers": scene.centers, "radii": scene.radii,
              "albedo": scene.albedo, "fuzz": scene.fuzz,
              "refract_idx": scene.refract_idx, "mat_type": scene.mat_type}
    perm, _ = fused._block_perm(width, height, 32)
    perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
    planes = fused.lane_planes(perm_t, width, cfg.tile_rows, split,
                               spp // split)
    cam = torch.from_numpy(fused.camera_params(
        cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(width, height), cfg)).to(device)
    salts = (0, 0, 50, spp // split)
    return pack_scene(arrays, device=device), len(scene.radii), salts, cam, \
        planes, perm_t


def _pixels(rad, perm_t, n_pixels, split):
    """Lane radiance planes -> (P, 3) per-pixel sums in natural order."""
    lanes = torch.stack([r.reshape(-1) for r in rad], dim=-1)
    lanes = lanes[:n_pixels * split].reshape(split, n_pixels, 3).sum(dim=0)
    out = torch.empty_like(lanes)
    out[perm_t] = lanes
    return out


def _check_kernel(label, scene, cc, width, height, spp, split, kw, device,
                  reps: int = 0) -> dict:
    """The kernel against the plain version on the same CUDA tensors:
    radiance and rays bit-identical, and the parity rule's metrics.  With
    ``reps``, also the CUDA-event times of the kernel (mean of ``reps``
    calls) and of the plain version (one call)."""
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
    from wavefront_path_tracer_tpu_torch.utils.parity import (
        check_parity,
        parity_report,
    )

    table, n_sph, salts, cam, planes, perm_t = _inputs(
        scene, cc, width, height, spp, split, device)

    def kernel():
        return fk.fused_render_persistent(table, n_sph, salts, cam, *planes,
                                          **kw)

    def plain():
        return fk.fused_render_persistent_reference(table, n_sph, salts, cam,
                                                    *planes, **kw)

    before = fk.LAUNCHES
    k = kernel()
    torch.cuda.synchronize()
    if fk.LAUNCHES != before + 1:
        raise AssertionError("the kernel wrapper did not count its launch")
    plain_ms, p = _time_ms(plain, 1)
    n = width * height

    def img(out):
        return (_pixels(out[:3], perm_t, n, split) / spp).cpu().numpy()

    rays_k, rays_p = int(k[3][0]), int(p[3][0])
    bit_exact = rays_k == rays_p and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(k[:3], p[:3]))
    rep = parity_report(img(k), img(p))
    rep.update(case=label, rays_kernel=rays_k, rays_plain=rays_p,
               bit_exact=bit_exact)
    if reps:
        rep["kernel_ms"], _ = _time_ms(kernel, reps)
        rep["plain_ms"] = plain_ms
    log(f"[kernel-vs-plain] {label}: {json.dumps(rep)}")
    if not bit_exact:
        raise AssertionError(f"{label}: kernel and plain version differ")
    check_parity(img(k), img(p), rays_k, rays_p)
    return rep


def _smoke_scene():
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    # The CLI's default scene and view (thin lens on).
    return (get_scene("book_one_final", seed=42),
            build_camera(build_parser().parse_args([])))


def phase_kernel_vs_plain(device) -> list[dict]:
    scene, cc = _smoke_scene()
    cases = [
        ("160x90@4spp default", {}, 1),
        ("160x90@4spp rr3/clamp0.5/stratified/split2",
         {"rr_start": 3, "clamp": 0.5, "sampler": "stratified"}, 2),
    ]
    return [_check_kernel(label, scene, cc, 160, 90, 4, split, kw, device)
            for label, kw, split in cases]


def phase_golden(device) -> float:
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
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=1000,
                       samples_per_frame=200, max_bounces=50, engine="fused")
    t0 = time.perf_counter()
    res = render(get_scene("book_one_final"),
                 CameraController.book_one_final(), cfg, device=device)
    seconds = time.perf_counter() - t0
    err = rmse(res.image, z["image"])
    log(f"[golden] book_one_final 400x225@1000spp display RMSE {err!r} "
        f"(gate {GOLDEN_GATE}) in {seconds:.2f} s, "
        f"{res.rays_traced:.0f} rays")
    if not err < GOLDEN_GATE:
        raise AssertionError(f"golden RMSE {err} >= {GOLDEN_GATE}")
    return err


def phase_main_path(device, smi: str) -> dict:
    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk

    out_png = os.path.join(OUT_DIR, "smoke_1080p.png")
    argv = ["--device", device.type, "--scene", "book_one_final",
            "--width", str(MAIN_WIDTH), "--height", str(MAIN_HEIGHT),
            "--spp", str(MAIN_SPP), "--spf", str(MAIN_SPP),
            "--max-bounces", "50", "--out", out_png, "--quiet"]
    cli.run(argv)                                  # warm-up
    torch.cuda.synchronize()
    fk.LAUNCHES = 0
    t0 = time.perf_counter()
    _, result = cli.run(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fk.LAUNCHES
    img = result.accumulated / result.samples
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if not np.isfinite(img).all() or not img.mean() > 0.01:
        raise AssertionError(f"bad 1080p image: mean {img.mean()}")
    mrays = result.rays_traced / result.wall_time_s / 1e6
    log(f"[main-path] cli {MAIN_WIDTH}x{MAIN_HEIGHT}@{MAIN_SPP}spp, "
        f"50 bounces: {seconds:.3f} s end to end, render {result.wall_time_s:.3f} s, "
        f"{result.rays_traced:.0f} rays, {mrays:.1f} Mrays/s, "
        f"launches {launches}, image mean {img.mean():.4f} [{smi}]")
    return {"seconds_end_to_end": seconds,
            "render_seconds": result.wall_time_s,
            "rays": result.rays_traced, "mrays_per_s": mrays,
            "launches": launches, "image_mean": float(img.mean())}


def phase_full_size(device, smi: str) -> list[dict]:
    """The checks of phase 3 and the times of kernel and plain version at
    the main path's planes, with 1 and with MAIN_SPP samples per lane."""
    scene, cc = _smoke_scene()
    out = []
    for spp, reps in ((1, 5), (MAIN_SPP, 3)):
        rep = _check_kernel(f"{MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp default",
                            scene, cc, MAIN_WIDTH, MAIN_HEIGHT, spp, 1, {},
                            device, reps=reps)
        log(f"[timing] {MAIN_WIDTH}x{MAIN_HEIGHT}@{spp}spp book_one_final, "
            f"50 bounces: kernel {rep['kernel_ms']!r} ms, plain "
            f"{rep['plain_ms']!r} ms [{smi}]")
        out.append(rep)
    return out


def main() -> int:
    name, smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    os.makedirs(OUT_DIR, exist_ok=True)
    build_s = phase_build()
    parity = phase_kernel_vs_plain(device)
    golden = phase_golden(device)
    main_path = phase_main_path(device, smi)
    full = phase_full_size(device, smi)

    record = {"card": smi, "device": name, "build_seconds": build_s,
              "parity": parity, "golden_rmse": golden,
              "main_path": main_path, "full_size": full}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    kernels = {"kernels": [{
        "name": "fused_render_persistent",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in parity + full),
        "ms": full[-1]["kernel_ms"],
        "plain_ms": full[-1]["plain_ms"],
    }]}
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
