"""The multi-device dry run, and the two-process worker.

    python -m wavefront_path_tracer_tpu_torch.parallel.dryrun [--device cpu|cuda]
    python -m wavefront_path_tracer_tpu_torch.parallel.dryrun --worker RANK INIT_METHOD [--world-size N] [--backend gloo|nccl] [--device cpu|cuda]

:func:`dryrun_multichip` is the port's counterpart of the reference's
``__graft_entry__.dryrun_multichip``: its four passes at its shapes (the
fused brute-force kernel; baked/cull8/block8 on 96 procedural spheres;
recluster 2 over dynamic cull8; wavefront/BVH), and a fifth on the
terrain mesh through dynamic culled/16.  Each pass checks the shape and
finiteness, as the reference does, and equality with the one-device
render on the mesh's first device: bit for bit where the mesh has one
sample shard, within rtol 1e-5, atol 1e-6 otherwise.  Without
``--worker`` the command line runs it over every CUDA card, or over 8
copies of the CPU (the reference's virtual devices) under ``--device
cpu``.

``--worker`` is the counterpart of the reference's
``tests/multihost_dryrun.py``: one rank of a ``torch.distributed`` world
(``multihost.initialize``) that renders its band of a mesh of four
devices a rank (book_cover, 64x32, 2 spp, 6 bounces; the megakernel, then
fused/baked/cull16), holds it bit for bit to a one-device render in this
process, gathers every band and holds the whole image to it; renders its
band once more over the default mesh (``multihost.rank_device``), held
bit for bit too; and prints ``process RANK: OK``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.parallel import multihost
from wavefront_path_tracer_tpu_torch.parallel.sharding import (
    make_mesh,
    render_samples_sharded,
)

RTOL, ATOL = 1e-5, 1e-6
WORKER_DEVICES = 4   # devices a rank, as the reference's virtual devices


def _setup(width: int, height: int, spp: int, engine: str, intersector: str,
           device, clusters: int = 0, block_tiles: int = 0, scene=None,
           triangles=None):
    """(config, camera, scene arrays on ``device``) of a pass, as the
    reference's ``__graft_entry__._setup`` builds them (book_one_final,
    its camera, 8 bounces)."""
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        book_one_final,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(
        width=width, height=height, samples_per_pixel=spp,
        samples_per_frame=spp, max_bounces=8, engine=engine,
        intersector=intersector, baked_clusters=clusters,
        block_tiles=block_tiles)
    if scene is None:
        scene = book_one_final(seed=42)
    cc = CameraController.book_one_final()
    return cfg, cc, prepare_scene(scene, cfg, device, triangles)


def check_pass(label: str, mesh, cfg, cc, arrays) -> dict:
    """One pass: the sharded render, checked for shape and finiteness and
    against the one-device render on the mesh's first device."""
    from wavefront_path_tracer_tpu_torch.models import get_engine

    args = (cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0,
            cfg.samples_per_pixel)
    t0 = time.perf_counter()
    rad, rays = render_samples_sharded(mesh, arrays, *args)
    rad = rad.cpu().numpy()
    seconds = time.perf_counter() - t0
    if rad.shape != (cfg.num_pixels, 3) or not np.isfinite(rad).all():
        raise AssertionError(f"dryrun {label}: radiance of shape {rad.shape}"
                             f", finite {np.isfinite(rad).all()}")
    t0 = time.perf_counter()
    one, one_rays = get_engine(cfg.engine).render_samples(arrays, *args)
    one = one.cpu().numpy()
    one_seconds = time.perf_counter() - t0
    bits = mesh.shape["samples"] == 1
    if bits and not np.array_equal(rad, one):
        raise AssertionError(f"dryrun {label}: not bit for bit with the "
                             "one-device render")
    if not bits:
        np.testing.assert_allclose(rad, one, rtol=RTOL, atol=ATOL,
                                   err_msg=f"dryrun {label}")
    if int(rays) != int(one_rays):
        raise AssertionError(f"dryrun {label}: {int(rays)} rays against "
                             f"{int(one_rays)} on one device")
    out = {"pass": label, "mesh": mesh.shape, "pixels": cfg.num_pixels,
           "spp": cfg.samples_per_pixel, "mean": float(rad.mean()),
           "rays": int(rays), "bit_for_bit": bits,
           "max_abs_err": float(np.abs(rad - one).max()),
           "seconds": seconds, "one_device_seconds": one_seconds}
    print(f"dryrun_multichip ok ({label}): mesh={mesh.shape} "
          f"pixels={cfg.num_pixels} spp={cfg.samples_per_pixel} "
          f"mean={out['mean']:.4f} max_abs_err={out['max_abs_err']:.3g}",
          flush=True)
    return out


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """The five passes over an ``n_devices`` mesh of ``devices`` (default
    the CUDA cards); a list of each pass's readings.  Raises on the first
    pass that fails."""
    from wavefront_path_tracer_tpu_torch.scene import mesh_terrain_scene
    from wavefront_path_tracer_tpu_torch.scene.scene import (
        procedural_spheres,
    )

    sample_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    tile_axis = n_devices // sample_axis
    mesh = make_mesh(n_devices, sample_axis=sample_axis, devices=devices)
    first = mesh.devices[0][0]
    # Tiny shapes: pixels divisible by the tile axis.
    width = max(16, 8 * tile_axis)
    spp = 2 * sample_axis
    out = [check_pass("fused/bruteforce", mesh, *_setup(
        width, 8, spp, "fused", "bruteforce", first))]
    # The production headline's path: the baked culled kernel with
    # block-tile lanes, whose unscatter exists only under a mesh.
    cfg2, cc2, arrays2 = _setup(
        width, 8, spp, "fused", "baked", first, clusters=8, block_tiles=8,
        scene=procedural_spheres(n=96, seed=7, extent=12.0))
    out.append(check_pass("baked/cull8/block8", mesh, cfg2, cc2, arrays2))
    # The segmented path: each shard sorts its own rays.
    cfg3 = cfg2.replace(intersector="bruteforce", baked_clusters=8,
                        recluster=2)
    out.append(check_pass("recluster=2/cull8", mesh, cfg3, cc2, arrays2))
    out.append(check_pass("wavefront/bvh", mesh, *_setup(
        width, 8, spp, "wavefront", "bvh", first)))
    scene, triangles = mesh_terrain_scene()
    out.append(check_pass("terrain dynamic/cull16", mesh, *_setup(
        width, 8, spp, "fused", "bruteforce", first, clusters=16,
        scene=scene, triangles=triangles)))
    return out


def _worker_camera():
    from wavefront_path_tracer_tpu_torch.scene import CameraController

    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.defocus_angle_deg = 0.0
    return cc


def worker(rank: int, init_method: str, world_size: int = 2,
           backend: str | None = None, device: str = "cuda") -> int:
    """One rank of the multi-process check (see the module docstring)."""
    import torch.distributed as dist

    from wavefront_path_tracer_tpu_torch.renderer import render, resolve_device
    from wavefront_path_tracer_tpu_torch.scene import book_cover
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    device = resolve_device(device)
    backend = multihost.initialize(init_method, world_size, rank, backend)
    if device.type == "cuda":
        device = multihost.rank_device()
    try:
        mesh = multihost.make_global_mesh(devices=[device] * WORKER_DEVICES)
        scene, cc = book_cover(), _worker_camera()
        base = RenderConfig(width=64, height=32, samples_per_pixel=2,
                            samples_per_frame=2, max_bounces=6)
        for cfg in (base.replace(engine="megakernel"),
                    base.replace(engine="fused", intersector="baked",
                                 baked_clusters=16)):
            label = f"{cfg.engine}/{cfg.intersector}"
            rad, ids = multihost.render_sharded_global(scene, cc, cfg, mesh)
            rows = cfg.num_pixels // world_size
            if rad.shape != (rows, 3) or not np.isfinite(rad).all():
                raise AssertionError(f"{label}: band of shape {rad.shape}")
            expect = np.arange(rank * rows, (rank + 1) * rows)
            if not np.array_equal(ids, expect):
                raise AssertionError(f"{label}: ids {ids[:4]}..., want a "
                                     f"band from {expect[0]}")
            one = render(scene, cc, cfg, device=device).accumulated
            one = one.reshape(-1, 3)
            if not np.array_equal(rad, one[ids]):
                raise AssertionError(f"{label}: band not bit for bit with "
                                     "the one-device render")
            # The caller's gather: gloo gathers host tensors, NCCL cards'.
            band = torch.from_numpy(rad)
            if backend == "nccl":
                band = band.to(device)
            bands = [torch.empty_like(band) for _ in range(world_size)]
            dist.all_gather(bands, band)
            image = torch.cat(bands).cpu().numpy()
            if not np.array_equal(image, one):
                raise AssertionError(f"{label}: gathered image not bit for "
                                     "bit with the one-device render")
            print(f"process {rank}: {label} band of {rows} pixels bit for "
                  f"bit, gathered image bit for bit ({backend}, {device})",
                  flush=True)
        # The default mesh: this rank's device from the hardware, whatever
        # the backend.
        default = multihost.rank_device()
        rad, ids = multihost.render_sharded_global(scene, cc, cfg)
        if default != device:
            one = render(scene, cc, cfg, device=default).accumulated
        if not np.array_equal(rad, one.reshape(-1, 3)[ids]):
            raise AssertionError(f"{label}: default mesh's band not bit for "
                                 "bit with the one-device render")
        print(f"process {rank}: default mesh on {default}, {label} band bit "
              "for bit", flush=True)
        print(f"process {rank}: OK ({rows} pixels, mean {rad.mean():.4f})",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wavefront_path_tracer_tpu_torch.parallel.dryrun",
        description="the multi-device dry run, or one rank of the "
                    "multi-process check")
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "INIT_METHOD"),
                    help="run one rank (INIT_METHOD: file://... or "
                         "tcp://localhost:PORT)")
    ap.add_argument("--world-size", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl with CUDA, else gloo")
    ap.add_argument("--device", default="cuda",
                    help="cpu or cuda (default; no fallback to the CPU)")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(int(args.worker[0]), args.worker[1], args.world_size,
                      args.backend, args.device)
    if torch.device(args.device).type == "cpu":
        dryrun_multichip(8, devices=[torch.device("cpu")] * 8)
    else:
        dryrun_multichip(torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    sys.exit(main())
