"""The shared runner of the hierarchy sweeps (:mod:`.super_gate`,
:mod:`.sweep10k`, :mod:`.dynsweep`, :mod:`.dynnocull`, :mod:`.cullstats`,
:mod:`.meshscale`, :mod:`.knotbench`, :mod:`.rr_floor_sweep`).

Each sweep renders one frame a configuration through the fused engine's
``render_pixels``, over a bake (``ops/bake.py`` ``bake_culled``) or a
dynamic table (``ops/dyn_tables.py``) of its own, built with the
configuration's hierarchy parameters, as the ``exp/`` scripts hand their
own bakes to the reference's ``render_pixels``.  The bakes and tables
come from the render path's caches (``models/fused.py`` ``_baked_scene``
and ``_dyn_tables``, whose keys carry the parameters) with its camera
hint, so that a sweep's default configuration is the render path's own
bake.  Times are wall seconds between
``torch.cuda.synchronize()`` calls of one render of the whole frame: the
configurations of a sweep in turns, the least of ``reps`` turns after one
warm run each (kernels move by up to 6% between calls).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.bake import GLOBAL_RADIUS_FACTOR
from wavefront_path_tracer_tpu_torch.probes import _slope

BLOCK_TILES = 32           # the exp scripts' block order


def add_device_args(ap: argparse.ArgumentParser, reps: int = 3) -> None:
    ap.add_argument("--reps", type=int, default=reps,
                    help="timed turns of each configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")


def card(device: torch.device) -> str:
    """nvidia-smi's name, power limit and SM clock on the card; on the
    CPU a note that the times are the plain versions'."""
    if device.type == "cuda":
        return _slope.card()
    return "cpu: the plain versions' times, not the card's"


def parse_pairs(spec: str) -> list[tuple[int, int]]:
    """``"16x8,32x8"`` as [(16, 8), (32, 8)]."""
    out = []
    for item in spec.split(","):
        a, b = item.split("x")
        out.append((int(a), int(b)))
    return out


@dataclasses.dataclass
class Frame:
    """One frame's render inputs: the scene on its device, the config,
    the pixels in block order and the camera."""

    arrays: dict
    config: object
    cc: object
    pix: torch.Tensor
    cam_params: torch.Tensor
    eye: np.ndarray

    @property
    def device(self) -> torch.device:
        return self.arrays["centers"].device

    @property
    def host(self) -> dict:
        return self.arrays["host_scene"]


def timed(fn, device):
    """(``fn()``, its wall seconds between synchronisations of
    ``device``)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def frame(scene, cc, device, *, width: int, height: int, spp: int,
          triangles=None, **config) -> Frame:
    """A :class:`Frame` of ``scene`` (with its mesh ``triangles``) seen
    by ``cc`` at width x height, ``spp`` samples in one frame, 50 bounces
    and block order unless ``config`` says otherwise."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    config = {"max_bounces": 50, "engine": "fused",
              "block_tiles": BLOCK_TILES, **config}
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       samples_per_frame=spp, **config)
    arrays = prepare_scene(scene, cfg, device, triangles)
    perm, _ = fused._block_perm(width, height, cfg.block_tiles)
    pix = torch.from_numpy(perm.astype(np.int64)).to(device)
    cam_params = torch.from_numpy(fused.camera_params(
        cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(width, height), cfg)).to(device)
    return Frame(arrays, cfg, cc, pix, cam_params,
                 fused._concrete_eye(cc.view_matrix()))


def bake(fr: Frame, cluster_size: int, **params):
    """(the culled bake of the frame's scene on its device with the
    hierarchy ``params`` of ``bake_culled``, seconds it took: 0 where the
    cache held it)."""
    from wavefront_path_tracer_tpu_torch.models import fused

    return timed(lambda: fused._baked_scene(
        fr.arrays, cluster_size, camera_pos=fr.eye, **params), fr.device)


def dynamic(fr: Frame, cluster_size: int,
            global_radius_factor: float = GLOBAL_RADIUS_FACTOR):
    """(the dynamic culled tables of the frame's scene on its device,
    seconds they took: 0 where the cache held them)."""
    from wavefront_path_tracer_tpu_torch.models import fused

    return timed(lambda: fused._dyn_tables(
        fr.arrays, cluster_size, camera_pos=fr.eye,
        global_radius_factor=global_radius_factor), fr.device)


def describe(tables) -> dict:
    """The hierarchy of a bake or a dynamic table: globals (without a
    dynamic table's NaN padding rows), clusters (a rolled dynamic
    sweep's padding to a super multiple included, as the reference
    counts them), supers (built; a bake's are swept only when
    two-level)."""
    if hasattr(tables, "super_ranges"):
        return {"globals": tables.n_globals, "clusters": tables.n_clusters,
                "supers": tables.n_supers,
                "two_level": bool(tables.super_ranges.shape[0]
                                  or tables.tri_super_ranges.shape[0])}
    real = ~torch.isnan(tables.spheres[:tables.n_globals, 0])
    return {"globals": int(real.sum()), "clusters": tables.n_clusters
            + tables.n_tri_clusters, "supers": tables.n_supers
            + tables.n_tri_supers,
            "two_level": bool(tables.n_supers or tables.n_tri_supers)}


def launches(tables) -> int:
    """The launch counter of the kernel that renders over ``tables``
    (``LAUNCHES`` of ``ops/baked_kernels.py`` or
    ``ops/dynculled_kernels.py``; the plain versions count nothing)."""
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk

    if hasattr(tables, "super_ranges"):
        return bk.LAUNCHES["culled" if tables.culled else "unculled"]
    return dk.LAUNCHES


def render(fr: Frame, tables, frame_salt: int = 0):
    """One render of the frame over ``tables`` (a bake or a dynamic
    table): ((P, 3) radiance sum in block order, rays, [iterations,
    supers, clusters])."""
    from wavefront_path_tracer_tpu_torch.models import fused

    key = "baked" if hasattr(tables, "super_ranges") else "dyn"
    radiance, rays, stats = fused.render_pixels(
        fr.pix, fr.arrays, fr.cc.gpu_camera(), None, None, fr.config,
        frame_salt, 0, fr.config.samples_per_pixel, with_stats=True,
        cam_params=fr.cam_params, **{key: tables})
    return radiance, int(rays), [int(v) for v in stats.values()]


def time_turns(fr: Frame, configs: list, reps: int) -> list[dict]:
    """Each of ``configs`` (tables) rendered once warm, then ``reps``
    turns in which each renders once at the next frame salt; per
    configuration {first_seconds, rays, iterations, supers_entered,
    clusters_entered and checksum (the radiance sum) of the warm render; seconds, the least of
    the turns; timed_rays, the turns' rays; mrays_per_s; launches, the
    kernel's over all of them}."""
    out = []
    for tables in configs:
        before = launches(tables)
        (radiance, rays, stats), seconds = timed(lambda: render(fr, tables),
                                                 fr.device)
        out.append({"first_seconds": seconds,
                    "seconds": float("inf"), "rays": rays,
                    "iterations": stats[0], "supers_entered": stats[1],
                    "clusters_entered": stats[2],
                    "checksum": float(radiance.double().sum()),
                    "launches": launches(tables) - before})
    for _ in range(reps):
        for rec, tables in zip(out, configs):
            before = launches(tables)
            (_, rays, _), seconds = timed(lambda: render(fr, tables, 1),
                                          fr.device)
            rec["seconds"] = min(rec["seconds"], seconds)
            rec["timed_rays"] = rays
            rec["launches"] += launches(tables) - before
    for rec in out:
        rec["mrays_per_s"] = rec["timed_rays"] / rec["seconds"] / 1e6
    return out


def build_seconds(device: torch.device) -> float:
    """Seconds to build (or find) the kernels' library on the card; 0 on
    the CPU, whose plain versions need none."""
    if device.type != "cuda":
        return 0.0
    from wavefront_path_tracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    return time.perf_counter() - t0


def emit(rec: dict) -> None:
    """A sweep's record as one JSON line."""
    print(json.dumps(rec), flush=True)


def line(label: str, rec: dict, card_line: str) -> str:
    """A configuration's line: Mrays/s, seconds, the hierarchy
    (:func:`describe`'s keys in ``rec``), supers and clusters entered a
    ray, and the card."""
    rays = max(rec["rays"], 1)
    sweep = "two-level" if rec["two_level"] else "flat"
    return (f"{label}: {rec['mrays_per_s']:.1f} Mrays/s "
            f"({rec['seconds']:.4f} s; {rec['globals']} globals, "
            f"{rec['clusters']} clusters, {rec['supers']} supers, {sweep}; "
            f"{rec['supers_entered'] / rays:.4f} supers and "
            f"{rec['clusters_entered'] / rays:.4f} clusters entered a ray) "
            f"[{card_line}]")
