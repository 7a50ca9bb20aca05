"""Rendering sharded over a mesh of devices.

Port of ``wavefront_path_tracer_tpu/parallel/sharding.py``:

* **Pixel data parallelism**: the flat pixel index is cut into one
  contiguous range a tile of the mesh's "tiles" axis; every device traces
  its own tile over a replicated scene (the tables are small and read
  only).  Rays never cross devices, so the only data movement is the
  final copy of each tile's radiance to the first device.
* **Sample parallelism** (``sample_axis``): the sample budget is split
  over the "samples" axis, and the shards' sums are added in shard order
  on the tile's device (the reference's ``psum``).

Each shard draws the same (pixel, frame, sample, bounce) streams that a
one-device render draws, so a mesh with ``sample_axis == 1`` renders the
one-device image bit for bit; with more sample shards the sums are
reordered and agree to float rounding.

A mesh is a grid of ``torch.device`` objects, and one device may appear
more than once: ``make_mesh(8, devices=[cpu] * 8)`` is the counterpart of
the reference's eight virtual XLA devices on the host, and ``[cuda:0] *
4`` shards one card.  Shards on one device run one after another on its
stream; shards on distinct cards are all launched before any is waited
for, so the cards overlap (the megakernel and wavefront engines read a
live count back each bounce, so theirs overlap little).
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.rng import MASK32
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig


class Mesh:
    """A (tiles, samples) grid of devices; ``ranks`` names the process
    that owns each entry (all 0 within one process)."""

    def __init__(self, devices, ranks=None):
        self.devices = [list(row) for row in devices]
        rows = len(self.devices)
        cols = len(self.devices[0]) if rows else 0
        if rows == 0 or any(len(row) != cols for row in self.devices):
            raise ValueError(f"a mesh is a non-empty (tiles, samples) grid, "
                             f"got {devices}")
        self.ranks = ([[0] * cols for _ in range(rows)] if ranks is None
                      else [list(row) for row in ranks])

    @property
    def shape(self) -> dict:
        return {"tiles": len(self.devices), "samples": len(self.devices[0])}

    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in mesh order."""
        seen = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:N``, so that one card is one
    device of the mesh whichever way it is named."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, sample_axis: int = 1,
              devices=None) -> Mesh:
    """A (tiles, samples) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA card).  Raises when more devices are asked for
    than are present; there is no fallback to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh takes the CUDA cards by default, "
                               "and CUDA is not available; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"a mesh of {n_devices} devices was asked for, and "
            f"{len(devices)} {'is' if len(devices) == 1 else 'are'} present "
            f"({', '.join(str(d) for d in devices)})")
    if n_devices < 1 or sample_axis < 1 or n_devices % sample_axis:
        raise AssertionError(f"{n_devices} devices do not divide into "
                             f"sample_axis {sample_axis}")
    tile_axis = n_devices // sample_axis
    return Mesh([devices[t * sample_axis:(t + 1) * sample_axis]
                 for t in range(tile_axis)])


def shard_pixels(config: RenderConfig, n_tiles: int) -> int:
    """Pixels per tile; the image size must divide evenly (pad upstream)."""
    if config.num_pixels % n_tiles:
        raise AssertionError(
            f"{config.num_pixels} pixels not divisible into {n_tiles} tiles; "
            "choose a resolution divisible by the mesh")
    return config.num_pixels // n_tiles


def _arrays_on(scene_arrays: dict, device: torch.device) -> dict:
    """The scene's tensors on ``device`` (the host copies as they are)."""
    if scene_arrays["centers"].device == device:
        return scene_arrays
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in scene_arrays.items()}


def _host(m) -> np.ndarray:
    """A matrix as a host array of its own dtype (the engines convert it
    as they would a one-device render's)."""
    return m.cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)


def _shard_inputs(config: RenderConfig, arrays, cam, view, inv_proj):
    """(view, inv_proj, keyword arguments) of the shards on ``arrays``'
    device, with all that the fused engine would upload there already on
    it: its tables, and its camera (``cam_params``), or under
    ``recluster`` the two matrices as float32 tensors, which the segmented
    path takes as they are."""
    from wavefront_path_tracer_tpu_torch.models import fused

    if config.engine != "fused":
        return view, inv_proj, {}
    device = arrays["centers"].device
    kwargs = fused.scene_tables(config, arrays, view)
    if config.recluster > 0:
        return (torch.as_tensor(view, dtype=torch.float32, device=device),
                torch.as_tensor(inv_proj, dtype=torch.float32,
                                device=device), kwargs)
    kwargs["cam_params"] = torch.from_numpy(
        fused.camera_params(cam, view, inv_proj, config)).to(device)
    return view, inv_proj, kwargs


def _render_shard(pixel_idx, arrays, inputs, cam, config: RenderConfig,
                  frame, sample_base, n_samples: int):
    """One shard: ``n_samples`` samples from ``sample_base`` of the pixels
    ``pixel_idx`` on their device, through the engine's ``render_pixels``
    (the fused engine's segmented one under ``recluster``: each shard
    sorts its own rays), with the device's :func:`_shard_inputs`.  ((N, 3)
    radiance sum, rays traced)."""
    from wavefront_path_tracer_tpu_torch.models import fused, get_engine

    view, inv_proj, kwargs = inputs
    args = (pixel_idx, arrays, cam, view, inv_proj, config, frame,
            sample_base, n_samples)
    if config.engine == "fused" and config.recluster > 0:
        return fused.render_pixels_recluster(*args, **kwargs)
    if config.engine == "fused":
        return fused.render_pixels(
            *args, lane_split=fused._effective_split(config.lane_split,
                                                     n_samples), **kwargs)
    return get_engine(config.engine).render_pixels(*args)


def render_tiles(mesh: Mesh, tiles, pixel_idx: np.ndarray, scene_arrays,
                 cam, view, inv_proj, config: RenderConfig, frame,
                 sample_base, n_samples: int):
    """The tiles ``tiles`` (indices on the mesh's "tiles" axis) of the
    pixel ids ``pixel_idx`` (a host array cut into equal tiles), each
    summed over its sample shards on its first device; (list of (rows, 3)
    radiance tensors, list of rays tensors, one a shard).  Every shard is
    launched before any is waited for."""
    from wavefront_path_tracer_tpu_torch.models import get_engine

    get_engine(config.engine).check_supported(config, scene_arrays)
    n_tiles, n_shards = mesh.shape["tiles"], mesh.shape["samples"]
    if n_samples % n_shards:
        raise AssertionError(f"{n_samples} samples not divisible over "
                             f"{n_shards} shards")
    per_shard = n_samples // n_shards
    per_tile = shard_pixels(config, n_tiles)
    view, inv_proj = _host(view), _host(inv_proj)
    devices = {d for t in tiles for d in mesh.devices[t]}
    arrays = {d: _arrays_on(scene_arrays, d) for d in devices}
    # Every upload before the first launch: a copy from pageable host
    # memory waits for its device's stream, so one made between two
    # fused shards on one card would wait for the first shard's kernel.
    # (The megakernel and wavefront engines read a count back each
    # bounce, and so wait all the same.)
    inputs = {d: _shard_inputs(config, arrays[d], cam, view, inv_proj)
              for d in devices}
    idx = {(t, d): torch.from_numpy(
        pixel_idx[t * per_tile:(t + 1) * per_tile].astype(np.int64)).to(d)
        for t in tiles for d in mesh.devices[t]}
    parts, rays = [], []
    for t in tiles:
        row = []
        for s, d in enumerate(mesh.devices[t]):
            base = (int(sample_base) + s * per_shard) & MASK32
            rad, r = _render_shard(idx[t, d], arrays[d], inputs[d], cam,
                                   config, frame, base, per_shard)
            row.append(rad)
            rays.append(r)
        parts.append(row)
    radiance = []
    for row in parts:
        acc = row[0]
        for rad in row[1:]:
            acc = acc + rad.to(acc.device)
        radiance.append(acc)
    return radiance, rays


def render_samples_sharded(mesh: Mesh, scene_arrays, cam, view, inv_proj,
                           config: RenderConfig, frame, sample_base,
                           n_samples: int):
    """Sharded counterpart of an engine's ``render_samples``: pixels shard
    over "tiles", samples over "samples".

    Returns ((P, 3) float32 radiance sum on the mesh's first device, rays
    traced as a 0-d int64 tensor there), the two values every engine's
    ``render_samples`` returns.  The reference returns the radiance alone
    (its ``sharding.py:225-228``), while its own bench unpacks two values
    from it (its ``bench.py:186-189``), so its ``--mesh`` cannot run; here
    the bench's reading holds.

    Under the fused engine's ``block_tiles`` each tile takes a contiguous
    slice of the block permutation (block-coherent lanes), and the image
    is put back in natural pixel order once all tiles are done.
    ``scene_arrays`` may lie on any device; each distinct device of the
    mesh gets its own copy, and its own bake or tables from the engine's
    caches.
    """
    from wavefront_path_tracer_tpu_torch.models import fused

    inv = None
    if config.engine == "fused" and config.block_tiles:
        pixel_idx, inv = fused._block_perm(config.width, config.height,
                                           config.block_tiles)
    else:
        pixel_idx = np.arange(config.num_pixels, dtype=np.int64)
    n_tiles = mesh.shape["tiles"]
    radiance, rays = render_tiles(mesh, range(n_tiles), pixel_idx,
                                  scene_arrays, cam, view, inv_proj, config,
                                  frame, sample_base, n_samples)
    first = mesh.devices[0][0]
    rad = torch.cat([r.to(first) for r in radiance])
    if inv is not None:
        rad = rad.index_select(0, torch.from_numpy(
            inv.astype(np.int64)).to(first))
    total = torch.stack([torch.as_tensor(r, dtype=torch.int64).to(first)
                         for r in rays]).sum()
    return rad, total


def render_sharded(scene, camera, config: RenderConfig, mesh: Mesh | None = None,
                   sample_axis: int = 1):
    """One-shot sharded render of ``config.samples_per_pixel`` samples over
    ``mesh`` (default: ``make_mesh(config.num_devices, sample_axis)`` on
    the CUDA cards); (the (H, W, 3) radiance sum as a numpy array, spp)."""
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    if mesh is None:
        mesh = make_mesh(config.num_devices, sample_axis)
    scene_arrays = prepare_scene(scene, config, mesh.devices[0][0])
    rad, _rays = render_samples_sharded(
        mesh, scene_arrays, camera.gpu_camera(), camera.view_matrix(),
        camera.inverse_projection(config.width, config.height), config,
        config.frame, 0, config.samples_per_pixel)
    spp = config.samples_per_pixel
    return rad.cpu().numpy().reshape(config.height, config.width, 3), spp
