"""Multi-process rendering on ``torch.distributed``.

Port of ``wavefront_path_tracer_tpu/parallel/multihost.py``: the tile and
sample mesh of ``parallel/sharding.py`` extended across processes.

* :func:`initialize` joins the process group, with the backend named:
  NCCL on CUDA by default, gloo when asked for and on the CPU.  NCCL
  gives each rank a card of its own, so more ranks on a host than it has
  cards raise; there is no silent switch of backend.
* :func:`make_global_mesh` builds the ("tiles", "samples") mesh over
  every process's devices, process-major, so that each process owns a
  contiguous band of tiles and the sum over samples never leaves a
  process.
* :func:`render_sharded_global` renders this process's band and returns
  its rows with their pixel ids.  Any gather is the caller's (gloo has no
  CUDA ``all_gather``: a caller on gloo copies to the host first).

``python -m wavefront_path_tracer_tpu_torch.parallel.dryrun --worker``
runs two such processes against one-device renders.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from wavefront_path_tracer_tpu_torch.parallel.sharding import (
    Mesh,
    render_tiles,
    shard_pixels,
)


def _env_int(name: str, value):
    """``value``, else the environment's ``name`` as an int, else None."""
    if value is not None:
        return int(value)
    return int(os.environ[name]) if name in os.environ else None


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> str:
    """Join the process group (idempotent per process); the backend.

    ``backend`` defaults to ``"nccl"`` where CUDA is available and to
    ``"gloo"`` elsewhere.  NCCL raises, naming the cause, when it is not
    in this build, when there is no card, or when more ranks share this
    host (``LOCAL_WORLD_SIZE``, else the world) than it has cards.  Under
    NCCL each rank takes the card ``LOCAL_RANK`` (else its rank)."""
    if dist.is_initialized():
        return dist.get_backend()
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl":
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError(
                "backend 'nccl' needs CUDA and a torch built with NCCL; this "
                f"process has CUDA {torch.cuda.is_available()}, NCCL "
                f"{dist.is_nccl_available()} (use backend='gloo')")
        cards = torch.cuda.device_count()
        local = _env_int("LOCAL_WORLD_SIZE", None) or world_size or 1
        if local > cards:
            raise RuntimeError(
                f"backend 'nccl' cannot run {local} ranks on {cards} "
                f"card{'s' if cards != 1 else ''}: NCCL refuses two ranks on "
                "one card (use backend='gloo', or one rank a card)")
        local_rank = _env_int("LOCAL_RANK", None)
        torch.cuda.set_device(rank or 0 if local_rank is None else local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return backend


def rank_device() -> torch.device:
    """This rank's device, taken from the hardware whatever the backend
    (the backend only carries the exchange between ranks): under NCCL the
    card that :func:`initialize` set; else, where CUDA is present, the
    card ``LOCAL_RANK`` (else the rank) modulo the card count; the CPU only
    where there is no CUDA."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if torch.cuda.is_available():
        local = _env_int("LOCAL_RANK", None)
        rank = dist.get_rank() if local is None else local
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_global_mesh(sample_axis: int = 1, devices=None) -> Mesh:
    """A ("tiles", "samples") mesh over every process's ``devices``
    (default: its one device, :func:`rank_device`; a list may repeat a
    device), process-major: each process owns a
    contiguous band of tiles.  ``sample_axis`` must divide each process's
    device count, so that the sum over samples stays inside a process."""
    devices = [torch.device(d) for d in (devices or [rank_device()])]
    local = len(devices)
    if local % sample_axis:
        raise AssertionError(
            f"sample_axis {sample_axis} must divide the per-process device "
            f"count {local} so that sample sums never cross processes")
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    if len(set(counts)) != 1:
        raise ValueError(f"every process must bring as many devices; they "
                         f"bring {counts}")
    me = dist.get_rank()
    rows, ranks = [], []
    for r in range(len(counts)):
        # Other processes' entries are placeholders: only their owner
        # renders them.
        mine = devices if r == me else [torch.device("meta")] * local
        for t in range(local // sample_axis):
            rows.append(mine[t * sample_axis:(t + 1) * sample_axis])
            ranks.append([r] * sample_axis)
    return Mesh(rows, ranks)


def render_sharded_global(scene, camera, config, mesh: Mesh | None = None,
                          sample_axis: int = 1):
    """This process's share of a sharded render of
    ``config.samples_per_pixel`` samples.

    Returns (local_radiance (rows, 3) float32, local_pixel_ids (rows,)),
    numpy arrays in linear pixel order: the tiles that this process owns
    and their global pixel ids.  The pixel index is linear (no block
    permutation, whose unscatter would cross processes), as in the
    reference.  A caller that wants the whole image gathers them."""
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    if mesh is None:
        mesh = make_global_mesh(sample_axis)
    n_tiles = mesh.shape["tiles"]
    per_tile = shard_pixels(config, n_tiles)
    me = dist.get_rank()
    tiles = [t for t in range(n_tiles) if mesh.ranks[t][0] == me]
    scene_arrays = prepare_scene(scene, config, mesh.devices[tiles[0]][0])
    pixel_idx = np.arange(config.num_pixels, dtype=np.int64)
    radiance, _rays = render_tiles(
        mesh, tiles, pixel_idx, scene_arrays, camera.gpu_camera(),
        camera.view_matrix(),
        camera.inverse_projection(config.width, config.height), config,
        config.frame, 0, config.samples_per_pixel)
    # A rank's tiles are one contiguous band: the ids are ascending.
    ids = np.concatenate([pixel_idx[t * per_tile:(t + 1) * per_tile]
                          for t in tiles])
    return np.concatenate([r.cpu().numpy() for r in radiance]), ids
