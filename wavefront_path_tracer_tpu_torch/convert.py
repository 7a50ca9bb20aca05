"""Carry scene state from the reference package to the port.

The path tracer has no weights: its parameters are the scene tables.
:func:`scene_arrays_to_torch` takes the dict that the reference's
``renderer.prepare_scene`` returns (JAX or numpy arrays; anything
``np.asarray`` accepts; sphere tables and, for a mesh, the ``tri_*``
tables, for a textured scene the ``tex_*`` tables, and with
``intersector="bvh"`` the flat trees ``bvh_*`` and ``tri_bvh_*`` with the
tables in BVH order) and returns the same keys as torch tensors on a
given device, with dtypes unchanged, plus what the fused engine derives
from them once per scene: the packed (S, 16) table the brute-force kernel
sweeps (``scene_packed``), and the host copy of the sphere, triangle and
texture tables with one fingerprint of all of them, which the bake and
dynamic-table caches read (``host_scene``, see ``ops/bake.py:host_scene``).
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.bake import host_scene
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import pack_scene


def scene_arrays_to_torch(scene_arrays: dict, device) -> dict:
    """{key: array} -> {key: tensor on ``device``}, values copied, plus
    ``scene_packed`` and ``host_scene``."""
    device = torch.device(device)
    host = {key: np.array(value, copy=True)
            for key, value in scene_arrays.items()}
    out = {key: torch.from_numpy(value).to(device)
           for key, value in host.items()}
    out["scene_packed"] = pack_scene(host, device=device)
    out["host_scene"] = host_scene(host)
    return out
