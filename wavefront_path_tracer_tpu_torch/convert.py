"""Carry scene state from the reference package to the port.

The path tracer has no weights: its parameters are the scene tables.
:func:`scene_arrays_to_torch` takes the dict that the reference's
``renderer.prepare_scene`` returns (JAX or numpy arrays; anything
``np.asarray`` accepts) and returns the same keys as torch tensors on a
given device, with dtypes unchanged, plus the packed (S, 16) table the
fused kernel sweeps (``scene_packed``), built once here.
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.fused_kernels import pack_scene


def scene_arrays_to_torch(scene_arrays: dict, device) -> dict:
    """{key: array} -> {key: tensor on ``device``}, values copied, plus
    ``scene_packed``."""
    device = torch.device(device)
    host = {key: np.array(value, copy=True)
            for key, value in scene_arrays.items()}
    out = {key: torch.from_numpy(value).to(device)
           for key, value in host.items()}
    out["scene_packed"] = pack_scene(host, device=device)
    return out
