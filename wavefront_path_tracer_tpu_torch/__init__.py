"""wavefront_path_tracer_tpu_torch — the path tracer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``wavefront_path_tracer_tpu`` (JAX/Pallas), which stays beside
it as the reference.  This package imports ``torch`` and never ``jax``,
and nothing of the reference package: the numpy-only host modules
(scenes, cameras, ``RenderConfig``, PNG/RMSE helpers) are its own copies,
held equal to the reference's by ``tests/test_torch_host.py``.

What runs today: the fused engine (``models/fused.py``), whose whole
render is one CUDA kernel on the card and its plain PyTorch version on
the CPU, with the brute-force intersector (``csrc/persistent.cu``,
``ops/fused_kernels.py``) and the baked intersects, unculled and culled
(``csrc/baked.cu``, ``ops/bake.py``, ``ops/baked_kernels.py``).
"""

__version__ = "0.1.0"

from wavefront_path_tracer_tpu_torch.utils.config import (  # noqa: F401
    RenderConfig,
)
