"""wavefront_path_tracer_tpu_torch — the path tracer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``wavefront_path_tracer_tpu`` (JAX/Pallas), which stays beside
it as the reference.  This package imports ``torch`` and never ``jax``.
Host modules that use only numpy and the standard library (scenes,
cameras, ``RenderConfig``, PNG/RMSE helpers) are re-exported from the
reference package, so the two cannot drift.

What runs today: the fused engine with the brute-force intersector
(``models/fused.py``), whose whole render is one CUDA kernel
(``csrc/persistent.cu``) on the card and its plain PyTorch version
(``ops/fused_kernels.py``) on the CPU.
"""

__version__ = "0.1.0"

from wavefront_path_tracer_tpu_torch.utils.config import (  # noqa: F401
    RenderConfig,
)
