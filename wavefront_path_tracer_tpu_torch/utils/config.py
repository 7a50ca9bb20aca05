"""Render configuration, re-exported from the reference package.

Sharing the dataclass keeps defaults and refusals (``__post_init__``)
identical between the two packages.
"""

from wavefront_path_tracer_tpu.utils.config import (  # noqa: F401
    RenderConfig,
    RenderProgress,
)
