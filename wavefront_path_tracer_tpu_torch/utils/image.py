"""PNG output, display transform and RMSE, re-exported from the
reference package (numpy and zlib only)."""

from wavefront_path_tracer_tpu.utils.image import (  # noqa: F401
    display_transform,
    rmse,
    write_png,
)
