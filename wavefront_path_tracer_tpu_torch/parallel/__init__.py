"""Multi-device parallelism: device meshes and sharded rendering."""

from wavefront_path_tracer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_samples_sharded,
    shard_pixels,
)
