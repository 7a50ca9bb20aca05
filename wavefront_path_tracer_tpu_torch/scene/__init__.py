"""Scenes and cameras, re-exported from the reference package.

Scene construction and the camera model are numpy-only host code, so the
port shares them instead of copying them: both packages build the same
tables and camera matrices from the same arguments.
"""

from wavefront_path_tracer_tpu.scene.camera import (  # noqa: F401
    CameraController,
)
from wavefront_path_tracer_tpu.scene.scene import (  # noqa: F401
    SCENE_CAMERAS,
    Scene,
    book_cover,
    book_one_final,
    get_scene,
)
