"""Scenes and cameras: the port's own numpy-only host modules.

``scene.py`` and ``camera.py`` are copies of the reference package's
modules of the same names (only the imports may differ);
``tests/test_torch_host.py`` holds them to byte-identical tables and
equal camera matrices.
"""

from wavefront_path_tracer_tpu_torch.scene.camera import (  # noqa: F401
    CameraController,
)
from wavefront_path_tracer_tpu_torch.scene.scene import (  # noqa: F401
    SCENE_CAMERAS,
    Scene,
    book_cover,
    book_one_final,
    get_scene,
)
