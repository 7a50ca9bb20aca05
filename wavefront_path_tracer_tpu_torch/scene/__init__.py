"""Scenes and cameras: the port's own numpy-only host modules.

``scene.py``, ``camera.py``, ``mesh.py`` and ``file.py`` are copies of
the reference package's modules of the same names (only the imports may
differ); ``tests/test_torch_host.py``, ``tests/test_torch_mesh.py`` and
``tests/test_torch_textures.py`` hold them to byte-identical tables and
equal camera matrices.  ``bvh.py`` is the copy of the reference's
binned-SAH builder; ``tests/test_torch_bvh.py`` holds its tables and
permutation byte-identical.
"""

from wavefront_path_tracer_tpu_torch.scene.bvh import (  # noqa: F401
    MAX_LEAF_SIZE,
    FlatBVH,
    build_bvh,
    build_flat_bvh,
    build_flat_bvh_aabb,
    bvh_depth,
)
from wavefront_path_tracer_tpu_torch.scene.camera import (  # noqa: F401
    CameraController,
)
from wavefront_path_tracer_tpu_torch.scene.file import (  # noqa: F401
    apply_camera_dict,
    load_scene_file,
)
from wavefront_path_tracer_tpu_torch.scene.mesh import (  # noqa: F401
    MeshSceneBuilder,
    TriangleSoA,
    knot_camera,
    knot_scene,
    load_obj,
    mesh_demo_scene,
    mesh_terrain_scene,
    torus_knot,
)
from wavefront_path_tracer_tpu_torch.scene.scene import (  # noqa: F401
    SCENE_CAMERAS,
    Scene,
    book_cover,
    book_one_final,
    get_scene,
)
