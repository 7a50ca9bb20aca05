"""Pinhole / thin-lens camera model.

Re-expresses the reference's camera stack
(``wavefront_common/src/camera.rs``, ``camera_controller.rs``,
``projection_matrix.rs``) as plain math on the host, producing the
uniform data the ray generator consumes: camera position, a
world-from-camera matrix, an inverse projection, and thin-lens defocus
parameters.

Matrix-layout note: the reference stores ``[[f32;4];4]`` row-arrays that
WGSL reinterprets as *columns* (reference camera.rs:52-57,
projection_matrix.rs:30-35 — SURVEY.md quirk 7).  We build the actual
mathematical matrices, so ``view @ v`` here equals WGSL
``view_matrix.view * v``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_SAFE_PI = math.pi - 0.001  # pitch clamp (camera_controller.rs:29)


@dataclasses.dataclass
class Camera:
    """Position + pitch/yaw orientation (reference camera.rs:3-30).

    pitch is the polar angle from +y (``acos(forward.y)``), yaw is
    ``atan2(forward.x, forward.z)``.
    """

    position: np.ndarray
    pitch: float
    yaw: float

    @classmethod
    def look_at(cls, look_from, look_to) -> "Camera":
        position = np.asarray(look_from, np.float32)
        fwd = np.asarray(look_to, np.float32) - position
        fwd = fwd / np.linalg.norm(fwd)
        return cls(position=position, pitch=math.acos(fwd[1]), yaw=math.atan2(fwd[0], fwd[2]))

    @classmethod
    def book_one_final(cls) -> "Camera":
        # Reference camera.rs:26-30.
        return cls.look_at([13.0, 2.0, 3.0], [0.0, 0.0, 0.0])

    def forward(self) -> np.ndarray:
        sp, cp = math.sin(self.pitch), math.cos(self.pitch)
        sy, cy = math.sin(self.yaw), math.cos(self.yaw)
        return np.array([sp * sy, cp, sp * cy], np.float32)

    def view_matrix(self) -> np.ndarray:
        """World-from-camera 4x4 with columns (right, up, forward, position).

        Math mirrors reference camera.rs:41-69 (x-flipped look-at for a
        right-handed world / left-handed camera).
        """
        direction = self.forward()
        right = np.cross(direction, [0.0, 1.0, 0.0])
        up = np.cross(right, direction)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = right
        m[:3, 1] = up
        m[:3, 2] = direction
        m[:3, 3] = self.position
        return m


def inverse_projection(vfov_rad: float, aspect_ratio: float, z_near: float, z_far: float) -> np.ndarray:
    """Inverse projection unprojecting NDC -> camera space.

    Column-assembled from reference projection_matrix.rs:21-38; applied to
    ``(ndc_x, ndc_y, 1, 1)`` and divided by w it yields the camera-space
    point on the far plane along the pixel ray.
    """
    h = math.tan(vfov_rad / 2.0)
    w = h * aspect_ratio
    r = z_far / (z_far - z_near)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[3, 2] = -1.0 / (r * z_near)
    m[2, 3] = 1.0
    m[3, 3] = 1.0 / z_near
    return m


@dataclasses.dataclass(frozen=True)
class GPUCamera:
    """Flattened per-render camera uniforms (camera_controller.rs:161-190).

    Frozen/hashable: used as a jit static argument alongside the matrices.
    """

    position: tuple[float, float, float]
    pitch: float
    yaw: float
    defocus_radius: float
    focus_distance: float


@dataclasses.dataclass
class CameraController:
    """Interactive camera state machine (camera_controller.rs:7-158).

    Headless but API-complete: WASD/QE movement amounts, mouse rotation,
    dt integration with pitch clamping, and the derived GPU uniforms.
    """

    camera: Camera
    vfov_deg: float = 20.0
    defocus_angle_deg: float = 0.6
    focus_distance: float = 10.0
    z_near: float = 0.1
    z_far: float = 100.0
    speed: float = 4.0
    sensitivity: float = 0.1

    _amount_forward: float = 0.0
    _amount_backward: float = 0.0
    _amount_right: float = 0.0
    _amount_left: float = 0.0
    _amount_up: float = 0.0
    _amount_down: float = 0.0
    _rotate_horizontal: float = 0.0
    _rotate_vertical: float = 0.0

    @classmethod
    def book_one_final(cls) -> "CameraController":
        # Ctor args from reference main.rs:24-32.
        return cls(Camera.book_one_final(), vfov_deg=20.0, defocus_angle_deg=0.6,
                   focus_distance=10.0, z_near=0.1, z_far=100.0, speed=4.0, sensitivity=0.1)

    # -- input API (camera_controller.rs:74-125) --
    def process_mouse(self, dx: float, dy: float) -> None:
        self._rotate_horizontal = dx
        self._rotate_vertical = dy

    def move_forward(self, pressed: bool) -> None:
        self._amount_forward = 1.0 if pressed else 0.0

    def move_backward(self, pressed: bool) -> None:
        self._amount_backward = 1.0 if pressed else 0.0

    def move_right(self, pressed: bool) -> None:
        self._amount_right = 1.0 if pressed else 0.0

    def move_left(self, pressed: bool) -> None:
        self._amount_left = 1.0 if pressed else 0.0

    def move_up(self, pressed: bool) -> None:
        self._amount_up = 1.0 if pressed else 0.0

    def move_down(self, pressed: bool) -> None:
        self._amount_down = 1.0 if pressed else 0.0

    def update_camera(self, dt: float) -> None:
        """Integrate movement/rotation (camera_controller.rs:127-158)."""
        sy, cy = math.sin(self.camera.yaw), math.cos(self.camera.yaw)
        forward = np.array([sy, 0.0, cy], np.float32)
        right = np.array([-cy, 0.0, sy], np.float32)
        pos = self.camera.position.astype(np.float32)
        pos = pos + forward * (self._amount_forward - self._amount_backward) * self.speed * dt
        pos = pos + right * (self._amount_right - self._amount_left) * self.speed * dt
        pos[1] += (self._amount_up - self._amount_down) * self.speed * dt
        self.camera.position = pos

        self.camera.yaw -= self._rotate_horizontal * self.sensitivity * dt
        self.camera.pitch -= self._rotate_vertical * self.sensitivity * dt
        self._rotate_horizontal = 0.0
        self._rotate_vertical = 0.0
        self.camera.pitch = float(np.clip(self.camera.pitch, -_SAFE_PI, _SAFE_PI))

    # -- derived uniforms --
    @property
    def vfov_rad(self) -> float:
        return math.radians(self.vfov_deg)

    @property
    def defocus_radius(self) -> float:
        # camera_controller.rs:175
        return self.focus_distance * math.tan(math.radians(self.defocus_angle_deg) / 2.0)

    def gpu_camera(self) -> GPUCamera:
        return GPUCamera(
            position=tuple(float(x) for x in self.camera.position),
            pitch=self.camera.pitch,
            yaw=self.camera.yaw,
            defocus_radius=self.defocus_radius,
            focus_distance=self.focus_distance,
        )

    def view_matrix(self) -> np.ndarray:
        return self.camera.view_matrix()

    def inverse_projection(self, width: int, height: int) -> np.ndarray:
        return inverse_projection(self.vfov_rad, width / height, self.z_near, self.z_far)
