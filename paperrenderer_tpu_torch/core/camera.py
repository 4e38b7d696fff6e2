"""Camera: projection + view matrices and the frustum data the culler needs.

PyTorch counterpart of ``paperrenderer_tpu/core/camera.py`` (reference
semantics: src/PaperRenderer/Camera.cpp:80-174):
  * perspective: GLM-compatible right-handed, depth in [-1, 1]
  * orthographic: glm::ortho style
  * view from position + quaternion, Z-up yaw/pitch, or look-at.

Matrices are built in f32 on the host and moved to the render device by the
consumer (``CameraMatrices.to``); they are 4x4, so the copy is negligible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .transforms import (
    quat_from_axis_angle, quat_multiply, quat_normalize, quat_to_mat3,
)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CameraMatrices:
    """Camera state consumed by the render ops (reference CameraUBOData,
    Camera.h:56-60)."""

    projection: torch.Tensor  # f32[4, 4]
    view: torch.Tensor        # f32[4, 4]
    # inverse(view_proj), filled in by ``to`` from the source device (the
    # host) so the G-buffer resolve never runs a device-side solver
    inv_view_proj: Optional[torch.Tensor] = None

    @property
    def view_proj(self) -> torch.Tensor:
        return self.projection @ self.view

    @property
    def inverse_view_proj(self) -> torch.Tensor:
        if self.inv_view_proj is not None:
            return self.inv_view_proj
        return torch.linalg.inv(self.view_proj)

    @property
    def cam_pos(self) -> torch.Tensor:
        """World-space camera position = inverse(view)[:3, 3]."""
        rot = self.view[:3, :3]
        return -rot.T @ self.view[:3, 3]

    def to(self, device) -> "CameraMatrices":
        """The matrices on ``device``, inverse included, as ONE non-blocking
        copy from pinned memory (a pageable copy would sync the stream)."""
        device = torch.device(device)
        src = self.projection.device
        if src.type == device.type and device.index in (None, src.index):
            return self
        packed = torch.stack(
            [self.projection, self.view, self.inverse_view_proj])
        if device.type == "cuda" and src.type == "cpu":
            packed = packed.pin_memory()
        p, v, i = packed.to(device, non_blocking=True).unbind(0)
        return CameraMatrices(projection=p, view=v, inv_view_proj=i)


def perspective(yfov_deg: float, aspect: float, near: float,
                far: float) -> torch.Tensor:
    """GLM-compatible right-handed perspective, NDC depth [-1, 1]."""
    f = 1.0 / torch.tan(torch.deg2rad(torch.tensor(yfov_deg, dtype=_F32)) * 0.5)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def orthographic(x_scale: float, y_scale: float, near: float,
                 far: float) -> torch.Tensor:
    """glm::ortho(-x, x, -y, y, near, far) — Camera.cpp:104."""
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = 1.0 / x_scale
    m[1, 1] = 1.0 / y_scale
    m[2, 2] = -2.0 / (far - near)
    m[2, 3] = -(far + near) / (far - near)
    m[3, 3] = 1.0
    return m


def view_from_pos_quat(pos, quat) -> torch.Tensor:
    """``view = mat4(R(q)) @ translate(-pos)`` — Camera.cpp:139-146."""
    rot = quat_to_mat3(quat_normalize(torch.as_tensor(quat, dtype=_F32)))
    pos = torch.as_tensor(pos, dtype=_F32)
    view = torch.eye(4, dtype=_F32)
    view[:3, :3] = rot
    view[:3, 3] = rot @ (-pos)
    return view


def quat_from_yaw_pitch(yaw_deg, pitch_deg) -> torch.Tensor:
    """Z-up Euler -> view quaternion (Camera.cpp:124-135)."""
    yaw = torch.tensor(math.radians(float(yaw_deg)), dtype=_F32)
    pitch = torch.tensor(math.radians(float(pitch_deg)), dtype=_F32)
    yaw_rot = quat_from_axis_angle(torch.tensor([0.0, 0.0, -1.0]), yaw)
    pitch_rot = quat_from_axis_angle(torch.tensor([-1.0, 0.0, 0.0]), pitch)
    return quat_normalize(quat_multiply(pitch_rot, yaw_rot))


def look_at(eye, center, up=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Right-handed look-at view matrix (Z-up default, like the example app)."""
    eye = torch.as_tensor(eye, dtype=_F32)
    center = torch.as_tensor(center, dtype=_F32)
    up = torch.as_tensor(up, dtype=_F32)
    fwd = center - eye
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    true_up = torch.linalg.cross(right, fwd)
    rot = torch.stack([right, true_up, -fwd])  # rows
    view = torch.eye(4, dtype=_F32)
    view[:3, :3] = rot
    view[:3, 3] = rot @ (-eye)
    return view


class Camera:
    """Host-side camera mirroring the reference API (Camera.h:56-88);
    ``matrices`` returns the immutable state passed to the render ops."""

    def __init__(
        self,
        *,
        yfov_deg: Optional[float] = 75.0,
        ortho_scale: Optional[tuple] = None,
        aspect: float = 1.0,
        near: float = 0.1,
        far: float = 1000.0,
    ):
        self._aspect = float(aspect)
        self._near = float(near)
        self._far = float(far)
        self._yfov = yfov_deg
        self._ortho = ortho_scale
        self._view = torch.eye(4, dtype=_F32)
        self._rebuild_projection()

    def _rebuild_projection(self) -> None:
        if self._ortho is not None:
            self._projection = orthographic(
                self._ortho[0], self._ortho[1], self._near, self._far)
        else:
            self._projection = perspective(
                self._yfov, self._aspect, self._near, self._far)

    def set_aspect(self, aspect: float) -> None:
        self._aspect = float(aspect)
        self._rebuild_projection()

    def update_projection(self, *, yfov_deg=None, ortho_scale=None, near=None,
                          far=None):
        if yfov_deg is not None:
            self._yfov, self._ortho = yfov_deg, None
        if ortho_scale is not None:
            self._ortho = ortho_scale
        if near is not None:
            self._near = float(near)
        if far is not None:
            self._far = float(far)
        self._rebuild_projection()

    def update_view(self, *, pos=None, quat=None, yaw_pitch=None, matrix=None):
        if matrix is not None:
            self._view = torch.as_tensor(matrix, dtype=_F32).cpu()
            return
        if yaw_pitch is not None:
            quat = quat_from_yaw_pitch(*yaw_pitch)
        self._view = view_from_pos_quat(pos, quat)

    def look_at(self, eye, center, up=(0.0, 0.0, 1.0)) -> None:
        self._view = look_at(eye, center, up)

    @property
    def matrices(self) -> CameraMatrices:
        return CameraMatrices(projection=self._projection, view=self._view)
