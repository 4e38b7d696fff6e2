"""Post-process chain: exposure -> white balance -> contrast/brightness ->
color filter -> saturation -> Hill ACES tonemap -> gamma.

PyTorch counterpart of ``paperrenderer_tpu/ops/tonemap.py``, the reference's
fullscreen tonemap pass (example/resources/shaders/BufferCopy.frag:22-136)
as elementwise tensor math.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.tree import device_constant, tree_to

# Hill ACES fit matrices (BufferCopy.frag:66-89): out = M @ pixel, rows as
# written; applied by _mat3 as unrolled elementwise sums
_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)
_LIN_2_LMS = (
    (3.90405e-1, 5.49941e-1, 8.92632e-3),
    (7.08416e-2, 9.63172e-1, 1.35775e-3),
    (2.31082e-2, 1.28021e-1, 9.36245e-1),
)
_LMS_2_LIN = (
    (2.85847e0, -1.62879e0, -2.48910e-2),
    (-2.10182e-1, 1.15820e0, 3.24281e-4),
    (-4.18120e-2, -1.18169e-1, 1.06867e0),
)


def _mat3(rgb: torch.Tensor, m) -> torch.Tensor:
    """out = rgb @ m.T with python-constant rows, unrolled elementwise."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([row[0] * r + row[1] * g + row[2] * b for row in m],
                       dim=-1)


@dataclasses.dataclass(frozen=True)
class TonemapParams:
    """Matches the reference UBO (BufferCopy.frag:8-18)."""

    color_filter: torch.Tensor  # f32[3]
    exposure: torch.Tensor      # f32[]
    wb_temp: torch.Tensor
    wb_tint: torch.Tensor
    contrast: torch.Tensor
    brightness: torch.Tensor
    saturation: torch.Tensor
    gamma: torch.Tensor

    @staticmethod
    def default(device="cpu") -> "TonemapParams":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return TonemapParams(
            color_filter=f32([1.0, 1.0, 1.0]), exposure=f32(1.0),
            wb_temp=f32(0.0), wb_tint=f32(0.0), contrast=f32(1.0),
            brightness=f32(0.0), saturation=f32(1.0), gamma=f32(1.0),
        )

    def to(self, device) -> "TonemapParams":
        return tree_to(self, device)


def white_balance(rgb, temperature, tint):
    """LMS-space white balance (BufferCopy.frag:23-64)."""
    t1 = temperature * 10.0 / 6.0
    t2 = tint * 10.0 / 6.0
    x = 0.31271 - t1 * torch.where(t1 < 0, 0.1, 0.05)
    std_y = 2.87 * x - 3.0 * x * x - 0.27509507
    y = std_y + t2 * 0.05
    big_y = 1.0
    big_x = big_y * x / y
    big_z = big_y * (1.0 - x - y) / y
    l = 0.7328 * big_x + 0.4296 * big_y - 0.1624 * big_z
    m = -0.7036 * big_x + 1.6975 * big_y + 0.0061 * big_z
    s = 0.0030 * big_x + 0.0136 * big_y + 0.9834 * big_z
    w1 = device_constant((0.949237, 1.03542, 1.08728), rgb.device)
    balance = w1 / torch.stack([l, m, s])
    return _mat3(_mat3(rgb, _LIN_2_LMS) * balance, _LMS_2_LIN)


def hill_aces(rgb: torch.Tensor) -> torch.Tensor:
    """Hill ACES fit (BufferCopy.frag:66-89)."""
    c = _mat3(rgb, _ACES_INPUT)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(_mat3(a / b, _ACES_OUTPUT), 0.0, 1.0)


def tonemap(hdr: torch.Tensor, params: Optional[TonemapParams] = None) -> torch.Tensor:
    """HDR f32[..., 3] -> LDR f32[..., 3] in [0, 1] (BufferCopy.frag main)."""
    p = params or TonemapParams.default(hdr.device)
    px = torch.clamp(hdr * p.exposure, min=0.0)
    px = torch.clamp(white_balance(px, p.wb_temp, p.wb_tint), min=0.0)
    px = torch.clamp(p.contrast * (px - 0.5) + 0.5 + p.brightness, min=0.0)
    px = px * p.color_filter
    luma = device_constant((0.299, 0.587, 0.114), hdr.device)
    gray = (px * luma).sum(dim=-1, keepdim=True)
    px = torch.clamp(gray + (px - gray) * p.saturation, min=0.0)
    return torch.pow(hill_aces(px), p.gamma)
