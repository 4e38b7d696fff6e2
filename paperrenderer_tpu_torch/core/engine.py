"""RenderEngine: the top-level facade and frame lifecycle.

PyTorch counterpart of ``paperrenderer_tpu/core/engine.py`` (reference
PaperRenderer.h:44-129). The engine owns

  Logger -> StatisticsTracker -> Scene (geometry arena + registries)
  -> MaterialRegistry

on one explicit ``device``. ``begin_frame`` clears per-frame stats and
flushes pending scene deltas (PaperRenderer.cpp:365-386); ``end_frame``
advances the frame counter and records frame time (:388-404).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..utils.device import require_device
from ..utils.logging import Logger
from ..utils.stats import StatisticsTracker, TimeStatisticInterval, Timer
from .geometry import GeometryArena
from .material import MaterialRegistry
from .scene import InstanceArrays, Scene


class RenderEngine:
    """Top-level engine facade (reference PaperRenderer.h:44-129)."""

    def __init__(
        self,
        *,
        device="cuda",
        log_callback: Optional[Callable] = None,
        device_check: bool = True,
    ):
        self.device = torch.device(device)
        self.logger = Logger(log_callback)
        self.statistics = StatisticsTracker()
        self.scene = Scene(GeometryArena(), device=self.device)
        self.materials = MaterialRegistry()
        self._frame = 0
        self._last_frame_time = time.perf_counter()
        self.delta_time = 0.0
        if device_check:
            require_device(self.device)
            name = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else self.device.type)
            self.logger.info(f"RenderEngine initialized on {name}")

    def begin_frame(self) -> InstanceArrays:
        """Clear per-frame stats, flush scene deltas; returns the instance SoA."""
        self.statistics.clear()
        with Timer(self.statistics, "Begin Frame"):
            arrays = self.scene.flush()
        return arrays

    def end_frame(self) -> None:
        self._frame += 1
        now = time.perf_counter()
        self.delta_time = now - self._last_frame_time
        self._last_frame_time = now
        self.statistics.insert_time_statistic(
            "Frame", TimeStatisticInterval.REGULAR, self.delta_time)

    @property
    def frame_number(self) -> int:
        return self._frame

    @property
    def buffer_index(self) -> int:
        """frame % 2, as the JAX package's engine gives it
        (PaperRenderer.h:112)."""
        return self._frame % 2

    def create_render_pass(self, **kwargs):
        from ..render.renderpass import RenderPass

        return RenderPass(self.scene, self.materials, **kwargs)

    def create_ray_trace_render(self, **kwargs):
        from ..render.raytrace import RayTraceRender

        return RayTraceRender(self.scene, self.materials, **kwargs)

    def create_hybrid_render(self, **kwargs):
        from ..render.hybrid import HybridRender

        return HybridRender(self.scene, self.materials, **kwargs)
