from .hybrid import HybridRender, make_hybrid_frame, render_frame_hybrid
from .raytrace import (
    RayTraceRender, build_world_scene, make_rt_frame, render_frame_rt,
    rt_frame)
from .renderpass import RenderPass, render_frame, render_frame_static

__all__ = ["HybridRender", "RayTraceRender", "RenderPass",
           "build_world_scene", "make_hybrid_frame", "make_rt_frame",
           "render_frame", "render_frame_hybrid", "render_frame_rt",
           "render_frame_static", "rt_frame"]
