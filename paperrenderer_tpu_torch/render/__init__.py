from .hybrid import HybridRender, render_frame_hybrid
from .raytrace import RayTraceRender, render_frame_rt
from .renderpass import RenderPass, render_frame, render_frame_static

__all__ = ["HybridRender", "RayTraceRender", "RenderPass", "render_frame",
           "render_frame_hybrid", "render_frame_rt", "render_frame_static"]
