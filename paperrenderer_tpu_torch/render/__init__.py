from .renderpass import RenderPass, render_frame_static

__all__ = ["RenderPass", "render_frame_static"]
