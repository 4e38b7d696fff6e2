"""The port's example CLIs, one module each, run as
``python -m paperrenderer_tpu_torch.examples.<name>`` (each has
``main(argv=None)``; ``--cpu`` runs it on the CPU, the card otherwise):

  render_scene     the example scene through RenderPass (config 1)
  render_rt        the RT scene through RayTraceRender
  render_hybrid    the hybrid scene through HybridRender
  render_crowd     the many-instance crowd, traced on the paged layout
  render_dynamic   config 2/5's grid animated on the device every frame
  render_textured  procedural textures through the raster or RT frame
  view_scene       the example scene served by the live HTTP viewer

They build their scenes with ``paperrenderer_tpu_torch.scenes`` and write
the first frame (the goldens' samples) with ``io.image.write_png``.
"""
