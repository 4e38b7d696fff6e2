"""Render ops of the port: plain tensor functions plus kernel wrappers
(``raster_exact.rasterize_bins``) that launch hand-written CUDA kernels on
CUDA tensors and run their plain PyTorch versions on CPU tensors."""
