from .image import read_image, write_png

__all__ = ["read_image", "write_png"]
