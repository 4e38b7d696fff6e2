from .gltf import GltfScene, instantiate, load_gltf
from .image import encode_png, read_image, write_png

__all__ = ["encode_png", "read_image", "write_png", "GltfScene", "instantiate",
           "load_gltf"]
