from .camera import Camera, CameraMatrices, look_at, orthographic, perspective
from .engine import RenderEngine
from .geometry import (
    GeometryArena,
    GeometryArrays,
    MeshHandle,
    make_cube,
    make_icosphere,
    make_plane,
    make_torus,
    make_uv_sphere,
)
from .material import (
    SHADE_EMISSIVE,
    SHADE_LEAF,
    SHADE_PBR,
    SHADE_TRANSLUCENT,
    Material,
    MaterialInstance,
    MaterialRegistry,
    MaterialTable,
)
from .model import MaterialMesh, Model, ModelInstance, ModelLOD
from .scene import InstanceArrays, Scene, SceneTables
from . import transforms

__all__ = [
    "Camera", "CameraMatrices", "look_at", "orthographic", "perspective",
    "RenderEngine",
    "GeometryArena", "GeometryArrays", "MeshHandle",
    "make_cube", "make_icosphere", "make_plane", "make_torus", "make_uv_sphere",
    "Material", "MaterialInstance", "MaterialRegistry", "MaterialTable",
    "SHADE_PBR", "SHADE_LEAF", "SHADE_EMISSIVE", "SHADE_TRANSLUCENT",
    "MaterialMesh", "Model", "ModelInstance", "ModelLOD",
    "InstanceArrays", "Scene", "SceneTables",
    "transforms",
]
