"""paperrenderer_tpu_torch — the PyTorch + CUDA port of paperrenderer_tpu.

Same scene API as the JAX package (RenderEngine / Scene / Model /
ModelInstance / Material / Camera / RenderPass), written in PyTorch; each
Pallas kernel of the JAX package becomes a hand-written Hopper kernel under
``csrc/``, built at first use. Every tensor lives on an explicit ``device``
(``Scene``/``RenderEngine``/``RenderPass``), the card unless the caller
asks for the CPU; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.

Ported so far: the static raster frame, ``RenderPass.render(cam)``, the
draw-list raster frame, ``RenderPass.render(cam, static_path=False)``, the
ray-traced frame, ``RayTraceRender.render(cam)``, on the flat and the paged
layout (big scenes, big models), and the hybrid frame,
``HybridRender.render(cam)``, both with the any-hit leaf cutout and
half-rate reflections, and textured materials on all of them (the atlas
and samplers of ``core.texture``), and animation: instances moved on the
device every frame (``ops.animation``, ``scenes.run_dynamic``: bench
config 5) and unique-geometry instances whose BLASes the RT and hybrid
frames refit (``RayTraceRender(animate=, anim_resplit=)``,
``HybridRender(animate=)``, ``render(cam, time=)``). Around the frames:
glTF import (``io.load_gltf``, ``io.instantiate``), the live HTTP viewer
(``Viewer``), the example CLIs (``python -m
paperrenderer_tpu_torch.examples.<name>``), the native scene core
(``native``: the C++ arena, delta packer and morton codes of
``native/scenecore.cpp``), and the XLA route (``use_pallas=False``: plain
tensor ops on the pass's device, the route that made the pinned goldens).
"""

import torch as _torch

# Geometry math cannot tolerate TF32-truncated products: vertex transforms,
# camera unprojection and edge setup all involve cancellation.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .core import (  # noqa: E402
    Camera,
    CameraMatrices,
    GeometryArena,
    Material,
    MaterialInstance,
    MaterialMesh,
    MaterialRegistry,
    Model,
    ModelInstance,
    RenderEngine,
    Scene,
    make_cube,
    make_icosphere,
    make_plane,
    make_torus,
    make_uv_sphere,
)
from .render import HybridRender, RayTraceRender, RenderPass  # noqa: E402
from .utils import Logger, LogType, StatisticsTracker, Timer  # noqa: E402
from .viewer import Viewer  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera", "CameraMatrices", "GeometryArena", "RenderEngine",
    "Material", "MaterialInstance", "MaterialMesh", "MaterialRegistry",
    "HybridRender", "Model", "ModelInstance", "RayTraceRender", "RenderPass",
    "Scene",
    "make_cube", "make_icosphere", "make_plane", "make_torus", "make_uv_sphere",
    "Logger", "LogType", "StatisticsTracker", "Timer", "Viewer",
    "__version__",
]
