"""Minimal glTF 2.0 loader (.glb / .gltf) -> Models + instances.

PyTorch-port counterpart of ``paperrenderer_tpu/io/gltf.py``. The reference
example app loads .glb scenes with tinygltf (example/src/main.cpp:28-200):
meshes become Models (one LOD, one material slot per primitive), nodes
with meshes become instances, and the pbrMetallicRoughness factors become
material parameters. This loader covers the same surface with json,
struct and numpy only:

  * the GLB container (JSON + BIN chunks) and .gltf with external or
    base64 ``data:`` buffers;
  * accessors POSITION / NORMAL / TEXCOORD_0 and indices (f32 / u8 / u16 /
    u32 components, strided or packed, not sparse);
  * materials: baseColorFactor, metallicFactor, roughnessFactor,
    emissiveFactor, alphaMode BLEND -> SHADE_TRANSLUCENT;
  * textures: the base colour, emissive, metallic-roughness and occlusion
    images (an embedded bufferView, a ``data:`` URI or an external file),
    decoded by ``io.image.read_image`` (every PNG, baseline,
    progressive, lossless and arithmetic-coded 8-bit JPEGs in gray, YCbCr,
    RGB, CMYK or YCCK at any integral sampling, BMP/DIB, TGA, GIF's first
    frame and WebP (lossless, lossy, with alpha, animated), as the JAX
    loader's imaging library decodes them) and attached to the Material;
    the MaterialRegistry packs them into the atlas when its table is
    built. Like the JAX loader it reads ``texture.source`` only (no
    ``EXT_texture_webp``: a WebP is read where ``source`` names one). An
    image in a form ``read_image`` refuses, as that library does (a 12-
    or 16-bit, hierarchical or arithmetic lossless JPEG, a BMP bitfield
    set outside Pillow's, a format not decoded yet such as DDS or TIFF),
    raises NotImplementedError naming the form and the glTF image index;
  * the node hierarchy with TRS or matrix transforms, flattened to world
    TRS (uniform-scale composition) in f32 on the CPU with the port's
    ``core.transforms``.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.geometry import GeometryArena
from ..core.material import SHADE_PBR, SHADE_TRANSLUCENT, Material
from ..core.model import MaterialMesh, Model, ModelInstance
from ..core.transforms import quat_multiply, quat_to_mat3
from .image import read_image

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_container(path: str) -> Tuple[dict, List[bytes]]:
    """(glTF JSON, buffers) of a .glb or .gltf file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        # GLB: a 12-byte header, then (length, type, payload) chunks
        offset, gltf, binary = 12, None, b""
        while offset < len(data):
            clen, ctype = struct.unpack_from("<I4s", data, offset)
            chunk = data[offset + 8 : offset + 8 + clen]
            if ctype == b"JSON":
                gltf = json.loads(chunk.decode("utf-8"))
            elif ctype == b"BIN\x00":
                binary = chunk
            offset += 8 + clen + (-clen % 4 if ctype == b"JSON" else 0)
        assert gltf is not None, "GLB missing JSON chunk"
        return gltf, [binary]
    gltf = json.loads(data.decode("utf-8"))
    buffers = []
    base = os.path.dirname(os.path.abspath(path))
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as bf:
                buffers.append(bf.read())
    return gltf, buffers


def _read_accessor(gltf: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    """Accessor ``idx`` -> a [count, components] array of its type."""
    acc = gltf["accessors"][idx]
    assert "sparse" not in acc, "sparse accessors not supported"
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    buf = buffers[view.get("buffer", 0)]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    if stride and stride != np.dtype(dtype).itemsize * ncomp:
        return np.stack([np.frombuffer(buf, dtype, ncomp, start + i * stride)
                         for i in range(count)])
    return np.frombuffer(buf, dtype, count * ncomp, start).reshape(
        count, ncomp).copy()


def _node_trs(node: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node transform -> (pos, scale, quat wxyz), f32."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major
        pos = m[:3, 3].copy()
        a = m[:3, :3]
        scale = np.linalg.norm(a, axis=0)
        r = a / np.maximum(scale, 1e-12)
        # rotation matrix -> quaternion (wxyz)
        t = np.trace(r)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            quat = np.asarray([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                               (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
        else:
            i = int(np.argmax(np.diag(r)))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
            quat = np.zeros(4)
            quat[1 + i] = 0.25 * s
            quat[0] = (r[k, j] - r[j, k]) / s
            quat[1 + j] = (r[j, i] + r[i, j]) / s
            quat[1 + k] = (r[k, i] + r[i, k]) / s
        return (pos.astype(np.float32), scale.astype(np.float32),
                quat.astype(np.float32))
    pos = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    scale = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    q_xyzw = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
    quat = np.asarray([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]], np.float32)
    return pos, scale, quat


class GltfScene:
    """Loaded scene: models, per-model material lists, node instances."""

    def __init__(self):
        self.models: List[Optional[Model]] = []
        self.materials: List[Material] = []           # by glTF material index
        self.model_slot_materials: List[Dict[int, Material]] = []
        # (model index, world pos, world scale, world quat wxyz)
        self.instances: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []


def _texture_image(gltf: dict, buffers: List[bytes], base_dir: str,
                   cache: Dict[int, Optional[np.ndarray]],
                   tex_ref: Optional[dict]) -> Optional[np.ndarray]:
    """A glTF textureInfo -> its decoded u8 image (None when absent)."""
    if tex_ref is None:
        return None
    src = gltf.get("textures", [])[tex_ref["index"]].get("source")
    if src is None:
        return None
    if src in cache:
        return cache[src]
    img_def = gltf["images"][src]
    if "bufferView" in img_def:
        view = gltf["bufferViews"][img_def["bufferView"]]
        start = view.get("byteOffset", 0)
        data = buffers[view.get("buffer", 0)][start : start + view["byteLength"]]
    else:
        uri = img_def.get("uri", "")
        data = (base64.b64decode(uri.split(",", 1)[1]) if uri.startswith("data:")
                else os.path.join(base_dir, uri))
    try:
        img = read_image(data)
    except NotImplementedError as exc:
        raise NotImplementedError(f"glTF image {src}: {exc}") from exc
    cache[src] = img
    return img


def load_gltf(path: str, arena: GeometryArena) -> GltfScene:
    """Parse a .glb/.gltf file into arena-backed Models + instance TRS list."""
    gltf, buffers = _load_container(path)
    out = GltfScene()
    base_dir = os.path.dirname(os.path.abspath(path))
    img_cache: Dict[int, Optional[np.ndarray]] = {}

    def texture(ref):
        return _texture_image(gltf, buffers, base_dir, img_cache, ref)

    for mi, mat in enumerate(gltf.get("materials", [])):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        blend = mat.get("alphaMode", "OPAQUE") == "BLEND"
        # decoded in the JAX loader's order, so its image cache fills alike
        base_img = texture(pbr.get("baseColorTexture"))
        emis_img = texture(mat.get("emissiveTexture"))
        mr_img = texture(pbr.get("metallicRoughnessTexture"))
        occ_img = texture(mat.get("occlusionTexture"))
        out.materials.append(Material(
            mat.get("name", f"material{mi}"),
            albedo=tuple(base[:3]),
            alpha=float(base[3]),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            emissive=tuple(mat.get("emissiveFactor", [0, 0, 0])),
            shading_model=SHADE_TRANSLUCENT if blend else SHADE_PBR,
            base_texture=base_img,
            emissive_texture=emis_img,
            mr_texture=mr_img,
            occlusion_texture=occ_img,
        ))
    default_mat = Material("gltf-default")

    for mesh_i, mesh in enumerate(gltf.get("meshes", [])):
        meshes: List[MaterialMesh] = []
        slot_mats: Dict[int, Material] = {}
        for slot, prim in enumerate(mesh.get("primitives", [])):
            attrs = prim["attributes"]

            def attr(name):
                return (_read_accessor(gltf, buffers, attrs[name]).astype(
                    np.float32) if name in attrs else None)

            pos = attr("POSITION")
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            handle = arena.add_mesh(pos, idx.astype(np.int64).reshape(-1, 3),
                                    attr("NORMAL"), attr("TEXCOORD_0"))
            meshes.append(MaterialMesh(handle, material_slot=slot))
            mat_idx = prim.get("material")
            slot_mats[slot] = (out.materials[mat_idx] if mat_idx is not None
                               else default_mat)
        out.models.append(
            Model(arena, [meshes], name=mesh.get("name", f"mesh{mesh_i}"))
            if meshes else None)
        out.model_slot_materials.append(slot_mats if meshes else {})

    # flatten the node hierarchy to world TRS (uniform-scale composition)
    nodes = gltf.get("nodes", [])
    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{}])[scene_idx].get("nodes", range(len(nodes)))

    def walk(ni, parent_pos, parent_scale, parent_quat):
        node = nodes[ni]
        pos, scale, quat = _node_trs(node)
        # world = parent o local, f32 on the CPU
        r_parent = quat_to_mat3(torch.from_numpy(parent_quat)).numpy()
        w_pos = parent_pos + r_parent @ (parent_scale * pos)
        w_scale = parent_scale * scale
        w_quat = quat_multiply(torch.from_numpy(parent_quat),
                               torch.from_numpy(quat)).numpy()
        if "mesh" in node and out.models[node["mesh"]] is not None:
            out.instances.append((node["mesh"], w_pos, w_scale, w_quat))
        for child in node.get("children", []):
            walk(child, w_pos, w_scale, w_quat)

    ident = (np.zeros(3, np.float32), np.ones(3, np.float32),
             np.asarray([1, 0, 0, 0], np.float32))
    for r in roots:
        walk(r, *ident)
    return out


def instantiate(gltf_scene: GltfScene, render_pass, scene=None):
    """Create ModelInstances in a render (a RenderPass, RayTraceRender or
    HybridRender: anything with ``add_instance(inst, {slot: material})``)
    from a loaded glTF scene (the example app's model-creation loop,
    main.cpp:131-200). Returns the instances."""
    created = []
    for model_i, pos, scale, quat in gltf_scene.instances:
        inst = ModelInstance(gltf_scene.models[model_i])
        inst.set_transform(pos=pos, scale=scale, quat=quat)
        render_pass.add_instance(inst, {
            slot: mat.instance()
            for slot, mat in gltf_scene.model_slot_materials[model_i].items()})
        created.append(inst)
    return created
