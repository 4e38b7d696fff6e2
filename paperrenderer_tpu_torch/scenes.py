"""The repository's benchmark scenes, built through the port's public API.

Exact copies of ``examples/render_scene.py::build_example_scene`` (config 1:
~4.1k triangles), ``examples/render_dynamic.py::build_dynamic_scene``
(config 2: 10k instances, half 12-triangle cubes and half 80-triangle
icospheres, ~460k triangles) and ``examples/render_rt.py::build_rt_scene``
(the ray-traced frame of config 3: a plane, a sphere and a mirror cube),
``examples/render_crowd.py::build_crowd_scene`` (many instances traced on
the paged layout) and ``examples/render_hybrid.py::build_hybrid_scene``
(the hybrid frame) — same meshes, materials, transforms, lights, camera and
seed — with a ``device`` that defaults to the card.
``build_translucent_grid`` is config 2's grid with glass and leaf
instances, drawn through sorted translucency, and ``build_leaf_rt_grid``
the same grid ray-traced and lit by the hybrid frame, which meet its leaves
through the any-hit leaf cutout; ``build_leaf_scene`` is a small scene
whose primary, AO and reflection rays all meet the cutout.
``build_big_model_scene`` is the big-model recipe of
``tests/test_trace_paged.py`` (a sphere cut into BLAS chunks among cubes)
with the sphere's size as a parameter. ``build_textured_scene`` is
``examples/render_textured.py::build_textured_scene`` (procedural
baseColor, emissive and metallicRoughness textures), and
``build_textured_grid`` config 2's grid with its four materials given
seeded procedural textures of a real texture set's size.

Animation: ``run_dynamic`` is ``examples/render_dynamic.py::run``, config
5's loop (``build_dynamic_scene`` animated on the device every frame by
``animate_instances``); ``build_animated_rt_scene``,
``build_animated_crowd_scene`` and ``build_animated_hybrid_scene`` are the
RT scene, the crowd and the hybrid example with some instances made
unique-geometry instances that ``animate_vertices`` deforms.
"""

from __future__ import annotations

import numpy as np

import time as _time

import torch

from .core import (
    SHADE_LEAF, SHADE_TRANSLUCENT, Camera, Material, MaterialRegistry, Model,
    ModelInstance, RenderEngine, Scene, make_cube, make_icosphere, make_plane,
    make_torus, make_uv_sphere,
)
from .ops.animation import animate_instances, animate_vertices
from .ops.shading import Lights
from .render import RayTraceRender, RenderPass
from .render.renderpass import render_frame_static


def build_example_scene(width: int = 512, height: int = 512, device="cuda"):
    """The bundled example scene; returns (RenderPass, Camera)."""
    scene = Scene(device=device)
    registry = MaterialRegistry()

    ground = Model.from_mesh(scene.arena, *make_plane(size=30.0), name="ground")
    sphere = Model.from_mesh(
        scene.arena, *make_uv_sphere(radius=1.0, rings=24, sectors=32),
        name="sphere")
    cube = Model.from_mesh(scene.arena, *make_cube(size=1.4), name="cube")
    torus = Model.from_mesh(
        scene.arena, *make_torus(major=0.9, minor=0.32, rings=32, sides=16),
        name="torus")

    gray = Material("gray", albedo=(0.55, 0.55, 0.6), roughness=0.9)
    red = Material("red", albedo=(0.9, 0.12, 0.1), roughness=0.35, metallic=0.0)
    gold = Material("gold", albedo=(1.0, 0.77, 0.34), roughness=0.3, metallic=1.0)
    blue = Material("blue", albedo=(0.15, 0.3, 0.9), roughness=0.15)
    glow = Material("glow", albedo=(0.1, 0.1, 0.1), emissive=(2.0, 1.2, 0.2))

    lights = Lights.make(
        [
            {"position": (4.0, -4.0, 6.0), "color": (120.0, 115.0, 100.0),
             "bounds": 60.0, "radius": 0.3},
            {"position": (-5.0, -2.0, 3.0), "color": (25.0, 35.0, 60.0),
             "bounds": 40.0},
        ],
        ambient=(0.6, 0.7, 1.0, 0.08),
    )

    rp = RenderPass(scene, registry, width=width, height=height, lights=lights)

    g = ModelInstance(ground)
    rp.add_instance(g, {0: gray.instance()})

    s = ModelInstance(sphere)
    s.set_transform(pos=(0.0, 0.0, 1.0))
    rp.add_instance(s, {0: red.instance()})

    c = ModelInstance(cube)
    c.set_transform(pos=(2.4, 1.2, 0.7), quat=(0.924, 0.0, 0.0, 0.383))
    rp.add_instance(c, {0: gold.instance()})

    t = ModelInstance(torus)
    t.set_transform(pos=(-2.2, 0.8, 0.5), quat=(0.793, 0.61, 0.0, 0.0))
    rp.add_instance(t, {0: blue.instance()})

    s2 = ModelInstance(sphere)
    s2.set_transform(pos=(-1.0, -2.0, 0.35), scale=0.35)
    rp.add_instance(s2, {0: glow.instance()})

    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -7.5, 3.6), (0.0, 0.0, 0.8), up=(0, 0, 1))
    return rp, cam


def build_dynamic_scene(n_instances: int, width: int, height: int,
                        seed: int = 0, device="cuda", textures=None):
    """The instanced grid of config 2 (and 5); returns (engine, pass, camera).
    ``textures`` (four dicts of ``Material`` texture keywords) textures the
    four materials."""
    eng = RenderEngine(device=device, device_check=False)
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=0.5), name="cube")
    ball = Model.from_mesh(
        eng.scene.arena, *make_icosphere(radius=0.3, subdivisions=1),
        name="ball")

    rp = eng.create_render_pass(
        width=width, height=height,
        lights=Lights.make(
            [{"position": (0.0, -30.0, 60.0), "color": (5000.0, 4800.0, 4500.0),
              "bounds": 500.0}],
            ambient=(0.7, 0.8, 1.0, 0.15),
        ),
    )
    tex = textures or [{}] * 4
    mats = [
        Material("a", albedo=(0.9, 0.2, 0.15), roughness=0.5, **tex[0]),
        Material("b", albedo=(0.2, 0.5, 0.9), roughness=0.4, **tex[1]),
        Material("c", albedo=(0.95, 0.8, 0.3), roughness=0.3, metallic=1.0,
                 **tex[2]),
        Material("d", albedo=(0.3, 0.85, 0.4), roughness=0.7, **tex[3]),
    ]
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 1.2
    for k in range(n_instances):
        model = cube if k % 2 == 0 else ball
        inst = ModelInstance(model)
        x = (k % side - side / 2) * spacing
        y = (k // side - side / 2) * spacing + 40.0
        z = rng.uniform(0.0, 2.0)
        inst.set_transform(pos=(x, y, z))
        rp.add_instance(inst, {0: mats[k % 4].instance()})
    cam = Camera(yfov_deg=70.0, aspect=width / height, near=0.1, far=500.0)
    cam.look_at((0.0, -side * 0.35, side * 0.35), (0.0, 40.0, 0.0), up=(0, 0, 1))
    return eng, rp, cam


def build_translucent_grid(n_instances: int, width: int, height: int,
                           layers: int = 4, seed: int = 0, device="cuda"):
    """Config 2's grid with one instance in four rebound to a 50% glass
    (SHADE_TRANSLUCENT) and one in sixteen to a leaf cutout (SHADE_LEAF),
    cubes and icospheres among both, drawn with ``layers`` depth-peel
    layers; returns (engine, pass, camera)."""
    eng, rp, cam = build_dynamic_scene(n_instances, width, height, seed=seed,
                                       device=device)
    glass = Material("glass", albedo=(0.6, 0.8, 0.95), roughness=0.1,
                     alpha=0.5, shading_model=SHADE_TRANSLUCENT).instance()
    leaf = Material("leaf", albedo=(0.25, 0.7, 0.2), roughness=0.6,
                    shading_model=SHADE_LEAF).instance()
    for inst in rp.scene.instances:
        # even indices are cubes, odd ones icospheres
        if inst.index % 32 in (2, 19):
            rp.add_instance(inst, {0: leaf})
        elif inst.index % 8 in (0, 5):
            rp.add_instance(inst, {0: glass})
    rp.translucent_layers = layers
    return eng, rp, cam


def build_leaf_rt_grid(n_instances: int, width: int, height: int,
                       seed: int = 0, device="cuda"):
    """The translucent grid (``build_translucent_grid``: one instance in
    sixteen a leaf cutout) mirrored into a RayTraceRender and a
    HybridRender through ``add_instances_from``, each with 1 shadow, 1 AO
    and 1 reflection sample; returns (engine, rt, hybrid, camera)."""
    eng, rp, cam = build_translucent_grid(n_instances, width, height,
                                          seed=seed, device=device)
    samples = dict(width=width, height=height, lights=rp.lights,
                   shadow_samples=1, ao_samples=1, reflection_samples=1)
    rt = eng.create_ray_trace_render(**samples)
    rt.add_instances_from(rp)
    hy = eng.create_hybrid_render(**samples)
    hy.add_instances_from(rp)
    return eng, rt, hy, cam


def build_leaf_scene(width: int = 48, height: int = 32, device="cuda"):
    """A ground plane, two upright leaf panels (2 x 2 planes, SHADE_LEAF;
    the second one force-opaque in the RT pass), a red cube behind the
    first and a gold mirror sphere behind both, in a RayTraceRender and a
    HybridRender that share the instances (1 shadow, 1 AO and 1
    reflection sample): camera, AO and reflection rays all meet the leaf
    cutout. Returns (engine, rt, hybrid, camera)."""
    eng = RenderEngine(device=device, device_check=False)
    ground = Model.from_mesh(eng.scene.arena, *make_plane(size=30.0))
    panel = Model.from_mesh(eng.scene.arena, *make_plane(size=2.0))
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=1.0))
    sphere = Model.from_mesh(
        eng.scene.arena, *make_uv_sphere(radius=0.8, rings=12, sectors=16))
    settings = dict(
        width=width, height=height,
        lights=Lights.make(
            [{"position": (3.0, -4.0, 6.0), "color": (160.0, 150.0, 130.0),
              "bounds": 60.0, "radius": 0.4}],
            ambient=(0.6, 0.7, 1.0, 0.3)),
        shadow_samples=1, reflection_samples=1, ao_samples=1, ao_radius=2.0)
    rt = eng.create_ray_trace_render(**settings)
    hy = eng.create_hybrid_render(**settings)
    white = Material("white", albedo=(0.75, 0.75, 0.78), roughness=0.9)
    red = Material("red", albedo=(0.85, 0.1, 0.08), roughness=0.4)
    gold = Material("gold", albedo=(1.0, 0.78, 0.35), roughness=0.1,
                    metallic=1.0)
    leaf = Material("leaf", albedo=(0.25, 0.7, 0.2), roughness=0.6,
                    shading_model=SHADE_LEAF)
    upright = (0.7071068, 0.7071068, 0.0, 0.0)   # the plane's +z -> -y
    for model, pos, quat, mat, opaque in (
            (ground, (0.0, 0.0, 0.0), None, white, False),
            (cube, (-1.3, 0.9, 0.5), (0.924, 0.0, 0.0, 0.383), red, False),
            (sphere, (0.3, 1.3, 0.8), None, gold, False),
            (panel, (-1.1, -0.4, 1.1), upright, leaf, False),
            (panel, (1.1, -0.9, 1.1), upright, leaf, True)):
        inst = ModelInstance(model)
        inst.set_transform(pos=pos, quat=quat)
        binds = {0: mat.instance()}
        rt.add_instance(inst, binds, force_opaque=opaque)
        hy.add_instance(inst, binds)
    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -6.5, 3.0), (0.0, 0.5, 0.9), up=(0, 0, 1))
    return eng, rt, hy, cam


def build_rt_scene(width: int = 192, height: int = 192, device="cuda"):
    """The ray-traced example scene (2 shadow samples, 1 AO sample, 1
    reflection); returns (engine, RayTraceRender, camera)."""
    eng = RenderEngine(device=device, device_check=False)
    ground = Model.from_mesh(eng.scene.arena, *make_plane(size=30.0))
    sphere = Model.from_mesh(
        eng.scene.arena, *make_uv_sphere(radius=1.0, rings=16, sectors=24))
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=1.4))

    rt = eng.create_ray_trace_render(
        width=width, height=height,
        lights=Lights.make(
            [{"position": (4.0, -4.0, 7.0), "color": (160.0, 150.0, 130.0),
              "bounds": 60.0, "radius": 0.4}],
            ambient=(0.6, 0.7, 1.0, 0.3),
        ),
        shadow_samples=2, reflection_samples=1, ao_samples=1, ao_radius=2.0,
    )
    white = Material("white", albedo=(0.75, 0.75, 0.78), roughness=0.9)
    red = Material("red", albedo=(0.85, 0.1, 0.08), roughness=0.3)
    gold = Material("gold", albedo=(1.0, 0.78, 0.35), roughness=0.15,
                    metallic=1.0)
    g = ModelInstance(ground)
    rt.add_instance(g, {0: white.instance()})
    s = ModelInstance(sphere)
    s.set_transform(pos=(-0.9, 0.3, 1.0))
    rt.add_instance(s, {0: red.instance()})
    c = ModelInstance(cube)
    c.set_transform(pos=(1.5, 0.8, 0.7), quat=(0.924, 0.0, 0.0, 0.383))
    rt.add_instance(c, {0: gold.instance()})
    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -6.5, 3.2), (0.0, 0.0, 0.7), up=(0, 0, 1))
    return eng, rt, cam


def build_crowd_scene(n_inst: int = 10_000, width: int = 512,
                      height: int = 512, seed: int = 0, device="cuda"):
    """n_inst spheres and cubes uniformly in a cube, one RayTraceRender (1
    shadow sample, no AO, no reflection); returns (scene, registry, rt,
    camera)."""
    rng = np.random.default_rng(seed)
    scene = Scene(device=device)
    registry = MaterialRegistry()
    sphere = Model.from_mesh(
        scene.arena, *make_uv_sphere(radius=0.5, rings=6, sectors=8))
    cube = Model.from_mesh(scene.arena, *make_cube(size=0.7))
    side = max(4.0, float(n_inst) ** (1 / 3) * 1.3)
    rt = RayTraceRender(
        scene, registry, width=width, height=height,
        lights=Lights.make(
            [{"position": (0.0, -3.0 * side, 2.0 * side),
              "color": (40.0 * side ** 2, 38.0 * side ** 2, 34.0 * side ** 2),
              "bounds": 10.0 * side}],
            ambient=(0.6, 0.7, 1.0, 0.3),
        ),
        shadow_samples=1, reflection_samples=0, ao_samples=0,
    )
    red = Material("red", albedo=(0.8, 0.2, 0.2), roughness=0.5)
    blue = Material("blue", albedo=(0.2, 0.2, 0.8), roughness=0.5)
    for i in range(n_inst):
        m = ModelInstance(sphere if i % 2 == 0 else cube)
        m.set_transform(pos=tuple(rng.uniform(-side, side, 3)))
        rt.add_instance(m, {0: (red if i % 2 else blue).instance()})
    cam = Camera(yfov_deg=60.0, aspect=width / height, near=0.1, far=1000.0)
    cam.look_at((0.0, -2.6 * side, 1.2 * side), (0, 0, 0), up=(0, 0, 1))
    return scene, registry, rt, cam


def build_hybrid_scene(width: int = 256, height: int = 256, device="cuda"):
    """The hybrid example (a plane, a red sphere and a mirror cube; 2 shadow
    samples, 2 AO samples, 1 reflection; a second light that casts no
    shadow); returns (engine, HybridRender, camera)."""
    eng = RenderEngine(device=device, device_check=False)
    ground = Model.from_mesh(eng.scene.arena, *make_plane(size=30.0),
                             name="ground")
    sphere = Model.from_mesh(
        eng.scene.arena, *make_uv_sphere(radius=1.0, rings=20, sectors=28),
        name="sphere")
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=1.4), name="cube")
    hy = eng.create_hybrid_render(
        width=width, height=height,
        lights=Lights.make(
            [{"position": (4.0, -4.0, 7.0), "color": (160.0, 150.0, 130.0),
              "bounds": 60.0, "radius": 0.4},
             {"position": (-6.0, -3.0, 4.0), "color": (40.0, 45.0, 60.0),
              "bounds": 40.0, "cast_shadow": False}],
            ambient=(0.6, 0.7, 1.0, 0.25),
        ),
        shadow_samples=2, reflection_samples=1, ao_samples=2, ao_radius=2.0,
    )
    white = Material("white", albedo=(0.75, 0.75, 0.78), roughness=0.85)
    red = Material("red", albedo=(0.85, 0.1, 0.08), roughness=0.3)
    mirror = Material("mirror", albedo=(0.95, 0.95, 0.95), roughness=0.05,
                      metallic=1.0)
    g = ModelInstance(ground)
    hy.add_instance(g, {0: white.instance()})
    s = ModelInstance(sphere)
    s.set_transform(pos=(-0.9, 0.3, 1.0))
    hy.add_instance(s, {0: red.instance()})
    c = ModelInstance(cube)
    c.set_transform(pos=(1.5, 0.8, 0.7), quat=(0.924, 0.0, 0.0, 0.383))
    hy.add_instance(c, {0: mirror.instance()})
    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -6.5, 3.2), (0.0, 0.0, 0.7), up=(0, 0, 1))
    return eng, hy, cam


def build_big_model_scene(rings: int = 40, sectors: int = 52,
                          n_small: int = 16, width: int = 32,
                          height: int = 32, seed: int = 7, device="cuda"):
    """One big uv sphere (radius 1.2, ``rings`` x ``sectors`` quads, so
    2 x rings x sectors triangles; over 4,096 of them its BLAS is cut into
    chunks) among ``n_small`` cubes: instance i is the sphere when i % 3 ==
    0, else a cube, at a seeded uniform position in [-6, 6]^3, in a
    RayTraceRender with the default lights and samples. The defaults are
    the 24-instance, 4,160-triangle scene of the big-model tests. Returns
    (engine, rt, camera)."""
    rng = np.random.default_rng(seed)
    eng = RenderEngine(device=device, device_check=False)
    big = Model.from_mesh(eng.scene.arena, *make_uv_sphere(
        radius=1.2, rings=rings, sectors=sectors))
    cube = Model.from_mesh(eng.scene.arena, *make_cube(size=0.7))
    rt = eng.create_ray_trace_render(width=width, height=height)
    red = Material("red", albedo=(0.8, 0.2, 0.2), roughness=0.5)
    blue = Material("blue", albedo=(0.2, 0.2, 0.8), roughness=0.5)
    for i in range(n_small + (n_small + 1) // 2):
        m = ModelInstance(big if i % 3 == 0 else cube)
        m.set_transform(pos=tuple(rng.uniform(-6.0, 6.0, 3)))
        rt.add_instance(m, {0: (red if i % 2 else blue).instance()})
    cam = Camera(yfov_deg=60.0, aspect=width / height, near=0.1, far=1000.0)
    cam.look_at((0.0, -16.0, 7.0), (0, 0, 0), up=(0, 0, 1))
    return eng, rt, cam


def _checker(n, c0, c1, tiles=8):
    img = np.zeros((n, n, 3), np.uint8)
    ii, jj = np.meshgrid(range(n), range(n), indexing="ij")
    sel = ((ii * tiles // n) + (jj * tiles // n)) % 2 == 1
    img[~sel] = c0
    img[sel] = c1
    return img


def _gradient(n):
    img = np.zeros((n, n, 3), np.uint8)
    img[..., 0] = np.linspace(0, 255, n, dtype=np.uint8)[None, :]
    img[..., 2] = np.linspace(255, 0, n, dtype=np.uint8)[:, None]
    return img


def build_textured_scene(width: int = 512, height: int = 512, device="cuda"):
    """The textured example: a checker-floored ground, a gradient ball with a
    metallicRoughness map and a cube with an emissive checker; returns
    (scene, registry, RenderPass, camera)."""
    scene = Scene(device=device)
    registry = MaterialRegistry()

    ground = Model.from_mesh(scene.arena, *make_plane(size=24.0), name="ground")
    sphere = Model.from_mesh(
        scene.arena, *make_uv_sphere(radius=1.0, rings=24, sectors=32),
        name="sphere")
    cube = Model.from_mesh(scene.arena, *make_cube(size=1.4), name="cube")

    # mr map: horizontal roughness ramp (g), vertical metallic ramp (b)
    mr = np.zeros((64, 64, 3), np.uint8)
    mr[..., 1] = np.linspace(30, 255, 64, dtype=np.uint8)[None, :]
    mr[..., 2] = np.linspace(255, 0, 64, dtype=np.uint8)[:, None]

    floor_mat = Material(
        "checker-floor", albedo=(1, 1, 1), roughness=0.8,
        base_texture=_checker(128, (40, 40, 46), (200, 200, 210), tiles=16),
    )
    ball_mat = Material(
        "gradient-ball", albedo=(1, 1, 1), roughness=0.4,
        base_texture=_gradient(64), mr_texture=mr,
    )
    glow_mat = Material(
        "glow-cube", albedo=(0.2, 0.2, 0.2), roughness=0.6,
        emissive_texture=_checker(32, (0, 0, 0), (255, 140, 0), tiles=4),
    )

    rp = RenderPass(
        scene, registry, width=width, height=height,
        lights=Lights.make(
            [{"position": (4.0, -5.0, 7.0), "color": (120.0, 115.0, 105.0),
              "bounds": 60.0, "radius": 0.3}],
            ambient=(0.6, 0.7, 1.0, 0.25),
        ),
    )
    rp.add_instance(ModelInstance(ground), {0: floor_mat.instance()})
    s = ModelInstance(sphere)
    s.set_transform(pos=(-1.1, 0.4, 1.0))
    rp.add_instance(s, {0: ball_mat.instance()})
    c = ModelInstance(cube)
    c.set_transform(pos=(1.4, 0.9, 0.7), quat=(0.924, 0.0, 0.0, 0.383))
    rp.add_instance(c, {0: glow_mat.instance()})

    cam = Camera(yfov_deg=55.0, aspect=width / height, near=0.1, far=200.0)
    cam.look_at((0.0, -6.0, 3.0), (0.0, 0.0, 0.7), up=(0, 0, 1))
    return scene, registry, rp, cam


def _noisy_checker(rng, n, tiles):
    """An n x n RGB checker of two seeded colours, each texel scaled by
    seeded noise in [0.75, 1]."""
    c0, c1 = rng.integers(0, 256, (2, 3))
    img = _checker(n, c0, c1, tiles=tiles).astype(np.float32)
    img *= rng.uniform(0.75, 1.0, (n, n, 1)).astype(np.float32)
    return img.astype(np.uint8)


def _grid_textures(seed: int = 0):
    """Config 2's four materials' textures, seeded: a 1024^2 sRGB
    baseColor on each, a 512^2 metallicRoughness (g roughness, b metallic
    ramps under noise) on the first and third, a 512^2 occlusion (seeded
    dark blotches) on the second and a 256^2 emissive stripe pattern on
    the fourth. Returns four dicts of ``Material`` texture keywords."""
    rng = np.random.default_rng(seed)
    out = [dict(base_texture=_noisy_checker(rng, 1024, int(t)))
           for t in rng.integers(4, 33, 4)]
    for k in (0, 2):
        mr = np.zeros((512, 512, 3), np.uint8)
        ramp = np.linspace(40, 255, 512, dtype=np.float32)
        noise = rng.uniform(0.8, 1.0, (512, 512)).astype(np.float32)
        mr[..., 1] = (ramp[None, :] * noise).astype(np.uint8)
        mr[..., 2] = (ramp[::-1, None] * noise).astype(np.uint8)
        out[k]["mr_texture"] = mr
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32) / 512.0
    occ = np.ones((512, 512), np.float32)
    for cy, cx, r in rng.uniform(0.0, 1.0, (12, 3)):
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        occ -= 0.5 * np.exp(-d2 / (0.02 + 0.05 * r))
    out[1]["occlusion_texture"] = np.clip(occ, 0.0, 1.0)
    emis = np.zeros((256, 256, 3), np.uint8)
    emis[(np.arange(256) // 16) % 2 == 0] = rng.integers(64, 256, 3)
    out[3]["emissive_texture"] = emis
    return out


def build_textured_grid(n_instances: int, width: int, height: int,
                        seed: int = 0, device="cuda"):
    """Config 2's grid (``build_dynamic_scene``: its geometry, instances and
    camera) with its four materials textured by ``_grid_textures(seed)``;
    returns (engine, pass, camera)."""
    return build_dynamic_scene(n_instances, width, height, seed=seed,
                               device=device, textures=_grid_textures(seed))


def run_dynamic(n_instances: int = 10_000, width: int = 1920,
                height: int = 1080, frames: int = 20, device="cuda",
                built=None):
    """Config 5's animated loop, ``examples/render_dynamic.py::run``: the
    frame inputs taken once, then every frame ``animate_instances`` moves
    the instances on the device and ``render_frame_static`` draws them,
    each frame's instances fed to the next: a first frame at t = 0, then
    ``frames`` frames at t = 0.05 (i + 1). ``built`` is a
    ``build_dynamic_scene`` result to use instead of a new one (its size
    then stands). Returns (host ms of each timed frame, synchronized, last
    ldr, last aux)."""
    _, rp, cam = built or build_dynamic_scene(n_instances, width, height,
                                              device=device)
    mapping, instances, tables, table, cmat, slots, visible = (
        rp.frame_inputs(cam))
    cuda = rp.device.type == "cuda"

    def frame(instances, t):
        instances = animate_instances(instances, t)
        ldr, aux = render_frame_static(
            mapping, instances, tables, table, rp.lights, cmat, slots,
            visible, rp.tonemap_params, width=rp.width, height=rp.height,
            do_culling=True, textures=rp._cached_textures)
        return instances, ldr, aux

    instances, ldr, aux = frame(instances, 0.0)
    ms = []
    for i in range(frames):
        if cuda:
            torch.cuda.synchronize()
        t0 = _time.perf_counter()
        instances, ldr, aux = frame(instances, 0.05 * (i + 1))
        if cuda:
            torch.cuda.synchronize()
        ms.append((_time.perf_counter() - t0) * 1e3)
    return ms, ldr, aux


def _make_unique(render, indices, phases=None, resplit: bool = False):
    """Make the instances at ``indices`` unique-geometry instances (phase
    ``phases[k]``, default 0) that ``animate_vertices`` deforms in
    ``render``'s frames (``resplit``: re-split every frame)."""
    for k, i in enumerate(indices):
        inst = render.scene.instances[i]
        inst.unique_geometry = True
        inst.anim_phase = 0.0 if phases is None else float(phases[k])
    render.animate = animate_vertices
    if hasattr(render, "anim_resplit"):
        render.anim_resplit = resplit
    return render


def build_animated_rt_scene(width: int = 192, height: int = 192,
                            resplit: bool = False, device="cuda"):
    """``build_rt_scene`` with its sphere (768 triangles, 128 implicit
    leaves) a unique-geometry instance deformed by ``animate_vertices``
    (``resplit``: re-split every frame); render it with ``time=``. Returns
    (engine, rt, camera)."""
    eng, rt, cam = build_rt_scene(width, height, device=device)
    return eng, _make_unique(rt, [1], resplit=resplit), cam


def build_animated_crowd_scene(n_inst: int = 10_000, width: int = 512,
                               height: int = 512, resplit: bool = False,
                               seed: int = 0, device="cuda"):
    """``build_crowd_scene`` with one instance in 64 (index i % 64 == 0, a
    96-triangle sphere: 16 implicit leaves) a unique-geometry instance of
    phase 0.1 i deformed by ``animate_vertices``; 10k instances make 157
    of them, 2,512 anim leaves. Returns (scene, registry, rt, camera)."""
    scene, reg, rt, cam = build_crowd_scene(n_inst, width, height, seed=seed,
                                            device=device)
    ids = list(range(0, n_inst, 64))
    _make_unique(rt, ids, [0.1 * i for i in ids], resplit=resplit)
    return scene, reg, rt, cam


def build_animated_hybrid_scene(width: int = 256, height: int = 256,
                                device="cuda"):
    """``build_hybrid_scene`` with its sphere (1,120 triangles, 256 implicit
    leaves) a unique-geometry instance deformed by ``animate_vertices`` in
    the RT passes (the G-buffer keeps its rest pose, as in the JAX
    package). Returns (engine, hybrid, camera)."""
    eng, hy, cam = build_hybrid_scene(width, height, device=device)
    return eng, _make_unique(hy, [1]), cam
