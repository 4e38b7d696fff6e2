"""The PyTorch port's scene core, I/O, viewer, examples and XLA route
against the JAX package, on the CPU.

Six tests, each looping over its cases and naming every case that fails
(xdist's ``--dist loadfile`` hands a file of six tests out after
tests/test_parallel_static.py, the tier-1 run's critical path):

1. the native scene core (``paperrenderer_tpu_torch.native``): the arena,
   the delta packer and ``morton3d`` against the JAX package's wrapper on
   the same calls, and the Python mirrors against both (bitwise);
   ``Scene(use_native=True/False)`` flushes against the JAX ``Scene`` on
   live rows (bitwise) and the arena's compaction remaps;
2. glTF import: the .glb of tests/test_gltf.py (copied here) and a .gltf
   with base64 and external buffers, u8/u16/u32 indices, a two-level
   hierarchy with rotation and scale, a matrix node, and RGB, RGBA,
   palette and gray+alpha PNG textures: the arena arrays and the materials
   equal the JAX loader's, world TRS within 1e-6, the decoded images
   bitwise the JAX package's (its imaging library's); a 32x32 static and
   RT frame against the JAX frames; the same .gltf with image 0 a JPEG
   and with it an Adam7-interlaced PNG, loaded as the JAX loader loads it;
3. the viewer: tests/test_viewer.py's end-to-end steps on the port's
   ``Viewer`` at 48x48, frames decoded with the port's ``read_image``;
4. the XLA route (``use_pallas=False``) against the JAX package's default
   CPU frames, which take that route, at 48x32: static, supersample=2, two
   translucent layers, the draw list (measured LDR max-channel |diff|:
   mean 8.1e-6 / 6.3e-6 / 8.1e-6 / 5.1e-7, max 1.5e-3 / 5.3e-4 / 1.5e-3 /
   4.7e-5; pinned at mean 2e-5 and max 4e-3, the draw list at 2e-6 and
   2e-4), and the 128x128 example scenes against tests/goldens/ with the
   bands of tests/test_golden_images.py, and the big model (chunked
   BLASes, which the JAX package's XLA route cannot assemble) bitwise the
   kernel route's CPU frame; the hybrid and RT frames' XLA checks sit
   beside their JAX frames in tests/test_torch_parity.py and
   tests/test_torch_rt.py;
5. every example CLI's ``main`` in-process on the CPU at 32x32;
6. ``read_image`` against the JAX package's (PIL) on every PNG colour type
   at 8 and 16 bits (palette at 1/2/4/8), interlaced and not, and on
   baseline JPEGs at 4:4:4, 4:2:2, 4:2:0 and gray, with and without
   restart intervals: bitwise; a progressive JPEG refused through
   ``load_gltf`` by its glTF image index.
"""

import base64
import dataclasses
import io
import json
import os
import struct
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import paperrenderer_tpu as JPKG
import paperrenderer_tpu_torch as TPKG
from paperrenderer_tpu import native as JN
from paperrenderer_tpu_torch import native as TN
from paperrenderer_tpu_torch.core.geometry import PyFragArena
from paperrenderer_tpu_torch.io.image import read_image
from paperrenderer_tpu_torch.ops import static_batch as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
TRS_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's tests: the tier-1 run
    puts several pytest workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _each(cases, check):
    """``check(case)`` for every case, reporting each one that fails."""
    failed = []
    for case in cases:
        try:
            check(case)
        except Exception as exc:   # noqa: BLE001 - name the case, go on
            failed.append(f"{case}: {type(exc).__name__}: {exc}")
    assert not failed, "\n".join(failed)


def _bands(img, ref, mean_tol=0.004, frac_tol=0.002, pix_thresh=0.06):
    diff = np.abs(np.asarray(img, np.float32) - ref).max(axis=-1)
    assert diff.mean() <= mean_tol, diff.mean()
    assert (diff > pix_thresh).mean() <= frac_tol, (diff > pix_thresh).mean()


def _golden(name):
    return read_image(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(
        np.float32) / 255.0


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- 1. the native scene core ---------------------------------------------------

def _native_case(case):
    assert TN.AVAILABLE and JN.AVAILABLE, TN.BUILD_ERROR
    rng = np.random.default_rng(11)
    if case == "arena":
        # the port's native arena against the JAX wrapper, and the port's
        # Python mirror against the JAX package's, on one call sequence
        from paperrenderer_tpu.core.geometry import PyFragArena as JPyFrag

        for arenas in ((TN.NativeArena(1 << 16, 4), JN.NativeArena(1 << 16, 4)),
                       (PyFragArena(1 << 16, 4), JPyFrag(1 << 16, 4))):
            r = np.random.default_rng(11)
            live = []
            for _ in range(400):
                if live and r.random() < 0.4:
                    off = live.pop(int(r.integers(len(live))))
                    assert len({a.free(off) for a in arenas}) == 1
                else:
                    size = int(r.integers(1, 300))
                    offs = {a.alloc(size) for a in arenas}
                    assert len(offs) == 1, offs
                    if None not in offs:
                        live.append(offs.pop())
                assert len({a.stack_top for a in arenas}) == 1
                assert len({a.live_count for a in arenas}) == 1
            assert len({a.free(12345677) for a in arenas}) == 1
            got, want = (a.compact() for a in arenas)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(np.asarray(g, np.uint64),
                                              np.asarray(w, np.uint64))
            assert int(got[3]) == int(want[3])
        return
    if case == "packer":
        packers = (TN.NativeDeltaPacker(16), JN.NativeDeltaPacker(16))
        n = 16
        for step in range(120):
            op = rng.random()
            if op < 0.6:
                i = int(rng.integers(n))
                vals = dict(pos=rng.normal(size=3), scale=rng.uniform(0.5, 2, 3),
                            quat=rng.normal(size=4),
                            model_id=int(rng.integers(-1, 5)))
                for k in list(vals):
                    if rng.random() < 0.2:
                        vals[k] = None
                for p in packers:
                    p.set(i, **vals)
            elif op < 0.8:
                i, last = sorted(int(x) for x in rng.integers(n, size=2))
                for p in packers:
                    p.swap_remove(i, last)
            elif op < 0.85 and n < 64:
                n += 12
                for p in packers:
                    p.grow(n)
            else:
                k = int(rng.integers(1, 10))
                outs = [p.pack(k) for p in packers]
                for g, w in zip(*outs):
                    np.testing.assert_array_equal(g, w)
            assert packers[0].dirty_count == packers[1].dirty_count
            assert packers[0].capacity == packers[1].capacity == n
            for g, w in zip(packers[0].views(), packers[1].views()):
                np.testing.assert_array_equal(g, w)
        return
    if case == "morton":
        p = np.concatenate([rng.uniform(-50, 50, (400, 3)),
                            rng.normal(size=(100, 3)) * 1e-4]).astype(np.float32)
        p[-5:, 2] = 3.0
        lo, hi = p.min(axis=0), p.max(axis=0)
        want = JN.morton3d(p, lo, hi)
        np.testing.assert_array_equal(TN.morton3d(p, lo, hi), want)
        np.testing.assert_array_equal(TS._morton_u64(p), want)
        np.testing.assert_array_equal(TS._morton_u64(p, use_native=False), want)
        return
    if case == "scene_flush":
        # the JAX Scene (native packer) against the port's, native and not
        def history(mod, **kw):
            scene = mod.Scene(**kw)
            cube = mod.Model.from_mesh(scene.arena, *mod.make_cube(0.5))
            ball = mod.Model.from_mesh(scene.arena, *mod.make_icosphere(0.3, 1))
            r = np.random.default_rng(4)
            insts, snaps = [], []

            def snap():
                a = scene.flush()
                n = scene.count
                snaps.append({f.name: _np(getattr(a, f.name))[:n].copy()
                              for f in dataclasses.fields(a)}
                             | {"model_all": _np(a.model_id).copy()})

            for k in range(150):                       # growth past 128
                inst = mod.ModelInstance(cube if k % 3 else ball)
                inst.set_transform(pos=r.uniform(-9, 9, 3),
                                   scale=float(r.uniform(0.5, 2.0)),
                                   quat=r.normal(size=4))
                scene.add_instance(inst)
                insts.append(inst)
            snap()
            for inst in insts[::5]:                    # a 30-row delta
                inst.set_transform(pos=r.uniform(-9, 9, 3), quat=r.normal(size=4))
            snap()
            for i in (3, 40, 149, 77):                 # swap-removes
                scene.remove_instance(insts[i])
            snap()
            for k in range(120):                       # grow again
                inst = mod.ModelInstance(ball)
                inst.set_transform(pos=r.uniform(-9, 9, 3))
                scene.add_instance(inst)
            snap()
            return scene, snaps

        sj, want = history(JPKG, use_native=True)
        assert sj._native is not None
        for use_native in (True, False):
            st, got = history(TPKG, use_native=use_native, device="cpu")
            assert (st._native is not None) == use_native
            for k, (g, w) in enumerate(zip(got, want)):
                for name in w:
                    np.testing.assert_array_equal(
                        g[name], w[name], f"native={use_native} step {k} {name}")
        return
    # compaction: the port's arena (native and mirror) against the JAX one
    def compaction(mod, **kw):
        arena = mod.GeometryArena(**kw)
        meshes = [mod.make_cube(0.5), mod.make_uv_sphere(1.0, 6, 8),
                  mod.make_icosphere(0.3, 1), mod.make_torus(0.6, 0.2, 8, 6),
                  mod.make_plane(2.0, 3)]
        hs = [arena.add_mesh(*m) for m in meshes]
        arena.remove_mesh(hs[1])
        arena.remove_mesh(hs[3])
        hs.append(arena.add_mesh(*mod.make_cube(0.25)))   # best fit
        remap = arena.compact()
        return arena, {k: dataclasses.astuple(v) for k, v in remap.items()}

    aj, rj = compaction(JPKG, use_native=True)
    for use_native in (True, False):
        at, rt = compaction(TPKG, use_native=use_native)
        assert isinstance(at._valloc, TN.NativeArena) == use_native
        assert rt == rj, (use_native, rt, rj)
        assert (at.vertex_count, at.tri_count) == (aj.vertex_count, aj.tri_count)
        for name in ("_pos", "_nrm", "_uv", "_idx"):
            np.testing.assert_array_equal(getattr(at, name), getattr(aj, name))


def test_native_scene_core_matches_jax():
    _each(["arena", "packer", "morton", "scene_flush", "compaction"],
          _native_case)


# -- 2. glTF -------------------------------------------------------------------

def _make_glb(path):
    """A .glb with one triangle-pair quad mesh, a red material, two nodes
    (tests/test_gltf.py's)."""
    positions = np.asarray(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    normals = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    indices = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    bin_parts = [positions.tobytes(), normals.tobytes(), indices.tobytes()]
    offsets, off = [], 0
    for part in bin_parts:
        offsets.append(off)
        off += len(part)
        off += -off % 4
    binary = b"".join(part + b"\x00" * (-len(part) % 4) for part in bin_parts)
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0, "translation": [0, 0, 0]},
            {"mesh": 0, "translation": [3, 0, 0], "scale": [2, 2, 2],
             "rotation": [0, 0, 0.7071068, 0.7071068]},
        ],
        "meshes": [{"name": "quad", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2,
            "material": 0}]}],
        "materials": [{
            "name": "red",
            "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.1, 0.1, 1.0],
                                     "roughnessFactor": 0.4,
                                     "metallicFactor": 0.0},
            "emissiveFactor": [0.1, 0.0, 0.0]}],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0], "byteLength": 48},
            {"buffer": 0, "byteOffset": offsets[1], "byteLength": 48},
            {"buffer": 0, "byteOffset": offsets[2], "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * (-len(json_bytes) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_bytes), b"JSON"))
        f.write(json_bytes)
        f.write(struct.pack("<I4s", len(binary), b"BIN\x00"))
        f.write(binary)


def _png(img, mode=None, **kw):
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(img, mode) if mode else Image.fromarray(img)
    if kw.pop("quantize", None):
        im = im.quantize(kw.pop("colors"))
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _jpeg(img, **kw):
    """``img`` written by PIL as a JPEG (``kw``: quality, subsampling,
    restart_marker_blocks, progressive)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(samples, depth):
    """Samples [h, w, c] (u8, u16, or sub-byte values) -> the rows of a PNG
    pass, each filtered with one of the five filters in turn."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.reshape(h, -1).astype(np.uint8)
    else:   # sub-byte: pack high bits first
        per = 8 // depth
        flat = samples.reshape(h, -1)
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        rows = np.zeros((h, flat.shape[1] // per), np.uint8)
        for k in range(per):
            rows |= flat[:, k::per].astype(np.uint8) << (8 - depth * (k + 1))
    bpp = max(1, c * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        r, ft = rows[y].astype(np.int64), y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 3:
            pred = (left + prev) >> 1
        elif ft == 4:   # Paeth
            pa = np.abs(prev - upleft)
            pb = np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = (0, left, prev)[ft]
        out.append(bytes([ft]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _png_raw(samples, color, depth, interlace, palette=None, trns=None):
    """A PNG of ``samples`` [h, w, c] in any colour type and depth, Adam7
    interlaced or not (the forms PIL reads but does not write)."""
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w = samples.shape[:2]
    if interlace:
        raw = b"".join(_png_rows(samples[y0::dy, x0::dx], depth)
                       for x0, y0, dx, dy in _ADAM7 if w > x0 and h > y0)
    else:
        raw = _png_rows(samples, depth)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                   int(interlace))),
        chunk(b"PLTE", palette.tobytes()) if palette is not None else b"",
        chunk(b"tRNS", trns.tobytes()) if trns is not None else b"",
        chunk(b"IDAT", zlib.compress(raw)), chunk(b"IEND", b"")])


def _textures(rng):
    """RGB, RGBA, palette (4-bit, with tRNS) and gray+alpha PNGs."""
    rgb = rng.integers(0, 256, (16, 16, 3), np.uint8)
    return dict(
        rgb=_png(rgb),
        rgba=_png(rng.integers(0, 256, (8, 8, 4), np.uint8)),
        palette=_png(rgb, quantize=True, colors=12, bits=4, transparency=3),
        gray_alpha=_png(rng.integers(0, 256, (8, 16, 2), np.uint8), "LA"),
    )


def _make_gltf(dirname, image0=None):
    """A .gltf: buffer 0 a base64 data: URI, buffer 1 an external file; a
    u8-indexed quad, a u16-indexed box and a u32-indexed BLEND quad with
    uvs; textures as a bufferView, a data: URI and an external file; a
    rotated, scaled root with a child and grandchild, and a matrix node.
    ``image0`` (encoded bytes) replaces image 0."""
    rng = np.random.default_rng(21)
    tex = _textures(rng)
    if image0 is not None:
        tex["rgb"] = image0
    quad = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                      np.float32)
    quad_uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    from paperrenderer_tpu_torch.core.geometry import make_cube

    bpos, bidx, bnrm, buv = make_cube(1.0)
    parts0, parts1, views = [], [], []
    accessors = []

    def add(parts, buffer, arr, ctype, typ, count):
        off = sum(len(p) for p in parts)
        data = arr.tobytes()
        parts.append(data + b"\x00" * (-len(data) % 4))
        views.append({"buffer": buffer, "byteOffset": off,
                      "byteLength": len(data)})
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": count, "type": typ})
        return len(accessors) - 1

    a_qpos = add(parts0, 0, quad, 5126, "VEC3", 4)
    a_quv = add(parts0, 0, quad_uv, 5126, "VEC2", 4)
    a_qidx8 = add(parts0, 0, np.asarray([0, 1, 2, 0, 2, 3], np.uint8), 5121,
                  "SCALAR", 6)
    a_bpos = add(parts1, 1, bpos, 5126, "VEC3", len(bpos))
    a_bnrm = add(parts1, 1, bnrm, 5126, "VEC3", len(bnrm))
    a_buv = add(parts1, 1, buv, 5126, "VEC2", len(buv))
    a_bidx16 = add(parts1, 1, bidx.reshape(-1).astype(np.uint16), 5123,
                   "SCALAR", bidx.size)
    a_qidx32 = add(parts1, 1, np.asarray([0, 2, 1, 0, 3, 2], np.uint32), 5125,
                   "SCALAR", 6)
    # image 0 (RGB) as a bufferView of buffer 0, image 3 (gray+alpha) of 1
    off0 = sum(len(p) for p in parts0)
    parts0.append(tex["rgb"] + b"\x00" * (-len(tex["rgb"]) % 4))
    views.append({"buffer": 0, "byteOffset": off0,
                  "byteLength": len(tex["rgb"])})
    v_rgb = len(views) - 1
    off1 = sum(len(p) for p in parts1)
    parts1.append(tex["gray_alpha"])
    views.append({"buffer": 1, "byteOffset": off1,
                  "byteLength": len(tex["gray_alpha"])})
    v_la = len(views) - 1
    with open(os.path.join(dirname, "palette.png"), "wb") as f:
        f.write(tex["palette"])
    buf0, buf1 = b"".join(parts0), b"".join(parts1)
    with open(os.path.join(dirname, "ext.bin"), "wb") as f:
        f.write(buf1)
    rot_z = [0.0, 0.0, 0.38268343, 0.9238795]      # 45 degrees about z
    rot_x = [0.25881904, 0.0, 0.0, 0.9659258]       # 30 degrees about x
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, -0.25, 0.0], "rotation": rot_z,
             "scale": [1.5, 1.5, 1.5], "children": [1]},
            {"mesh": 1, "translation": [1.0, 0.0, 0.5], "rotation": rot_x,
             "scale": [0.5, 0.5, 0.5], "children": [2]},
            {"mesh": 2, "translation": [0.0, 2.0, 0.0]},
            {"mesh": 1, "matrix": [0.8, 0, 0, 0, 0, 0.8, 0, 0, 0, 0, 0.8, 0,
                                   -2.0, 0.5, -1.0, 1]},
        ],
        "meshes": [
            {"name": "quad8", "primitives": [{
                "attributes": {"POSITION": a_qpos, "TEXCOORD_0": a_quv},
                "indices": a_qidx8, "material": 0}]},
            {"name": "box16", "primitives": [{
                "attributes": {"POSITION": a_bpos, "NORMAL": a_bnrm,
                               "TEXCOORD_0": a_buv},
                "indices": a_bidx16, "material": 1}]},
            {"name": "glass32", "primitives": [{
                "attributes": {"POSITION": a_qpos, "TEXCOORD_0": a_quv},
                "indices": a_qidx32, "material": 2}]},
        ],
        "materials": [
            {"name": "rgb-base", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 3},
                "roughnessFactor": 0.6, "metallicFactor": 0.2},
             "emissiveTexture": {"index": 1}, "emissiveFactor": [0.3, 0.2, 0.1]},
            {"name": "palette-base", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 2},
                "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                "roughnessFactor": 0.3, "metallicFactor": 0.0},
             "occlusionTexture": {"index": 3}},
            {"name": "glass", "alphaMode": "BLEND", "pbrMetallicRoughness": {
                "baseColorFactor": [0.2, 0.4, 0.9, 0.5],
                "roughnessFactor": 0.1, "metallicFactor": 0.0}},
        ],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2},
                     {"source": 3}],
        "images": [
            {"bufferView": v_rgb, "mimeType": "image/png"},
            {"uri": "data:image/png;base64,"
             + base64.b64encode(tex["rgba"]).decode()},
            {"uri": "palette.png"},
            {"bufferView": v_la, "mimeType": "image/png"},
        ],
        "buffers": [
            {"byteLength": len(buf0), "uri": "data:application/octet-stream;"
             "base64," + base64.b64encode(buf0).decode()},
            {"byteLength": len(buf1), "uri": "ext.bin"},
        ],
        "bufferViews": views,
        "accessors": accessors,
    }
    path = os.path.join(dirname, "scene.gltf")
    with open(path, "w") as f:
        json.dump(gltf, f)
    return path


def _gltf_frames(mod, path, rt):
    """A 32x32 frame of a glTF file through ``mod``'s loader (static, or
    ray-traced with one sample of each kind)."""
    from importlib import import_module

    render_mod = import_module(mod.__name__ + ".render")
    gltf_mod = import_module(mod.__name__ + ".io.gltf")
    kw = {} if mod is JPKG else {"device": "cpu"}
    scene = mod.Scene(**kw)
    registry = mod.MaterialRegistry()
    gs = gltf_mod.load_gltf(path, scene.arena)
    if rt:
        r = render_mod.RayTraceRender(scene, registry, width=32, height=32,
                                      shadow_samples=1, reflection_samples=1,
                                      ao_samples=1)
    else:
        r = render_mod.RenderPass(scene, registry, width=32, height=32,
                                  translucent_layers=2)
    gltf_mod.instantiate(gs, r)
    cam = mod.Camera(yfov_deg=60.0, aspect=1.0, near=0.1, far=100.0)
    cam.look_at((0.5, -6.0, 4.0), (0.0, 0.5, 0.0), up=(0, 0, 1))
    return np.asarray(r.render(cam)[0])


def _gltf_case(case, tmp):
    from paperrenderer_tpu.io import gltf as JG
    from paperrenderer_tpu_torch.io import gltf as TG

    if case.startswith("glb"):
        path = os.path.join(tmp, "quad.glb")
        if not os.path.exists(path):
            _make_glb(path)
    else:   # gltf_*: PNG textures; jpeg_load / interlaced_load: image 0
        rgb = np.random.default_rng(5).integers(0, 256, (8, 8, 3), np.uint8)
        image0 = dict(jpeg_load=lambda: _jpeg(rgb),
                      interlaced_load=lambda: _png_raw(rgb, 2, 8, True)).get(
                          case, lambda: None)()
        d = os.path.join(tmp, case if image0 is not None else "gltf")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "scene.gltf")
        if not os.path.exists(path):
            _make_gltf(d, image0)
    if case.endswith("_frames"):
        for rt in (False, True):
            want = _gltf_frames(JPKG, path, rt)
            got = _gltf_frames(TPKG, path, rt)
            assert got.shape == want.shape == (32, 32, 3)
            _bands(got, want)
            assert got.max() > 0.05                    # something drawn
        return
    aj, at = JPKG.GeometryArena(), TPKG.GeometryArena()
    gj, gt = JG.load_gltf(path, aj), TG.load_gltf(path, at)
    assert (at.vertex_count, at.tri_count) == (aj.vertex_count, aj.tri_count)
    for name in ("_pos", "_nrm", "_uv", "_idx"):
        np.testing.assert_array_equal(getattr(at, name), getattr(aj, name))
    assert [m.name for m in gt.models] == [m.name for m in gj.models]
    assert len(gt.materials) == len(gj.materials)
    for mt, mj in zip(gt.materials, gj.materials):
        for k in ("name", "albedo", "emissive", "roughness", "metallic",
                  "alpha", "shading_model"):
            assert getattr(mt, k) == getattr(mj, k), (mt.name, k)
        for k in ("base_texture", "emissive_texture", "mr_texture",
                  "occlusion_texture"):
            a, b = getattr(mt, k), getattr(mj, k)
            assert (a is None) == (b is None), (mt.name, k)
            if a is not None:
                assert a.dtype == b.dtype == np.uint8
                np.testing.assert_array_equal(a, b, f"{mt.name} {k}")
    assert [[s for s in d] for d in gt.model_slot_materials] == [
        [s for s in d] for d in gj.model_slot_materials]
    assert len(gt.instances) == len(gj.instances)
    for (mi_t, *trs_t), (mi_j, *trs_j) in zip(gt.instances, gj.instances):
        assert mi_t == mi_j
        for a, b in zip(trs_t, trs_j):
            np.testing.assert_allclose(a, b, rtol=0, atol=TRS_TOL)
    if case == "gltf_load":
        kinds = {m.name: m for m in gt.materials}
        assert kinds["palette-base"].base_texture.shape == (16, 16, 4)
        assert kinds["rgb-base"].mr_texture.shape == (8, 16, 4)
        assert kinds["glass"].shading_model == TPKG.core.material.SHADE_TRANSLUCENT


def test_gltf_import_matches_jax(tmp_path):
    _each(["glb_load", "gltf_load", "glb_frames", "gltf_frames",
           "jpeg_load", "interlaced_load"],
          lambda c: _gltf_case(c, str(tmp_path)))


# -- 3. the viewer ---------------------------------------------------------------

def _viewer_scene(width=48, height=48):
    scene = TPKG.Scene(device="cpu")
    registry = TPKG.MaterialRegistry()
    pos, idx, nrm, uv = TPKG.make_uv_sphere(radius=1.0, rings=8, sectors=12)
    model = TPKG.Model.from_mesh(scene.arena, pos, idx, nrm, uv)
    red = TPKG.Material("red", albedo=(1.0, 0.1, 0.1), roughness=0.4)
    rp = TPKG.RenderPass(scene, registry, width=width, height=height)
    rp.add_instance(TPKG.ModelInstance(model), {0: red.instance()})
    cam = TPKG.Camera(aspect=width / height)
    cam.look_at((0.0, -3.0, 0.0), (0.0, 0.0, 0.0))
    return rp, cam


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:   # 4xx still carries a JSON body
        return json.loads(e.read())


def _viewer_case(case):
    stats = TPKG.StatisticsTracker()
    rp, cam = _viewer_scene()
    direct = (np.clip(rp.render(cam)[0].numpy(), 0, 1) * 255 + 0.5).astype(
        np.uint8)
    renders = {"raster": rp}
    if case == "modes":
        rp2, _ = _viewer_scene()
        renders["b"] = rp2
    v = TPKG.Viewer(renders, cam, statistics=stats).start()
    try:
        assert v.wait_frame(1, timeout=120.0)
        base = v.url
        if case == "modes":
            _post(base + "/mode", {"mode": "b"})
            assert json.loads(_get(base + "/modes"))["active"] == "b"
            i = v._frame_index
            assert v.wait_frame(i + 2, timeout=120.0)
            mats_a = json.loads(_get(base + "/materials?mode=raster"))
            assert mats_a["mode"] == "raster"
            rid = [m for m in mats_a["materials"] if m["name"] == "red"][0]["id"]
            ok = _post(base + "/material", {"id": rid, "mode": "raster",
                                            "updates": {"roughness": 0.9}})
            assert ok == {"ok": True}
            mats = json.loads(_get(base + "/materials?mode=raster"))
            assert [m for m in mats["materials"]
                    if m["name"] == "red"][0]["roughness"] == 0.9
            assert "error" not in json.loads(_get(base + "/stats"))
            return
        assert "paperrenderer_tpu" in _get(base + "/").decode()
        img = read_image(_get(base + "/frame.png"))
        assert img.shape == (48, 48, 3)
        np.testing.assert_array_equal(img, direct)    # the same camera
        c = img[24, 24]
        assert int(c[0]) > int(c[1]) and int(c[0]) > int(c[2])
        s = json.loads(_get(base + "/stats"))
        assert s["frame"] >= 1 and s["mode"] == "raster" and s["width"] == 48
        assert "error" not in s
        mats = json.loads(_get(base + "/materials"))["materials"]
        red = [m for m in mats if m["name"] == "red"]
        assert len(red) == 1 and red[0]["albedo"] == [1.0, 0.1, 0.1]
        idx0 = v._frame_index
        _post(base + "/material",
              {"id": red[0]["id"], "updates": {"albedo": [0.1, 1.0, 0.1]}})
        assert v.wait_frame(idx0 + 2, timeout=120.0)
        c2 = read_image(_get(base + "/frame.png"))[24, 24]
        assert int(c2[1]) > int(c2[0])
        assert "error" in _post(base + "/material",
                                {"id": red[0]["id"], "updates": {"width": 1}})
        _post(base + "/camera", {"pos": [0.0, -6.0, 0.0], "yaw": 0.0,
                                 "pitch": 0.0})
        idx1 = v._frame_index
        assert v.wait_frame(idx1 + 2, timeout=120.0)
        assert json.loads(_get(base + "/modes")) == {"modes": ["raster"],
                                                     "active": "raster"}
        assert "error" in _post(base + "/mode", {"mode": "nope"})
        assert "error" not in json.loads(_get(base + "/stats"))
    finally:
        v.stop()


def test_viewer_end_to_end():
    """tests/test_viewer.py's steps on the port's Viewer: the page, a
    decodable frame equal to a direct render, stats without an error,
    materials, a live edit reaching the next frames, a bad edit refused,
    a camera move, the modes; and a mode switch with panel-scoped edits."""
    _each(["end_to_end", "modes"], _viewer_case)


# -- 4. the XLA route --------------------------------------------------------------

def _glass(render, shade):
    """Make the example scene's red sphere a 50% glass."""
    for obj in render.materials.objects():
        base = getattr(obj, "base", obj)
        if base.name == "red":
            base.shading_model, base.alpha = shade, 0.5
            render.materials.update(obj)
    render.invalidate()


def _xla_case(case):
    from examples.render_scene import build_example_scene as build_jax
    from paperrenderer_tpu.core.material import SHADE_TRANSLUCENT as JT
    from paperrenderer_tpu_torch import scenes
    from paperrenderer_tpu_torch.core.material import SHADE_TRANSLUCENT as TT

    if case == "big_model":
        # chunked BLASes: assembled paged, traced through the flat view
        _, rt, cam = scenes.build_big_model_scene(width=16, height=16,
                                                  device="cpu")
        want = rt.render(cam)[1]["hdr"]
        rt._frame, rt.use_pallas = 0, False
        got = rt.render(cam)[1]["hdr"]
        assert torch.isfinite(got).all()
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    if case in ("raster_example", "hybrid_example", "rt_example",
                "textured_example"):
        if case == "raster_example":
            r, cam = scenes.build_example_scene(128, 128, device="cpu")
        elif case == "textured_example":
            r, cam = scenes.build_textured_scene(128, 128, device="cpu")[2:]
        else:
            build = (scenes.build_hybrid_scene if case == "hybrid_example"
                     else scenes.build_rt_scene)
            _, r, cam = build(128, 128, device="cpu")
        r.use_pallas = False
        ldr, aux = r.render(cam)
        assert torch.isfinite(aux["hdr"]).all()
        _bands(ldr.numpy(), _golden(case))
        return
    rp, cam = scenes.build_example_scene(48, 32, device="cpu")
    xla = TPKG.RenderPass(rp.scene, rp.materials, width=48, height=32,
                          lights=rp.lights, use_pallas=False)
    xla._bindings, xla._visible = rp._bindings, rp._visible
    rpj, camj = build_jax(48, 32)
    assert not rpj.use_pallas                   # JAX's CPU default route
    kw, mean_tol, max_tol = {}, 2e-5, 4e-3
    if case == "supersample2":
        xla.supersample = rpj.supersample = 2
    elif case == "translucent2":
        _glass(xla, TT)
        _glass(rpj, JT)
        xla.translucent_layers = rpj.translucent_layers = 2
    elif case == "draw_list":
        kw, mean_tol, max_tol = dict(static_path=False), 2e-6, 2e-4
    ldr, aux = xla.render(cam, **kw)
    want, aux_j = rpj.render(camj, **kw)
    diff = np.abs(ldr.numpy() - np.asarray(want)).max(axis=-1)
    assert diff.mean() <= mean_tol and diff.max() <= max_tol, (
        diff.mean(), diff.max())
    assert int(aux["total_tris"]) == int(aux_j["total_tris"])
    if kw:
        assert int(aux["draw_count"]) == int(aux_j["draw_count"])
    else:
        assert int(aux["required_work"]) == 0   # no pair table: no K1
    if case == "translucent2":                  # the glass shows
        opaque = rp.render(cam)[0].numpy()
        assert np.abs(ldr.numpy() - opaque).max() > 0.05


def test_xla_route_matches_jax_and_goldens():
    """``use_pallas=False`` against the JAX package's default CPU frames
    (the XLA route there too), against the pinned goldens that route
    made, and on chunked BLASes against the kernel route."""
    _each(["static", "supersample2", "translucent2", "draw_list",
           "raster_example", "rt_example", "hybrid_example",
           "textured_example", "big_model"], _xla_case)


# -- 5. the examples ----------------------------------------------------------------

EXAMPLES = {
    "render_scene": [], "render_rt": [], "render_hybrid": [],
    "render_textured": ["--rt"], "render_crowd": ["--n", "100"],
    "render_dynamic": ["--n", "100"], "view_scene": ["--rt", "--port", "0"],
}


def test_examples_run(tmp_path):
    """Every example module's ``main`` on the CPU at 32x32, its PNG read
    back (view_scene serves 3 frames and writes the last one)."""
    from importlib import import_module

    def run(name):
        mod = import_module(f"paperrenderer_tpu_torch.examples.{name}")
        out = str(tmp_path / f"{name}.png")
        frames = ["--frames", "3" if name == "view_scene" else "0"]
        assert mod.main(["--cpu", "--size", "32", "--out", out] + frames
                        + EXAMPLES[name]) == 0
        img = read_image(out)
        assert img.shape == (32, 32, 3) and img.max() > 0

    _each(list(EXAMPLES), run)


# -- 6. image formats --------------------------------------------------------------


def _smooth(rng, h, w, c):
    """A photo-like u8 image (smooth waves and noise): JPEG's material."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) + 1.0) * 120.0
                    for k in range(c)], axis=-1)
    return np.clip(img + rng.normal(0.0, 12.0, img.shape), 0,
                   255).astype(np.uint8)


def _image_case(case, tmp):
    from paperrenderer_tpu.io.image import read_image as jax_read
    from paperrenderer_tpu_torch.io import gltf as TG

    rng = np.random.default_rng(sum(map(ord, case)))
    kind, *rest = case.split("_")
    if kind == "progressive":   # refused through glTF, by image index
        d = os.path.join(tmp, case)
        os.makedirs(d)
        data = _jpeg(_smooth(rng, 16, 16, 3), progressive=True)
        with pytest.raises(NotImplementedError,
                           match="glTF image 0.*progressive JPEG"):
            TG.load_gltf(_make_gltf(d, data), TPKG.GeometryArena())
        return
    datas = []
    for h, w in ((13, 11), (37, 53), (1, 1), (9, 5)):
        if kind == "jpeg":      # jpeg_<subsampling>_<restart blocks>
            sub, rst = rest
            gray = sub == "gray"
            img = _smooth(rng, h, w, 1 if gray else 3)
            kw = dict(quality=85 if h % 2 else 50,
                      restart_marker_blocks=int(rst))
            if not gray:
                kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[sub]
            datas.append(_jpeg(img[..., 0] if gray else img, **kw))
        else:                   # png_<colour type>_<depth>_<interlace>
            color, depth, interlace = (int(v) for v in rest)
            c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
            hi = 1 << depth
            img = rng.integers(0, hi, (h, w, c)).astype(
                np.uint16 if depth == 16 else np.uint8)
            if color == 0 and depth == 16:
                img[0, 0] = 200           # below PIL's clip at 255
            palette = trns = None
            if color == 3:
                palette = rng.integers(0, 256, (hi, 3), np.uint8)
                trns = rng.integers(0, 256, (max(1, hi // 2),), np.uint8)
            if depth == 8 and not interlace and color != 3:   # PIL writes it
                mode = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[color]
                datas.append(_png(img[..., 0] if c == 1 else img, mode))
            elif color == 0 and depth == 16 and not interlace:
                datas.append(_png(img[..., 0]))                 # "I;16"
            else:
                datas.append(_png_raw(img, color, depth, interlace, palette,
                                      trns))
    for data in datas:
        want, got = jax_read(data), read_image(data)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def test_image_formats_match_jax(tmp_path):
    """``read_image`` bitwise the JAX package's (PIL's decode) on the PNG
    forms (every colour type at 8 and 16 bits, palette at 1/2/4/8, each
    interlaced and not; PIL writes the 8-bit non-interlaced and 16-bit gray
    ones, the test's own writer the rest, with all five row filters) and
    on PIL's baseline JPEGs at 4:4:4, 4:2:2, 4:2:0 and gray, with and
    without a restart interval, at four sizes (odd ones among them); a
    progressive JPEG as a glTF image raises naming image 0 and the form."""
    png = [f"png_{c}_{d}_{i}" for c in (0, 2, 4, 6) for d in (8, 16)
           for i in (0, 1)]
    png += [f"png_3_{d}_{i}" for d in (1, 2, 4, 8) for i in (0, 1)]
    jpeg = [f"jpeg_{s}_{r}" for s in ("444", "422", "420", "gray")
            for r in (0, 2)]
    _each(png + jpeg + ["progressive"],
          lambda c: _image_case(c, str(tmp_path)))
