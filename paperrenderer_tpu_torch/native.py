"""ctypes bindings for the native scene core (``native/scenecore.cpp``).

PyTorch-port counterpart of ``paperrenderer_tpu/native.py``: the host-side
runtime pieces the reference writes in C++ — the fragmentable arena
allocator, the dirty-row delta packer of the instance SoA, and morton
coding — with the same classes and signatures.

The library is found at first use (``AVAILABLE``, ``LOADED_FROM``):

  1. the shipped ``native/libscenecore.so`` (the one the JAX package
     loads, so both packages run the same binary where it loads);
  2. otherwise (missing, or built against another C library) the port
     builds ``native/scenecore.cpp`` with the Makefile's flags into
     ``build/native/libscenecore_<hash>.so`` at the repository root, the
     hash covering the source and the flags, as ``utils/cuda_build.py``
     does for the CUDA kernels.

Where neither loads (no source, no C++ compiler) ``AVAILABLE`` is False
and the scene core runs its Python/numpy mirrors; ``BUILD_ERROR`` says
why.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "native" / "libscenecore.so"
SOURCE = ROOT / "native" / "scenecore.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-fvisibility=hidden", "-shared")

_lib = None
_tried = False
LOADED_FROM: Optional[str] = None   # "shipped" or "built", once loaded
BUILD_ERROR: Optional[str] = None


def _declare(lib) -> None:
    u64, i64, i32 = C.c_uint64, C.c_int64, C.c_int32
    fp, ip, up = (C.POINTER(C.c_float), C.POINTER(C.c_int32),
                  C.POINTER(C.c_uint64))
    lib.arena_create.restype = C.c_void_p
    lib.arena_create.argtypes = [u64, u64]
    lib.arena_destroy.argtypes = [C.c_void_p]
    lib.arena_alloc.restype = u64
    lib.arena_alloc.argtypes = [C.c_void_p, u64]
    lib.arena_free.restype = C.c_int
    lib.arena_free.argtypes = [C.c_void_p, u64]
    for name in ("arena_stack_top", "arena_live_bytes", "arena_live_count"):
        getattr(lib, name).restype = u64
        getattr(lib, name).argtypes = [C.c_void_p]
    lib.arena_compact.restype = i64
    lib.arena_compact.argtypes = [C.c_void_p, up, up, up, i64, up]

    lib.packer_create.restype = C.c_void_p
    lib.packer_create.argtypes = [i64]
    lib.packer_destroy.argtypes = [C.c_void_p]
    lib.packer_capacity.restype = i64
    lib.packer_capacity.argtypes = [C.c_void_p]
    lib.packer_grow.argtypes = [C.c_void_p, i64]
    for name in ("packer_pos", "packer_scale", "packer_quat"):
        getattr(lib, name).restype = fp
        getattr(lib, name).argtypes = [C.c_void_p]
    lib.packer_model.restype = ip
    lib.packer_model.argtypes = [C.c_void_p]
    lib.packer_set.argtypes = [C.c_void_p, i64, fp, fp, fp, i32, i32]
    lib.packer_swap_remove.argtypes = [C.c_void_p, i64, i64]
    lib.packer_dirty_count.restype = i64
    lib.packer_dirty_count.argtypes = [C.c_void_p]
    lib.packer_pack.restype = i64
    lib.packer_pack.argtypes = [C.c_void_p, i64, ip, fp, fp, fp, ip]
    lib.packer_clear_dirty.argtypes = [C.c_void_p]
    lib.morton3d.argtypes = [fp, i64, fp, fp, up]


def _build(force: bool = False) -> Path:
    """Compile ``native/scenecore.cpp`` into ``build/native/`` (reused while
    the source and the flags stay the same, unless ``force``)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build native/scenecore.cpp")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libscenecore_{digest}.so"
    if force or not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _try_load():
    """The loaded library, or None; tries the shipped file, then a build,
    once per process."""
    global _lib, _tried, LOADED_FROM, BUILD_ERROR
    if _tried:
        return _lib
    _tried = True
    errors = []
    # a cached build from another host may not load either: rebuild it once
    for origin, path in (("shipped", lambda: SHIPPED), ("built", _build),
                         ("built", lambda: _build(force=True))):
        try:
            lib = C.CDLL(str(path()))
            _declare(lib)
        except (OSError, AttributeError, RuntimeError) as exc:
            errors.append(f"{origin}: {exc}")
            continue
        _lib, LOADED_FROM = lib, origin
        return lib
    BUILD_ERROR = "; ".join(errors)
    return None


def __getattr__(name):
    # AVAILABLE is resolved at first use, so importing the package never
    # runs a compiler
    if name == "AVAILABLE":
        return _try_load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _require():
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"libscenecore could not be loaded: {BUILD_ERROR}")
    return lib


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


class NativeArena:
    """Fragmentable offset allocator (reference FragmentableBuffer parity)."""

    def __init__(self, capacity: int, alignment: int = 1):
        self._lib = _require()
        self._h = self._lib.arena_create(capacity, alignment)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.arena_destroy(self._h)
            self._h = None

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.arena_alloc(self._h, size)
        return None if off == 2**64 - 1 else off

    def free(self, offset: int) -> bool:
        return self._lib.arena_free(self._h, offset) == 0

    @property
    def stack_top(self) -> int:
        return self._lib.arena_stack_top(self._h)

    @property
    def live_bytes(self) -> int:
        return self._lib.arena_live_bytes(self._h)

    @property
    def live_count(self) -> int:
        return self._lib.arena_live_count(self._h)

    def compact(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Returns (old_offsets, new_offsets, sizes, new_top)."""
        cap = int(self.live_count)
        old = np.zeros(cap + 1, np.uint64)
        new = np.zeros(cap + 1, np.uint64)
        sizes = np.zeros(cap + 1, np.uint64)
        top = np.zeros(1, np.uint64)
        up = C.POINTER(C.c_uint64)
        n = self._lib.arena_compact(
            self._h, old.ctypes.data_as(up), new.ctypes.data_as(up),
            sizes.ctypes.data_as(up), cap + 1, top.ctypes.data_as(up))
        assert n >= 0
        return old[:n], new[:n], sizes[:n], int(top[0])


class NativeDeltaPacker:
    """Instance SoA store + dirty-row staging packer in C++."""

    def __init__(self, capacity: int):
        self._lib = _require()
        self._h = self._lib.packer_create(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.packer_destroy(self._h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.packer_capacity(self._h)

    def grow(self, new_capacity: int) -> None:
        self._lib.packer_grow(self._h, new_capacity)

    def clear_dirty(self) -> None:
        self._lib.packer_clear_dirty(self._h)

    def views(self):
        """Zero-copy numpy views of the SoA (pos, scale, quat, model),
        valid until the next ``grow``: copy them before keeping them."""
        cap = self.capacity
        lib, h = self._lib, self._h

        def view(ptr, n):
            return np.ctypeslib.as_array(ptr, shape=(n,))

        return (view(lib.packer_pos(h), cap * 3).reshape(cap, 3),
                view(lib.packer_scale(h), cap * 3).reshape(cap, 3),
                view(lib.packer_quat(h), cap * 4).reshape(cap, 4),
                view(lib.packer_model(h), cap))

    def set(self, i: int, pos=None, scale=None, quat=None, model_id=None):
        fp = C.POINTER(C.c_float)
        # keep the converted arrays alive until the call returns
        arrs = [None if a is None else _as_f32(a) for a in (pos, scale, quat)]
        ptrs = [None if a is None else a.ctypes.data_as(fp) for a in arrs]
        self._lib.packer_set(
            self._h, i, *ptrs,
            -1 if model_id is None else int(model_id),
            0 if model_id is None else 1)

    def swap_remove(self, i: int, last: int) -> None:
        self._lib.packer_swap_remove(self._h, i, last)

    @property
    def dirty_count(self) -> int:
        return self._lib.packer_dirty_count(self._h)

    def pack(self, max_rows: int):
        """Pack dirty rows -> (count, idx, pos, scale, quat, model) dense
        arrays of ``max_rows`` rows; rows past ``count`` are padding."""
        idx = np.zeros(max_rows, np.int32)
        pos = np.zeros((max_rows, 3), np.float32)
        scale = np.ones((max_rows, 3), np.float32)
        quat = np.zeros((max_rows, 4), np.float32)
        model = np.full(max_rows, -1, np.int32)
        fp = C.POINTER(C.c_float)
        ip = C.POINTER(C.c_int32)
        n = self._lib.packer_pack(
            self._h, max_rows, idx.ctypes.data_as(ip), pos.ctypes.data_as(fp),
            scale.ctypes.data_as(fp), quat.ctypes.data_as(fp),
            model.ctypes.data_as(ip))
        return n, idx, pos, scale, quat, model


def morton3d(points: np.ndarray, lo, hi) -> np.ndarray:
    """63-bit morton codes (21 bits/axis) of ``points`` over the box
    [lo, hi], from the native library -> u64[N]."""
    lib = _require()
    pts = _as_f32(points).reshape(-1, 3)
    lo, hi = _as_f32(lo), _as_f32(hi)
    out = np.zeros(pts.shape[0], np.uint64)
    fp = C.POINTER(C.c_float)
    lib.morton3d(pts.ctypes.data_as(fp), pts.shape[0], lo.ctypes.data_as(fp),
                 hi.ctypes.data_as(fp), out.ctypes.data_as(C.POINTER(C.c_uint64)))
    return out
