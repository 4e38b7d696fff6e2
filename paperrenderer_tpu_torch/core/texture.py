"""Texture atlas and its samplers.

PyTorch counterpart of ``paperrenderer_tpu/core/texture.py`` (reference
``Image``: staged upload, blit-chain mip generation, views and samplers,
src/PaperRenderer/VulkanResources.cpp:640-1003). Every texture and its
box-filtered mip chain is packed into one atlas by a host shelf packer;
the host code is the JAX package's, so both packages build the same atlas
bit for bit:

  * texels are stored as x-adjacent PAIRS, ``pairs i32[H*W, 2]`` holding
    (texel[x], texel[x+1]) as RGBA8 little-endian words (the second
    clamped at the atlas edge), so one bilinear tap row is one row gather
    and a bilinear sample two;
  * ``rects f32[T, MAX_MIPS, 4]`` holds each (texture, mip)'s placement
    (x, y, w, h); levels past a texture's chain repeat its last mip;
  * the mip level is an explicit argument: the deferred shade computes it
    from image-space uv derivatives (``uv_screen_lod``).

Colors are linearized (sRGB -> linear) at upload, as the reference's
``VK_FORMAT_*_SRGB`` views do in hardware. The samplers are plain tensor
ops (gathers and elementwise math) on the atlas's device; the JAX
package's ``select_rows`` TPU gather workaround becomes direct indexing,
which is exact, as its "exact" path is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_to

MAX_MIPS = 8


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    a = x / 255.0
    return np.where(a <= 0.04045, a / 12.92, ((a + 0.055) / 1.055) ** 2.4)


def _to_rgba8(img: np.ndarray, srgb: bool) -> np.ndarray:
    """Any (h, w, 1|3|4) u8/f32 image -> linear RGBA8."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    if srgb:
        lin = np.clip(_srgb_to_linear(img[..., :3].astype(np.float32)) * 255.0
                      + 0.5, 0, 255).astype(np.uint8)
        img = np.concatenate([lin, img[..., 3:]], axis=-1) if img.shape[-1] == 4 \
            else lin
    h, w, c = img.shape
    if c == 1:
        img = np.repeat(img, 3, axis=-1)
        c = 3
    if c == 3:
        img = np.concatenate(
            [img, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return img


def _mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Box-filtered mip chain (the reference's linear blit chain,
    VulkanResources.cpp:865-1003), down to 1x1, capped at MAX_MIPS."""
    mips = [img]
    while len(mips) < MAX_MIPS and max(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        m = mips[-1].astype(np.float32)
        h, w = m.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        m = m[: h2 * 2, : w2 * 2]
        if h > 1:
            m = (m[0::2] + m[1::2]) * 0.5
        if w > 1:
            m = (m[:, 0::2] + m[:, 1::2]) * 0.5
        mips.append((m + 0.5).astype(np.uint8))
    return mips


@dataclasses.dataclass(frozen=True)
class TextureArrays:
    """Device view of the atlas."""

    pairs: torch.Tensor       # i32[H*W, 2] — (texel[x], texel[x+1]) RGBA8 words
    rects: torch.Tensor       # f32[T, MAX_MIPS, 4] — (x, y, w, h) per (tex, mip)
    mip_counts: torch.Tensor  # i32[T]
    width: int = 0            # atlas width in texels

    @property
    def count(self) -> int:
        return self.rects.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.pairs, self.rects, self.mip_counts))

    def to(self, device) -> "TextureArrays":
        return tree_to(self, device)


class TextureAtlas:
    """Host-side shelf packer; uploads the atlas to a device when asked and
    again only after a texture was added."""

    def __init__(self, width: int = 1024):
        self.width = width
        self._shelves: List[Tuple[int, int, int]] = []  # (y, height, x_used)
        self._height = 0
        self._entries: List[List[Tuple[int, int, int, int]]] = []  # per tex: mip rects
        self._images: List[List[np.ndarray]] = []
        self._host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._device: Dict[str, TextureArrays] = {}

    def _place(self, w: int, h: int) -> Tuple[int, int]:
        for i, (y, sh, x) in enumerate(self._shelves):
            if sh >= h and x + w <= self.width:
                self._shelves[i] = (y, sh, x + w)
                return x, y
        y = self._height
        self._shelves.append((y, h, w))
        self._height += h
        return 0, y

    def add(self, image: np.ndarray, srgb: bool = True) -> int:
        """Register a texture; returns its id. Builds + places its mip chain."""
        rgba = _to_rgba8(image, srgb)
        if rgba.shape[1] > self.width:
            raise ValueError(f"texture {rgba.shape[1]} texels wide, wider "
                             f"than the {self.width}-texel atlas")
        mips = _mip_chain(rgba)
        rects = []
        for m in mips:
            h, w = m.shape[:2]
            x, y = self._place(w, h)
            rects.append((x, y, w, h))
        tid = len(self._entries)
        self._entries.append(rects)
        self._images.append(mips)
        self._host = None
        self._device = {}
        return tid

    @property
    def count(self) -> int:
        return len(self._entries)

    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pairs i32[H*W, 2], rects f32[T, MAX_MIPS, 4], mip_counts i32[T])
        as numpy, built once per set of textures."""
        if self._host is not None:
            return self._host
        h = max(1, self._height)
        w = self.width
        atlas = np.zeros((h, w, 4), np.uint8)
        t = max(1, len(self._entries))
        rects = np.zeros((t, MAX_MIPS, 4), np.float32)
        mip_counts = np.ones((t,), np.int32)
        for tid, (mips, rlist) in enumerate(zip(self._images, self._entries)):
            mip_counts[tid] = len(mips)
            for lvl, (m, (x, y, mw, mh)) in enumerate(zip(mips, rlist)):
                atlas[y : y + mh, x : x + mw] = m
                rects[tid, lvl] = (x, y, mw, mh)
            for lvl in range(len(mips), MAX_MIPS):
                rects[tid, lvl] = rects[tid, len(mips) - 1]
        words = atlas.reshape(h, w, 4).view(np.uint32)[..., 0]  # RGBA8 LE words
        # x-adjacent pairs (clamped at the atlas edge): one gather = one tap row
        nxt = np.concatenate([words[:, 1:], words[:, -1:]], axis=1)
        pairs = np.stack([words, nxt], axis=-1).reshape(h * w, 2)
        self._host = (pairs.view(np.int32), rects, mip_counts)
        return self._host

    def device_arrays(self, device="cpu") -> TextureArrays:
        """The atlas on ``device``, uploaded once per device and set of
        textures."""
        key = str(torch.empty(0, device=device).device)   # "cuda" -> "cuda:0"
        if key not in self._device:
            pairs, rects, mip_counts = self.host_arrays()
            self._device[key] = TextureArrays(
                pairs=torch.from_numpy(pairs).to(device),
                rects=torch.from_numpy(rects).to(device),
                mip_counts=torch.from_numpy(mip_counts).to(device),
                width=self.width)
        return self._device[key]


def select_rows(table: torch.Tensor, ids: torch.Tensor, *,
                exact: bool = False) -> torch.Tensor:
    """``table[ids]`` as the JAX package's ``select_rows`` gives it: a table
    of at most 64 rows yields zeros for an id outside it, a larger one
    clamps the id. A plain gather (the JAX package's select accumulation
    and packed row gathers are TPU gather costs); ``exact`` is accepted for
    its signature: the gather is always exact."""
    del exact
    n = table.shape[0]
    idx = torch.clamp(ids, 0, n - 1).long()
    out = table[idx]
    if n <= 64:
        inside = ((ids >= 0) & (ids < n)).reshape(
            ids.shape + (1,) * (table.dim() - 1))
        out = torch.where(inside, out, torch.zeros((), dtype=table.dtype,
                                                    device=table.device))
    return out


def _decode_rgba(words: torch.Tensor) -> torch.Tensor:
    """i32 RGBA8 words [...] -> f32[..., 4] in [0, 1]: each word's bytes,
    R, G, B, A from the lowest (the atlas's little-endian words), read
    through a uint8 view. The same values as shifting and masking each
    channel (a word whose alpha is >= 128 is negative as int32; its bytes
    are not), in two elementwise ops instead of nine."""
    return (words.contiguous().view(torch.uint8)
            .reshape(words.shape + (4,)).to(torch.float32) * (1.0 / 255.0))


def _rect_lookup(tex: TextureArrays, tex_id: torch.Tensor,
                 lod: torch.Tensor) -> torch.Tensor:
    """(x, y, w, h) f32[..., 4] of each sample's (texture, mip): the id
    clipped into the table, the lod truncated toward zero and clipped to
    the texture's chain."""
    tid = torch.clamp(tex_id.long(), 0, tex.count - 1)
    mips = tex.mip_counts[tid]
    lvl = torch.minimum(torch.clamp(lod.to(torch.int32), min=0), mips - 1)
    return tex.rects[tid, lvl.long()]


def _bilinear_tap(tex: TextureArrays, rect: torch.Tensor,
                  uv: torch.Tensor) -> torch.Tensor:
    """One bilinear tap inside a placement rect -> f32[..., 4] (two paired-
    texel row gathers; repeat wrap)."""
    rx, ry, rw, rh = rect.unbind(dim=-1)
    u = uv[..., 0] - torch.floor(uv[..., 0])   # repeat wrap
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = u * rw - 0.5
    fy = v * rh - 0.5
    x0 = torch.minimum(torch.clamp(torch.floor(fx), min=0.0),
                       torch.clamp(rw - 2.0, min=0.0))
    y0 = torch.minimum(torch.clamp(torch.floor(fy), min=0.0),
                       torch.clamp(rh - 1.0, min=0.0))
    # rw == 1: the paired second texel belongs to an atlas neighbor — zero it
    ax = torch.where(rw >= 2.0, torch.clamp(fx - x0, 0.0, 1.0), 0.0)[..., None]
    ay = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
    y1 = torch.minimum(y0 + 1.0, rh - 1.0)

    gx = (rx + x0).to(torch.int32)
    gy0 = (ry + y0).to(torch.int32)
    gy1 = (ry + y1).to(torch.int32)
    w = tex.width
    n = tex.pairs.shape[0]
    row0 = tex.pairs[torch.clamp(gy0 * w + gx, 0, n - 1).long()]   # [..., 2]
    row1 = tex.pairs[torch.clamp(gy1 * w + gx, 0, n - 1).long()]
    c0 = _decode_rgba(row0)   # [..., 2, 4]: texels x0 and x0 + 1 of row y0
    c1 = _decode_rgba(row1)
    top = c0[..., 0, :] * (1.0 - ax) + c0[..., 1, :] * ax
    bot = c1[..., 0, :] * (1.0 - ax) + c1[..., 1, :] * ax
    return top * (1.0 - ay) + bot * ay


def sample_bilinear(tex: TextureArrays, tex_id: torch.Tensor,
                    uv: torch.Tensor,
                    lod: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear (nearest-mip) sample -> f32[..., 4] linear RGBA; ``tex_id``
    i32[...] (negative: no texture, white), ``uv`` f32[..., 2], ``lod``
    f32[...] (None: mip 0). Two row gathers a sample; repeat wrap."""
    if lod is None:
        lod = torch.zeros(tex_id.shape, dtype=torch.float32,
                          device=tex_id.device)
    out = _bilinear_tap(tex, _rect_lookup(tex, tex_id, lod), uv)
    return torch.where((tex_id >= 0)[..., None], out, 1.0)


def sample_trilinear(tex: TextureArrays, tex_id: torch.Tensor,
                     uv: torch.Tensor,
                     lod: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trilinear sample -> f32[..., 4]: bilinear taps in the two mips
    around ``lod`` lerped by its fraction (VK_SAMPLER_MIPMAP_MODE_LINEAR,
    VulkanResources.cpp:787-794); four row gathers a sample."""
    if lod is None:
        return sample_bilinear(tex, tex_id, uv)
    l0 = torch.floor(lod)
    frac = torch.clamp(lod - l0, 0.0, 1.0)[..., None]
    c0 = _bilinear_tap(tex, _rect_lookup(tex, tex_id, l0), uv)
    c1 = _bilinear_tap(tex, _rect_lookup(tex, tex_id, l0 + 1.0), uv)
    out = c0 * (1.0 - frac) + c1 * frac
    return torch.where((tex_id >= 0)[..., None], out, 1.0)


def sample_aniso2(tex: TextureArrays, tex_id: torch.Tensor, uv: torch.Tensor,
                  lod: torch.Tensor,
                  duv_major: torch.Tensor) -> torch.Tensor:
    """2-tap anisotropic filter: two trilinear taps at +-1/4 of the
    major-axis uv footprint ``duv_major`` f32[..., 2], each at the minor-axis
    ``lod`` (``uv_screen_lod_aniso``)."""
    off = duv_major * 0.25
    c0 = sample_trilinear(tex, tex_id, uv - off, lod)
    c1 = sample_trilinear(tex, tex_id, uv + off, lod)
    return (c0 + c1) * 0.5


def _uv_diffs(uv: torch.Tensor):
    """Forward differences of an f32[H, W, 2] uv image along x and y, the
    last column / row repeated (0)."""
    return (torch.diff(uv, dim=1, append=uv[:, -1:]),
            torch.diff(uv, dim=0, append=uv[-1:]))


def uv_screen_lod(uv: torch.Tensor, rw: torch.Tensor,
                  rh: torch.Tensor) -> torch.Tensor:
    """Mip level from image-space uv derivatives: f32[H, W, 2] uv image and
    per-pixel texture extents -> f32[H, W] (the deferred-shading analogue
    of fragment-quad derivatives)."""
    duv_dx, duv_dy = _uv_diffs(uv)
    du_dx, du_dy = duv_dx.abs(), duv_dy.abs()
    fx = torch.maximum(du_dx[..., 0] * rw, du_dx[..., 1] * rh)
    fy = torch.maximum(du_dy[..., 0] * rw, du_dy[..., 1] * rh)
    foot = torch.clamp(torch.maximum(fx, fy), min=1e-8)
    return torch.clamp(torch.log2(foot), 0.0, MAX_MIPS - 1.0)


def uv_screen_lod_aniso(uv: torch.Tensor, rw: torch.Tensor, rh: torch.Tensor,
                        max_aniso: float = 2.0):
    """``(lod, duv_major)``: the lod of the MINOR footprint axis (the
    major/minor ratio capped at ``max_aniso``) and the major-axis uv
    derivative for ``sample_aniso2``'s tap offsets."""
    duv_dx, duv_dy = _uv_diffs(uv)
    fx = torch.maximum(duv_dx[..., 0].abs() * rw, duv_dx[..., 1].abs() * rh)
    fy = torch.maximum(duv_dy[..., 0].abs() * rw, duv_dy[..., 1].abs() * rh)
    major = torch.clamp(torch.maximum(fx, fy), min=1e-8)
    minor = torch.maximum(torch.minimum(fx, fy), major / max_aniso)
    lod = torch.clamp(torch.log2(minor), 0.0, MAX_MIPS - 1.0)
    duv_major = torch.where((fx >= fy)[..., None], duv_dx, duv_dy)
    return lod, duv_major
