"""Host-side texture pipeline: decode, convert, mip-build, atlas-pack
(port of vimg_tpu.textures.mipmap; numpy, copied so that both packages
build the same atlas bytes).

Mip chains use the reference's 8-tap GPU-friendly AA downsampling filter
(Wronski weights 0.37487566 / -0.12487566, src/image_texture.cpp:98-122).
All textures (all mip levels) are packed into ONE flat (N, 3) float32 atlas
with an integer offset table, so device-side fetches are plain 1-D row
gathers (no per-texture arrays, no padding-to-max).
"""
from __future__ import annotations

import numpy as np


def srgb_to_linear(img01):
    img01 = np.asarray(img01, np.float32)
    return np.where(img01 <= 0.04045, img01 / 12.92,
                    ((img01 + 0.055) / 1.055) ** 2.4).astype(np.float32)


def rgb_to_normal(img255, scale=1.0):
    """RGB [0,255] -> tangent-space normals, glTF convention
    (reference image_texture.cpp:268-279)."""
    n = np.asarray(img255, np.float32) / 127.5 - 1.0
    n[..., 0] *= scale
    n[..., 1] *= scale
    length = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return (n / length).astype(np.float32)


def _bilinear(img, u, v):
    """Clamp-mode bilinear sample of (H, W, 3) at arrays u, v in [0,1]
    (matches reference col_at_uv_mipmap with pixel_u = u*W, floor+clamp)."""
    H, W = img.shape[:2]
    pu = np.clip(u, 0.0, 1.0) * W
    pv = np.clip(v, 0.0, 1.0) * H
    x0 = np.clip(pu.astype(np.int32), 0, W - 1)
    y0 = np.clip(pv.astype(np.int32), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (pu - x0)[..., None]
    fy = (pv - y0)[..., None]
    a = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    b = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return a * (1 - fy) + b * fy


_W0 = 0.37487566
_W1 = -0.12487566
_TAPS = [(_W0, -0.75777, -0.75777), (_W0, 0.75777, -0.75777),
         (_W0, 0.75777, 0.75777), (_W0, -0.75777, 0.75777),
         (_W1, -2.907, 0.0), (_W1, 2.907, 0.0),
         (_W1, 0.0, -2.907), (_W1, 0.0, 2.907)]

MAX_MIP_LEVELS = 15


def build_mip_chain(image):
    """Reference-equivalent mip pyramid (image_texture.cpp:60-129)."""
    image = np.asarray(image, np.float32)
    H, W = image.shape[:2]
    size = min(W, H)
    n_levels = min(int(np.ceil(np.log2(max(float(size), 2.0)))),
                   MAX_MIP_LEVELS)
    mips = [image]
    pw, ph = W, H
    for _ in range(1, max(n_levels, 1)):
        nw, nh = max(pw // 2, 1), max(ph // 2, 1)
        ys, xs = np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij")
        u = 2.0 * xs / pw
        v = 2.0 * ys / ph
        acc = np.zeros((nh, nw, 3), np.float32)
        prev = mips[-1]
        for wgt, du, dv in _TAPS:
            acc += wgt * _bilinear(prev, u + du / pw, v + dv / ph)
        mips.append(np.maximum(acc, 0.0).astype(np.float32))
        pw, ph = nw, nh
    return mips


class AtlasBuilder:
    """Packs mip chains into one flat buffer + (NT, L, 3) offset table."""

    def __init__(self):
        self.chunks = []
        self.metas = []   # per texture: list of (offset, w, h)
        self.total = 0

    def add(self, image, build_mips=True):
        mips = build_mip_chain(image) if build_mips else [np.asarray(
            image, np.float32)]
        meta = []
        for m in mips:
            h, w = m.shape[:2]
            self.chunks.append(m.reshape(-1, 3))
            meta.append((self.total, w, h))
            self.total += w * h
        self.metas.append(meta)
        return len(self.metas) - 1

    def finalize(self):
        """Returns (atlas (N,3) f32, meta (NT, L, 3) i32, n_levels)."""
        if not self.chunks:
            return (np.zeros((1, 3), np.float32),
                    np.zeros((1, 1, 3), np.int32), 1)
        max_l = max(len(m) for m in self.metas)
        meta = np.zeros((len(self.metas), max_l, 3), np.int32)
        for i, m in enumerate(self.metas):
            for l in range(max_l):
                # clamp to the texture's last level (lookups never go past)
                meta[i, l] = m[min(l, len(m) - 1)]
        atlas = np.concatenate(self.chunks, axis=0).astype(np.float32)
        return atlas, meta, max_l
