"""Tonemapping, sRGB encoding and PNG output (port of
vimg_tpu.render.film). Operators take and return linear (H, W, 3) or
(N, 3) float32 tensors.

A tonemapped frame has the same bits on the card as on the CPU: colour
matrices are products and sums in a fixed order (a matmul's order of
additions and fused multiply-adds are its library's), log2 and pow are
taken in float64 and rounded to float32 (CUDA's and the CPU's float32
versions round an ulp apart on some inputs; the float64 values round to
the same float32 but in near-ties, about 2^-29 of inputs), and divides
by Python numbers go through core.math.div.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from vimg_tpu_torch.core.math import div, luminance

# AgX (reference src/tonemap/agx.cpp); rows are glm's column-major
# constructor transposed
_AGX_MAT = ((0.842479062253094, 0.0784335999999992, 0.0792237451477643),
            (0.0423282422610123, 0.878468636469772, 0.0791661274605434),
            (0.0423756549057051, 0.0784336, 0.879142973793104))
_AGX_MAT_INV = ((1.19687900512017, -0.0980208811401368, -0.0990297440797205),
                (-0.0528968517574562, 1.15190312990417, -0.0989611768448433),
                (-0.0529716355144438, -0.0980434501171241, 1.15107367264116))
_ACES_IN = ((0.59719, 0.35458, 0.04823),
            (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.60475, -0.53108, -0.07367),
             (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def _mat(rows, col):
    """``rows`` (3x3, rounded to float32) times each colour, summed in
    (r, g, b) order."""
    c0, c1, c2 = col[..., 0], col[..., 1], col[..., 2]
    m = np.asarray(rows, np.float32).tolist()
    return torch.stack([c0 * r[0] + c1 * r[1] + c2 * r[2] for r in m],
                       dim=-1)


def _log2(x):
    return torch.log2(x.double()).float()


def _pow(x, e):
    """x ** e with e rounded to float32 first, as a float32 pow takes it."""
    return torch.pow(x.double(), float(np.float32(e))).float()


def _agx_contrast(x):
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(col):
    min_ev, max_ev = -12.47393, 4.026069
    val = torch.clamp(_log2(torch.clamp_min(_mat(_AGX_MAT, col), 1e-10)),
                      min_ev, max_ev)
    val = _agx_contrast(div(val - min_ev, max_ev - min_ev))
    # the default AgX look is identity
    val = torch.clamp_min(_mat(_AGX_MAT_INV, val), 0.0)
    return _pow(val, 2.2)


def aces(col):
    v = _mat(_ACES_IN, col)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return _mat(_ACES_OUT, a / b)


def reinhard(col):
    lum = luminance(col)
    largest = lum.max()
    new_l = lum * (1.0 + lum / torch.clamp_min(largest * largest, 1e-20)) \
        / (1.0 + lum)
    scale = torch.where(lum > 0.0, new_l / torch.clamp_min(lum, 1e-20),
                        torch.zeros_like(lum))
    return col * scale[..., None]


def clamp01(col):
    return torch.clamp(col, 0.0, 1.0)


TONEMAPPERS = {"clamp": clamp01, "agx": agx, "reinhard": reinhard,
               "aces": aces}


def srgb_encode(col):
    col = torch.clamp(col, 0.0, 1.0)
    return torch.where(col < 0.0031308, col * 12.92,
                       1.055 * _pow(torch.clamp_min(col, 1e-10), 1.0 / 2.4)
                       - 0.055)


def srgb_decode(col):
    return torch.where(col <= 0.04045, div(col, 12.92),
                       _pow(div(col + 0.055, 1.055), 2.4))


def finalize(image_linear, tonemap="clamp"):
    """Linear HDR -> display sRGB in [0, 1]; NaN pixels are magenta."""
    out = srgb_encode(TONEMAPPERS[tonemap](image_linear))
    nan = torch.isnan(image_linear).any(dim=-1, keepdim=True)
    magenta = torch.tensor([1.0, 0.0, 1.0], device=out.device)
    return torch.where(nan, magenta, out)


def write_png(path, srgb01):
    """8-bit RGB PNG from an (H, W, 3) image in [0, 1] (stdlib zlib)."""
    if isinstance(srgb01, torch.Tensor):
        srgb01 = srgb01.detach().cpu().numpy()
    img = (np.clip(np.asarray(srgb01), 0, 1) * 255).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
