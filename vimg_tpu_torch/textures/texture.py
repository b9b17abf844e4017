"""Texture evaluation (port of vimg_tpu.textures.texture): constant colours,
checkerboards and mip-mapped image lookups with ray-cone LOD.

Every image texture (every mip level) lives in ONE flat (N, 3) atlas with
an (NT, L, 3) offset / width / height table, so a wavefront's fetches are
plain 1-D row gathers; vimg_tpu does them in XLA, and so they stay tensor
code here. Bilinear filtering follows the reference (pixel = wrap(uv) *
size, floor and clamp, fractional lerp, no half-texel offset); UVs wrap
by repeat only, as in vimg_tpu.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.core.math import dot, normalize
from vimg_tpu_torch.scene import ir


def _checker_color(scene: ir.Scene, tex_id, uv):
    wh = scene.tex_wh[tex_id]
    u_board = torch.floor(uv[..., 0] * wh[..., 0]).to(torch.int64)
    v_board = torch.floor(uv[..., 1] * wh[..., 1]).to(torch.int64)
    even = ((u_board + v_board) % 2) == 0
    cols = scene.tex_cols[tex_id]             # (B, 2, 3)
    return torch.where(even[..., None], cols[..., 0, :], cols[..., 1, :])


def base_color_at_hit(scene: ir.Scene, mat_id, hit, cone_width=None,
                      ray_dir=None):
    """Base colour (albedo) of each ray's material at its hit point: the
    material's colour, or its constant, checker or image texture's. The
    checker and image branches run only in scenes that hold such a
    texture (elsewhere they select nothing)."""
    col = scene.mat_base[mat_id]
    tex_id = scene.mat_tex[mat_id][..., 0]
    has_tex = tex_id >= 0
    safe_tex = tex_id.clamp_min(0)
    ttype = scene.tex_type[safe_tex]
    const_col = scene.tex_cols[safe_tex][..., 0, :]
    col = torch.where((has_tex & (ttype == ir.TEX_CONST))[..., None],
                      const_col, col)
    if scene.has_checker:
        checker = _checker_color(scene, safe_tex, hit.uv)
        col = torch.where((has_tex & (ttype == ir.TEX_CHECKER))[..., None],
                          checker, col)
    if scene.has_image_tex:
        img = image_color_at_hit(scene, safe_tex, hit, cone_width, ray_dir)
        col = torch.where((has_tex & (ttype == ir.TEX_IMAGE))[..., None],
                          img, col)
    return col


# ---------------------------------------------------------------------------
# flat atlas lookups
# ---------------------------------------------------------------------------

def _wrap_repeat(x):
    """Repeat wrapping: the fraction, negatives folded into [0, 1)."""
    f = x - torch.trunc(x)
    return torch.where(f < 0.0, 1.0 + f, f)


def _atlas_fetch_bilinear(scene: ir.Scene, level, tex_id, uv):
    """Bilinear fetch; ``level`` and ``tex_id`` are (B,) integer tensors."""
    n_levels = scene.atlas_meta.shape[1]
    level = level.clamp(0, n_levels - 1)
    meta = scene.atlas_meta[tex_id, level]   # (B, 3): offset, w, h
    off = meta[..., 0]
    w = meta[..., 1]
    h = meta[..., 2]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)

    pu = _wrap_repeat(uv[..., 0]) * wf
    pv = _wrap_repeat(uv[..., 1]) * hf
    x0 = torch.clamp(pu.to(torch.int64), torch.zeros_like(w), w - 1)
    y0 = torch.clamp(pv.to(torch.int64), torch.zeros_like(h), h - 1)
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)
    fx = (pu - x0.to(torch.float32))[..., None]
    fy = (pv - y0.to(torch.float32))[..., None]

    def at(xi, yi):
        return scene.atlas[off + yi * w + xi]

    a = at(x0, y0) * (1 - fx) + at(x1, y0) * fx
    b = at(x0, y1) * (1 - fx) + at(x1, y1) * fx
    return a * (1 - fy) + b * fy


def atlas_trilinear(scene: ir.Scene, tex_id, uv, lod):
    """Trilinear lookup (bilinear on two mip levels); ``lod`` is a float
    per ray."""
    n_levels = scene.atlas_meta.shape[1]
    lod = torch.clamp(lod, 0.0, n_levels - 1.0)
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    l0i = l0.to(torch.int64)
    c0 = _atlas_fetch_bilinear(scene, l0i, tex_id, uv)
    c1 = _atlas_fetch_bilinear(scene, l0i + 1, tex_id, uv)
    return c0 * (1 - frac) + c1 * frac


def texture_lod(scene: ir.Scene, tex_id, hit, cone_width, ray_dir):
    """Ray-cone level of detail, before the caller's fixed -2 bias."""
    meta = scene.atlas_meta[tex_id, 0]
    wh = (meta[..., 1] * meta[..., 2]).to(torch.float32)
    lam = 0.5 * torch.log2(torch.clamp_min(hit.uv_area, 1e-30)
                           / torch.clamp_min(hit.prim_area, 1e-30))
    lam = lam + torch.log2(torch.clamp_min(cone_width.abs(), 1e-30)
                           / torch.clamp_min(dot(ray_dir, hit.n_g).abs(),
                                             1e-30))
    lam = lam + 0.5 * torch.log2(torch.clamp_min(wh, 1.0))
    return torch.where(torch.isnan(lam), 0.0, lam)


def image_color_at_hit(scene: ir.Scene, tex_id, hit, cone_width, ray_dir):
    atlas_id = scene.tex_atlas[tex_id].clamp_min(0)
    if cone_width is None or ray_dir is None:
        lod = torch.zeros(hit.uv.shape[:-1], device=hit.uv.device)
    else:
        lod = texture_lod(scene, atlas_id, hit, cone_width, ray_dir) - 2.0
    return atlas_trilinear(scene, atlas_id, hit.uv, lod)


def metal_rough_at_uv(scene: ir.Scene, tex_id, uv):
    """(metallic, roughness) factors from a metal-rough texture (glTF: B =
    metal, G = rough), or (1, 1) where there is none."""
    has = tex_id >= 0
    safe = tex_id.clamp_min(0)
    c = _atlas_fetch_bilinear(scene, torch.zeros_like(safe), safe, uv)
    mr = torch.stack([c[..., 2], c[..., 1]], dim=-1)
    return torch.where(has[..., None], mr, 1.0)


def normal_at_uv(scene: ir.Scene, tex_id, uv):
    """Tangent-space normal from a normal map (the atlas stores decoded
    [-1, 1] vectors), normalised after bilinear filtering."""
    safe = tex_id.clamp_min(0)
    c = _atlas_fetch_bilinear(scene, torch.zeros_like(safe), safe, uv)
    return normalize(c)
