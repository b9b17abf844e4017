"""HDR environment map (port of vimg_tpu.lights.envmap): a lat-long
radiance map with luminance * sin(theta) importance sampling.

The sampler draws the reference's texel distribution through an alias
table over the flat (H * W,) texels (Vose's method, built on the host in
numpy at load time), and the solid-angle pdf rides a per-texel table shared
by the sampler and the MIS pdf query, so the two never disagree. One 24-bit
uniform feeds the texel, the accept draw and the sub-texel offset dv, as in
vimg_tpu. Rotations are written out as products and sums in a fixed order,
and every divide by a Python number goes through ``core.math.div``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vimg_tpu_torch.core.math import div, normalize

PI = np.pi


def build_env_tables(image: np.ndarray, env_to_world=None, radiance_scale=1.0,
                     n_mips=None):
    """Host-side construction of the env fields of ir.build_scene (numpy
    arrays; ``env_mips`` a list of levels). image: (H, W, 3) float32
    linear radiance."""
    image = np.asarray(image, np.float32)
    H, W, _ = image.shape
    lum = image @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    v = (np.arange(H, dtype=np.float32) + 0.5) / H
    sin_el = np.sin(PI * v)
    weighted = lum * sin_el[:, None]

    # flat texel distribution -> alias tables (Vose) + per-texel pdf
    flat_w = weighted.reshape(-1).astype(np.float64)
    total = flat_w.sum()
    N = flat_w.size
    if total > 0:
        p = flat_w / total
    else:
        p = np.full(N, 1.0 / N)
    prob, alias = _build_alias(p)
    # solid-angle pdf = p_texel * W*H / (2 pi^2 sin(theta)); the sin
    # factor is continuous in the sampled point, so it divides at use
    pdf_w = (p * (W * H) / (2.0 * PI * PI)).astype(np.float32)

    # mip chain (simple 2x2 box; env lookups only need coarse LOD)
    mips = [image]
    m = image
    if n_mips is None:
        n_mips = max(1, int(np.floor(np.log2(max(H, W)))) + 1)
    while len(mips) < n_mips and min(m.shape[0], m.shape[1]) >= 2:
        h2, w2 = m.shape[0] // 2, m.shape[1] // 2
        m = m[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 3).mean(axis=(1, 3))
        mips.append(m)

    if env_to_world is None:
        env_to_world = np.eye(4, dtype=np.float32)
    env_to_world = np.asarray(env_to_world, np.float32)
    world_to_env = np.linalg.inv(env_to_world)

    return dict(
        env_mips=mips,
        env_alias=alias,
        env_prob=prob,
        env_pdf_w=pdf_w,
        env_to_world=env_to_world,
        world_to_env=world_to_env,
        env_scale=np.float32(radiance_scale))


def _build_alias(p):
    """Vose's alias method: O(N) build of (prob, alias) such that
    sampling j0 ~ U{0..N-1}, accepting j0 with probability prob[j0] and
    falling back to alias[j0] draws texel j with probability p[j]."""
    N = p.size
    scaled = p * N
    alias = np.zeros(N, np.int32)
    prob = np.ones(N, np.float32)
    small = [i for i in range(N) if scaled[i] < 1.0]
    large = [i for i in range(N) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = np.float32(scaled[s_i])
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def _rotate(m, v):
    """Rows of the 3x3 block of ``m`` dotted with v, summed in (x, y, z)
    order (vimg_tpu: v @ m[:3, :3].T)."""
    return torch.stack([m[r, 0] * v[..., 0] + m[r, 1] * v[..., 1]
                        + m[r, 2] * v[..., 2] for r in range(3)], dim=-1)


def _lat_long(scene, world_dir):
    """(u, v) of a world direction in the map's lat-long parametrisation."""
    d = normalize(_rotate(scene.world_to_env, world_dir))
    u = (1.0 + div(torch.atan2(-d[..., 0], d[..., 2]), math.pi)) * 0.5
    v = div(torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)), math.pi)
    return u, v


def env_sample(scene, r1, r2):
    """Importance-sample the env map. Returns (radiance, wi,
    pdf_solid_angle). r1 picks the alias slot (its fractional residual is
    the accept draw, rescaled after the accept / reject into the sub-texel
    dv); r2 is the sub-texel du."""
    H = scene.env_mips[0].shape[0]
    W = scene.env_mips[0].shape[1]
    N = H * W
    x = r1 * N
    j0 = x.to(torch.int64).clamp(0, N - 1)
    a = x - j0.to(torch.float32)              # accept draw in [0, 1)
    pr = scene.env_prob[j0]
    accept = a < pr
    j = torch.where(accept, j0, scene.env_alias[j0])
    # rescale the accept residual into a fresh uniform: a/pr on accept,
    # (a-pr)/(1-pr) on reject
    dv = torch.where(accept, a / torch.clamp_min(pr, 1e-12),
                     (a - pr) / torch.clamp_min(1.0 - pr, 1e-12))
    dv = torch.clamp(dv, 0.0, 1.0 - 1e-7)
    du = r2

    row = j // W
    col = j % W
    u = div(col.to(torch.float32) + du, W)
    v = div(row.to(torch.float32) + dv, H)

    elevation = v * math.pi
    y = torch.cos(elevation)
    azimuth = u * 2.0 * math.pi
    sin_el = torch.sin(elevation)
    x3 = torch.sin(azimuth) * sin_el
    z3 = -torch.cos(azimuth) * sin_el
    wi = torch.stack([x3, y, z3], dim=-1)
    wi = normalize(_rotate(scene.env_to_world, wi))

    pdf = scene.env_pdf_w[j] / torch.clamp_min(sin_el, 1e-8)
    rad = _bilinear_level(scene.env_mips[0], u, v) * scene.env_scale
    return rad, wi, pdf


def env_pdf(scene, world_dir):
    """Solid-angle pdf of a direction: one gather from the per-texel table
    the sampler uses."""
    H = scene.env_mips[0].shape[0]
    W = scene.env_mips[0].shape[1]
    u, v = _lat_long(scene, world_dir)
    col = (u * W).to(torch.int64).clamp(0, W - 1)
    row = (v * H).to(torch.int64).clamp(0, H - 1)
    sin_el = torch.sin(math.pi * v)
    return scene.env_pdf_w[row * W + col] / torch.clamp_min(sin_el, 1e-8)


def _bilinear_level(img, u, v):
    """Bilinear fetch from one mip level, repeat-wrapped in u and clamped
    in v (lat-long)."""
    Hh, Ww = img.shape[0], img.shape[1]
    x = u * Ww - 0.5
    y = v * Hh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64) % Ww
    x1i = (x0i + 1) % Ww
    y0i = y0.to(torch.int64).clamp(0, Hh - 1)
    y1i = (y0i + 1).clamp(0, Hh - 1)
    c00 = img[y0i, x0i]
    c10 = img[y0i, x1i]
    c01 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    a = c00 * (1 - fx)[..., None] + c10 * fx[..., None]
    b = c01 * (1 - fx)[..., None] + c11 * fx[..., None]
    return a * (1 - fy)[..., None] + b * fy[..., None]


def _bilinear_flat(flat, off, h, w, u, v):
    """Bilinear fetch from a flattened mip pyramid with per-lane level
    geometry (off / h / w are (B,) integer tensors): repeat wrap in u,
    clamped v, value-identical to _bilinear_level at the lane's level."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), torch.zeros_like(h), h - 1)
    y1i = torch.clamp(y0i + 1, torch.zeros_like(h), h - 1)
    c00 = flat[off + y0i * w + x0i]
    c10 = flat[off + y0i * w + x1i]
    c01 = flat[off + y1i * w + x0i]
    c11 = flat[off + y1i * w + x1i]
    a = c00 * (1 - fx) + c10 * fx
    b = c01 * (1 - fx) + c11 * fx
    return a * (1 - fy) + b * fy


# the flat mip pyramid of a scene's env map, built once a scene for
# forward renders: (id of the levels tuple, the levels' versions) ->
# (levels, flat (N, 3), offsets, heights, widths)
_PYRAMIDS = {}


def _flat_pyramid(mips):
    """The levels ``mips`` as one flat (N, 3) tensor with per-level
    offsets, heights and widths. Cached while no level needs a gradient
    (a cached ``flat`` would hold a graph that a backward frees, and an
    optimizer's in-place step keeps the tuple's id) and keyed on every
    level's version, so a level written in place is never read stale."""
    key = (id(mips), tuple(m._version for m in mips))
    hit = _PYRAMIDS.get(key)
    if hit is not None and hit[0] is mips:
        return hit[1:]
    dev = mips[0].device
    flat = torch.cat([m.reshape(-1, 3) for m in mips])
    hs = np.array([m.shape[0] for m in mips], np.int64)
    ws = np.array([m.shape[1] for m in mips], np.int64)
    offs = np.concatenate([[0], np.cumsum(hs * ws)[:-1]]).astype(np.int64)
    entry = (mips, flat, *(torch.from_numpy(x).to(dev)
                           for x in (offs, hs, ws)))
    if not flat.requires_grad:
        if len(_PYRAMIDS) > 8:
            _PYRAMIDS.clear()
        _PYRAMIDS[key] = entry
    return entry[1:]


def env_emit(scene, world_dir, cone_spread):
    """Radiance of a direction that escaped the scene: a lat-long lookup,
    trilinear between the two mip levels the ray cone's spread angle
    picks, read from the scene's flat mip pyramid."""
    u, v = _lat_long(scene, world_dir)

    H = scene.env_mips[0].shape[0]
    lam = torch.log2(torch.clamp_min(cone_spread.abs(), 1e-20)
                     * (H / math.pi))
    lam = torch.where(torch.isnan(lam), 0.0, lam) - 2.0
    n_levels = len(scene.env_mips)
    lam = torch.clamp(lam, 0.0, n_levels - 1.0)
    l0 = torch.floor(lam)
    frac = (lam - l0)[..., None]

    flat, offs_t, hs_t, ws_t = _flat_pyramid(scene.env_mips)
    l0i = l0.to(torch.int64).clamp(0, n_levels - 1)
    l1i = torch.clamp_max(l0i + 1, n_levels - 1)
    c0 = _bilinear_flat(flat, offs_t[l0i], hs_t[l0i], ws_t[l0i], u, v)
    c1 = _bilinear_flat(flat, offs_t[l1i], hs_t[l1i], ws_t[l1i], u, v)
    return (c0 * (1.0 - frac) + c1 * frac) * scene.env_scale
