"""Next-event-estimation light sampling over the flat light table (port of
vimg_tpu.lights.emitters): triangle and sphere lights, and the background,
a constant colour or an importance-sampled env map (lights/envmap.py).

Every ray picks one light uniformly and samples a point on it; per-type
results are combined by masks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vimg_tpu_torch.core.math import (cross, div, dot, length2, normalize,
                                      onb_from_normal, onb_to_world, sqrt_cr)
from vimg_tpu_torch.core.warps import (INV_4PI, sample_sphere,
                                       sample_sphere_cap, sample_triangle_uv)
from vimg_tpu_torch.lights import envmap
from vimg_tpu_torch.scene import ir


@dataclass(frozen=True)
class LightSample:
    radiance: torch.Tensor  # (B, 3) emitted toward the shading point
    wi: torch.Tensor        # (B, 3) direction shading point -> light
    pdf: torch.Tensor       # (B,) area pdf (solid angle for bg), incl. 1/L
    dist: torch.Tensor      # (B,) distance to the light point
    G: torch.Tensor         # (B,) geometry term cos/dist^2 (1 for bg)


def _emitted_one_sided(scene, mat_id, wi, n):
    emit = scene.mat_base[mat_id]
    return torch.where((dot(n, wi) < 0.0)[..., None], emit,
                       torch.zeros_like(emit))


def _sample_tri(scene: ir.Scene, tri_id, look_from, r1, r2):
    vidx = scene.tri_vidx[tri_id]
    p0 = scene.verts[vidx[:, 0]]
    p1 = scene.verts[vidx[:, 1]]
    p2 = scene.verts[vidx[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n_tri = normalize(cross(e1, e2))
    has_n = ((scene.tri_flags[tri_id] & ir.TRI_HAS_NORMALS) != 0)[:, None]
    n0 = torch.where(has_n, scene.vnormals[vidx[:, 0]], n_tri)
    n1 = torch.where(has_n, scene.vnormals[vidx[:, 1]], n_tri)
    n2 = torch.where(has_n, scene.vnormals[vidx[:, 2]], n_tri)

    u, v = sample_triangle_uv(r1, r2)
    w = 1.0 - u - v
    hit_p = p0 * u[:, None] + p1 * v[:, None] + p2 * w[:, None]
    hit_n = normalize(n0 * u[:, None] + n1 * v[:, None] + n2 * w[:, None])

    dvec = hit_p - look_from
    dist2 = length2(dvec)
    wi = normalize(dvec)
    area = sqrt_cr(torch.clamp_min(length2(cross(e2, e1)), 0.0)) * 0.5
    pdf = 1.0 / torch.clamp_min(area, 1e-20)
    G = dot(hit_n, -wi).abs() / torch.clamp_min(dist2, 1e-20)
    rad = _emitted_one_sided(scene, scene.tri_mat[tri_id], wi, hit_n)
    return rad, wi, pdf, sqrt_cr(dist2), G


def _sphere_cone(radius, d2):
    cos_max = sqrt_cr(torch.clamp(
        1.0 - (radius * radius) / torch.clamp_min(d2, 1e-20), 0.0, 1.0))
    pdf_cone = 1.0 / (2.0 * math.pi * torch.clamp_min(1.0 - cos_max, 1e-12))
    return cos_max, pdf_cone


def _sample_sphere_light(scene: ir.Scene, sph_id, look_from, r1, r2):
    center = scene.sph_center[sph_id]
    radius = scene.sph_radius[sph_id]
    to_c = look_from - center
    d2 = length2(to_c)
    inside = d2 <= radius * radius
    cos_max, pdf_cone = _sphere_cone(radius, d2)

    # outside: uniform cone toward the sphere
    dir_c_lf = normalize(to_c)
    u_ax, v_ax = onb_from_normal(dir_c_lf)
    zdir = sample_sphere_cap(r1, r2, cos_max)
    p_out = normalize(onb_to_world(u_ax, v_ax, dir_c_lf, zdir)) \
        * radius[:, None] + center
    # inside: uniform over the whole sphere
    p_in = sample_sphere(r1, r2) * radius[:, None] + center

    # the sampled point is the sampling warp's: detached (the estimator
    # holds it fixed); G stays differentiable through look_from
    hit_p = torch.where(inside[:, None], p_in, p_out).detach()
    n = normalize(hit_p - center)
    dvec = hit_p - look_from
    dist2 = length2(dvec)
    wi = normalize(dvec)
    G = dot(n, -wi).abs() / torch.clamp_min(dist2, 1e-20)
    sa = 4.0 * math.pi * radius * radius
    pdf = torch.where(inside, 1.0 / sa, pdf_cone * G)
    rad = _emitted_one_sided(scene, scene.sph_mat[sph_id], wi, n)
    return rad, wi, pdf, sqrt_cr(dist2), G


def _sample_background(scene: ir.Scene, r1, r2):
    if scene.has_envmap:
        rad, wi, pdf = envmap.env_sample(scene, r1, r2)
    else:
        wi = sample_sphere(r1, r2)
        pdf = torch.full(r1.shape, INV_4PI, device=r1.device)
        rad = scene.bg_color.expand_as(wi)
    dist = torch.full(r1.shape, float("inf"), device=r1.device)
    G = torch.ones_like(r1)
    return rad, wi, pdf, dist, G


def sample_lights(scene: ir.Scene, look_from, pick_rand, r1, r2) -> LightSample:
    """Uniformly pick one light per ray and sample it; the pdf includes the
    1/num_lights pick probability."""
    L = scene.n_lights()
    idx = (pick_rand * L).to(torch.int64).clamp(0, L - 1)
    ltype = scene.light_type[idx]
    lidx = scene.light_idx[idx]

    B = look_from.shape[0]
    dev = look_from.device
    out = (torch.zeros((B, 3), device=dev), torch.zeros((B, 3), device=dev),
           torch.zeros((B,), device=dev), torch.zeros((B,), device=dev),
           torch.zeros((B,), device=dev))
    if scene.lights_have_tri:
        out = _mix(out, _sample_tri(
            scene, lidx.clamp(0, max(scene.n_tris() - 1, 0)), look_from, r1,
            r2), ltype == ir.LIGHT_TRI)
    if scene.lights_have_sphere:
        out = _mix(out, _sample_sphere_light(
            scene, lidx.clamp(0, max(scene.n_spheres() - 1, 0)),
            look_from, r1, r2), ltype == ir.LIGHT_SPHERE)
    if scene.lights_have_bg:
        out = _mix(out, _sample_background(scene, r1, r2),
                   ltype == ir.LIGHT_BACKGROUND)

    rad, wi, pdf, dist, G = out
    return LightSample(radiance=rad, wi=wi, pdf=div(pdf, L), dist=dist, G=G)


def _mix(acc, new, mask):
    return tuple(torch.where(mask[..., None] if a.ndim == 2 else mask, n, a)
                 for a, n in zip(acc, new))


def surf_pdf(scene: ir.Scene, prim_type, prim_id, look_from, point_on_light,
             direction):
    """Area-measure pdf of a point on a hit emissive primitive (MIS weight
    of BSDF-sampled light hits)."""
    pdf = torch.zeros((prim_id.shape[0],), device=look_from.device)
    if scene.n_tris() > 0:
        vidx = scene.tri_vidx[prim_id.clamp(0, scene.n_tris() - 1)]
        p0 = scene.verts[vidx[:, 0]]
        p1 = scene.verts[vidx[:, 1]]
        p2 = scene.verts[vidx[:, 2]]
        area = sqrt_cr(torch.clamp_min(
            length2(cross(p2 - p0, p1 - p0)), 0.0)) * 0.5
        pdf = torch.where(prim_type == ir.PRIM_TRI,
                          1.0 / torch.clamp_min(area, 1e-20), pdf)
    if scene.n_spheres() > 0:
        sid = prim_id.clamp(0, scene.n_spheres() - 1)
        center = scene.sph_center[sid]
        radius = scene.sph_radius[sid]
        d2 = length2(look_from - center)
        inside = d2 <= radius * radius
        sa = 4.0 * math.pi * radius * radius
        _, pdf_cone = _sphere_cone(radius, d2)
        n = normalize(point_on_light - center)
        cosine = dot(n, -direction).abs()
        dist2 = length2(point_on_light - look_from)
        pdf_out = pdf_cone * cosine / torch.clamp_min(dist2, 1e-20)
        pdf = torch.where(prim_type == ir.PRIM_SPHERE,
                          torch.where(inside, 1.0 / sa, pdf_out), pdf)
    return pdf


def background_emit(scene: ir.Scene, direction, cone_spread=None):
    """Radiance of rays that escaped the scene; an env map reads the mip
    level the ray cone's spread angle picks."""
    if scene.has_envmap:
        return envmap.env_emit(scene, direction, cone_spread)
    return scene.bg_color.expand_as(direction)


def background_pdf(scene: ir.Scene, direction):
    if scene.has_envmap:
        return envmap.env_pdf(scene, direction)
    return torch.full(direction.shape[:-1], INV_4PI, device=direction.device)
