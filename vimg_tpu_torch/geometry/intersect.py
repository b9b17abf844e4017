"""Batched ray-primitive intersection (port of vimg_tpu.geometry.intersect).

- Triangles: the watertight test (pbrt / Woop et al.), boundary hits
  accepted when all edge signs agree.
- Spheres: the numerically robust quadric (RT Gems 1 ch.7).
- ``hit_info``: deferred shading data for the surviving hit: interpolated
  vertex normals on TRI_HAS_NORMALS triangles, UVs, the dpdu / dpdv frame,
  normal maps, anisotropic tangents and the mean curvature of ray cones.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vimg_tpu_torch.core.math import (cross, div, dot, dotk, gram_schmidt,
                                      normalize, onb_from_normal, sqrt_cr)
from vimg_tpu_torch.scene import ir

INF = float("inf")


def tri_intersect(ro, rd, p0, p1, p2, minT, maxT):
    """Watertight ray/triangle intersection, broadcasting rays vs tris.

    Returns (t, u, v, w, hit) with t = +inf on miss; (u, v, w) weight
    (p0, p1, p2)."""
    p0t, p1t, p2t = p0 - ro, p1 - ro, p2 - ro
    adx, ady, adz = rd[..., 0].abs(), rd[..., 1].abs(), rd[..., 2].abs()
    kz0 = (adx >= ady) & (adx >= adz)
    kz1 = (~kz0) & (ady >= adz)

    def _perm(v):
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        # kz=0 -> (kx,ky,kz)=(1,2,0); kz=1 -> (2,0,1); kz=2 -> (0,1,2)
        px = torch.where(kz0, y, torch.where(kz1, z, x))
        py = torch.where(kz0, z, torch.where(kz1, x, y))
        pz = torch.where(kz0, x, torch.where(kz1, y, z))
        return px, py, pz

    dx, dy, dz = _perm(rd)
    p0x, p0y, p0z = _perm(p0t)
    p1x, p1y, p1z = _perm(p1t)
    p2x, p2y, p2z = _perm(p2t)

    sx = -dx / dz
    sy = -dy / dz
    sz = 1.0 / dz
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z

    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x

    same_sign = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
                  & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ok = same_sign & (det != 0.0)

    t_scaled = e0 * (p0z * sz) + e1 * (p1z * sz) + e2 * (p2z * sz)
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = torch.where(det != 0.0, 1.0 / safe, torch.zeros_like(det))
    t = t_scaled * inv_det
    ok = ok & (t >= minT) & (t <= maxT)

    c = cross(p2 - p0, p1 - p0)
    degenerate = (c * c).sum(-1) == 0.0
    ok = ok & ~degenerate.expand_as(ok)

    u = e0 * inv_det
    v = e1 * inv_det
    w = e2 * inv_det
    t = torch.where(ok, t, torch.full_like(t, INF))
    return t, u, v, w, ok


def sphere_intersect(ro, rd, center, radius, minT, maxT):
    """Robust ray/sphere intersection. Returns (t, hit), t = +inf on miss."""
    f = ro - center
    a = dot(rd, rd)
    b_prime = dot(-f, rd)
    c = dot(f, f) - radius * radius
    temp = f + (b_prime / a)[..., None] * rd
    disc = radius * radius - dot(temp, temp)
    has_root = disc >= 0.0

    one = torch.ones_like(disc)
    sign = torch.where(b_prime > 0, one, -one)
    disc_safe = torch.where(has_root, torch.clamp_min(a * disc, 1e-30), one)
    q = b_prime + sign * sqrt_cr(disc_safe)
    x0 = c / torch.where(q == 0.0, one, q)
    x1 = q / a
    t0 = torch.minimum(x0, x1)
    t1 = torch.maximum(x0, x1)

    t0_ok = (t0 >= minT) & (t0 <= maxT)
    t1_ok = (t1 >= minT) & (t1 <= maxT)
    t = torch.where(t0_ok, t0, t1)
    ok = has_root & (t0_ok | t1_ok)
    return torch.where(ok, t, torch.full_like(t, INF)), ok


@dataclass(frozen=True)
class HitResult:
    t: torch.Tensor          # (B,) f32, +inf on miss
    prim_type: torch.Tensor  # (B,) i64 (PRIM_TRI / PRIM_SPHERE)
    prim_id: torch.Tensor    # (B,) i64
    u: torch.Tensor          # (B,) barycentric weight of p0 (tris only)
    v: torch.Tensor          # (B,) barycentric weight of p1

    @property
    def hit(self):
        return torch.isfinite(self.t)


def _tri_points(scene: ir.Scene):
    p = scene.verts[scene.tri_vidx]          # (T, 3, 3)
    return p[None, :, 0], p[None, :, 1], p[None, :, 2]


def intersect_bruteforce(scene: ir.Scene, ro, rd, minT, maxT):
    """Closest hit against every primitive. ro/rd: (B, 3)."""
    B = ro.shape[0]
    dev = ro.device
    best_t = torch.full((B,), INF, device=dev)
    best_type = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_id = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((B,), device=dev)
    best_v = torch.zeros((B,), device=dev)

    if scene.n_tris() > 0:
        t, u, v, _, _ = tri_intersect(ro[:, None], rd[:, None],
                                      *_tri_points(scene),
                                      minT[:, None], maxT[:, None])
        tmin, ti = t.min(dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_type = torch.where(better, ir.PRIM_TRI, best_type)
        best_id = torch.where(better, ti, best_id)
        best_u = torch.where(better, u.gather(1, ti[:, None])[:, 0], best_u)
        best_v = torch.where(better, v.gather(1, ti[:, None])[:, 0], best_v)

    if scene.n_spheres() > 0:
        t, _ = sphere_intersect(ro[:, None], rd[:, None],
                                scene.sph_center[None], scene.sph_radius[None],
                                minT[:, None], maxT[:, None])
        smin, si = t.min(dim=1)
        better = smin < best_t
        best_t = torch.where(better, smin, best_t)
        best_type = torch.where(better, ir.PRIM_SPHERE, best_type)
        best_id = torch.where(better, si, best_id)

    return HitResult(t=best_t, prim_type=best_type, prim_id=best_id,
                     u=best_u, v=best_v)


def occlude_bruteforce(scene: ir.Scene, ro, rd, minT, maxT):
    """Any-hit test: True where something blocks [minT, maxT]."""
    occluded = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    if scene.n_tris() > 0:
        *_, ok = tri_intersect(ro[:, None], rd[:, None], *_tri_points(scene),
                               minT[:, None], maxT[:, None])
        occluded = occluded | ok.any(dim=1)
    if scene.n_spheres() > 0:
        _, ok = sphere_intersect(ro[:, None], rd[:, None],
                                 scene.sph_center[None], scene.sph_radius[None],
                                 minT[:, None], maxT[:, None])
        occluded = occluded | ok.any(dim=1)
    return occluded


@dataclass(frozen=True)
class HitInfo:
    """Shading data of the hits. The last five fields are None in scenes
    that read none of them (no texture reads UVs, no ray cones), so such
    frames compute only the first six, as before textures were ported."""
    mat_id: torch.Tensor     # (B,) i64
    p: torch.Tensor          # (B, 3) hit point
    n_s: torch.Tensor        # (B, 3) shading normal
    n_g: torch.Tensor        # (B, 3) geometric normal
    tangent: torch.Tensor    # (B, 3) frame u
    bitangent: torch.Tensor  # (B, 3) frame v
    uv: torch.Tensor = None         # (B, 2)
    mr_uv: torch.Tensor = None      # (B, 2) metal-rough uv set
    prim_area: torch.Tensor = None  # (B,) 2 * triangle area (sphere: 1)
    uv_area: torch.Tensor = None    # (B,) uv-space area (sphere: 1e-6)
    curvature: torch.Tensor = None  # (B,) mean curvature

    def select(self, idx):
        """Rows ``idx`` of every field."""
        return HitInfo(*(None if getattr(self, f) is None
                         else getattr(self, f)[idx] for f in _HIT_FIELDS))


_HIT_FIELDS = ("mat_id", "p", "n_s", "n_g", "tangent", "bitangent", "uv",
               "mr_uv", "prim_area", "uv_area", "curvature")


def _full_fields(scene: ir.Scene):
    """Whether hits carry the last five HitInfo fields: where a texture
    reads UVs, a frame follows them (anisotropy, normal maps) or ray cones
    are traced."""
    return (scene.needs_uv or scene.has_aniso or scene.has_normal_maps
            or scene.needs_cones)


# the default uvs of a triangle's three corners, one copy a device
_CORNERS = {}


def _corners(dev):
    if dev not in _CORNERS:
        _CORNERS[dev] = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]],
                                     device=dev)
    return _CORNERS[dev]


def _tri_hit_info(scene: ir.Scene, hr: HitResult):
    tid = hr.prim_id.clamp(0, max(scene.n_tris() - 1, 0))
    vidx = scene.tri_vidx[tid]
    p0 = scene.verts[vidx[:, 0]]
    p1 = scene.verts[vidx[:, 1]]
    p2 = scene.verts[vidx[:, 2]]
    u, v = hr.u, hr.v
    w = 1.0 - u - v
    e1 = p1 - p0
    e2 = p2 - p0
    n_g = normalize(cross(e1, e2))
    # smooth shading: interpolated vertex normals on TRI_HAS_NORMALS tris
    flags = scene.tri_flags[tid]
    has_n = ((flags & ir.TRI_HAS_NORMALS) != 0)[:, None]
    n0 = scene.vnormals[vidx[:, 0]]
    n1 = scene.vnormals[vidx[:, 1]]
    n2 = scene.vnormals[vidx[:, 2]]
    n_interp = normalize(u[:, None] * n0 + v[:, None] * n1 + w[:, None] * n2)
    n_s = torch.where(has_n, n_interp, n_g)
    hit_p = u[:, None] * p0 + v[:, None] * p1 + w[:, None] * p2
    mat_id = scene.tri_mat[tid]

    # Static fast path: with no UV consumers, no anisotropy and no normal
    # maps the tangent frame's orientation is irrelevant (isotropic GGX):
    # the cheap ONB, and the cone fields only where cones are traced
    fast = not (scene.needs_uv or scene.has_aniso or scene.has_normal_maps)
    if fast and not scene.needs_cones:
        tangent, bitangent = onb_from_normal(n_s)
        return dict(mat_id=mat_id, p=hit_p, n_s=n_s, n_g=n_g,
                    tangent=tangent, bitangent=bitangent)
    n0 = torch.where(has_n, n0, n_g)
    n1 = torch.where(has_n, n1, n_g)
    n2 = torch.where(has_n, n2, n_g)
    c = cross(e1, e2)
    prim_area = sqrt_cr(torch.clamp_min(dot(c, c), 0.0))
    if fast:
        tangent, bitangent = onb_from_normal(n_s)
        uv = torch.stack([u, v], dim=-1)
        return dict(mat_id=mat_id, p=hit_p, n_s=n_s, n_g=n_g,
                    tangent=tangent, bitangent=bitangent, uv=uv, mr_uv=uv,
                    prim_area=prim_area, uv_area=torch.zeros_like(u),
                    curvature=(dot(n2 - n0, tangent)
                               + dot(n2 - n1, bitangent)) * 0.5)

    corner = _corners(u.device)

    def uv_set(table, flag):
        """(uv at the hit, its three vertex uvs): the default (0,0),
        (1,0), (1,1) corners and the barycentrics where ``flag`` is
        unset."""
        has = ((flags & flag) != 0)[:, None]
        t0 = torch.where(has, table[vidx[:, 0]], corner[0])
        t1 = torch.where(has, table[vidx[:, 1]], corner[1])
        t2 = torch.where(has, table[vidx[:, 2]], corner[2])
        interp = u[:, None] * t0 + v[:, None] * t1 + w[:, None] * t2
        return (torch.where(has, interp, torch.stack([u, v], dim=-1)),
                t0, t1, t2)

    uv, uv0, uv1, uv2 = uv_set(scene.vuv, ir.TRI_HAS_UV)

    has_mr = ((flags & ir.TRI_HAS_UV_MR) != 0)[:, None]
    mr_interp = (u[:, None] * scene.vuv_mr[vidx[:, 0]]
                 + v[:, None] * scene.vuv_mr[vidx[:, 1]]
                 + w[:, None] * scene.vuv_mr[vidx[:, 2]])
    mr_uv = torch.where(has_mr, mr_interp, uv)

    # surface differentials dpdu / dpdv from the uv parametrisation
    duvds = uv2 - uv0
    duvdt = uv2 - uv1
    det = duvds[:, 0] * duvdt[:, 1] - duvdt[:, 0] * duvds[:, 1]
    ok_det = (det.abs() > 1e-8) & ~torch.isnan(det)
    safe_det = torch.where(ok_det, det, 1.0)
    dsdu = duvdt[:, 1] / safe_det
    dtdu = -duvds[:, 1] / safe_det
    dsdv = duvdt[:, 0] / safe_det
    dtdv = -duvds[:, 0] / safe_det
    dpds = p2 - p0
    dpdt = p2 - p1
    dpdu = dpds * dsdu[:, None] + dpdt * dtdu[:, None]
    dpdv = dpds * dsdv[:, None] + dpdt * dtdv[:, None]
    au, av = onb_from_normal(n_s)
    okm = ok_det[:, None]
    dpdu = torch.where(okm, dpdu, au)
    dpdv = torch.where(okm, dpdv, av)
    dsdu = torch.where(ok_det, dsdu, 0.0)
    dtdu = torch.where(ok_det, dtdu, 0.0)
    dsdv = torch.where(ok_det, dsdv, 0.0)
    dtdv = torch.where(ok_det, dtdv, 0.0)

    if scene.has_normal_maps:
        from vimg_tpu_torch.textures.texture import normal_at_uv
        ntex = scene.mat_tex[mat_id, 1]
        has_nm = ntex >= 0
        n_uv, _, _, _ = uv_set(scene.vuv_nmap, ir.TRI_HAS_UV_NORMALMAP)
        n_tan = normal_at_uv(scene, ntex, n_uv)
        au2, av2 = onb_from_normal(n_s)
        n_local = (au2 * n_tan[:, 0:1] + av2 * n_tan[:, 1:2]
                   + n_s * n_tan[:, 2:3])
        ulen = sqrt_cr(torch.clamp_min(dot(dpdu, dpdu), 1e-20))[:, None]
        vlen = sqrt_cr(torch.clamp_min(dot(dpdv, dpdv), 1e-20))[:, None]
        dpdu_nm = normalize(gram_schmidt(dpdu, n_local)) * ulen
        dpdv_nm = normalize(cross(n_local, dpdu_nm)) * vlen
        m = has_nm[:, None]
        dpdu = torch.where(m, dpdu_nm, dpdu)
        dpdv = torch.where(m, dpdv_nm, dpdv)
        n_s = torch.where(m, n_local, n_s)

    tangent = normalize(dpdu - n_s * dotk(dpdu, n_s))
    bitangent = normalize(cross(n_s, tangent))

    # mean curvature from dn/du, dn/dv
    dnds = n2 - n0
    dndt = n2 - n1
    dndu = dnds * dsdu[:, None] + dndt * dtdu[:, None]
    dndv = dnds * dsdv[:, None] + dndt * dtdv[:, None]
    curvature = (dot(dndu, tangent) + dot(dndv, bitangent)) * 0.5

    uv_area = ((uv1[:, 0] - uv0[:, 0]) * (uv2[:, 1] - uv0[:, 1])
               - (uv2[:, 0] - uv0[:, 0]) * (uv1[:, 1] - uv0[:, 1])).abs()
    return dict(mat_id=mat_id, p=hit_p, n_s=n_s, n_g=n_g, tangent=tangent,
                bitangent=bitangent, uv=uv, mr_uv=mr_uv, prim_area=prim_area,
                uv_area=uv_area, curvature=curvature)


def _sphere_hit_info(scene: ir.Scene, ro, rd, hr: HitResult):
    sid = hr.prim_id.clamp(0, max(scene.n_spheres() - 1, 0))
    center = scene.sph_center[sid]
    t = torch.where(torch.isfinite(hr.t), hr.t, torch.zeros_like(hr.t))
    hit_p = ro + rd * t[:, None]
    n = normalize(hit_p - center)
    if scene.needs_uv:
        radius = scene.sph_radius[sid]
        theta = torch.acos(torch.clamp(-n[:, 1], -1.0, 1.0))
        phi = torch.atan2(-n[:, 2], n[:, 0]) + math.pi
        uv = torch.stack([div(phi, 2.0 * math.pi), div(theta, math.pi)],
                         dim=-1)
        dpdu = torch.stack([-radius * n[:, 1], radius * n[:, 0],
                            torch.zeros_like(radius)], dim=-1)
        tangent = dpdu - n * dotk(dpdu, n)
        tlen2 = dot(tangent, tangent)
        au, _ = onb_from_normal(n)
        tangent = torch.where((tlen2 > 1e-12)[:, None], normalize(tangent),
                              au)
        bitangent = normalize(cross(n, tangent))
    else:
        tangent, bitangent = onb_from_normal(n)
        uv = None
    out = dict(mat_id=scene.sph_mat[sid], p=hit_p, n_s=n, n_g=n,
               tangent=tangent, bitangent=bitangent)
    if _full_fields(scene):
        ones = torch.ones_like(t)
        if uv is None:
            uv = torch.zeros_like(n[:, :2])
        out.update(uv=uv, mr_uv=uv, prim_area=ones, uv_area=ones * 1e-6,
                   curvature=ones / scene.sph_radius[sid])
    return out


def hit_info(scene: ir.Scene, ro, rd, hr: HitResult) -> HitInfo:
    """Shading data for the surviving hits; undefined where ``hr.hit`` is
    False (callers mask)."""
    tri = _tri_hit_info(scene, hr) if scene.n_tris() > 0 else None
    sph = _sphere_hit_info(scene, ro, rd, hr) if scene.n_spheres() > 0 else None
    if tri is None:
        return HitInfo(**sph)
    if sph is None:
        return HitInfo(**tri)
    is_sph = hr.prim_type == ir.PRIM_SPHERE
    return HitInfo(**{k: torch.where(is_sph[:, None] if tri[k].ndim == 2
                                     else is_sph, sph[k], tri[k])
                      for k in tri})
