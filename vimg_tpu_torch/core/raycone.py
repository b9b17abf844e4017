"""Ray cones for texture and env-map LOD (port of vimg_tpu.core.raycone).

A cone is the pair (width, spread angle) carried per ray as two float
tensors; every function broadcasts over leading dims and keeps vimg_tpu's
order of operations.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.core.math import div, dot, normalize, sqrt_cr, sqrt_pos


def primary_cone_spread(vfov_rad, pixel_height):
    """Spread angle of a primary-ray cone."""
    return torch.atan(div(2.0 * torch.tan(vfov_rad * 0.5), pixel_height))


def _fsign(x):
    return torch.where(x > 0.0, 1.0, -1.0).to(x.dtype)


def spread_angle_from_curvature(mean_curvature, cone_width, ray_dir, normal):
    """Surface-induced spread angle."""
    dn = -dot(ray_dir, normal)
    dn = torch.where(dn.abs() < 1e-5, _fsign(dn) * 1e-5, dn)
    return mean_curvature * cone_width / dn


def propagate_reflect(width, spread, surface_spread_angle, hit_dist):
    """Cone update on reflection / continuation."""
    new_width = (spread * hit_dist + width).abs()
    new_spread = spread + surface_spread_angle
    return new_width, new_spread


def _refract_tir_2d(d, n, eta):
    """2D refraction; on total internal reflection the tangential
    projection of d."""
    nd = d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1]
    k = 1.0 - eta * eta * (1.0 - nd * nd)
    tir = k < 0.0
    refr = d * eta[..., None] - n * (eta * nd + sqrt_pos(k))[..., None]
    tangential = d - n * nd[..., None]
    tlen = sqrt_cr(torch.clamp_min(
        tangential[..., 0] ** 2 + tangential[..., 1] ** 2, 1e-20))
    fallback = tangential / tlen[..., None]
    return torch.where(tir[..., None], fallback, refr)


def _rot2d_pm(v, angle):
    c = torch.cos(angle)
    s = torch.sin(angle)
    cx = c * v[..., 0]
    sy = s * v[..., 1]
    sx = s * v[..., 0]
    cy = c * v[..., 1]
    plus = torch.stack([cx - sy, sx + cy], dim=-1)
    minus = torch.stack([cx + sy, -sx + cy], dim=-1)
    return plus, minus


def _ortho2d(v):
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _acos(x):
    """acos; under autograd its derivative at x = +-1 is 0, not infinite
    (the values are the same). The cone update runs on every lane, and a
    lane whose result is discarded would otherwise turn its zero cotangent
    into NaN (ROADMAP C21)."""
    if not x.requires_grad:
        return torch.acos(x)
    edge = x.abs() >= 1.0
    safe = torch.acos(torch.where(edge, torch.zeros_like(x), x))
    return torch.where(edge, torch.acos(x).detach(), safe)


def propagate_refract(width, spread, ray_in_dir, surface_spread_angle, eta,
                      refracted_dir):
    """Cone update through refraction, by the reference's construction in
    the 2D plane of the incident and refracted directions. ``eta`` is a
    float tensor."""
    denom = eta[..., None] * refracted_dir + ray_in_dir
    normal = -normalize(denom)

    x_axis = normalize(ray_in_dir - normal * dot(normal, ray_in_dir)[..., None])
    y_axis = normal

    def proj2(v):
        return torch.stack([dot(v, x_axis), dot(v, y_axis)], dim=-1)

    refr2 = proj2(refracted_dir)
    inc2 = proj2(ray_in_dir)
    inc2_ortho = _ortho2d(inc2)

    width_sign = torch.where(width > 0.0, 1.0, -1.0).to(width.dtype)
    inc2_u, inc2_l = _rot2d_pm(inc2, spread * width_sign * 0.5)

    tu = inc2_ortho * (width * 0.5)[..., None]
    tl = -tu

    hp_u_x = tu[..., 0] + inc2_u[..., 0] * (-tu[..., 1] / inc2_u[..., 1])
    hp_l_x = tl[..., 0] + inc2_l[..., 0] * (-tl[..., 1] / inc2_l[..., 1])

    normal_sign = torch.where(hp_u_x > hp_l_x, 1.0, -1.0).to(width.dtype)

    n2 = torch.stack([torch.zeros_like(width), torch.ones_like(width)],
                     dim=-1)
    n2_u, n2_l = _rot2d_pm(n2, -surface_spread_angle * normal_sign * 0.5)

    r2_u = _refract_tir_2d(inc2_u, n2_u, eta)
    r2_l = _refract_tir_2d(inc2_l, n2_l, eta)

    cross_ul = r2_u[..., 0] * r2_l[..., 1] - r2_u[..., 1] * r2_l[..., 0]
    sign_a = torch.where(cross_ul * normal_sign < 0.0, 1.0, -1.0).to(
        width.dtype)
    d_ul = torch.clamp(_dot2(r2_u, r2_l), -1.0, 1.0)
    new_spread = _acos(d_ul) * sign_a
    new_spread = torch.where(torch.isnan(new_spread), 0.0, new_spread)

    refr_ortho = _ortho2d(refr2)
    new_width = (-hp_u_x * r2_u[..., 1]) / _dot2(refr_ortho, _ortho2d(r2_u))
    new_width = new_width + (hp_l_x * r2_l[..., 1]) / _dot2(refr_ortho,
                                                            _ortho2d(r2_l))
    # NaNs from degenerate 2D frames (e.g. normal incidence)
    new_width = torch.where(torch.isnan(new_width),
                            spread.abs() * 0.0 + width.abs(), new_width)
    return new_width, new_spread
