"""Disney/Principled BSDF lobes, batched and branchless (port of
vimg_tpu.materials.disney).

Directions: ``dir_in`` points from the surface toward the previous vertex
(-ray_dir), ``dir_out`` is the sampled/evaluated direction, and
(fu, fv, fw) is the shading frame with fw the (possibly flipped) normal.
"""
from __future__ import annotations

import math

import torch

from vimg_tpu_torch.core.math import (dot, dotk, luminance, normalize,
                                      onb_to_world, pow5, sqrt_cr, sqrt_pos,
                                      world_to_onb)

PI = math.pi
INV_PI = 1.0 / math.pi

ALPHA_MIN = 1e-4
REG_MIN = 0.03
REG_MAX = 0.1
ROUGH_THRESH = 0.1


def _sel(cond, a, b):
    """jnp.where with Python-scalar branches allowed (float32 result)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full(cond.shape, a, dtype=torch.float32, device=cond.device)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def regularize_alpha(alpha, regularize):
    """Roughen near-specular lobes after the first non-specular bounce."""
    widened = torch.clamp(2.0 * alpha, REG_MIN, REG_MAX)
    return torch.where(regularize & (alpha < ROUGH_THRESH), widened, alpha)


def anisotropic_alphas(roughness, anisotropic, clamp_roughness=True):
    aspect = sqrt_cr(1.0 - 0.9 * anisotropic)
    r = torch.clamp(roughness, 0.01, 1.0) if clamp_roughness else roughness
    r2 = r * r
    return (torch.clamp_min(r2 / aspect, ALPHA_MIN),
            torch.clamp_min(r2 * aspect, ALPHA_MIN))


def smith_g(w, alphax, alphay, fu, fv, fw):
    """Smith masking term G_w."""
    lx = dot(w, fu)
    ly = dot(w, fv)
    lz = dot(w, fw)
    lz2 = torch.clamp_min(lz * lz, 1e-20)
    ax = lx * alphax
    ay = ly * alphay
    a = (ax * ax + ay * ay) / lz2
    lam = (sqrt_cr(1.0 + a) - 1.0) / 2.0
    return 1.0 / (1.0 + lam)


def ggx_d(local_h, alphax, alphay):
    """Anisotropic GGX normal distribution."""
    hx, hy, hz = local_h[..., 0], local_h[..., 1], local_h[..., 2]
    denom = (hx * hx) / (alphax * alphax) + (hy * hy) / (alphay * alphay) \
        + hz * hz
    return 1.0 / (PI * alphax * alphay * torch.clamp_min(denom * denom, 1e-20))


def sample_vndf(local_dir_in, alphax, alphay, r1, r2):
    """Visible-normal sampling via spherical caps; local frame."""
    sign = _sel(local_dir_in[..., 2] < 0.0, -1.0, 1.0)
    din = local_dir_in * sign[..., None]
    hemi = normalize(torch.stack([alphax * din[..., 0], alphay * din[..., 1],
                                  din[..., 2]], dim=-1))
    phi = 2.0 * PI * r1
    z = (1.0 - r2) * (1.0 + hemi[..., 2]) - hemi[..., 2]
    sin_t = sqrt_cr(torch.clamp(1.0 - z * z, 0.0, 1.0))
    c = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), z], -1)
    h = c + hemi
    n = normalize(torch.stack([alphax * h[..., 0], alphay * h[..., 1],
                               torch.clamp_min(h[..., 2], 0.0)], dim=-1))
    return n * sign[..., None]


def fresnel_dielectric(n_dot_i, eta):
    """Exact unpolarized dielectric Fresnel; 1 on total internal
    reflection."""
    n_dot_t_sq = 1.0 - (1.0 - n_dot_i * n_dot_i) / (eta * eta)
    tir = n_dot_t_sq < 0.0
    n_dot_t = sqrt_pos(n_dot_t_sq)
    ni = n_dot_i.abs()
    rs = (ni - eta * n_dot_t) / torch.clamp_min(ni + eta * n_dot_t, 1e-12)
    rp = (eta * ni - n_dot_t) / torch.clamp_min(eta * ni + n_dot_t, 1e-12)
    f = (rs * rs + rp * rp) / 2.0
    return _sel(tir, 1.0, f)


def _fd(n, w, fd90):
    return 1.0 + (fd90 - 1.0) * pow5(1.0 - torch.clamp_min(dot(n, w), 0.0))


def _tint(base_col):
    base_lum = luminance(base_col)
    return torch.where((base_lum > 0)[..., None],
                       base_col / torch.clamp_min(base_lum, 1e-12)[..., None],
                       torch.ones_like(base_col))


# ---------------------------------------------------------------------------
# lobes: (eval (B, 3), pdf (B,)); above/below masks are applied by callers
# ---------------------------------------------------------------------------

def eval_pdf_diffuse(dir_in, dir_out, base_col, subsurface, roughness,
                     half_vec, fw):
    cos_out = torch.clamp_min(dot(fw, dir_out), 0.0)
    cos_in = torch.clamp_min(dot(fw, dir_in), 0.0)
    h_dot_out = torch.clamp_min(dot(half_vec, dir_out), 0.0)
    fd90 = 0.5 + 2.0 * roughness * h_dot_out * h_dot_out
    base_diffuse = (base_col * INV_PI * (_fd(fw, dir_in, fd90)
                    * _fd(fw, dir_out, fd90) * cos_out)[..., None])
    fss90 = roughness * h_dot_out * h_dot_out
    fss = (_fd(fw, dir_in, fss90) * _fd(fw, dir_out, fss90)
           * (1.0 / torch.clamp_min(cos_out + cos_in, 1e-7) - 0.5) + 0.5)
    ss_diffuse = base_col * (1.25 * INV_PI) * (fss * cos_out)[..., None]
    ev = ((1.0 - subsurface)[..., None] * base_diffuse
          + subsurface[..., None] * ss_diffuse)
    return ev, cos_out * INV_PI


def eval_pdf_sheen(dir_in, dir_out, base_col, sheen_tint, half_vec, fw):
    c_sheen = (1.0 - sheen_tint)[..., None] + sheen_tint[..., None] \
        * _tint(base_col)
    cos_out = torch.clamp_min(dot(fw, dir_out), 0.0)
    ev = c_sheen * (pow5(1.0 - torch.clamp_min(dot(half_vec, dir_out), 0.0))
                    * cos_out)[..., None]
    return ev, cos_out * INV_PI


def eval_pdf_metal(dir_in, dir_out, base_col, spec_tint, specular, eta,
                   metallic, half_vec, fu, fv, fw, G, G_in, alphax, alphay):
    k_s = (1.0 - spec_tint)[..., None] + spec_tint[..., None] * _tint(base_col)
    em1 = eta - 1.0
    ep1 = eta + 1.0
    r0 = (em1 * em1) / (ep1 * ep1)
    c0 = ((specular * r0 * (1.0 - metallic))[..., None] * k_s
          + metallic[..., None] * base_col)
    fres = c0 + (1.0 - c0) * pow5(1.0 - dot(half_vec, dir_out))[..., None]
    d = ggx_d(world_to_onb(fu, fv, fw, half_vec), alphax, alphay)
    inv4 = 1.0 / (4.0 * torch.clamp_min(dot(fw, dir_in).abs(), 1e-12))
    return fres * (d * G * inv4)[..., None], d * G_in * inv4


_CC_R0 = ((1.5 - 1.0) ** 2) / ((1.5 + 1.0) ** 2)


def eval_pdf_clearcoat(dir_in, dir_out, alpha_g, half_vec, fu, fv, fw):
    h_dot_out = dot(half_vec, dir_out).abs()
    fres = _CC_R0 + (1.0 - _CC_R0) * pow5(1.0 - h_dot_out)
    G = (smith_g(dir_in, 0.25, 0.25, fu, fv, fw)
         * smith_g(dir_out, 0.25, 0.25, fu, fv, fw))
    a2 = alpha_g * alpha_g
    hz = world_to_onb(fu, fv, fw, half_vec)[..., 2]
    d = (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * hz * hz))
    ev_s = (fres * d * G) / (4.0 * torch.clamp_min(dot(fw, dir_in).abs(),
                                                   1e-12))
    pdf = (d * dot(fw, half_vec).abs()) / (4.0 * torch.clamp_min(h_dot_out,
                                                                 1e-12))
    return ev_s[..., None] * torch.ones_like(half_vec), pdf


def eval_pdf_rough_glass(dir_in, dir_out, n_g, base_col, mat_eta, half_vec,
                         fu, fv, fw, G, G_in, alphax, alphay):
    """Walter-style rough dielectric; the refraction half vector is
    recomputed here."""
    in_geo = dot(dir_in, n_g)
    reflect = (in_geo * dot(n_g, dir_out)) >= 0.0
    eta = torch.where(in_geo >= 0.0, mat_eta, 1.0 / mat_eta)

    gen_h = normalize(dir_in + dir_out * eta[..., None])
    h = torch.where(reflect[..., None], half_vec, gen_h)

    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)
    d = ggx_d(world_to_onb(fu, fv, fw, h), alphax, alphay)
    n_in = dot(fw, dir_in)
    abs_n_in = torch.clamp_min(n_in.abs(), 1e-12)

    ev_refl = base_col * ((F * d * G) / (4.0 * abs_n_in))[..., None]
    pdf_refl = (F * d * G_in) / (4.0 * abs_n_in)

    h_dot_out = dot(h, dir_out)
    sqrt_denom = h_dot_in + eta * h_dot_out
    sd2 = torch.clamp_min(sqrt_denom * sqrt_denom, 1e-20)
    eta_factor = 1.0 / (eta * eta)
    ev_refr = (sqrt_cr(torch.clamp_min(base_col, 0.0))
               * (eta_factor * (1.0 - F) * d * G * eta * eta
                  * (h_dot_out * h_dot_in).abs() / (abs_n_in * sd2))[..., None])
    dh_dout = eta * eta * h_dot_out / sd2
    pdf_refr = (1.0 - F) * d * G_in * (
        dh_dout * h_dot_in / _sel(n_in == 0.0, 1e-12, n_in)).abs()

    return (torch.where(reflect[..., None], ev_refl, ev_refr),
            torch.where(reflect, pdf_refl, pdf_refr))


# ---------------------------------------------------------------------------
# lobe samplers
# ---------------------------------------------------------------------------

def _mirror(dir_in, h):
    return normalize(-dir_in + 2.0 * dotk(dir_in, h) * h)


def sample_diffuse_dir(fu, fv, fw, n_g, r1, r2, from_warp):
    dir_out = onb_to_world(fu, fv, fw, from_warp(r1, r2))
    return dir_out, dot(n_g, dir_out) > 0.0


def sample_metal(dir_in, n_g, roughness, anisotropic, fu, fv, fw, r1, r2,
                 regularize):
    # the reference metal sampler uses unclamped roughness^2 (eval clamps)
    alphax, alphay = anisotropic_alphas(roughness, anisotropic,
                                        clamp_roughness=False)
    alphax = regularize_alpha(alphax, regularize)
    alphay = regularize_alpha(alphay, regularize)
    local_h = sample_vndf(world_to_onb(fu, fv, fw, dir_in), alphax, alphay,
                          r1, r2)
    h = normalize(onb_to_world(fu, fv, fw, local_h))
    refl = _mirror(dir_in, h)
    return refl, dot(refl, n_g) > 0.0


def sample_clearcoat(dir_in, n_g, clearcoat_gloss, fu, fv, fw, r1, r2,
                     regularize):
    alpha_g = (1.0 - clearcoat_gloss) * 0.1 + clearcoat_gloss * 0.001
    alpha_g = regularize_alpha(alpha_g, regularize)
    a2 = alpha_g * alpha_g
    cos2 = (1.0 - torch.pow(a2, 1.0 - r1)) / (1.0 - a2)
    cos_e = sqrt_cr(torch.clamp(cos2, 0.0, 1.0))
    sin_e = sqrt_cr(torch.clamp(1.0 - cos2, 0.0, 1.0))
    az = 2.0 * PI * r2
    local_h = torch.stack([sin_e * torch.cos(az), sin_e * torch.sin(az),
                           cos_e], dim=-1)
    flip = (dot(fw, dir_in) < 0.0)[..., None]
    fu2 = torch.where(flip, -fu, fu)
    fv2 = torch.where(flip, -fv, fv)
    fw2 = torch.where(flip, -fw, fw)
    h = normalize(onb_to_world(fu2, fv2, fw2, local_h))
    refl = _mirror(dir_in, h)
    return refl, dot(n_g, refl) > 0.0


def sample_rough_glass(dir_in, n_g, mat_eta, anisotropic, roughness,
                       fu, fv, fw, r1, r2, fres_rand, regularize):
    """Returns (dir_out, eta_out, valid); eta_out = 0 for reflection."""
    in_geo = dot(dir_in, n_g)
    eta = torch.where(in_geo >= 0.0, mat_eta, 1.0 / mat_eta)
    alphax, alphay = anisotropic_alphas(roughness, anisotropic)
    alphax = regularize_alpha(alphax, regularize)
    alphay = regularize_alpha(alphay, regularize)
    local_h = sample_vndf(world_to_onb(fu, fv, fw, dir_in), alphax, alphay,
                          r1, r2)
    h = onb_to_world(fu, fv, fw, local_h)
    h_dot_in = dot(h, dir_in)
    F = fresnel_dielectric(h_dot_in, eta)

    do_reflect = fres_rand <= F
    refl = _mirror(dir_in, h)
    refl_valid = (dot(refl, n_g) * in_geo) > 0.0

    h_dot_out_sq = 1.0 - (1.0 - h_dot_in * h_dot_in) / (eta * eta)
    h_flip = torch.where((h_dot_in < 0.0)[..., None], -h, h)
    h_dot_out = sqrt_cr(torch.clamp_min(h_dot_out_sq, 0.0))
    refr = (-dir_in / eta[..., None]
            + (h_dot_in.abs() / eta - h_dot_out)[..., None] * h_flip)
    refr_valid = (h_dot_out_sq > 0.0) & ((dot(refr, n_g) * in_geo) < 0.0)
    # NaN-pdf guard on the generalized half vector
    gen_h = normalize(dir_in + refr * eta[..., None])
    gh_dot_in = dot(gen_h, dir_in)
    refr_valid = refr_valid & (
        (1.0 - (1.0 - gh_dot_in * gh_dot_in) / (eta * eta)) > 0.0)

    dir_out = torch.where(do_reflect[..., None], refl, refr)
    valid = torch.where(do_reflect, refl_valid, refr_valid)
    eta_out = torch.where(do_reflect, torch.zeros_like(eta), eta)
    return dir_out, eta_out, valid
