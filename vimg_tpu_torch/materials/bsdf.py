"""Material dispatch over per-ray material ids (port of
vimg_tpu.materials.bsdf).

Every material family present in the scene is evaluated branchlessly and
selected by type mask; families absent from a scene are skipped by the
static Scene flags. ``wi`` is the ray direction toward the surface,
``dir_in = -wi`` and ``wo`` points away from the surface. The base colour
comes through textures.texture.base_color_at_hit (constant, checker and
mip-mapped image textures); ``texture_inputs`` fetches a hit's texture
inputs once for the three BSDF calls of a segment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vimg_tpu_torch.core.math import (dot, dotk, normalize, onb_from_normal,
                                      onb_to_world, pow5, sqrt_cr)
from vimg_tpu_torch.core.warps import sample_hemisphere_cosine
from vimg_tpu_torch.geometry.intersect import HitInfo
from vimg_tpu_torch.materials import disney
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.textures.texture import (base_color_at_hit,
                                             metal_rough_at_uv)

INV_PI = 1.0 / math.pi


@dataclass(frozen=True)
class ScatterSample:
    wo: torch.Tensor           # (B, 3)
    eta: torch.Tensor          # (B,) refraction eta (0 when not refracting)
    is_specular: torch.Tensor  # (B,) bool
    valid: torch.Tensor        # (B,) bool (False == absorbed / invalid)


def is_delta(scene: ir.Scene, mat_id):
    """Delta (un-NEE-able) materials: smooth dielectric only."""
    return scene.mat_type[mat_id] == ir.MAT_DIELECTRIC


def is_emissive(scene: ir.Scene, mat_id):
    return scene.mat_type[mat_id] == ir.MAT_DIFFUSE_LIGHT


def emitted(scene: ir.Scene, mat_id, ray_dir, n_s):
    """One-sided emission."""
    emit = scene.mat_base[mat_id]
    on = is_emissive(scene, mat_id) & (dot(n_s, ray_dir) < 0.0)
    return torch.where(on[..., None], emit, torch.zeros_like(emit))


def texture_inputs(scene: ir.Scene, mat_id, hit: HitInfo, cone_width,
                   ray_dir):
    """Every per-hit texture input, fetched once: the base colour (with
    ray-cone LOD) and the metal-rough factors (None without image
    textures). The NEE eval, the BSDF sample and the bounce eval of a
    segment shade the same hit; each takes this dict as ``tex=``."""
    tex = dict(base_col=base_color_at_hit(scene, mat_id, hit, cone_width,
                                          ray_dir), mr=None)
    if scene.has_image_tex:
        tex["mr"] = metal_rough_at_uv(scene, scene.mat_tex[mat_id][..., 2],
                                      hit.mr_uv)
    return tex


def _principled_frame(hit: HitInfo, dir_in):
    """Shading frame with the reference's two-sided flip."""
    flip = (dot(hit.n_s, dir_in) * dot(hit.n_g, dir_in)) < 0.0
    s = torch.where(flip, -1.0, 1.0).to(dir_in.dtype)[..., None]
    return hit.tangent * s, hit.bitangent * s, hit.n_s * s


_PARAM_COLS = dict(
    eta=ir.MS_IOR, spec_trans=ir.MS_SPEC_TRANS, subsurface=ir.MS_SUBSURFACE,
    specular=ir.MS_SPECULAR, spec_tint=ir.MS_SPEC_TINT,
    anisotropic=ir.MS_ANISO, sheen=ir.MS_SHEEN, sheen_tint=ir.MS_SHEEN_TINT,
    clearcoat=ir.MS_CLEARCOAT, clearcoat_gloss=ir.MS_CLEARCOAT_GLOSS,
    metallic=ir.MS_METALLIC, roughness=ir.MS_ROUGHNESS)


def _principled_params(scene: ir.Scene, mat_id, hit: HitInfo, mr=None):
    """Per-ray Principled scalars; metallic and roughness are multiplied
    by the metal-rough texture where the scene has image textures. ``mr``
    is the precomputed factor pair (texture_inputs) or None to fetch."""
    sc = scene.mat_scalars[mat_id]
    p = {k: sc[..., c] for k, c in _PARAM_COLS.items()}
    # lanes of other materials (their results are discarded) get IOR 1 for
    # their unused 0: the rough-glass term's 1/eta^2 x eta^2 = inf x 0
    # would turn their zero cotangent into NaN (ROADMAP C21)
    p["eta"] = torch.where(scene.mat_type[mat_id] == ir.MAT_PRINCIPLED,
                           p["eta"], 1.0)
    if scene.has_image_tex:
        if mr is None:
            mr = metal_rough_at_uv(scene, scene.mat_tex[mat_id][..., 2],
                                   hit.mr_uv)
        p["metallic"] = p["metallic"] * mr[..., 0]
        p["roughness"] = p["roughness"] * mr[..., 1]
    return p


def _lobe_weights(p):
    w_diff = (1.0 - p["metallic"]) * (1.0 - p["spec_trans"])
    w_clear = 0.25 * p["clearcoat"]
    w_metal = 1.0 - p["spec_trans"] * (1.0 - p["metallic"])
    w_glass = (1.0 - p["metallic"]) * p["spec_trans"]
    total = torch.clamp_min(w_diff + w_clear + w_metal + w_glass, 1e-12)
    return w_diff / total, w_clear / total, w_metal / total, w_glass / total


def _principled_eval_pdf(scene, mat_id, wi, wo, hit, regularize, base_col,
                         mr=None):
    """Full Principled mixture eval + pdf."""
    dir_in = -wi
    fu, fv, fw = _principled_frame(hit, dir_in)
    p = _principled_params(scene, mat_id, hit, mr)
    half_vec = normalize(dir_in + wo)

    alphax, alphay = disney.anisotropic_alphas(p["roughness"],
                                               p["anisotropic"])
    alphax = disney.regularize_alpha(alphax, regularize)
    alphay = disney.regularize_alpha(alphay, regularize)
    G_in = disney.smith_g(dir_in, alphax, alphay, fu, fv, fw)
    G = G_in * disney.smith_g(wo, alphax, alphay, fu, fv, fw)

    zero1 = torch.zeros_like(p["roughness"])
    zero3 = torch.zeros_like(base_col)

    if scene.has_spec_trans:
        ev_glass, pdf_glass = disney.eval_pdf_rough_glass(
            dir_in, wo, hit.n_g, base_col, p["eta"], half_vec, fu, fv, fw,
            G, G_in, alphax, alphay)
    else:
        ev_glass, pdf_glass = zero3, zero1

    above = (dot(hit.n_g, dir_in) >= 0.0) & (dot(hit.n_g, wo) >= 0.0)
    under = dot(hit.n_g, dir_in) < 0.0

    if scene.has_sheen:
        ev_sheen, _ = disney.eval_pdf_sheen(dir_in, wo, base_col,
                                            p["sheen_tint"], half_vec, fw)
    else:
        ev_sheen = zero3
    ev_diff, pdf_diff = disney.eval_pdf_diffuse(
        dir_in, wo, base_col, p["subsurface"], p["roughness"], half_vec, fw)

    if scene.has_clearcoat:
        alpha_g = ((1.0 - p["clearcoat_gloss"]) * 0.1
                   + p["clearcoat_gloss"] * 0.001)
        alpha_g = disney.regularize_alpha(alpha_g, regularize)
        ev_clear, pdf_clear = disney.eval_pdf_clearcoat(
            dir_in, wo, alpha_g, half_vec, fu, fv, fw)
    else:
        ev_clear, pdf_clear = zero3, zero1

    ev_metal, pdf_metal = disney.eval_pdf_metal(
        dir_in, wo, base_col, p["spec_tint"], p["specular"], p["eta"],
        p["metallic"], half_vec, fu, fv, fw, G, G_in, alphax, alphay)

    # reflective lobes are zero below the surface
    am = above[..., None]
    ev_diff = torch.where(am, ev_diff, zero3)
    ev_sheen = torch.where(am, ev_sheen, zero3)
    ev_clear = torch.where(am, ev_clear, zero3)
    ev_metal = torch.where(am, ev_metal, zero3)
    pdf_diff = torch.where(above, pdf_diff, zero1)
    pdf_clear = torch.where(above, pdf_clear, zero1)
    pdf_metal = torch.where(above, pdf_metal, zero1)

    w_diff, w_clear, w_metal, w_glass = _lobe_weights(p)
    one_m = 1.0 - p["metallic"]
    ev_mix = (((1.0 - p["spec_trans"]) * one_m)[..., None] * ev_diff
              + (one_m * p["sheen"])[..., None] * ev_sheen
              + (0.25 * p["clearcoat"])[..., None] * ev_clear
              + (1.0 - p["spec_trans"] * one_m)[..., None] * ev_metal
              + (one_m * p["spec_trans"])[..., None] * ev_glass)
    pdf_mix = (w_diff * pdf_diff + w_clear * pdf_clear + w_metal * pdf_metal
               + w_glass * pdf_glass)

    ev_under = (one_m * p["spec_trans"])[..., None] * ev_glass
    return (torch.where(under[..., None], ev_under, ev_mix),
            torch.where(under, pdf_glass, pdf_mix))


def _principled_sample(scene, mat_id, wi, hit, rands, regularize, mr=None):
    dir_in = -wi
    fu, fv, fw = _principled_frame(hit, dir_in)
    p = _principled_params(scene, mat_id, hit, mr)
    r1, r2 = rands["u"], rands["v"]
    zero = torch.zeros_like(r1)
    in_geo = dot(hit.n_g, dir_in)
    above = in_geo >= 0.0

    d_dir, d_valid = disney.sample_diffuse_dir(
        fu, fv, fw, hit.n_g, r1, r2, sample_hemisphere_cosine)
    d_valid = d_valid & above

    if scene.has_clearcoat:
        c_dir, c_valid = disney.sample_clearcoat(
            dir_in, hit.n_g, p["clearcoat_gloss"], fu, fv, fw, r1, r2,
            regularize)
        c_valid = c_valid & above
    else:
        c_dir, c_valid = d_dir, d_valid   # weight 0 -> never picked

    m_dir, m_valid = disney.sample_metal(
        dir_in, hit.n_g, p["roughness"], p["anisotropic"], fu, fv, fw,
        r1, r2, regularize)
    m_valid = m_valid & above

    if scene.has_spec_trans:
        g_dir, g_eta, g_valid = disney.sample_rough_glass(
            dir_in, hit.n_g, p["eta"], p["anisotropic"], p["roughness"],
            fu, fv, fw, r1, r2, rands["fresnel"], regularize)
    else:
        # glass is reachable only from under the surface; without
        # transmission those paths terminate
        g_dir, g_eta, g_valid = m_dir, zero, torch.zeros_like(m_valid)

    w_diff, w_clear, w_metal, _ = _lobe_weights(p)
    rnd = rands["lobe"]
    c1 = w_diff
    c2 = c1 + w_clear
    c3 = c2 + w_metal
    pick_diff = rnd <= c1
    pick_clear = (rnd > c1) & (rnd <= c2)
    pick_metal = (rnd > c2) & (rnd <= c3)
    # glass is also forced when arriving from below the surface
    under = in_geo < 0.0
    pick_glass = (~(pick_diff | pick_clear | pick_metal)) | under
    pick_diff = pick_diff & ~under
    pick_clear = pick_clear & ~under
    pick_metal = pick_metal & ~under

    wo = torch.where(pick_diff[..., None], d_dir,
         torch.where(pick_clear[..., None], c_dir,
         torch.where(pick_metal[..., None], m_dir, g_dir)))
    valid = torch.where(pick_diff, d_valid,
            torch.where(pick_clear, c_valid,
            torch.where(pick_metal, m_valid, g_valid)))
    eta = torch.where(pick_glass, g_eta, zero)
    return ScatterSample(wo=wo, eta=eta, is_specular=~pick_diff, valid=valid)


def _dielectric_sample(scene, mat_id, wi, hit, rands):
    """Smooth glass with Schlick reflectance."""
    ior = scene.mat_scalars[mat_id][..., ir.MS_IOR]
    front = dot(wi, hit.n_s) < 0.0
    n = torch.where(front[..., None], hit.n_s, -hit.n_s)
    cos_i = -dot(wi, n)

    def schlick(cosine, n1, n2):
        r = (n1 - n2) / (n1 + n2)
        r0 = r * r
        return r0 + (1.0 - r0) * pow5(1.0 - cosine)

    eta_in = torch.where(front, ior, 1.0 / ior)
    ratio = torch.where(front, 1.0 / ior, ior)
    sin_t_sq = ratio * ratio * (1.0 - cos_i * cos_i)
    tir = sin_t_sq > 1.0
    cos_t = sqrt_cr(torch.clamp_min(1.0 - sin_t_sq, 0.0))
    refl_prob = torch.where(front, schlick(cos_i, 1.0, ior),
                            torch.where(tir, torch.full_like(cos_t, 1.1),
                                        schlick(cos_t, ior, 1.0)))
    do_reflect = refl_prob > rands["fresnel"]
    refl = wi - 2.0 * dotk(wi, n) * n
    refr = ratio[..., None] * wi + (ratio * cos_i - cos_t)[..., None] * n
    return torch.where(do_reflect[..., None], refl, refr), eta_in


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

def sample_mat(scene: ir.Scene, mat_id, wi, hit: HitInfo, rands,
               regularize, tex=None) -> ScatterSample:
    """Sample an outgoing direction per ray. ``rands``: dict with keys
    'lobe', 'u', 'v', 'fresnel' of (B,) floats; ``tex``: an optional
    texture_inputs dict."""
    mt = scene.mat_type[mat_id]
    B = mat_id.shape[0]
    dev = wi.device
    wo = torch.zeros((B, 3), device=dev)
    eta = torch.zeros((B,), device=dev)
    is_spec = torch.zeros((B,), dtype=torch.bool, device=dev)
    valid = torch.zeros((B,), dtype=torch.bool, device=dev)

    if scene.has_lambertian:
        front = dot(wi, hit.n_s) < 0.0
        n = torch.where(front[..., None], hit.n_s, -hit.n_s)
        u, v = onb_from_normal(n)
        d = onb_to_world(u, v, n, sample_hemisphere_cosine(rands["u"],
                                                           rands["v"]))
        m = mt == ir.MAT_LAMBERTIAN
        wo = torch.where(m[..., None], d, wo)
        valid = torch.where(m, front, valid)

    if scene.has_dielectric:
        d_wo, d_eta = _dielectric_sample(scene, mat_id, wi, hit, rands)
        m = mt == ir.MAT_DIELECTRIC
        wo = torch.where(m[..., None], d_wo, wo)
        eta = torch.where(m, d_eta, eta)
        is_spec = is_spec | m
        valid = valid | m

    # diffuse_light: absorbed (valid stays False)

    if scene.has_principled:
        ps = _principled_sample(scene, mat_id, wi, hit, rands, regularize,
                                mr=None if tex is None else tex["mr"])
        m = mt == ir.MAT_PRINCIPLED
        wo = torch.where(m[..., None], ps.wo, wo)
        eta = torch.where(m, ps.eta, eta)
        is_spec = torch.where(m, ps.is_specular, is_spec)
        valid = torch.where(m, ps.valid, valid)

    return ScatterSample(wo=normalize(wo), eta=eta, is_specular=is_spec,
                         valid=valid)


def eval_pdf(scene: ir.Scene, mat_id, wi, wo, hit: HitInfo, regularize,
             cone_width=None, tex=None):
    """(f, pdf) pair; delta materials return (0, 0). ``tex``: an optional
    texture_inputs dict, else the base colour is fetched with the LOD of
    ``cone_width``."""
    mt = scene.mat_type[mat_id]
    B = mat_id.shape[0]
    f = torch.zeros((B, 3), device=wi.device)
    pdf = torch.zeros((B,), device=wi.device)
    base_col = tex["base_col"] if tex is not None else \
        base_color_at_hit(scene, mat_id, hit, cone_width, wi)

    if scene.has_lambertian:
        cospi = torch.clamp_min(dot(wo, hit.n_s), 0.0) * INV_PI
        m = mt == ir.MAT_LAMBERTIAN
        f = torch.where(m[..., None], base_col * cospi[..., None], f)
        pdf = torch.where(m, cospi, pdf)

    if scene.has_principled:
        ev, pp = _principled_eval_pdf(scene, mat_id, wi, wo, hit, regularize,
                                      base_col,
                                      mr=None if tex is None else tex["mr"])
        m = mt == ir.MAT_PRINCIPLED
        f = torch.where(m[..., None], ev, f)
        pdf = torch.where(m, pp, pdf)
    return f, pdf


def eval_div_pdf(scene: ir.Scene, mat_id, wi, wo, hit: HitInfo, regularize,
                 cone_width=None):
    """f/pdf with the analytic cancellations (Lambertian -> albedo,
    dielectric -> 1)."""
    mt = scene.mat_type[mat_id]
    out = torch.zeros((mat_id.shape[0], 3), device=wi.device)
    base_col = base_color_at_hit(scene, mat_id, hit, cone_width, wi)
    if scene.has_lambertian:
        out = torch.where((mt == ir.MAT_LAMBERTIAN)[..., None], base_col, out)
    if scene.has_dielectric:
        out = torch.where((mt == ir.MAT_DIELECTRIC)[..., None],
                          torch.ones_like(out), out)
    if scene.has_principled:
        ev, pp = _principled_eval_pdf(scene, mat_id, wi, wo, hit, regularize,
                                      base_col)
        pp = pp.detach()              # detached-sampling estimator
        safe = torch.where((pp > 0.0)[..., None],
                           ev / torch.clamp_min(pp, 1e-20)[..., None],
                           torch.zeros_like(ev))
        out = torch.where((mt == ir.MAT_PRINCIPLED)[..., None], safe, out)
    return out
