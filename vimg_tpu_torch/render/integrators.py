"""Loop integrators over batches of (pixel, sample) ids (port of
vimg_tpu.render.integrators): the plain PyTorch version of the CUDA
megakernel.

- s_normal / g_normal: normal visualisation
- material: forward path tracing without NEE
- mis: NEE + BSDF sampling with the balance heuristic both ways

Each draw uses vimg_tpu's counter-RNG key (pixel, sample, bounce, draw) and
each path follows vimg_tpu's loop order, so every sample traces the same
path as in vimg_tpu. Where vimg_tpu's while_loop masks finished lanes, this
port drops them from the batch (``idx`` maps the live lanes to their
output rows): lanes are independent, so the per-sample results are the
same. In scenes with image textures or an env map every path carries a
ray cone (core/raycone.py) for the mip levels; elsewhere the loops run no
cone work. Smooth dielectrics work under MIS here, a deliberate
divergence from the C++ reference that vimg_tpu makes too.

``stats`` (optional dict) accumulates ``segments`` (closest-hit rays of
live paths) and ``shadow_rays`` (NEE rays) as the megakernel counts them;
where it holds a ``pixel_segments`` tensor (int64, one entry a pixel of
the frame), the material and MIS loops add each segment to its pixel.

Gradients (diff/grad.py) use vimg_tpu's detached-sampling estimator:
autograd flows through BSDF eval, emission, textures, the background and
the geometric terms, while sampled directions, pdf divisors, MIS weights
and roulette ratios are detached at vimg_tpu's stop_gradient points. In a
forward render the detaches change no value. ``bounded_depth`` runs
exactly that many bounces whatever ``settings.max_depth`` says (vimg_tpu's
``lax.scan`` bound of the differentiable path); paths end earlier when no
lane is live, where vimg_tpu's scan masks them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.core.math import div, dot, length, normalize
from vimg_tpu_torch.core.raycone import (propagate_reflect, propagate_refract,
                                         spread_angle_from_curvature)
from vimg_tpu_torch.core.rng import Draw
from vimg_tpu_torch.geometry import intersect
from vimg_tpu_torch.lights import emitters
from vimg_tpu_torch.materials import bsdf
from vimg_tpu_torch.render import camera as cam_mod
from vimg_tpu_torch.scene import ir

MIN_T = 1e-4                 # reference Ray.minT
SHADOW_EPS = 1e-4            # reference mis_integrator.cpp:62
ROULETTE_THRESHOLD = 5       # reference mis_integrator.cpp:31
ROULETTE_CLAMP = 0.95


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _count_pixels(stats, pix):
    """One segment for the pixel of each path in ``pix`` (pixel ids, with
    repeats), added to ``stats["pixel_segments"]`` where the caller asks
    for it."""
    if stats is not None and "pixel_segments" in stats:
        stats["pixel_segments"].index_add_(
            0, pix, torch.ones(pix.shape[0], dtype=torch.int64,
                               device=pix.device))


def _primary_rays(scene: ir.Scene, settings, pix, samp):
    """Pixel/sample ids -> camera rays (origin, direction, cone width, cone
    spread): x = pix % W, y = H-1 - pix // W, R2 jitter indexed by
    x + y + sample."""
    W, H = settings.width, settings.height
    x = pix % W
    y = (H - 1) - pix // W
    ox, oy = rng.r2_sequence(x + y + samp)
    lens1, lens2 = rng.uniform2(pix, samp, 0, Draw.CAMERA_LENS)
    px = x.to(torch.float32) + ox
    py = y.to(torch.float32) + oy
    return cam_mod.generate_rays(scene.camera, px, py, lens1, lens2)


def _full(ref, value):
    return torch.full(ref.shape[:1], value, dtype=torch.float32,
                      device=ref.device)


def _sky_gradient(rd):
    a = 0.5 * (normalize(rd)[..., 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], device=rd.device)
    return (1.0 - a)[..., None] + a[..., None] * blue


def normal_integrator(scene, settings, tracer, pix, samp, shading=True,
                      stats=None):
    ro, rd, _, _ = _primary_rays(scene, settings, pix, samp)
    hr = tracer.closest(scene, ro, rd, _full(ro, MIN_T),
                        _full(ro, float("inf")))
    _count(stats, "segments", ro.shape[0])
    hi = intersect.hit_info(scene, ro, rd, hr)
    n = hi.n_s if shading else hi.n_g
    return torch.where(hr.hit[..., None], (n + 1.0) * 0.5, _sky_gradient(rd))


def _balance(pdf1, pdf2):
    return pdf1 / torch.clamp_min(pdf1 + pdf2, 1e-20)


def _geometric_term(look_from, point, normal):
    d = look_from - point
    dist2 = torch.clamp_min(dot(d, d), 1e-20)
    return dot(normal, normalize(d)).abs() / dist2


def _roulette(throughput, eta_scale, rand):
    """Russian roulette: (survive mask, reweighted throughput); the
    continuation probability is detached."""
    rr = (throughput / eta_scale[..., None]).detach()
    max_val = torch.clamp_max(rr.amax(dim=-1), ROULETTE_CLAMP)
    survive = rand <= max_val
    return survive, throughput / torch.clamp_min(max_val, 1e-20)[..., None]


def _hit_cone(hi, ro, rd, cone_w, cone_s):
    """The cone at the hit (reflected / continued) and the surface's
    spread angle."""
    ssa = spread_angle_from_curvature(hi.curvature, cone_w, rd, hi.n_s)
    w, s = propagate_reflect(cone_w, cone_s, ssa * 2.0, length(ro - hi.p))
    return w, s, ssa


def _texture_inputs(scene, hi, cone_w, rd):
    """A segment's texture inputs, fetched once for its three BSDF calls;
    None where no texture reads the hit's UVs (the calls then fetch the
    plain base colour themselves, as before textures were ported)."""
    if not scene.needs_uv:
        return None
    return bsdf.texture_inputs(scene, hi.mat_id, hi, cone_w, rd)


def _bsdf_rands(pix, samp, d):
    b1, b2, b3, b4 = rng.uniform4(pix, samp, d, Draw.BSDF_SAMPLE)
    return {"lobe": b1, "u": b2, "v": b3, "fresnel": b4}


def material_integrator_loop(scene, settings, tracer, pix, samp, stats=None):
    """Forward path tracing without NEE (reference mat_integrator.cpp)."""
    ro, rd, cone_w, cone_s = _primary_rays(scene, settings, pix, samp)
    cones = scene.needs_cones
    if not cones:
        cone_w = cone_s = None
    result = torch.zeros_like(rd)
    idx = torch.arange(ro.shape[0], device=ro.device)
    tp = torch.ones_like(rd)
    non_spec = torch.zeros_like(idx, dtype=torch.bool)
    eta_scale = torch.ones_like(rd[:, 0])
    d = 0
    while d < settings.max_depth and idx.numel() > 0:
        _count(stats, "segments", idx.numel())
        _count_pixels(stats, pix[idx])
        hr = tracer.closest(scene, ro, rd, _full(ro, MIN_T),
                            _full(ro, float("inf")))
        found = hr.hit
        bg = emitters.background_emit(scene, rd, cone_s)
        result.index_add_(0, idx, torch.where(
            (~found)[..., None], tp * bg, torch.zeros_like(tp)))

        hi = intersect.hit_info(scene, ro, rd, hr)
        emitted_col = bsdf.emitted(scene, hi.mat_id, rd, hi.n_s)
        p, s = pix[idx], samp[idx]
        sc = bsdf.sample_mat(scene, hi.mat_id, rd, hi, _bsdf_rands(p, s, d),
                             non_spec)
        absorbed = found & ~sc.valid
        result.index_add_(0, idx, torch.where(
            absorbed[..., None], tp * emitted_col, torch.zeros_like(tp)))

        cont = found & sc.valid
        non_spec = non_spec | (cont & ~sc.is_specular)
        refr = sc.eta != 0.0
        if cones:
            w_refl, s_refl, ssa = _hit_cone(hi, ro, rd, cone_w, cone_s)
            w_refr, s_refr = propagate_refract(cone_w, cone_s, rd, ssa,
                                               sc.eta, sc.wo)
            cone_w = torch.where(refr, w_refr, w_refl)
            cone_s = torch.where(refr, s_refr, s_refl)
        eta_scale = torch.where(refr, eta_scale / (sc.eta * sc.eta),
                                eta_scale)
        ratio = bsdf.eval_div_pdf(scene, hi.mat_id, rd, sc.wo, hi, non_spec,
                                  cone_width=cone_w)
        tp = torch.where(cont[..., None], tp * (emitted_col + ratio), tp)

        rr_rand = rng.uniform1(p, s, d, Draw.ROULETTE)
        survive, rr_tp = _roulette(tp, eta_scale, rr_rand)
        do_rr = cont & (d > ROULETTE_THRESHOLD)
        tp = torch.where((do_rr & survive)[..., None], rr_tp, tp)
        cont = cont & (survive | ~do_rr)

        idx, ro, rd, tp = idx[cont], hi.p[cont], sc.wo[cont], tp[cont]
        non_spec, eta_scale = non_spec[cont], eta_scale[cont]
        if cones:
            cone_w, cone_s = cone_w[cont], cone_s[cont]
        d += 1
    return result


def mis_integrator_loop(scene, settings, tracer, pix, samp, stats=None):
    """MIS path tracer (reference mis_integrator.cpp)."""
    ro, rd, cone_w, cone_s = _primary_rays(scene, settings, pix, samp)
    cones = scene.needs_cones
    B = ro.shape[0]
    hr = tracer.closest(scene, ro, rd, _full(ro, MIN_T),
                        _full(ro, float("inf")))
    _count(stats, "segments", B)
    _count_pixels(stats, pix)
    hi = intersect.hit_info(scene, ro, rd, hr)

    # primary miss -> background; first hit emissive -> its emission
    zero3 = torch.zeros_like(rd)
    result = torch.where((~hr.hit)[..., None],
                         emitters.background_emit(scene, rd, cone_s), zero3)
    emissive0 = bsdf.is_emissive(scene, hi.mat_id) & hr.hit
    em0 = bsdf.emitted(scene, hi.mat_id, rd, hi.n_s)
    result = result + torch.where(emissive0[..., None], em0, zero3)

    live = hr.hit & ~emissive0
    idx = torch.nonzero(live)[:, 0]
    rd, hi = rd[idx], hi.select(idx)
    if cones:
        ro, cone_w, cone_s = ro[idx], cone_w[idx], cone_s[idx]
    else:
        cone_w = cone_s = None
    tp = torch.ones_like(rd)
    non_spec = torch.zeros_like(idx, dtype=torch.bool)
    eta_scale = torch.ones_like(rd[:, 0])
    n_lights = scene.n_lights()
    nl = max(n_lights, 1)
    d = 0
    while d < settings.max_depth and idx.numel() > 0:
        p, s = pix[idx], samp[idx]
        minT = _full(rd, MIN_T)
        infT = _full(rd, float("inf"))
        mat_delta = bsdf.is_delta(scene, hi.mat_id)
        nee_cone_w = None
        if cones:
            nee_cone_w, nee_cone_s, ssa = _hit_cone(hi, ro, rd, cone_w,
                                                    cone_s)
        tex = _texture_inputs(scene, hi, nee_cone_w, rd)

        # ---- light sampling (NEE) -------------------------------------
        if n_lights > 0:
            pick, lr1, lr2, _ = rng.uniform4(p, s, d, Draw.LIGHT_SAMPLE)
            ls = emitters.sample_lights(scene, hi.p, pick, lr1, lr2)
            # the light sample's direction, pdf and distance are detached;
            # G stays differentiable (the integrand's falloff at the hit)
            ls = dataclasses.replace(ls, wi=ls.wi.detach(),
                                     pdf=ls.pdf.detach(),
                                     dist=ls.dist.detach())
            do_nee = ~mat_delta & (ls.pdf != 0.0)
            _count(stats, "shadow_rays", do_nee.sum())
            shadow_max = torch.where(torch.isfinite(ls.dist),
                                     ls.dist - SHADOW_EPS, infT)
            occl = tracer.occluded(scene, hi.p, ls.wi, minT, shadow_max)
            f, mpdf = bsdf.eval_pdf(scene, hi.mat_id, rd, ls.wi, hi,
                                    non_spec, tex=tex)
            ok = do_nee & ~occl & (mpdf != 0.0) & ~torch.isnan(mpdf)
            w = _balance(ls.pdf, mpdf.detach() * ls.G).detach()
            contrib = (tp * f * ls.radiance
                       * (w * ls.G / torch.clamp_min(ls.pdf, 1e-20))[..., None])
            contrib = torch.where(torch.isnan(contrib),
                                  torch.zeros_like(contrib), contrib)
            result.index_add_(0, idx, torch.where(
                ok[..., None], contrib, torch.zeros_like(contrib)))

        # ---- BSDF sampling --------------------------------------------
        sc = bsdf.sample_mat(scene, hi.mat_id, rd, hi, _bsdf_rands(p, s, d),
                             non_spec, tex=tex)
        sc = dataclasses.replace(sc, wo=sc.wo.detach(), eta=sc.eta.detach())
        cont = sc.valid
        non_spec = non_spec | (cont & ~sc.is_specular)
        refr = sc.eta != 0.0
        if cones:
            w_refr, s_refr = propagate_refract(cone_w, cone_s, rd, ssa,
                                               sc.eta, sc.wo)
            cone_w = torch.where(refr, w_refr, nee_cone_w)
            cone_s = torch.where(refr, s_refr, nee_cone_s)
        eta_scale = torch.where(refr, eta_scale / (sc.eta * sc.eta),
                                eta_scale)
        f2, pdf2 = bsdf.eval_pdf(scene, hi.mat_id, rd, sc.wo, hi, non_spec,
                                 tex=tex)
        cont = cont & ~torch.isnan(pdf2)      # NaN pdf suppression
        # smooth dielectric: eval/pdf == 1 analytically
        ratio = torch.where(mat_delta[..., None], torch.ones_like(f2),
                            f2 / torch.clamp_min(pdf2.detach(), 1e-20)[
                                ..., None])
        ratio = torch.where(torch.isnan(ratio) | torch.isinf(ratio),
                            torch.zeros_like(ratio), ratio)
        tp = torch.where(cont[..., None], tp * ratio, tp)

        # ---- next bounce ----------------------------------------------
        nro, nrd = hi.p, sc.wo
        _count(stats, "segments", cont.sum())
        _count_pixels(stats, pix[idx[cont]])
        hr2 = tracer.closest(scene, nro, nrd, minT, infT)
        hi2 = intersect.hit_info(scene, nro, nrd, hr2)
        found = cont & hr2.hit
        missed = cont & ~hr2.hit

        # emissive hit -> MIS-weighted emission, path ends
        hit_emissive = found & bsdf.is_emissive(scene, hi2.mat_id)
        em = bsdf.emitted(scene, hi2.mat_id, nrd, hi2.n_s)
        light_pdf = div(emitters.surf_pdf(scene, hr2.prim_type, hr2.prim_id,
                                          nro, hi2.p, nrd), nl)
        G2 = _geometric_term(nro, hi2.p, hi2.n_g)
        one = torch.ones_like(pdf2)
        # pdf2*G2 can overflow to inf; the clamp keeps the weight -> 1
        w_hit = torch.where(mat_delta | (pdf2 == 0.0), one, _balance(
            torch.clamp_max(pdf2 * G2, 1e30), light_pdf)).detach()
        result.index_add_(0, idx, torch.where(
            hit_emissive[..., None], tp * w_hit[..., None] * em,
            torch.zeros_like(em)))

        if scene.bg_is_emissive:
            bgp = div(emitters.background_pdf(scene, nrd), nl)
            w_bg = torch.where(mat_delta | (pdf2 == 0.0), one,
                               _balance(pdf2, bgp)).detach()
            bg2 = emitters.background_emit(scene, nrd, cone_s)
            result.index_add_(0, idx, torch.where(
                missed[..., None], tp * w_bg[..., None] * bg2,
                torch.zeros_like(tp)))

        # russian roulette after the bounce hit a non-light surface
        carry_on = found & ~hit_emissive
        rr_rand = rng.uniform1(p, s, d, Draw.ROULETTE)
        survive, rr_tp = _roulette(tp, eta_scale, rr_rand)
        do_rr = carry_on & (d > ROULETTE_THRESHOLD)
        tp = torch.where((do_rr & survive)[..., None], rr_tp, tp)
        carry_on = carry_on & (survive | ~do_rr)

        idx, rd, hi, tp = idx[carry_on], nrd[carry_on], hi2.select(
            carry_on), tp[carry_on]
        non_spec, eta_scale = non_spec[carry_on], eta_scale[carry_on]
        if cones:
            ro, cone_w, cone_s = (nro[carry_on], cone_w[carry_on],
                                  cone_s[carry_on])
        d += 1
    return result


INTEGRATORS = {
    "s_normal": functools.partial(normal_integrator, shading=True),
    "g_normal": functools.partial(normal_integrator, shading=False),
    "material": material_integrator_loop,
    "mis": mis_integrator_loop,
}


def trace_radiance(scene, settings, tracer, pix, samp, integrator=None,
                   bounded_depth=None, stats=None):
    """Radiance (B, 3) of the paths (pix, samp) under ``integrator``
    (``settings.integrator`` when None); ``bounded_depth`` as the module
    docstring says."""
    if bounded_depth is not None:
        settings = dataclasses.replace(settings, max_depth=bounded_depth)
    return INTEGRATORS[integrator or settings.integrator](
        scene, settings, tracer, pix, samp, stats=stats)
