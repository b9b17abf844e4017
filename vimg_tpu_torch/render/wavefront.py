"""Persistent-wavefront MIS renderer with lane refill (port of
vimg_tpu.render.wavefront).

Each superstep advances every lane by one path segment and refills the
lanes whose paths ended with fresh (pixel, sample) work from a global
counter, handed out in Morton pixel order:

  1. closest-trace each lane's pending ray (camera ray for fresh lanes,
     BSDF bounce ray otherwise); resolve emissive / miss termination with
     the MIS weight carried from the sampling step; Russian roulette
  2. NEE at the surviving hits (shadow trace + balance heuristic)
  3. sample the BSDF -> the next pending ray
  4. add finished paths to the film; refill lanes from the counter

Every step follows vimg_tpu's superstep operation for operation, with the
same counter-RNG keys, so each path is the path vimg_tpu traces. Like
vimg_tpu's wavefront it has no depth cut: ``settings.max_depth`` is not
read (paths end by emission, a miss, absorption or roulette); the loop
integrator and the megakernel do cut at max_depth. The roulette draw uses
key ``d`` at the new hit, where the loop integrator draws key ``d`` after
the bounce, so the wavefront and the loop agree only statistically.

In scenes with image textures or an env map (``scene.needs_cones``) every
lane also carries a ray cone (``cone_w``, ``cone_s``): refill sets it from
the camera, a miss reads the env map at its spread, a hit propagates it
for NEE and the texture LOD, and a refraction bends it. Where a texture
reads the hit's UVs, its inputs are fetched once a segment for the NEE
eval, the BSDF sample and the bounce eval. A scene without either runs
none of this.

The run loop is a host loop over supersteps that reads ``n_done`` once per
superstep, with vimg_tpu's safety valve on the superstep count. Segment and
shadow-ray counters are exact int64.

``sample_offset`` shifts every sample id the refill hands out, so disjoint
sample slabs of one frame (checkpoint slabs, per-process slabs) draw
disjoint RNG streams: a (pixel, sample) path depends only on that pair.
``VIMG_NO_MORTON`` (set to anything) hands out work in raster order.

The primary pre-pass (opt-in: ``VIMG_PREPASS``, see ``_want_prepass``)
traces every camera ray of the frame first, in (Morton pixel, sample)
order and unsorted, into one packed (total, 16) float32 table of first
hits and the rays that produced them (``trace_primaries``); a refilled
lane then reads its row and skips its camera trace in the superstep. The
table is allocated once and the chunks are written into it, so its peak
is its own 64 bytes a path.

``make_superstep(..., ablate=)`` is vimg_tpu's diagnosis hook
(``probes/ablate_superstep.py`` drives it): a set of stage names whose
work is replaced by a cheap stand-in, so that timing a superstep with and
without each stage splits its cost. The keys and stand-ins are vimg_tpu's
(``ABLATE_KEYS``); production callers leave the set empty, and then the
superstep runs exactly its usual code. vimg_tpu's stand-ins keep their
inputs alive (``* 1e-30``, ``* 0.0`` terms) so that XLA cannot drop the
work around them; an eager loop drops nothing, so here they only keep the
state's values what vimg_tpu's variant computes. What each leaves out on
the card:

- ``film``: the three index_add_ scatters of finished paths (the film
  gets sum(result) * 1e-30 everywhere instead);
- ``cumsum``: the prefix sum of free lanes (lane i takes slot i);
- ``nee``: light sampling, the shadow trace and the NEE BSDF eval;
- ``shadow``: the shadow trace only (nothing is occluded);
- ``beval``: both BSDF evals (a cosine lobe, pdf |cos| / pi, f = pdf / 2);
- ``bsample``: the BSDF sample (a cosine-hemisphere direction);
- ``trace``: the closest trace (every ray hits primitive 0, a sphere, at
  t = 1, u = v = 0.3);
- ``hitinfo``: the hit's shading data (material 0, the normal -rd);
- ``bg``: the background lookup (0.1 radiance, pdf 0.25).
With ``beval`` and ``bsample`` both set the texture inputs are not fetched.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.core.math import div, dot, onb_to_world
from vimg_tpu_torch.core.raycone import propagate_refract
from vimg_tpu_torch.core.rng import Draw
from vimg_tpu_torch.core.warps import sample_hemisphere_cosine
from vimg_tpu_torch.geometry import intersect
from vimg_tpu_torch.lights import emitters
from vimg_tpu_torch.materials import bsdf
from vimg_tpu_torch.render.integrators import (MIN_T, ROULETTE_CLAMP,
                                               ROULETTE_THRESHOLD, SHADOW_EPS,
                                               _balance, _geometric_term,
                                               _hit_cone, _primary_rays,
                                               _texture_inputs)
from vimg_tpu_torch.scene import ir

# default lane count (vimg_tpu's; settings.batch_size overrides it)
MAX_LANES = 1 << 17
INF = float("inf")
# pre-pass table cap: 64 bytes a path (first hit, camera ray and cone,
# three pad columns), 2^23 paths = 512 MiB. Bigger frames trace their
# primaries in the superstep (or render in sample slabs).
PREPASS_MAX_TOTAL = 1 << 23
# the pre-pass table's first five columns: (lane state, HitResult field)
_PRE_FIELDS = (("pre_t", "t"), ("pre_ptype", "prim_type"),
               ("pre_pid", "prim_id"), ("pre_u", "u"), ("pre_v", "v"))
_PRE_INT = ("prim_type", "prim_id")
# stats dict of the latest render_wavefront (what return_stats returns)
LAST_STATS = None
# the stages make_superstep's ``ablate`` can replace (vimg_tpu's keys)
ABLATE_KEYS = frozenset(("film", "cumsum", "nee", "shadow", "beval",
                         "bsample", "trace", "hitinfo", "bg"))
INV_PI = 1.0 / math.pi


def morton_pixel_order(W, H):
    """Pixel ids (y*W + x) in Morton (Z-curve) order: the work-dispensing
    order, so the in-flight set is a compact 2D block rather than a
    full-width strip."""
    xs = np.arange(W, dtype=np.uint32)
    ys = np.arange(H, dtype=np.uint32)
    X, Y = np.meshgrid(xs, ys)                 # (H, W)

    def spread(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    code = (spread(X) << np.uint32(1)) | spread(Y)
    pid = (Y.astype(np.int64) * W + X).ravel()
    order = np.argsort(code.ravel(), kind="stable")
    return pid[order].astype(np.int32)


def init_state(B, device, cones=False, prepass=False, sample_offset=0):
    """All lanes idle; the first superstep's refill hands out work. With
    ``cones`` the lanes carry a ray cone too, with ``prepass`` the first
    hit of their pending camera ray (valid while ``fresh``)."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((B, *shape), dtype=dtype, device=device)

    def scalar():
        return torch.zeros((), dtype=torch.int64, device=device)

    extra = dict(cone_w=z(), cone_s=z()) if cones else {}
    if prepass:
        extra.update({f: z(dtype=torch.int64 if h in _PRE_INT
                             else torch.float32)
                      for f, h in _PRE_FIELDS})
    return dict(
        **extra,
        alive=z(dtype=torch.bool),         # lane holds an in-flight path
        pix=z(dtype=torch.int64), samp=z(dtype=torch.int64),
        d=z(dtype=torch.int64),
        ro=z(3), rd=z(3),                  # pending ray
        fresh=z(dtype=torch.bool),         # pending ray is a camera ray
        throughput=z(3) + 1.0, result=z(3),
        non_spec=z(dtype=torch.bool), eta_scale=z() + 1.0,
        prev_pdf=z(), prev_delta=z(dtype=torch.bool),
        next_work=scalar(), n_done=scalar(),
        samp_off=scalar() + sample_offset,
        # exact counters: segments traced, shadow rays cast
        n_segments=scalar(), n_shadow=scalar(),
    )


def make_superstep(scene: ir.Scene, settings: ir.RenderSettings, tracer,
                   total_paths: int, morton_pix=None, pre_tab=None,
                   ablate=frozenset()):
    """Returns superstep(state, accum) -> (state, accum); ``accum`` is the
    (3, H*W) film, ``morton_pix`` the work order's pixel ids (int64; None:
    raster order), ``pre_tab`` the pre-pass table (None: fresh lanes trace
    their camera rays in the superstep), ``ablate`` the stages replaced by
    stand-ins (module docstring; empty for a render)."""
    ab = frozenset(ablate)
    if not ab <= ABLATE_KEYS:
        raise ValueError(f"unknown ablate keys {sorted(ab - ABLATE_KEYS)} "
                         f"({sorted(ABLATE_KEYS)})")
    spp = settings.spp
    n_lights = scene.n_lights()
    nl = max(n_lights, 1)
    cones = scene.needs_cones
    n_pix = settings.width * settings.height
    # more work than the frame holds (the ablate probe's endless run): work
    # ids past the frame name pixels below it, whose paths the film drops,
    # as vimg_tpu's scatter drops out-of-range indices
    past_frame = morton_pix is None and total_paths > n_pix * spp

    def refill(s, accum, finished):
        """Add finished paths to the film and pull new work."""
        if "film" in ab:
            accum = accum + torch.where(finished[:, None], s["result"],
                                        0.0).sum() * 1e-30
        else:
            on_film = finished & (s["pix"] < n_pix) if past_frame \
                else finished
            done = torch.nonzero(on_film)[:, 0]
            accum.index_add_(1, s["pix"][done], s["result"][done].T)
        n_done = s["n_done"] + finished.sum()

        free = finished | ~s["alive"]
        if "cumsum" in ab:
            slot = torch.arange(free.shape[0], device=free.device)
        else:
            slot = torch.cumsum(free.to(torch.int64), 0) - 1
        new_k = s["next_work"] + slot
        take = free & (new_k < total_paths)
        next_work = s["next_work"] + take.sum()

        k = new_k[take]
        pix = s["pix"].clone()
        samp = s["samp"].clone()
        pix[take] = k // spp if morton_pix is None else morton_pix[k // spp]
        samp[take] = k % spp + s["samp_off"]
        ro, rd = s["ro"].clone(), s["rd"].clone()
        if pre_tab is None:
            ro[take], rd[take], cw, cs = _primary_rays(scene, settings,
                                                       pix[take], samp[take])
        else:
            # the stored camera ray, so that hit and shading see one ray
            row = pre_tab[k]
            ro[take], rd[take], cw, cs = (row[:, 5:8], row[:, 8:11],
                                          row[:, 11], row[:, 12])
            pre = {}
            for c, (f, h) in enumerate(_PRE_FIELDS):
                pre[f] = s[f].clone()
                pre[f][take] = (row[:, c].long() if h in _PRE_INT
                                else row[:, c])
            s = dict(s, **pre)
        if cones:
            cone_w, cone_s = s["cone_w"].clone(), s["cone_s"].clone()
            cone_w[take], cone_s[take] = cw, cs
            s = dict(s, cone_w=cone_w, cone_s=cone_s)
        m = take[:, None]
        return dict(
            s,
            alive=(s["alive"] & ~finished) | take,
            pix=pix, samp=samp,
            d=torch.where(take, 0, s["d"]),
            ro=ro, rd=rd,
            fresh=s["fresh"] | take,
            throughput=torch.where(m, 1.0, s["throughput"]),
            result=torch.where(m, 0.0, s["result"]),
            non_spec=s["non_spec"] & ~take,
            eta_scale=torch.where(take, 1.0, s["eta_scale"]),
            prev_pdf=torch.where(take, 0.0, s["prev_pdf"]),
            prev_delta=s["prev_delta"] & ~take,
            next_work=next_work, n_done=n_done,
        ), accum

    def superstep(s, accum):
        alive, fresh = s["alive"], s["fresh"]
        ro, rd, tp = s["ro"], s["rd"], s["throughput"]
        pix, samp, d = s["pix"], s["samp"], s["d"]
        B = alive.shape[0]
        minT = torch.full((B,), MIN_T, device=ro.device)
        infT = torch.full((B,), INF, device=ro.device)
        n_segments = s["n_segments"] + alive.sum()

        # ---- 1. trace pending rays ------------------------------------
        # idle lanes walk with maxT = -inf: they leave the walk at once;
        # with the pre-pass, so do fresh lanes (their hit is in the state)
        if "trace" in ab:
            zi = torch.zeros(B, dtype=torch.int64, device=ro.device)
            hr = intersect.HitResult(
                t=1.0 + minT * 0.0 + rd[:, 0] * 1e-12,
                prim_type=zi + ir.PRIM_SPHERE, prim_id=zi,
                u=0.3 + minT * 0.0, v=0.3 + minT * 0.0)
        else:
            live = alive & ~fresh if pre_tab is not None else alive
            hr = tracer.closest(scene, ro, rd, minT,
                                torch.where(live, infT, -INF))
            if pre_tab is not None:
                hr = intersect.HitResult(**{
                    h: torch.where(fresh, s[f], getattr(hr, h))
                    for f, h in _PRE_FIELDS})
        hi = _ablated_hit_info(ro, rd, hr) if "hitinfo" in ab else \
            intersect.hit_info(scene, ro, rd, hr)
        found = alive & hr.hit
        missed = alive & ~hr.hit

        emissive = found & bsdf.is_emissive(scene, hi.mat_id)
        em = bsdf.emitted(scene, hi.mat_id, rd, hi.n_s)
        # MIS weight of a light hit by BSDF sampling; camera rays and
        # delta bounces weigh 1
        light_pdf = div(emitters.surf_pdf(scene, hr.prim_type, hr.prim_id,
                                          ro, hi.p, rd), nl)
        G2 = _geometric_term(ro, hi.p, hi.n_g)
        unweighted = fresh | s["prev_delta"] | (s["prev_pdf"] == 0.0)
        # the clamp keeps an overflowing pdf*G2 from making the weight NaN
        w_hit = torch.where(unweighted, 1.0, _balance(
            torch.clamp_max(s["prev_pdf"] * G2, 1e30), light_pdf))
        result = s["result"] + torch.where(
            emissive[:, None], tp * w_hit[:, None] * em, 0.0)

        # background on a miss: direct for camera rays, MIS-weighted
        # otherwise
        if "bg" in ab:
            bg = rd * 0.0 + 0.1
            bgp = rd[:, 0] * 0.0 + 0.25
        else:
            bg = emitters.background_emit(scene, rd, s.get("cone_s"))
            bgp = div(emitters.background_pdf(scene, rd), nl)
        w_bg = torch.where(unweighted, 1.0, _balance(s["prev_pdf"], bgp))
        add_bg = missed & (fresh | scene.bg_is_emissive)
        result = result + torch.where(
            add_bg[:, None], tp * w_bg[:, None] * bg, 0.0)

        terminated = missed | emissive
        cont = found & ~emissive

        # russian roulette on continuing paths (depth from path state)
        rr_rand = rng.uniform1(pix, samp, d, Draw.ROULETTE)
        max_val = torch.clamp_max((tp / s["eta_scale"][:, None]).amax(-1),
                                  ROULETTE_CLAMP)
        survive = rr_rand <= max_val
        do_rr = cont & (d > ROULETTE_THRESHOLD) & ~fresh
        tp = torch.where((do_rr & survive)[:, None],
                         tp / torch.clamp_min(max_val, 1e-20)[:, None], tp)
        rr_kill = do_rr & ~survive
        terminated = terminated | rr_kill
        cont = cont & ~rr_kill

        # ---- 2. NEE ----------------------------------------------------
        nee_cone_w = None
        if cones:
            nee_cone_w, nee_cone_s, ssa = _hit_cone(hi, ro, rd, s["cone_w"],
                                                    s["cone_s"])
        tex = None if {"beval", "bsample"} <= ab else \
            _texture_inputs(scene, hi, nee_cone_w, rd)
        mat_delta = bsdf.is_delta(scene, hi.mat_id)
        n_shadow = s["n_shadow"]
        if n_lights > 0 and "nee" not in ab:
            pick, lr1, lr2, _ = rng.uniform4(pix, samp, d, Draw.LIGHT_SAMPLE)
            ls = emitters.sample_lights(scene, hi.p, pick, lr1, lr2)
            do_nee = cont & ~mat_delta & (ls.pdf != 0.0)
            # lanes without a shadow ray walk with -inf (see above)
            shadow_max = torch.where(torch.isfinite(ls.dist),
                                     ls.dist - SHADOW_EPS, infT)
            shadow_max = torch.where(do_nee, shadow_max, -INF)
            if "shadow" in ab:
                occl = ls.wi[:, 0] > 2.0     # never true
            else:
                occl = tracer.occluded(scene, hi.p, ls.wi, minT, shadow_max)
            n_shadow = n_shadow + do_nee.sum()
            if "beval" in ab:
                f, mpdf = _ablated_eval(ls.wi, hi)
            else:
                f, mpdf = bsdf.eval_pdf(scene, hi.mat_id, rd, ls.wi, hi,
                                        s["non_spec"], tex=tex)
            ok = do_nee & ~occl & (mpdf != 0.0) & ~torch.isnan(mpdf)
            w = _balance(ls.pdf, mpdf * ls.G)
            contrib = (tp * f * ls.radiance
                       * (w * ls.G / torch.clamp_min(ls.pdf, 1e-20))[:, None])
            contrib = torch.where(torch.isnan(contrib), 0.0, contrib)
            result = result + torch.where(ok[:, None], contrib, 0.0)

        # ---- 3. BSDF sampling -----------------------------------------
        b1, b2, b3, b4 = rng.uniform4(pix, samp, d, Draw.BSDF_SAMPLE)
        rands = {"lobe": b1, "u": b2, "v": b3, "fresnel": b4}
        if "bsample" in ab:
            sc = bsdf.ScatterSample(
                wo=onb_to_world(hi.tangent, hi.bitangent, hi.n_s,
                                sample_hemisphere_cosine(b2, b3)),
                eta=b1 * 0.0, is_specular=b1 > 2.0, valid=b1 < 2.0)
        else:
            sc = bsdf.sample_mat(scene, hi.mat_id, rd, hi, rands,
                                 s["non_spec"], tex=tex)
        absorbed = cont & ~sc.valid
        terminated = terminated | absorbed
        cont = cont & sc.valid
        non_spec = s["non_spec"] | (cont & ~sc.is_specular)
        refr = sc.eta != 0.0
        if cones:
            w_refr, s_refr = propagate_refract(s["cone_w"], s["cone_s"], rd,
                                               ssa, sc.eta, sc.wo)
            cone_w = torch.where(refr, w_refr, nee_cone_w)
            cone_s = torch.where(refr, s_refr, nee_cone_s)
        eta_scale = torch.where(refr, s["eta_scale"] / (sc.eta * sc.eta),
                                s["eta_scale"])
        if "beval" in ab:
            f2, pdf2 = _ablated_eval(sc.wo, hi)
        else:
            f2, pdf2 = bsdf.eval_pdf(scene, hi.mat_id, rd, sc.wo, hi,
                                     non_spec, tex=tex)
        nan_pdf = torch.isnan(pdf2)
        terminated = terminated | (cont & nan_pdf)
        cont = cont & ~nan_pdf
        # smooth dielectrics: eval/pdf == 1 analytically
        ratio = torch.where(mat_delta[:, None], 1.0,
                            f2 / torch.clamp_min(pdf2, 1e-20)[:, None])
        ratio = torch.where(torch.isnan(ratio) | torch.isinf(ratio), 0.0,
                            ratio)
        tp = torch.where(cont[:, None], tp * ratio, tp)

        m = cont[:, None]
        if cones:
            s = dict(s, cone_w=torch.where(cont, cone_w, s["cone_w"]),
                     cone_s=torch.where(cont, cone_s, s["cone_s"]))
        s = dict(
            s,
            ro=torch.where(m, hi.p, ro),
            rd=torch.where(m, sc.wo, rd),
            fresh=fresh & ~alive,
            throughput=tp, result=result,
            non_spec=non_spec, eta_scale=eta_scale,
            prev_pdf=torch.where(cont, pdf2, s["prev_pdf"]),
            prev_delta=torch.where(cont, mat_delta, s["prev_delta"]),
            d=torch.where(cont, d + 1, d),
            n_segments=n_segments, n_shadow=n_shadow,
        )
        return refill(s, accum, terminated)

    return superstep


def _ablated_hit_info(ro, rd, hr):
    """The ``hitinfo`` stand-in: material 0 and the normal -rd at the hit
    point (vimg_tpu's)."""
    n = -rd
    z = n[:, 2] * 0.0
    return intersect.HitInfo(
        mat_id=torch.zeros(rd.shape[0], dtype=torch.int64, device=rd.device),
        p=ro + rd * hr.t[:, None], n_s=n, n_g=n,
        tangent=torch.stack([n[:, 1], -n[:, 0], z], -1),
        bitangent=torch.stack([z, n[:, 2], -n[:, 1]], -1),
        uv=n[:, :2] * 0.0, mr_uv=n[:, :2] * 0.0,
        prim_area=1.0 + hr.t * 0.0, uv_area=1e-6 + hr.t * 0.0,
        curvature=hr.t * 0.0)


def _ablated_eval(wi, hi):
    """The ``beval`` stand-in: a cosine lobe, pdf |wi.n_s| / pi and f =
    pdf / 2 (vimg_tpu's)."""
    pdf = torch.abs(dot(wi, hi.n_s)) * INV_PI
    return hi.n_s * 0.0 + pdf[:, None] * 0.5, pdf


def trace_primaries(scene, settings, tracer, morton_pix, total,
                    sample_offset=0, chunk_B=None):
    """Trace every camera ray of the frame in (Morton pixel, sample) work
    order, unsorted (consecutive work ids are one pixel's samples, then
    Morton-adjacent pixels: coherent already). Returns ``{"pre_tab": T}``,
    T the (total, 16) float32 table indexed by work id: t, prim type, prim
    id (ids as exact float32 values, below 2^24), u, v, the ray's origin
    and direction, its cone width and spread, three zero columns. The
    rays ride in the table so that the refill hands a lane the very ray
    its hit was traced with. T is allocated once and each chunk of
    ``chunk_B`` work ids (default: the frame in chunks of up to 2^20) is
    written into it."""
    spp = settings.spp
    dev = scene.device
    CB = chunk_B or min(1 << 20, -(-total // 8192) * 8192)
    tab = torch.zeros((total, 16), dtype=torch.float32, device=dev)
    for k0 in range(0, total, CB):
        k = torch.arange(k0, min(k0 + CB, total), device=dev)
        pix = morton_pix[k // spp]
        samp = k % spp + sample_offset
        ro, rd, cw, cs = _primary_rays(scene, settings, pix, samp)
        n = k.shape[0]
        hr = tracer.closest(scene, ro, rd,
                            torch.full((n,), MIN_T, device=dev),
                            torch.full((n,), INF, device=dev), sort=False)
        rows = tab[k0:k0 + n]
        for c, (_, h) in enumerate(_PRE_FIELDS):
            rows[:, c] = getattr(hr, h)
        rows[:, 5:8] = ro
        rows[:, 8:11] = rd
        rows[:, 11] = cw
        rows[:, 12] = cs
    return {"pre_tab": tab}


def _want_prepass(scene, tracer, total):
    """Opt-in: ``VIMG_PREPASS`` set and ``VIMG_NO_PREPASS`` unset, a
    tracer that takes ``sort=False`` (``presortable``), more than 64 and
    fewer than 2^24 triangles (ids ride as exact float32 values), at most
    PREPASS_MAX_TOTAL paths."""
    if not os.environ.get("VIMG_PREPASS") or \
            os.environ.get("VIMG_NO_PREPASS"):
        return False
    return (getattr(tracer, "presortable", False)
            and 64 < scene.n_tris() < (1 << 24)
            and total <= PREPASS_MAX_TOTAL)


def render_wavefront(scene: ir.Scene, settings: ir.RenderSettings,
                     tracer=None, progress=False, sample_offset=0,
                     return_stats=False):
    """Full-frame MIS render with the refill wavefront. Returns the linear
    (H, W, 3) image on the scene's device, plus (with ``return_stats``) a
    dict of supersteps, segments, shadow_rays, seconds and prepass_seconds
    (0.0 without the pre-pass). ``sample_offset`` shifts every sample id."""
    from vimg_tpu_torch.geometry.trace import make_tracer
    tracer = tracer or make_tracer(scene)
    W, H, spp = settings.width, settings.height, settings.spp
    dev = scene.device
    total = W * H * spp
    cap = settings.batch_size if settings.batch_size is not None \
        else MAX_LANES
    B = min(cap, max(total // 2, 1024))
    # safety valve far above any real superstep count
    max_supersteps = 70 * (total // B + 1) + 8192
    use_prepass = _want_prepass(scene, tracer, total)
    # the pre-pass's work order is always Morton
    use_morton = use_prepass or not os.environ.get("VIMG_NO_MORTON")

    t0 = time.time()
    morton_pix = (torch.from_numpy(
        morton_pixel_order(W, H).astype(np.int64)).to(dev)
        if use_morton else None)
    pre_tab = None
    if use_prepass:
        cb = int(os.environ.get("VIMG_PREPASS_CHUNK", 0)) or B
        pre_tab = trace_primaries(scene, settings, tracer, morton_pix, total,
                                  sample_offset, chunk_B=cb)["pre_tab"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pre_dt = time.time() - t0 if use_prepass else 0.0
    superstep = make_superstep(scene, settings, tracer, total, morton_pix,
                               pre_tab)
    state = init_state(B, dev, cones=scene.needs_cones,
                       prepass=use_prepass, sample_offset=sample_offset)
    accum = torch.zeros((3, W * H), dtype=torch.float32, device=dev)
    it = 0
    while it < max_supersteps:
        state, accum = superstep(state, accum)
        it += 1
        if int(state["n_done"]) >= total:
            break
    img = div(accum.T.reshape(H, W, 3), spp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    segs, shadow = int(state["n_segments"]), int(state["n_shadow"])
    global LAST_STATS
    LAST_STATS = dict(supersteps=it, segments=segs, shadow_rays=shadow,
                      seconds=dt, prepass_seconds=pre_dt)
    if progress:
        print(f"Render Completed: {it} supersteps, "
              f"{total / max(dt, 1e-9) / 1e6:.2f} Mpaths/s, "
              f"{(segs + shadow) / max(dt, 1e-9) / 1e6:.2f} Mrays/s "
              f"({segs / 1e6:.1f}M segments + {shadow / 1e6:.1f}M shadow"
              + (f"; prepass {pre_dt:.2f}s" if use_prepass else "") + ")")
    return (img, dict(LAST_STATS)) if return_stats else img
