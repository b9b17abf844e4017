"""The envtex slice's pure functions against vimg_tpu on the CPU: ray
cones, the mip chain and texture atlas, texture lookups and LOD, the env
map's tables, sampler, pdf and emission.

Criteria. Host-built tables (mip chains, atlas, env alias / prob / pdf
tables and mip levels) are equal byte for byte. Float functions are held
within float32 rounding, rtol 1e-5 and atol 1e-6 (RTOL, ATOL), except
where a transcendental feeds a discrete decision: torch's log2, acos,
atan2, sin and cos may differ from XLA's by an ulp, which can flip a mip
level, an alias accept or a texel; such flips are counted and bounded
(FLIP_FRAC) and the values compared where both took the same decision.
vimg_tpu's env functions and lookups run as plain jnp (no Pallas).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vimg_tpu.core import raycone as jrc
from vimg_tpu.lights import envmap as jenv
from vimg_tpu.scene import ir as jir
from vimg_tpu.textures import mipmap as jmip
from vimg_tpu.textures import texture as jtex
from vimg_tpu_torch.core import raycone as trc
from vimg_tpu_torch.lights import envmap as tenv
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.textures import mipmap as tmip
from vimg_tpu_torch.textures import texture as ttex

RTOL, ATOL = 1e-5, 1e-6
# share of lanes where an ulp of a transcendental may flip a decision
FLIP_FRAC = 2e-3


def _close(a, b, rtol=RTOL, atol=ATOL, mask=None):
    a = np.asarray(a, np.float64)
    b = b.numpy().astype(np.float64) if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# ray cones
# ---------------------------------------------------------------------------

def test_raycone_reflect_and_curvature():
    r = np.random.default_rng(1)
    n = 4000
    curv = r.normal(size=n).astype(np.float32)
    w = (r.normal(size=n) * 0.01).astype(np.float32)
    s = (r.normal(size=n) * 0.01).astype(np.float32)
    d = _unit(r.normal(size=(n, 3)))
    nn = _unit(r.normal(size=(n, 3)))
    nn[:50] = np.cross(d[:50], _unit(r.normal(size=(50, 3))))  # grazing
    dist = (r.random(n) * 10).astype(np.float32)
    j = jrc.spread_angle_from_curvature(*map(jnp.asarray, (curv, w, d, nn)))
    t = trc.spread_angle_from_curvature(*map(torch.as_tensor,
                                             (curv, w, d, nn)))
    _close(j, t, rtol=1e-4)
    jw, js = jrc.propagate_reflect(*map(jnp.asarray, (w, s, curv, dist)))
    tw, ts = trc.propagate_reflect(*map(torch.as_tensor, (w, s, curv, dist)))
    _close(jw, tw)
    _close(js, ts)
    _close(jrc.primary_cone_spread(jnp.float32(0.7853982), 256.0),
           trc.primary_cone_spread(torch.tensor(0.7853982), 256.0))


@pytest.mark.parametrize("case", ["random", "tir", "normal_incidence"])
def test_raycone_refract(case):
    """The 2D refraction construction, through total internal reflection
    (eta > 1 at grazing angles) and at normal incidence (its degenerate
    2D frame: the NaN fallback to |width|)."""
    r = np.random.default_rng({"random": 2, "tir": 3,
                               "normal_incidence": 4}[case])
    n = 3000
    w = (r.random(n) * 0.02 - 0.01).astype(np.float32)
    s = (r.normal(size=n) * 0.02).astype(np.float32)
    ssa = (r.normal(size=n) * 0.05).astype(np.float32)
    d_in = _unit(r.normal(size=(n, 3)))
    eta = (0.6 + r.random(n)).astype(np.float32)
    nrm = _unit(r.normal(size=(n, 3)))
    nrm = np.where((np.sum(nrm * d_in, -1) > 0)[:, None], -nrm, nrm)
    if case == "tir":
        eta = (1.3 + r.random(n)).astype(np.float32)
    if case == "normal_incidence":
        d_in = -nrm
    # a refracted direction of d_in through nrm (where it exists)
    c = -np.sum(d_in * nrm, -1)
    k = 1 - (1 / eta) ** 2 * (1 - c * c)
    refr = (d_in / eta[:, None] + ((c / eta) - np.sqrt(np.maximum(k, 0)))[
        :, None] * nrm)
    refr = _unit(refr)
    args = (w, s, d_in, ssa, eta, refr)
    jw, js = jrc.propagate_refract(*map(jnp.asarray, args))
    tw, ts = trc.propagate_refract(*map(torch.as_tensor, args))
    jw, js = np.asarray(jw), np.asarray(js)
    assert np.array_equal(np.isfinite(jw), np.isfinite(tw.numpy()))
    assert np.array_equal(np.isfinite(js), np.isfinite(ts.numpy()))
    f = np.isfinite(jw) & np.isfinite(js)
    # the width subtracts nearly equal terms (hit-point offsets of the
    # cone's two edges): held to 1e-3 of the widths' scale. The spread is
    # acos(d) of the two edge directions' dot d, which sits an ulp below 1
    # for thin cones, where acos(1 - k 2^-24) = sqrt(k 2^-23): an ulp or
    # four of d moves it by 3.5e-4 to 7e-4, so it is held to 1e-3
    scale = np.abs(jw[f]).max() + 1e-3
    assert (np.abs(jw - tw.numpy())[f]
            <= 1e-3 * scale + 1e-4 * np.abs(jw[f])).all()
    assert (np.abs(js - ts.numpy())[f] <= 1e-3 + 1e-4 * np.abs(js[f])).all()
    if case == "normal_incidence":
        _close(jw, tw)       # the |width| fallback (or its exact value)


# ---------------------------------------------------------------------------
# mip chain, atlas, texture lookups
# ---------------------------------------------------------------------------

def _images(seed):
    r = np.random.default_rng(seed)
    return [r.random((32, 32, 3)).astype(np.float32),
            r.random((16, 8, 3)).astype(np.float32),
            r.random((5, 7, 3)).astype(np.float32),
            r.random((1, 1, 3)).astype(np.float32)]


def test_mip_chain_and_atlas_exact():
    imgs = _images(5)
    for img in imgs:
        a, b = jmip.build_mip_chain(img), tmip.build_mip_chain(img)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    builders = (jmip.AtlasBuilder(), tmip.AtlasBuilder())
    for ab in builders:
        for k, img in enumerate(imgs):
            ab.add(img, build_mips=k != 2)
    (ja, jm_, jl), (ta, tm, tl) = (b.finalize() for b in builders)
    assert jl == tl and np.array_equal(ja, ta) and np.array_equal(jm_, tm)
    assert ja.dtype == ta.dtype and jm_.dtype == tm.dtype
    # the empty atlas
    assert all(np.array_equal(x, y) for x, y in zip(
        jmip.AtlasBuilder().finalize()[:2], tmip.AtlasBuilder().finalize()[:2]))
    x = np.random.default_rng(6).random((9, 9, 3)).astype(np.float32)
    assert np.array_equal(jmip.srgb_to_linear(x), tmip.srgb_to_linear(x))
    assert np.array_equal(jmip.rgb_to_normal(x * 255, 0.7),
                          tmip.rgb_to_normal(x * 255, 0.7))


class _Hit:
    """The HitInfo fields the texture functions read."""

    def __init__(self, lib, uv, uv_area, prim_area, n_g):
        cast = jnp.asarray if lib == "jax" else torch.as_tensor
        self.uv, self.mr_uv = cast(uv), cast(uv)
        self.uv_area, self.prim_area = cast(uv_area), cast(prim_area)
        self.n_g = cast(n_g)


def _atlas_scenes():
    """vimg_tpu's and the port's scene with two image textures and a
    checker (an 8 x 4 board), built by each package's own SceneBuilder."""
    from vimg_tpu.render.camera import Camera as JCam
    from vimg_tpu.scene.json_loader import SceneBuilder as JB
    from vimg_tpu_torch.scene.json_loader import SceneBuilder as TB
    imgs = _images(7)
    out = []
    for B, mip, kw in ((JB, jmip, {}), (TB, tmip, {"device": "cpu"})):
        b = B()
        ab = mip.AtlasBuilder()
        a0 = ab.add(imgs[0])
        a1 = ab.add(imgs[1])
        t0 = b.add_texture(jir.TEX_IMAGE, atlas_id=a0)
        t1 = b.add_texture(jir.TEX_IMAGE, atlas_id=a1)
        t2 = b.add_texture(jir.TEX_CHECKER, col_a=(0.9, 0.1, 0.1),
                           col_b=(0.1, 0.1, 0.9), wh=(8, 4))
        for t in (t0, t1, t2):
            b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5),
                           tex=(t, -1, -1))
        b.add_sphere((0, 0, 0), 1.0, 0)
        atlas, meta, _ = ab.finalize()
        c2w = np.eye(4, dtype=np.float32)
        cam = (JCam.make(c2w, 8, 8, 45.0) if B is JB else
               dict(cam2world=c2w, width=8, height=8, vfov_deg=45.0))
        out.append(b.build(camera=cam, atlas=dict(
            atlas=jnp.asarray(atlas) if B is JB else atlas,
            atlas_meta=jnp.asarray(meta) if B is JB else meta), **kw))
    return out


def test_atlas_lookups_and_lod():
    js, ts = _atlas_scenes()
    assert ts.has_image_tex and ts.has_checker
    r = np.random.default_rng(8)
    n = 5000
    uv = (r.random((n, 2)) * 5 - 2).astype(np.float32)
    tex = r.integers(0, 2, n).astype(np.int32)
    level = r.integers(-1, 8, n).astype(np.int32)
    lod = (r.random(n) * 8 - 1).astype(np.float32)
    j = jtex._atlas_fetch_bilinear(js, jnp.asarray(level), jnp.asarray(tex),
                                   jnp.asarray(uv))
    t = ttex._atlas_fetch_bilinear(ts, torch.as_tensor(level).long(),
                                   torch.as_tensor(tex).long(),
                                   torch.as_tensor(uv))
    _close(j, t)
    _close(jtex.atlas_trilinear(js, jnp.asarray(tex), jnp.asarray(uv),
                                jnp.asarray(lod)),
           ttex.atlas_trilinear(ts, torch.as_tensor(tex).long(),
                                torch.as_tensor(uv), torch.as_tensor(lod)))
    # the ray-cone LOD, and a trilinear fetch at it (level flips counted)
    uv_area = (r.random(n) * 0.1).astype(np.float32)
    prim_area = (r.random(n) * 0.1 + 1e-4).astype(np.float32)
    n_g = _unit(r.normal(size=(n, 3)))
    rd = _unit(r.normal(size=(n, 3)))
    cw = (r.normal(size=n) * 0.01).astype(np.float32)
    jh = _Hit("jax", uv, uv_area, prim_area, n_g)
    th = _Hit("torch", uv, uv_area, prim_area, n_g)
    jl = np.asarray(jtex.texture_lod(js, jnp.asarray(tex), jh,
                                     jnp.asarray(cw), jnp.asarray(rd)))
    tl = ttex.texture_lod(ts, torch.as_tensor(tex).long(), th,
                          torch.as_tensor(cw), torch.as_tensor(rd))
    _close(jl, tl, rtol=1e-5, atol=1e-5)
    flips = np.floor(jl - 2.0) != np.floor(tl.numpy() - 2.0)
    assert flips.mean() <= FLIP_FRAC
    mid = np.asarray(r.integers(0, 2, n), np.int32)
    jc = jtex.base_color_at_hit(js, jnp.asarray(mid), jh, jnp.asarray(cw),
                                jnp.asarray(rd))
    tc = ttex.base_color_at_hit(ts, torch.as_tensor(mid).long(), th,
                                torch.as_tensor(cw), torch.as_tensor(rd))
    _close(jc, tc, rtol=1e-4, atol=1e-4, mask=~flips)
    # metal-rough factors (1, 1) without a texture, and a normal map
    mr_tex = np.where(r.random(n) < 0.3, -1, tex).astype(np.int32)
    _close(jtex.metal_rough_at_uv(js, jnp.asarray(mr_tex), jnp.asarray(uv)),
           ttex.metal_rough_at_uv(ts, torch.as_tensor(mr_tex).long(),
                                  torch.as_tensor(uv)))
    _close(jtex.normal_at_uv(js, jnp.asarray(tex), jnp.asarray(uv)),
           ttex.normal_at_uv(ts, torch.as_tensor(tex).long(),
                             torch.as_tensor(uv)))


def test_checker_color():
    """Checker squares: equal colours except where floor(uv * wh) sits on
    a square's edge."""
    js, ts = _atlas_scenes()
    r = np.random.default_rng(9)
    n = 5000
    uv = (r.random((n, 2)) * 4 - 1).astype(np.float32)
    uv[:8] = [[0.125, 0.25], [0.5, 0.5], [-0.125, 0.0], [0.0, -0.25],
              [1.0, 1.0], [0.99999994, 0.0], [-1.0, 0.75], [0.0625, 0.125]]
    tid = np.full(n, 2, np.int32)
    j = jtex._checker_color(js, jnp.asarray(tid), jnp.asarray(uv))
    t = ttex._checker_color(ts, torch.as_tensor(tid).long(),
                            torch.as_tensor(uv))
    assert np.array_equal(np.asarray(j), t.numpy())


def test_repeat_wrap_pinned():
    """UVs wrap by repeat only (vimg_tpu's _wrap_repeat; the reference's
    other wrap modes are ROADMAP C5): fract with negatives folded up."""
    x = np.array([-2.25, -1.0, -0.75, -1e-8, 0.0, 0.3, 1.0, 1.75, 7.5,
                  -7.5], np.float32)
    j = np.asarray(jtex._wrap_repeat(jnp.asarray(x)))
    t = ttex._wrap_repeat(torch.as_tensor(x)).numpy()
    assert np.array_equal(j, t)
    assert np.array_equal(t[[0, 2, 5, 7, 8, 9]],
                          np.float32([0.75, 0.25, 0.3, 0.75, 0.5, 0.5]))
    assert t[1] == 0.0 and t[6] == 0.0


# ---------------------------------------------------------------------------
# env map
# ---------------------------------------------------------------------------

def _env_image(h=16, w=32, seed=10):
    r = np.random.default_rng(seed)
    th = (np.arange(h) + 0.5) / h * np.pi
    ph = (np.arange(w) + 0.5) / w * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sky = np.stack([0.3 + 0.3 * np.cos(tt), 0.45 + 0.3 * np.cos(tt),
                    0.8 + 0.15 * np.cos(tt)], -1)
    sun = np.exp(-((tt - 0.9) ** 2 + (pp - 1.1) ** 2) / 0.02)[..., None]
    return (sky + 50 * sun + 0.05 * r.random((h, w, 3))).astype(np.float32)


def _env_to_world():
    c, s = np.cos(0.6), np.sin(0.6)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return m


def test_env_tables_exact():
    img = _env_image()
    for kw in ({}, {"env_to_world": _env_to_world(), "radiance_scale": 2.5},
               {"n_mips": 2}):
        j = jenv.build_env_tables(img, **kw)
        t = tenv.build_env_tables(img, **kw)
        assert set(j) == set(t)
        assert len(j["env_mips"]) == len(t["env_mips"])
        for a, b in zip(j["env_mips"], t["env_mips"]):
            assert np.array_equal(np.asarray(a), b)
        for k in j:
            if k != "env_mips":
                a = np.asarray(j[k])
                assert a.dtype == np.asarray(t[k]).dtype, k
                assert np.array_equal(a, t[k]), k
    # the alias table reproduces the texel distribution it was built for
    p = np.random.default_rng(11).random(257)
    p /= p.sum()
    prob, alias = tenv._build_alias(p)
    got = prob.astype(np.float64) / p.size
    np.add.at(got, alias, (1.0 - prob.astype(np.float64)) / p.size)
    np.testing.assert_allclose(got, p, rtol=1e-6, atol=1e-9)


def _env_scenes(rotated):
    """vimg_tpu's and the port's scene (one sphere) under the test env."""
    from vimg_tpu.render.camera import Camera as JCam
    from vimg_tpu.scene.json_loader import SceneBuilder as JB
    from vimg_tpu_torch.scene.json_loader import SceneBuilder as TB
    kw = {"env_to_world": _env_to_world()} if rotated else {}
    img = _env_image()
    out = []
    for B, env in ((JB, jenv.build_env_tables(img, **kw)),
                   (TB, tenv.build_env_tables(img, **kw))):
        b = B()
        b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
        b.add_sphere((0, 0, 0), 1.0, 0)
        c2w = np.eye(4, dtype=np.float32)
        if B is JB:
            out.append(b.build(camera=JCam.make(c2w, 8, 8, 45.0), env=env,
                               bg_light=True))
        else:
            out.append(b.build(camera=dict(cam2world=c2w, width=8, height=8,
                                           vfov_deg=45.0), env=env,
                               bg_light=True, device="cpu"))
    return out


@pytest.mark.parametrize("rotated", [False, True])
def test_env_sample_pdf_emit(rotated):
    js, ts = _env_scenes(rotated)
    tf, tm = tir.scene_to_numpy(ts)
    jf, jm = tir.scene_to_numpy(js)
    assert tm == jm
    r = np.random.default_rng(12)
    n = 20000
    r1, r2 = (r.random(n).astype(np.float32) for _ in range(2))
    jrad, jwi, jpdf = (np.asarray(x) for x in jenv.env_sample(
        js, jnp.asarray(r1), jnp.asarray(r2)))
    trad, twi, tpdf = tenv.env_sample(ts, torch.as_tensor(r1),
                                      torch.as_tensor(r2))
    # the texel each draw took: the accept decision a < prob[j0] is
    # exact here (products and a subtraction of float32 values), so no
    # draw may take another texel
    _close(jrad, trad, rtol=1e-5, atol=1e-5)
    _close(jwi, twi, rtol=1e-5, atol=2e-6)
    _close(jpdf, tpdf, rtol=1e-4, atol=1e-6)
    # the pdf query on random directions and on the sampled ones
    d = _unit(r.normal(size=(n, 3)))
    jp = np.asarray(jenv.env_pdf(js, jnp.asarray(d)))
    tp = tenv.env_pdf(ts, torch.as_tensor(d)).numpy()
    texel = np.abs(jp - tp) > 1e-4 * np.abs(jp) + 1e-6
    assert texel.mean() <= FLIP_FRAC      # a texel edge moved by an ulp
    tp2 = tenv.env_pdf(ts, twi).numpy()
    assert (np.abs(tp2 - tpdf.numpy()) <= 1e-3 * tpdf.numpy() + 1e-6
            ).mean() > 0.99
    # emission: the cone's spread picks the mip levels
    spread = (10.0 ** r.uniform(-5, 0, n)).astype(np.float32)
    spread[:10] = [0.0, np.nan, -0.01, 1e-30, 3.0, 0.5, 1e-3, 2e-3, 4e-3,
                   8e-3]
    je_ = np.asarray(jenv.env_emit(js, jnp.asarray(d), jnp.asarray(spread)))
    te_ = tenv.env_emit(ts, torch.as_tensor(d), torch.as_tensor(spread))
    lam = np.log2(np.maximum(np.abs(spread), 1e-20) * (16 / np.pi)) - 2.0
    near = np.abs(lam - np.round(lam)) < 1e-5     # a level boundary
    bad = (np.abs(je_ - te_.numpy()) > 1e-4 * np.abs(je_) + 1e-5).any(-1)
    assert (bad & ~near).mean() <= FLIP_FRAC
    # the flat pyramid is built once a scene
    assert tenv._flat_pyramid(ts.env_mips)[0] is \
        tenv._flat_pyramid(ts.env_mips)[0]


def test_env_sample_one_uniform_pinned():
    """ROADMAP C1, matched on purpose: one 24-bit uniform r1 picks the
    alias slot j0 = floor(r1 N), and its residual a = r1 N - j0 is both
    the accept draw and, rescaled, the sub-texel dv; r2 is du alone."""
    js, ts = _env_scenes(False)
    H, W = ts.env_mips[0].shape[:2]
    N = H * W
    prob = ts.env_prob.numpy()
    alias = ts.env_alias.numpy()
    r = np.random.default_rng(13)
    r1 = r.random(4000).astype(np.float32)
    r2 = r.random(4000).astype(np.float32)
    x = r1 * np.float32(N)
    j0 = np.clip(x.astype(np.int64), 0, N - 1)
    a = x - j0.astype(np.float32)
    pr = prob[j0]
    acc = a < pr
    j = np.where(acc, j0, alias[j0])
    dv = np.where(acc, a / np.maximum(pr, np.float32(1e-12)),
                  (a - pr) / np.maximum(np.float32(1.0) - pr,
                                        np.float32(1e-12)))
    dv = np.clip(dv, 0.0, np.float32(1.0 - 1e-7)).astype(np.float32)
    v = (j // W + dv).astype(np.float32) / np.float32(H)
    _, wi, _ = tenv.env_sample(ts, torch.as_tensor(r1), torch.as_tensor(r2))
    np.testing.assert_allclose(wi.numpy()[:, 1], np.cos(np.pi * v),
                               atol=2e-6)
    # the same r1 with another r2 moves only du (u), never the elevation
    _, wi2, _ = tenv.env_sample(ts, torch.as_tensor(r1),
                                torch.as_tensor(1.0 - r2))
    np.testing.assert_allclose(wi2.numpy()[:, 1], wi.numpy()[:, 1],
                               atol=2e-7)


def test_srgb_decode():
    """film.srgb_decode (8-bit sRGB textures to linear) against
    vimg_tpu's, and as the inverse of srgb_encode."""
    from vimg_tpu.render import film as jfilm
    from vimg_tpu_torch.render import film as tfilm
    x = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    j = np.asarray(jfilm.srgb_decode(jnp.asarray(x)))
    t = tfilm.srgb_decode(torch.as_tensor(x))
    _close(j, t)
    back = tfilm.srgb_encode(t).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=2e-6)
