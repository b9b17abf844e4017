"""vimg_tpu_torch materials and lights against vimg_tpu on the same hits,
directions and random numbers (every flagship material, plus the smooth
dielectric of the unit-scale test scene).

Tolerances, and why:
- sampled directions and eval values: 1e-5 relative with a 1e-5 absolute
  floor. They chain a dozen float32 operations, and XLA's CPU code may
  contract a*b + c into an FMA and round sin/cos/log/pow differently from
  ATen by an ulp or two.
- pdfs: the same bound must hold for 99.5% of rays. The rough-glass
  refraction terms divide by (h.i + eta h.o)^2 and subtract nearly equal
  numbers, so near-grazing configurations are ill-conditioned: there both
  float32 results sit up to tens of percent away from a float64 reference,
  and from each other.
- validity masks and lobe choices: equal except on at most 0.1% of rays
  (a random number within an ulp of a lobe threshold).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.core.math import onb_from_normal
from vimg_tpu.geometry.intersect import HitInfo as JHit
from vimg_tpu.lights import emitters as je
from vimg_tpu.materials import bsdf as jb
from vimg_tpu_torch.geometry.intersect import HitInfo as THit
from vimg_tpu_torch.lights import emitters as te
from vimg_tpu_torch.materials import bsdf as tb
from vimg_tpu_torch.scene import ir as tir

B = 8000
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    from __graft_entry__ import _flagship_scene
    js, _ = _flagship_scene()
    return js, tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def unit_scenes():
    from vimg_tpu.core.math import look_at
    from vimg_tpu.render.camera import Camera
    from vimg_tpu.scene import ir as jir
    from vimg_tpu.scene.json_loader import SceneBuilder
    b = SceneBuilder()
    red = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(jir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={jir.MS_IOR: 1.5})
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    js = b.build(camera=Camera.make(look_at([0, 0, 6], [0.7, 0, 0],
                                            [0, 1, 0]), 32, 24, 45.0))
    return js, tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed, mat):
    r = np.random.default_rng(seed)
    n = _unit(r.normal(size=(B, 3)))
    u, v = (np.array(x) for x in onb_from_normal(jnp.asarray(n)))
    return dict(
        mid=np.full(B, mat, np.int32), n=n, u=u, v=v,
        p=r.normal(size=(B, 3)).astype(np.float32),
        wi=_unit(r.normal(size=(B, 3))), wo=_unit(r.normal(size=(B, 3))),
        rands={k: r.random(B).astype(np.float32)
               for k in ("lobe", "u", "v", "fresnel")},
        reg=r.random(B) < 0.5)


def _hits(x):
    z2, z1 = np.zeros((B, 2), np.float32), np.zeros(B, np.float32)
    jh = JHit(mat_id=jnp.asarray(x["mid"]), p=jnp.asarray(x["p"]),
              n_s=jnp.asarray(x["n"]), n_g=jnp.asarray(x["n"]), uv=z2,
              mr_uv=z2, tangent=jnp.asarray(x["u"]),
              bitangent=jnp.asarray(x["v"]), prim_area=z1, uv_area=z1,
              curvature=z1, light_id=jnp.asarray(x["mid"]))
    th = THit(mat_id=torch.as_tensor(x["mid"]).long(),
              p=torch.as_tensor(x["p"]), n_s=torch.as_tensor(x["n"]),
              n_g=torch.as_tensor(x["n"]), tangent=torch.as_tensor(x["u"]),
              bitangent=torch.as_tensor(x["v"]))
    return jh, th


def _close(a, b, frac=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    f = np.isfinite(a)
    if not f.any():
        return
    bad = np.abs(a[f] - b[f]) > ATOL + RTOL * np.abs(a[f])
    assert bad.mean() <= frac, (bad.mean(), np.abs(a[f] - b[f]).max())


def _check_material(js, ts, mat, seed):
    x = _inputs(seed, mat)
    jh, th = _hits(x)
    jmid, tmid = jnp.asarray(x["mid"]), torch.as_tensor(x["mid"]).long()
    jwi, twi = jnp.asarray(x["wi"]), torch.as_tensor(x["wi"])
    jwo, two = jnp.asarray(x["wo"]), torch.as_tensor(x["wo"])
    jreg, treg = jnp.asarray(x["reg"]), torch.as_tensor(x["reg"])

    js_ = jb.sample_mat(js, jmid, jwi, jh, {k: jnp.asarray(v) for k, v in
                                             x["rands"].items()}, jreg)
    ts_ = tb.sample_mat(ts, tmid, twi, th, {k: torch.as_tensor(v) for k, v
                                            in x["rands"].items()}, treg)
    agree = (np.asarray(js_.valid) == ts_.valid.numpy()) & (
        np.asarray(js_.is_specular) == ts_.is_specular.numpy())
    assert (~agree).mean() <= 1e-3
    ok = agree & ts_.valid.numpy()
    _close(np.asarray(js_.wo)[ok], ts_.wo.numpy()[ok], frac=1e-3)
    _close(np.asarray(js_.eta)[agree], ts_.eta.numpy()[agree], frac=1e-3)

    jf, jp = jb.eval_pdf(js, jmid, jwi, jwo, jh, jreg)
    tf, tp = tb.eval_pdf(ts, tmid, twi, two, th, treg)
    _close(jf, tf, frac=5e-3)
    _close(jp, tp, frac=5e-3)
    jr = jb.eval_div_pdf(js, jmid, jwi, jwo, jh, jreg)
    tr = tb.eval_div_pdf(ts, tmid, twi, two, th, treg)
    _close(jr, tr, frac=5e-3)
    return int(ok.sum())


@pytest.mark.parametrize("mat", range(8))
def test_flagship_material(scenes, mat):
    """0 white Lambertian, 1 light, 2..7 the six Principled spheres."""
    js, ts = scenes
    n_valid = _check_material(js, ts, mat, seed=10 + mat)
    assert (n_valid == 0) == (mat == 1)     # lights absorb every sample


@pytest.mark.parametrize("mat", range(3))
def test_unit_scene_material(unit_scenes, mat):
    """Lambertian, smooth dielectric and light of the unit-scale scene."""
    js, ts = unit_scenes
    _check_material(js, ts, mat, seed=20 + mat)


def test_emitted_and_flags(scenes):
    js, ts = scenes
    x = _inputs(30, 1)
    jh, th = _hits(x)
    je_ = jb.emitted(js, jnp.asarray(x["mid"]), jnp.asarray(x["wi"]),
                     jnp.asarray(x["n"]))
    te_ = tb.emitted(ts, torch.as_tensor(x["mid"]).long(),
                     torch.as_tensor(x["wi"]), torch.as_tensor(x["n"]))
    assert np.array_equal(np.asarray(je_), te_.numpy())
    mids = np.arange(8)
    assert np.array_equal(np.asarray(jb.is_delta(js, mids)),
                          tb.is_delta(ts, torch.as_tensor(mids)).numpy())


@pytest.mark.parametrize("which", ["flagship", "unit"])
def test_sample_lights_and_surf_pdf(scenes, unit_scenes, which):
    js, ts = scenes if which == "flagship" else unit_scenes
    scale = 500.0 if which == "flagship" else 2.0
    r = np.random.default_rng(40)
    p = (r.normal(size=(B, 3)) * scale).astype(np.float32)
    pick, r1, r2 = (r.random(B).astype(np.float32) for _ in range(3))
    jls = je.sample_lights(js, *map(jnp.asarray, (p, pick, r1, r2)))
    tls = te.sample_lights(ts, *map(torch.as_tensor, (p, pick, r1, r2)))
    for k in ("radiance", "wi", "pdf", "dist", "G"):
        _close(np.asarray(getattr(jls, k)), getattr(tls, k).numpy(),
               frac=1e-3)
    # surf_pdf of the sampled light points, as a BSDF hit would see them
    n_l = ts.n_lights()
    idx = np.clip((pick * n_l).astype(np.int64), 0, n_l - 1)
    lt = np.asarray(js.light_type)[idx]
    lidx = np.asarray(js.light_idx)[idx]
    ptype = np.where(lt == tir.LIGHT_TRI, tir.PRIM_TRI, tir.PRIM_SPHERE)
    q = p + np.asarray(jls.wi) * np.asarray(jls.dist)[:, None]
    jsp = je.surf_pdf(js, *map(jnp.asarray, (ptype, lidx, p, q,
                                             np.asarray(jls.wi))))
    tsp = te.surf_pdf(ts, torch.as_tensor(ptype), torch.as_tensor(lidx).long(),
                      *map(torch.as_tensor, (p, q, np.array(jls.wi))))
    _close(jsp, tsp, frac=1e-3)


def test_background(scenes):
    js, ts = scenes
    d = _unit(np.random.default_rng(50).normal(size=(100, 3)))
    assert np.array_equal(np.asarray(je.background_emit(js, jnp.asarray(d),
                                                        None)),
                          te.background_emit(ts, torch.as_tensor(d)).numpy())
    assert np.array_equal(np.asarray(je.background_pdf(js, jnp.asarray(d))),
                          te.background_pdf(ts, torch.as_tensor(d)).numpy())
