"""vimg_tpu_torch.geometry against vimg_tpu.geometry on the same rays.

Primitive tests and the SoA tracer must return the same closest hit
(t, prim id, u, v). Tolerances: t to 1e-6 relative; barycentrics to 1e-6
relative with a 1e-5 absolute floor (u, v come from differences of
~1e3-magnitude dot products on the flagship scene, where XLA's FMA
contraction moves the last few bits). Ids must agree except on rays whose
two nearest hits are within 1e-5 relative of each other (an exact tie
break that either rounding can flip); the test counts those explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.geometry import intersect as ji
from vimg_tpu.geometry.soa_intersect import SoATracer as JSoA
from vimg_tpu_torch.geometry import intersect as ti
from vimg_tpu_torch.geometry.soa_intersect import SoATracer as TSoA
from vimg_tpu_torch.geometry import soa_intersect as tsoa
from vimg_tpu_torch.geometry.trace import make_tracer
from vimg_tpu_torch.scene import ir as tir


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def flagship():
    from __graft_entry__ import _flagship_scene
    js, st = _flagship_scene()
    return js, tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _scene_rays(n, seed):
    """Rays from inside the flagship box toward random directions."""
    r = np.random.default_rng(seed)
    ro = (r.random((n, 3)) * [1200, 500, 500] - [600, 250, 250])
    rd = r.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def test_tri_intersect():
    r = np.random.default_rng(0)
    n = 4000
    p = r.normal(size=(3, n, 3)).astype(np.float32)
    ro = r.normal(size=(n, 3)).astype(np.float32) * 3
    # aim most rays at a point inside (or just outside) their triangle
    w = r.dirichlet([1, 1, 1], n).astype(np.float32) * 1.2 - 0.066
    target = w[:, 0:1] * p[0] + w[:, 1:2] * p[1] + w[:, 2:3] * p[2]
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    mn = np.full(n, 1e-4, np.float32)
    mx = np.full(n, np.inf, np.float32)
    jo = ji.tri_intersect(*map(jnp.asarray, (ro, rd, *p, mn, mx)))
    to = ti.tri_intersect(*map(torch.as_tensor, (ro, rd, *p, mn, mx)))
    hit_j, hit_t = np.asarray(jo[4]), to[4].numpy()
    assert (hit_j != hit_t).mean() < 1e-3     # edge-on rays may flip
    both = hit_j & hit_t
    assert both.sum() > 1000
    for a, b in zip(jo[:4], to[:4]):
        _close(np.asarray(a)[both], b.numpy()[both], atol=1e-5)


def test_sphere_intersect():
    r = np.random.default_rng(1)
    n = 4000
    ro = r.normal(size=(n, 3)).astype(np.float32) * 3
    rd = r.normal(size=(n, 3)).astype(np.float32)
    c = r.normal(size=(n, 3)).astype(np.float32)
    rad = (r.random(n) + 0.5).astype(np.float32)
    mn = np.full(n, 1e-4, np.float32)
    mx = np.full(n, np.inf, np.float32)
    jt, jh = ji.sphere_intersect(*map(jnp.asarray, (ro, rd, c, rad, mn, mx)))
    tt, th = ti.sphere_intersect(*map(torch.as_tensor,
                                      (ro, rd, c, rad, mn, mx)))
    assert np.array_equal(np.asarray(jh), th.numpy())
    h = th.numpy()
    _close(np.asarray(jt)[h], tt.numpy()[h])


def _check_hits(jh, th, scene_ref):
    jt, tt = np.asarray(jh.t), th.t.numpy()
    assert np.array_equal(np.isfinite(jt), np.isfinite(tt))
    f = np.isfinite(jt)
    _close(jt[f], tt[f])
    same = (np.asarray(jh.prim_type) == th.prim_type.numpy()) & (
        np.asarray(jh.prim_id) == th.prim_id.numpy())
    assert (~same[f]).sum() <= max(2, int(1e-3 * f.sum()))
    m = f & same & (th.prim_type.numpy() == tir.PRIM_TRI)
    _close(np.asarray(jh.u)[m], th.u.numpy()[m], atol=1e-5)
    _close(np.asarray(jh.v)[m], th.v.numpy()[m], atol=1e-5)
    return f.sum()


def test_soa_closest_hits_flagship(flagship):
    js, ts = flagship
    jtr, ttr = JSoA(js), TSoA(ts)
    assert np.array_equal(jtr.tri_c, ttr.tri_c)
    assert np.array_equal(jtr.sph_c, ttr.sph_c)
    ro, rd = _scene_rays(5000, 2)
    mn = np.full(len(ro), 1e-4, np.float32)
    mx = np.full(len(ro), np.inf, np.float32)
    jh = jtr.closest(js, *map(jnp.asarray, (ro, rd, mn, mx)))
    th = ttr.closest(ts, *map(torch.as_tensor, (ro, rd, mn, mx)))
    assert _check_hits(jh, th, js) > 4000
    # any-hit with a finite max distance
    mx2 = np.full(len(ro), 300.0, np.float32)
    jo = np.asarray(jtr.occluded(js, *map(jnp.asarray, (ro, rd, mn, mx2))))
    to = ttr.occluded(ts, *map(torch.as_tensor, (ro, rd, mn, mx2))).numpy()
    assert (jo != to).mean() < 1e-3


def test_bruteforce_tracer(flagship):
    js, ts = flagship
    ro, rd = _scene_rays(3000, 3)
    mn = np.full(3000, 1e-4, np.float32)
    jh = ji.intersect_bruteforce(js, *map(jnp.asarray, (
        ro, rd, mn, np.full(3000, np.inf, np.float32))))
    tr = make_tracer(ts, force="brute")
    th = tr.closest(ts, *map(torch.as_tensor, (
        ro, rd, mn, np.full(3000, np.inf, np.float32))))
    assert _check_hits(jh, th, js) > 2000
    mx = np.full(3000, 300.0, np.float32)
    jo = np.asarray(ji.occlude_bruteforce(js, *map(jnp.asarray,
                                                   (ro, rd, mn, mx))))
    to = tr.occluded(ts, *map(torch.as_tensor, (ro, rd, mn, mx))).numpy()
    assert (jo != to).mean() < 1e-3


def test_hit_info_flagship(flagship):
    js, ts = flagship
    ro, rd = _scene_rays(4000, 4)
    mn = np.full(len(ro), 1e-4, np.float32)
    mx = np.full(len(ro), np.inf, np.float32)
    th = TSoA(ts).closest(ts, *map(torch.as_tensor, (ro, rd, mn, mx)))
    # feed vimg_tpu the port's HitResult so both shade the same hit
    jh = ji.HitResult(t=jnp.asarray(th.t.numpy()),
                      prim_type=jnp.asarray(th.prim_type.numpy(), jnp.int32),
                      prim_id=jnp.asarray(th.prim_id.numpy(), jnp.int32),
                      u=jnp.asarray(th.u.numpy()), v=jnp.asarray(th.v.numpy()))
    jhi = ji.hit_info(js, jnp.asarray(ro), jnp.asarray(rd), jh)
    thi = ti.hit_info(ts, torch.as_tensor(ro), torch.as_tensor(rd), th)
    f = np.isfinite(th.t.numpy())
    assert np.array_equal(np.asarray(jhi.mat_id)[f], thi.mat_id.numpy()[f])
    _close(np.asarray(jhi.p)[f], thi.p.numpy()[f], atol=1e-6 * 1300)
    for k in ("n_s", "n_g", "tangent", "bitangent"):
        _close(np.asarray(getattr(jhi, k))[f], getattr(thi, k).numpy()[f])


def test_make_tracer_limits(flagship):
    """<= 64 primitives: SoA; more triangles with <= 64 spheres: the
    cluster tracer; more spheres than that: the BVH tracer."""
    from vimg_tpu_torch.geometry.bvh import BVHTracer
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    _, ts = flagship
    assert isinstance(make_tracer(ts), TSoA)
    big = ts.replace(tri_vidx=ts.tri_vidx.repeat(6, 1),
                     tri_mat=ts.tri_mat.repeat(6),
                     tri_flags=ts.tri_flags.repeat(6))
    assert isinstance(make_tracer(big), ClusterTracer)
    many = big.replace(sph_center=torch.zeros((65, 3)),
                       sph_radius=torch.ones(65),
                       sph_mat=torch.zeros(65, dtype=torch.int64))
    assert isinstance(make_tracer(many), BVHTracer)


def test_tri_constants_verbatim(flagship):
    from vimg_tpu.geometry.soa_intersect import tri_constants as jtc
    js, _ = flagship
    v, t = np.asarray(js.verts), np.asarray(js.tri_vidx)
    assert np.array_equal(jtc(v, t), tsoa.tri_constants(v, t))
