"""The product-formulation brute-force tracer
(vimg_tpu_torch/geometry/mxu_intersect.py, ``make_tracer(force="mxu")``)
against vimg_tpu's MXUBruteForceTracer on the CPU.

Criteria: tests/test_fast_tracers.py's tolerances (hit agreement and prim
id agreement above 0.999, t within rtol = atol = 1e-3, u within 2e-3,
occlusion agreement above 0.999) on tests/test_bvh.py's
_random_tri_scene(25, 6) (25 triangles, 6 spheres) at 2,048 rays; the
tables equal vimg_tpu's (float64 host math, float32 store); the chunked
pass equal to the unchunked one bit for bit; make_tracer's warning text
vimg_tpu's.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from vimg_tpu_torch.geometry import mxu_intersect as tm
from vimg_tpu_torch.scene import ir as tir

B = 2048


@pytest.fixture(scope="module")
def scenes():
    """vimg_tpu's _random_tri_scene(25, 6) and the port's copy of it."""
    from tests.test_bvh import _random_tri_scene
    js = _random_tri_scene(25, 6)
    jf, meta = tir.scene_to_numpy(js)
    return js, tir.scene_from_numpy(jf, meta, device="cpu")


def _rays(n=B, seed=1):
    """tests/test_fast_tracers.py's rays."""
    r = np.random.default_rng(seed)
    ro = r.uniform(-15, 15, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _aimed_rays(scene, n=B, seed=2):
    """Rays from random origins toward random points near the triangles'
    and spheres' centres: most of them hit."""
    r = np.random.default_rng(seed)
    c = np.concatenate([scene.verts.numpy()[scene.tri_vidx.numpy()]
                        .mean(1), scene.sph_center.numpy()])
    ro = r.uniform(-15, 15, (n, 3)).astype(np.float32)
    rd = (c[r.integers(0, c.shape[0], n)]
          + r.normal(0, 0.3, (n, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def test_tables_equal_vimg_tpu(scenes):
    from vimg_tpu.geometry.mxu_intersect import build_tables
    js, ts = scenes
    jw, ja = build_tables(js)
    tw, ta = tm.build_tables(ts)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())


@pytest.mark.parametrize("kind", ["random", "aimed"])
def test_matches_vimg_tpu(scenes, kind):
    """test_fast_tracers.py's random rays (few hit), and aimed rays."""
    import jax.numpy as jnp
    from vimg_tpu.geometry.mxu_intersect import MXUBruteForceTracer
    js, ts = scenes
    ro, rd = _rays() if kind == "random" else _aimed_rays(ts)
    jt = MXUBruteForceTracer(js)
    ref = jt.closest(js, jnp.asarray(ro), jnp.asarray(rd),
                     jnp.full((B,), 1e-4), jnp.full((B,), jnp.inf))
    tr = tm.MXUBruteForceTracer(ts)
    got = tr.closest(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                     torch.full((B,), 1e-4), torch.full((B,), float("inf")))
    t1, t2 = np.asarray(ref.t), got.t.numpy()
    assert (np.isfinite(t1) == np.isfinite(t2)).mean() > 0.999
    both = np.isfinite(t1) & np.isfinite(t2)
    assert both.sum() > (10 if kind == "random" else 500)
    assert np.allclose(t1[both], t2[both], rtol=1e-3, atol=1e-3)
    assert (np.asarray(ref.prim_id)[both]
            == got.prim_id.numpy()[both]).mean() > 0.999
    assert (np.asarray(ref.prim_type)[both]
            == got.prim_type.numpy()[both]).all()
    tri = both & (np.asarray(ref.prim_type) == 0)
    if kind == "aimed":
        assert tri.sum() > 150 and (both & ~tri).sum() > 150
    assert np.allclose(np.asarray(ref.u)[tri], got.u.numpy()[tri],
                       atol=2e-3)
    assert np.allclose(np.asarray(ref.v)[tri], got.v.numpy()[tri],
                       atol=2e-3)
    occ_ref = np.asarray(jt.occluded(js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.full((B,), 1e-4),
                                     jnp.full((B,), 10.0)))
    occ = tr.occluded(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                      torch.full((B,), 1e-4), torch.full((B,), 10.0))
    assert occ.dtype == torch.bool
    assert (occ_ref == occ.numpy()).mean() > 0.999


@pytest.mark.parametrize("max_bytes", [200, 4096, 50_000])
def test_chunked_equals_unchunked(scenes, max_bytes):
    """Blocks of rays x primitives down to one ray x 8 primitives: the
    same (t, type, id, u, v) bit for bit as one block, misses and ties
    included (a copy of every triangle after the originals ties each hit
    exactly)."""
    _, ts = scenes
    nt = ts.n_tris()
    tv = ts.tri_vidx
    twin = dataclasses.replace(
        ts, tri_vidx=torch.cat([tv, tv]),
        tri_mat=torch.cat([ts.tri_mat, ts.tri_mat]),
        **{f: torch.cat([getattr(ts, f), getattr(ts, f)])
           for f in ("tri_flags",) if getattr(ts, "tri_flags", None)
           is not None})
    ro, rd = (torch.from_numpy(np.concatenate([a, b])) for a, b in
              zip(_aimed_rays(ts, 250, 5), _rays(50, 5)))
    mn, mx = torch.full((300,), 1e-4), torch.full((300,), float("inf"))
    W, aux = tm.build_tables(twin)
    assert W.shape == (7, tm.COLS * (2 * nt + ts.n_spheres()))
    one = tm.mxu_intersect(W, aux, ro, rd, mn, mx, 2 * nt, ts.n_spheres(),
                           max_bytes=1 << 40)
    got = tm.mxu_intersect(W, aux, ro, rd, mn, mx, 2 * nt, ts.n_spheres(),
                           max_bytes=max_bytes)
    for k in ("t", "prim_type", "prim_id", "u", "v"):
        assert torch.equal(getattr(got, k).view(torch.int32)
                           if getattr(got, k).is_floating_point()
                           else getattr(got, k),
                           getattr(one, k).view(torch.int32)
                           if getattr(one, k).is_floating_point()
                           else getattr(one, k)), k
    hit_tri = one.hit & (one.prim_type == tir.PRIM_TRI)
    assert bool(hit_tri.any()) and bool((one.prim_id[hit_tri] < nt).all())
    assert bool((~one.hit).any())
    occ = tm.mxu_intersect(W, aux, ro, rd, mn, mx, 2 * nt, ts.n_spheres(),
                           any_hit=True, max_bytes=max_bytes)
    assert torch.equal(occ, one.hit)


def test_make_tracer_warns_as_vimg_tpu(scenes):
    from vimg_tpu.geometry.trace import make_tracer as jmake
    from vimg_tpu_torch.geometry.trace import make_tracer
    js, ts = scenes
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jmake(js, force="mxu")
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tr = make_tracer(ts, force="mxu")
    assert isinstance(tr, tm.MXUBruteForceTracer)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == 1


def test_product_ignores_tf32_setting(scenes):
    """The seven-term sum reads no TF32 setting and changes none."""
    _, ts = scenes
    ro, rd = (torch.from_numpy(x) for x in _rays(64))
    mn, mx = torch.full((64,), 1e-4), torch.full((64,), float("inf"))
    tr = tm.MXUBruteForceTracer(ts)
    before = torch.backends.cuda.matmul.allow_tf32
    a = tr.closest(ts, ro, rd, mn, mx)
    torch.backends.cuda.matmul.allow_tf32 = not before
    try:
        b = tr.closest(ts, ro, rd, mn, mx)
        assert torch.backends.cuda.matmul.allow_tf32 == (not before)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(a.t, b.t) and torch.equal(a.u, b.u)
