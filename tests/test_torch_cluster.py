"""vimg_tpu_torch.geometry.cluster_trace against vimg_tpu on the CPU.

- Host tables: byte-identical to vimg_tpu's ClusterData for the same
  builder (numpy oracle on a 1,500-triangle soup, native C++ on a 20k
  terrain), and build_bvh_numpy / ray_sort_key equal to vimg_tpu's.
- Plain walks (the plain versions of kernels B3/B4): against vimg_tpu's
  dense intersectors with tests/test_cluster_trace.py's bounds (the
  watertight triangle test there is another formulation), and against
  vimg_tpu's SoA formulation (``soa_intersect._trace_impl``, the same
  float32 constants and formula, called eagerly) to 1e-5 relative in t.
  vimg_tpu's Pallas cluster kernel is not run here: in interpret mode it
  takes tens of seconds per call on this CPU.
- Wide vs skip walk bit for bit; sorted vs unsorted tracer bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.core.math import look_at
from vimg_tpu.geometry import cluster_trace as jct
from vimg_tpu.geometry.intersect import (intersect_bruteforce,
                                         occlude_bruteforce)
from vimg_tpu.render.camera import Camera
from vimg_tpu.scene import ir as jir
from vimg_tpu.scene.json_loader import SceneBuilder
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.scene import ir as tir


def _soup_scene(T=1500, spheres=2, seed=0):
    """tests/test_cluster_trace.py::_soup_scene."""
    rs = np.random.RandomState(seed)
    c = rs.rand(T, 3).astype(np.float32)
    verts = (c[:, None, :]
             + 0.05 * rs.randn(T, 3, 3).astype(np.float32)).reshape(-1, 3)
    idx = np.arange(T * 3).reshape(T, 3)
    b = SceneBuilder()
    m = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    b.add_mesh(verts, idx, m)
    for k in range(spheres):
        b.add_sphere(rs.rand(3) * 1.2, 0.08 + 0.05 * rs.rand(), m)
    cam = Camera.make(look_at([0.5, 0.5, 3], [0.5, 0.5, 0.5], [0, 1, 0]),
                      8, 8, 45.0)
    js = b.build(camera=cam)
    return js, tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _rays(B=2048, seed=3):
    rs = np.random.RandomState(seed)
    ro = rs.rand(B, 3).astype(np.float32) * 2.0 - 0.5
    rd = rs.randn(B, 3).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd, np.full(B, 1e-4, np.float32), np.full(B, np.inf, np.float32)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.fixture(scope="module")
def soup():
    return _soup_scene()


@pytest.fixture(scope="module")
def soup_ref(soup):
    """vimg_tpu's dense closest and any-hit answers on the soup."""
    js, _ = soup
    ro, rd, mn, mx = _rays()
    hb = intersect_bruteforce(js, *map(jnp.asarray, (ro, rd, mn, mx)))
    ro2, rd2, mn2, _ = _rays(seed=7)
    mx2 = np.full(ro2.shape[0], 0.6, np.float32)
    ob = np.asarray(occlude_bruteforce(js, *map(jnp.asarray,
                                                (ro2, rd2, mn2, mx2))))
    return hb, ob


def _same_tables(jd, td):
    for k in ("tri_rows", "perm", "cl_len", "node_aabbs", "node_cid",
              "node_skip", "node_right", "node_order"):
        a, b = getattr(jd, k), getattr(td, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert (jd.n_clusters, jd.n_nodes, jd.tree_depth) == (
        td.n_clusters, td.n_nodes, td.tree_depth)
    jw, tw = jd.wide_tables(), td.wide_tables()
    assert jw.keys() == tw.keys()
    for k in jw:
        if isinstance(jw[k], np.ndarray):
            assert jw[k].dtype == tw[k].dtype, k
            assert jw[k].tobytes() == tw[k].tobytes(), k
        else:
            assert jw[k] == tw[k], k


@pytest.mark.parametrize("case", ["soup_numpy", "terrain20k_native"])
def test_tables_byte_identical(soup, case):
    if case == "soup_numpy":
        js, ts = soup
        builder = "numpy"
    else:
        from vimg_tpu.scene.synthetic import terrain_scene as jterrain
        from vimg_tpu_torch.scene.synthetic import terrain_scene as tterrain
        js = jterrain(20_000, 16, 8)
        ts = tterrain(20_000, 16, 8, device="cpu")
        builder = "auto"
    jd = jct.ClusterData(js, builder=builder)
    td = tct.ClusterData(ts, builder=builder)
    assert td.n_clusters > 4
    _same_tables(jd, td)


def test_build_bvh_numpy_matches():
    from vimg_tpu.geometry.bvh import build_bvh_numpy as jbuild
    from vimg_tpu_torch.geometry.bvh import build_bvh_numpy as tbuild
    r = np.random.default_rng(5)
    c = r.random((400, 3)).astype(np.float32)
    p = c[:, None] + 0.03 * r.normal(size=(400, 3, 3)).astype(np.float32)
    args = (p.min(1), p.max(1), p.mean(1))
    a, b = jbuild(*args), tbuild(*args)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_native_builder_never_falls_back(monkeypatch, tmp_path):
    """The port's C++ builder compiles into vimg_tpu_torch/_build/ only,
    and a missing compiler raises instead of switching builders."""
    from vimg_tpu_torch.runtime import native
    assert native.library_path().parent.name == "_build"
    assert native.library_path().parent.parent.name == "vimg_tpu_torch"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native._compile_lib()


@pytest.mark.parametrize("mode", ["origin", "dir"])
def test_ray_sort_key_bit_equal(mode):
    ro, rd, _, _ = _rays(4096, seed=9)
    lo = np.array([-0.4, -0.5, -0.3], np.float32)
    hi = np.array([1.2, 1.4, 1.1], np.float32)
    a = np.asarray(jct.ray_sort_key(*map(jnp.asarray, (ro, rd, lo, hi)),
                                    mode=mode))
    b = tct.ray_sort_key(*_t(ro, rd, lo, hi), mode=mode).numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("walk", ["wide", "skip"])
def test_plain_walks_match_bruteforce(soup, soup_ref, walk):
    """tests/test_cluster_trace.py's bounds, both walks, spheres merged."""
    js, ts = soup
    hb, ob = soup_ref
    ct = tct.ClusterTracer(ts, walk=walk)
    assert ct.data.n_clusters > 4
    hc = ct.closest(ts, *_t(*_rays()))
    hit_c, hit_b = hc.hit.numpy(), np.asarray(hb.hit)
    assert (hit_c == hit_b).mean() > 0.999
    both = hit_c & hit_b
    assert np.abs(hc.t.numpy()[both] - np.asarray(hb.t)[both]).max() < 1e-4
    same = ((hc.prim_id.numpy() == np.asarray(hb.prim_id))
            & (hc.prim_type.numpy() == np.asarray(hb.prim_type)))
    assert same[both].mean() > 0.999
    tri_hit = both & (np.asarray(hb.prim_type) == jir.PRIM_TRI)
    assert np.abs(hc.u.numpy() - np.asarray(hb.u))[tri_hit].max() < 1e-3
    # the spheres take part through the merge
    assert (hc.prim_type.numpy()[both] == jir.PRIM_SPHERE).sum() >= 5
    ro, rd, mn, _ = _rays(seed=7)
    oc = ct.occluded(ts, *_t(ro, rd, mn, np.full(ro.shape[0], 0.6,
                                                 np.float32))).numpy()
    assert (oc == ob).mean() > 0.999


def test_plain_walks_match_soa_formulation():
    """Against vimg_tpu's SoA tracer math (same f32 constants and formula)
    on a 200-triangle soup: equal hit masks, t to 1e-5 relative, the same
    triangle except on exact-t ties between two triangles, counted."""
    from vimg_tpu.geometry.soa_intersect import _trace_impl, build_constants
    js, ts = _soup_scene(200, spheres=0, seed=4)
    ro, rd, mn, mx = _rays(seed=11)
    # aim the rays at triangle centroids so that most of them hit
    tri = np.asarray(js.verts)[np.asarray(js.tri_vidx)].mean(axis=1)
    rs = np.random.RandomState(12)
    rd = tri[rs.randint(0, 200, ro.shape[0])] - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tri_c, _ = build_constants(js)
    ref = _trace_impl(tri_c, None, *map(jnp.asarray, (ro, rd, mn, mx)),
                      False)
    rt, rid = np.asarray(ref.t), np.asarray(ref.prim_id)
    for walk in ("wide", "skip"):
        hc = tct.ClusterTracer(ts, walk=walk).closest(ts, *_t(ro, rd, mn, mx))
        ct, cid = hc.t.numpy(), hc.prim_id.numpy()
        assert np.array_equal(np.isfinite(ct), np.isfinite(rt))
        f = np.isfinite(rt)
        assert f.mean() > 0.5
        np.testing.assert_allclose(ct[f], rt[f], rtol=1e-5)
        differ = f & (cid != rid)
        # a different triangle only where both lie at the same t
        ties = differ & (ct == rt)
        assert differ.sum() == ties.sum() <= 2, (differ.sum(), ties.sum())


def test_wide_equals_skip_and_sort_is_transparent(soup):
    """Wide and skip walks give identical bits (closest and any-hit); the
    Morton-sorted tracer gives the unsorted tracer's hits, idle lanes
    (maxT = -inf) included."""
    _, ts = soup
    B = tct.SORT_MIN_RAYS + 808
    ro, rd, mn, mx = _rays(B, seed=13)
    mx[::7] = -np.inf
    wide = tct.ClusterTracer(ts, walk="wide", sort_rays=False)
    skip = tct.ClusterTracer(ts, walk="skip", data=wide.data)
    sorted_wide = tct.ClusterTracer(ts, walk="wide", data=wide.data)
    args = _t(ro, rd, mn, mx)
    for any_hit in (False, True):
        a = wide.trace(*args, any_hit)
        b = skip.trace(*args, any_hit)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    h0 = wide.closest(ts, *args)
    h1 = sorted_wide.closest(ts, *args)
    for f in ("t", "prim_type", "prim_id", "u", "v"):
        assert torch.equal(getattr(h0, f), getattr(h1, f)), f
    assert not h0.hit.numpy()[::7].any()
    occ = wide.occluded(ts, *_t(ro, rd, mn, np.where(mx > 0, 4.0, mx)))
    assert occ.numpy()[::7].all()          # vimg_tpu: bt == -inf


def test_walk_counts_and_guards(soup, monkeypatch):
    _, ts = soup
    ct = tct.ClusterTracer(ts, walk="skip")
    ro, rd, mn, mx = _t(*_rays(256))
    stats = {}
    tct.skip_walk_plain(*ct.node_tables, ct.tri_rows, ct.data.n_nodes, ro,
                        rd, mn, mx, False, stats=stats)
    assert stats["box_tests"] > 256 and stats["tri_tests"] % tct.SUB == 0
    # the f32 hit-code guard: > 2^24 slots refuse to pack
    with pytest.raises(ValueError, match="2\\^24"):
        tct.ClusterData(ts, max_k=(1 << 24) + 1, builder="numpy")
    # no walk for a device without a kernel, and no CPU walk for it either
    meta = ts.replace(verts=ts.verts.to("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        tct.ClusterTracer(meta)
    with pytest.raises(NotImplementedError, match="meta"):
        tct.trace_wide(*ct.node_tables, ct.tri_rows, 1, 24,
                       *(x.to("meta") for x in (ro, rd, mn, mx)), False)
    before = (tct.LAUNCHES_WIDE, tct.LAUNCHES_SKIP)
    ct.closest(ts, ro, rd, mn, mx)
    assert (tct.LAUNCHES_WIDE, tct.LAUNCHES_SKIP) == before
