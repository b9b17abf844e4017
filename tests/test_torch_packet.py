"""vimg_tpu_torch.geometry.packet_trace (the packet tracer, kernel B5's
plain version and its cull) against vimg_tpu on the CPU.

These tests never run vimg_tpu's packet kernel: in Pallas interpret mode
one call on 128 rays of a 450-triangle terrain takes about 50 s on a CPU.
Instead:

- Tables: PacketData byte-identical to vimg_tpu's (native builder on a 2k
  terrain, numpy builder on a soup), octant orders equal.
- Cull: ``_cull_meta`` bit-identical to vimg_tpu's XLA function (jitted)
  on the same arrays, without and with the f2b orderings.
- Plain walk: the same t bit for bit as the port's plain cluster walk
  (``ClusterTracer(walk="skip", plain=True)``), the same triangle except
  on exact ties in t (counted, at most 2); t within 1e-5 relative of
  vimg_tpu's SoA formulation (``soa_intersect._trace_impl``).
- Variants: f2b gives slist's t bit for bit, and its triangle except on
  exact ties in t (the per-lane rule and another chain order may then pick
  another code).
- Facade: vimg_tpu's XLA ``_closest_impl`` / ``_occluded_impl`` run on the
  port's (bt, code) (its instance ``_run`` replaced) agree with the port's
  ``closest`` / ``occluded``: t, prim type and prim id exactly, u and v
  to 1e-6; spheres merged.
- The 10 MiB table budget refuses the same scenes; a 16x8 @ 2 spp wavefront
  through the plain packet walk equals the one through the plain cluster
  walk.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.core.math import look_at
from vimg_tpu.geometry import packet_trace as jpt
from vimg_tpu.render.camera import Camera
from vimg_tpu.scene import ir as jir
from vimg_tpu.scene.json_loader import SceneBuilder
from vimg_tpu.scene.synthetic import terrain_scene as jterrain
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.geometry import packet_trace as tpt
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene.synthetic import terrain_scene as tterrain


def _soup(T=1000, spheres=3, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.rand(T, 3).astype(np.float32)
    verts = (c[:, None, :]
             + 0.05 * rs.randn(T, 3, 3).astype(np.float32)).reshape(-1, 3)
    b = SceneBuilder()
    m = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    b.add_mesh(verts, np.arange(T * 3).reshape(T, 3), m)
    for _ in range(spheres):
        b.add_sphere(rs.rand(3) * 1.2, 0.08 + 0.05 * rs.rand(), m)
    cam = Camera.make(look_at([0.5, 0.5, 3], [0.5, 0.5, 0.5], [0, 1, 0]),
                      8, 8, 45.0)
    js = b.build(camera=cam)
    return js, tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _rays(scene, n=640, seed=0, lift=1.0):
    """Rays from above the scene's box, downward; a fifth with a
    finite maxT and every 37th idle (maxT = -inf)."""
    r = np.random.default_rng(seed)
    v = scene.verts.numpy()
    lo, hi = v.min(0), v.max(0)
    ro = (lo + r.random((n, 3)) * (hi - lo) + [0, lift, 0]).astype(np.float32)
    rd = r.normal(size=(n, 3))
    rd[:, 1] = -np.abs(rd[:, 1]) - 1.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    mx = np.full(n, np.inf, np.float32)
    mx[::5] = 2.0
    mx[::37] = -np.inf
    return ro, rd, np.full(n, 1e-4, np.float32), mx


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.fixture(scope="module")
def terrain():
    js, ts = jterrain(2000, 16, 8), tterrain(2000, 16, 8, device="cpu")
    return js, ts, tpt.PacketData(ts)


@pytest.fixture(scope="module")
def soup():
    return _soup()


@pytest.mark.parametrize("case", ["terrain2k_native", "soup_numpy"])
def test_tables_byte_identical(terrain, soup, case):
    if case == "terrain2k_native":
        js, _, td = terrain
        jd = jpt.PacketData(js)
    else:
        js, ts = soup
        jd = jpt.PacketData(js, builder="numpy")
        td = tpt.PacketData(ts, builder="numpy")
    assert td.n_clusters == jd.n_clusters > 8
    for k in ("tri_rows_t", "cl_lo", "cl_hi", "perm", "scene_lo", "scene_hi"):
        a, b = getattr(jd, k), getattr(td, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert np.array_equal(jd.octant_orders(), td.octant_orders())


@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_cull_bit_identical(terrain, variant):
    js, ts, td = terrain
    jt = jpt.PacketTracer(js)
    tt = tpt.PacketTracer(ts, variant=variant, data=td)
    assert tt.cp == jt.cp and tt.entry_scale == jt.entry_scale
    assert tt.scene_bounds == jt._bounds_static
    _, rays = tt.pack(*_t(*_rays(ts)))
    f2b = variant == "f2b"
    cull = jax.jit(functools.partial(jpt._cull_meta, cp=jt.cp,
                                     pi=jt.pi if f2b else None,
                                     entry_scale=jt.entry_scale))
    want = np.asarray(cull(*(jnp.asarray(x.numpy()) for x in rays),
                           jt.cl_lo, jt.cl_hi))
    got = tt.cull(rays).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got.reshape(-1, 8, tt.cp)[:, 2, 0] > 0).all()


def test_plain_walk_matches_cluster_walk(terrain):
    """Equal t bit for bit, the same triangle except on exact ties in t,
    the same occlusion."""
    _, ts, td = terrain
    args = _t(*_rays(ts))
    pt = tpt.PacketTracer(ts, data=td)
    ct = tct.ClusterTracer(ts, walk="skip", plain=True)
    hp, hc = pt.closest(ts, *args), ct.closest(ts, *args)
    assert int(hc.hit.sum()) > 300
    assert torch.equal(hp.t, hc.t)
    differ = hp.prim_id != hc.prim_id
    assert int(differ.sum()) <= 2 and bool((hp.hit | ~differ).all())
    assert torch.equal(pt.occluded(ts, *args), ct.occluded(ts, *args))
    # the walk's barycentrics are not kept: u, v are solved in the plane
    assert float((hp.u - hc.u).abs()[hc.hit].max()) < 1e-4
    assert not torch.equal(hp.u[hc.hit], hc.u[hc.hit])


def test_walk_stats_count_needed_tests(terrain):
    """The plain walk's tri_tests (the bound's operation count): closest
    hits test every valid lane of every candidate their packet holds, idle
    lanes (maxT = -inf, padding included) nothing; recounted here from the
    cull's bits. Any-hit rays stop at their first hit, so they need fewer."""
    _, ts, td = terrain
    pt = tpt.PacketTracer(ts, data=td)
    _, rays = pt.pack(*_t(*_rays(ts)))
    meta = pt.cull(rays)
    m = meta.view(-1, tpt.META_ROWS, pt.cp).numpy()
    live = (rays[3] != -np.inf).numpy().reshape(-1, tpt.N_PACKETS, 8).sum(2)
    want = 0
    for w in range(m.shape[0]):
        for c in range(td.n_clusters):
            for p in range(tpt.N_PACKETS):
                if (m[w, 1, c] >> p) & 1:
                    want += int(live[w, p]) * int(td.cl_len[c])
    counts = {}
    for any_hit in (False, True):
        st = {}
        tpt.packet_walk_plain(pt.tri_t, meta, *rays, *pt.walk_args(any_hit),
                              stats=st, cl_len=td.cl_len)
        counts[any_hit] = st["tri_tests"]
        assert st["packet_tests"] == sum(
            int(np.bitwise_and(m[:, 1, :td.n_clusters] >> p, 1).sum())
            for p in range(tpt.N_PACKETS))
    assert counts[False] == want
    assert want < 8 * 128 * st["packet_tests"]     # padding lanes not counted
    assert 0 < counts[True] < counts[False]


def test_plain_walk_matches_soa_formulation():
    """Against vimg_tpu's SoA tracer math (the same float32 constants and
    formula, called eagerly) on a 200-triangle soup, rays aimed at
    triangle centroids: equal hit masks, t to 1e-5 relative, the same
    triangle except on exact ties in t."""
    from vimg_tpu.geometry.soa_intersect import _trace_impl, build_constants
    js, ts = _soup(200, spheres=0, seed=4)
    rs = np.random.RandomState(12)
    ro = (rs.rand(512, 3) * 2.0 - 0.5).astype(np.float32)
    tri = np.asarray(js.verts)[np.asarray(js.tri_vidx)].mean(axis=1)
    rd = tri[rs.randint(0, 200, 512)] - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    mn, mx = np.full(512, 1e-4, np.float32), np.full(512, np.inf, np.float32)
    ref = _trace_impl(build_constants(js)[0], None,
                      *map(jnp.asarray, (ro, rd, mn, mx)), False)
    rt, rid = np.asarray(ref.t), np.asarray(ref.prim_id)
    hp = tpt.PacketTracer(ts).closest(ts, *_t(ro, rd, mn, mx))
    pt, pid = hp.t.numpy(), hp.prim_id.numpy()
    f = np.isfinite(rt)
    assert np.array_equal(np.isfinite(pt), f) and f.mean() > 0.5
    np.testing.assert_allclose(pt[f], rt[f], rtol=1e-5)
    differ = f & (pid != rid)
    assert differ.sum() == (differ & (pt == rt)).sum() <= 2


def test_f2b_matches_slist():
    """On a 20k terrain's 128x64 camera rays (236 clusters: enough for the
    early exit to fire)."""
    from vimg_tpu_torch.render.integrators import _primary_rays
    ts = tterrain(20_000, 128, 64, device="cpu")
    n = 128 * 64
    ro, rd = _primary_rays(ts, tir.RenderSettings(width=128, height=64),
                           torch.arange(n), torch.zeros(n, dtype=torch.int64))
    args = (ro, rd, torch.full((n,), 1e-4), torch.full((n,), float("inf")))
    slist = tpt.PacketTracer(ts)
    f2b = tpt.PacketTracer(ts, variant="f2b", data=slist.data)
    _, rays = f2b.pack(*args)
    meta = f2b.cull(rays)
    stats = {}
    a = tpt.packet_walk_plain(slist.tri_t, slist.cull(rays), *rays,
                              *slist.walk_args(False))
    b = tpt.packet_walk_plain(f2b.tri_t, meta, *rays, *f2b.walk_args(False),
                              stats=stats)
    assert torch.equal(a[0], b[0])
    differ = a[1] != b[1]
    assert int(differ.sum()) <= 2        # only exact ties in t, if any
    # the early exit skipped candidates
    total = sum(int(torch.bitwise_and(meta.view(-1, 8, f2b.cp)[:, 1] >> p, 1)
                    .sum()) for p in range(tpt.N_PACKETS))
    assert 0 < stats["packet_tests"] < total
    for any_hit in (False, True):
        x = slist.occluded(ts, *args) if any_hit else slist.closest(ts, *args)
        y = f2b.occluded(ts, *args) if any_hit else f2b.closest(ts, *args)
        assert torch.equal(x if any_hit else x.t, y if any_hit else y.t)


def test_facade_matches_vimg_tpu(soup):
    """vimg_tpu's XLA closest / occluded facade, op by op, on the port's
    walk output: prim ids through perm, u, v rebuilt in the plane, spheres
    merged. (Jit-fused XLA rounds the sphere quadric and the plane solve
    otherwise: up to 5e-6 in t and 3e-6 in u here.)"""
    js, ts = soup
    jt = jpt.PacketTracer(js)
    tt = tpt.PacketTracer(ts)
    ro, rd, mn, mx = _rays(ts, n=700, seed=2, lift=0.3)
    args = _t(ro, rd, mn, mx)
    jargs = tuple(map(jnp.asarray, (ro, rd, mn, mx)))
    for any_hit in (False, True):
        bt, code = tt._run(*args, any_hit=any_hit)
        jt._run = lambda *a, **k: (jnp.asarray(bt.numpy()),
                                   jnp.asarray(code.numpy()))
        if any_hit:
            want = np.asarray(jt._occluded_impl(*jargs))
            assert np.array_equal(tt.occluded(ts, *args).numpy(), want)
            continue
        want = jt._closest_impl(*jargs)
        got = tt.closest(ts, *args)
        for f in ("t", "prim_type", "prim_id"):
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
        for f in ("u", "v"):
            assert np.abs(getattr(got, f).numpy()
                          - np.asarray(getattr(want, f))).max() <= 1e-6, f
        assert (got.prim_type[got.hit] == tir.PRIM_SPHERE).sum() >= 3
        assert (got.prim_type[got.hit] == tir.PRIM_TRI).sum() >= 100


def test_budget_and_idle_lanes(terrain, monkeypatch):
    """The VMEM budget refuses the same scenes; idle lanes (maxT = -inf)
    sort among live rays, miss in closest() and report occluded."""
    from vimg_tpu.geometry.cluster_trace import ray_sort_key as jkey
    js, ts, td = terrain
    nbytes = td.tri_rows_t.nbytes
    for cls in (jpt.PacketTracer, tpt.PacketTracer):
        monkeypatch.setattr(cls, "VMEM_BUDGET_BYTES", nbytes - 1)
    with pytest.raises(ValueError, match="VMEM budget"):
        jpt.PacketTracer(js)
    with pytest.raises(ValueError, match="VMEM budget"):
        tpt.PacketTracer(ts, data=td)
    for cls in (jpt.PacketTracer, tpt.PacketTracer):
        monkeypatch.setattr(cls, "VMEM_BUDGET_BYTES", nbytes)
    jt, tt = jpt.PacketTracer(js), tpt.PacketTracer(ts, data=td)
    ro, rd, mn, mx = _rays(ts, n=300, seed=5)
    order, rays = tt.pack(*_t(ro, rd, mn, mx))
    want = np.argsort(np.asarray(jkey(jnp.asarray(ro), jnp.asarray(rd),
                                      *jt.bounds)), kind="stable")
    assert np.array_equal(order.numpy(), want)
    assert rays[0].shape == (384, 3) and (rays[3][300:] == -np.inf).all()
    idle = torch.from_numpy(mx == -np.inf)
    hr = tt.closest(ts, *_t(ro, rd, mn, mx))
    assert not hr.hit[idle].any() and hr.hit[~idle].any()
    assert tt.occluded(ts, *_t(ro, rd, mn, mx))[idle].all()
    unsorted = tpt.PacketTracer(ts, data=td, sort_rays=False)
    assert torch.equal(unsorted.closest(ts, *_t(ro, rd, mn, mx)).t, hr.t)


def test_wavefront_through_packet_walk(monkeypatch):
    """16x8 @ 2 spp through the plain packet walk and the plain cluster
    walk: the same hits, so the same image and ray counts. render_frame
    hands make_tracer(force="packet") to the wavefront."""
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render import wavefront as twf
    from vimg_tpu_torch.render.render import render_frame
    ts = tterrain(2000, 16, 8, device="cpu")
    st = tir.RenderSettings(width=16, height=8, spp=2, max_depth=6,
                            integrator="mis", batch_size=1 << 10)
    pt = make_tracer(ts, force="packet")
    assert isinstance(pt, tpt.PacketTracer) and not pt.plain
    before = tpt.LAUNCHES
    a, sa = twf.render_wavefront(ts, st, tracer=pt, return_stats=True)
    b, sb = twf.render_wavefront(ts, st, tracer=tct.ClusterTracer(ts),
                                 return_stats=True)
    assert tpt.LAUNCHES == before
    assert np.isfinite(a.numpy()).all() and float(a.mean()) > 0
    assert abs(float(a.mean()) - float(b.mean())) <= 1e-6 * float(b.mean())
    for k in ("segments", "shadow_rays", "supersteps"):
        assert sa[k] == sb[k], k
    monkeypatch.setattr(twf, "render_wavefront",
                        lambda scene, settings, tracer, progress: tracer)
    st8 = tir.RenderSettings(width=16, height=8, spp=8, integrator="mis")
    assert isinstance(render_frame(ts, st8, tracer_force="packet"),
                      tpt.PacketTracer)
    assert render_frame(ts, st8, tracer=pt) is pt
    with pytest.raises(NotImplementedError, match="meta"):
        tpt.trace_packet(pt.tri_t, None, *(x.to("meta") for x in
                                           _t(*_rays(ts, n=128))),
                         pt.data.n_clusters, False)
