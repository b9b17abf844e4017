"""vimg_tpu_torch.geometry.packet_trace (the packet tracer, kernel B5's
plain version and its cull) against vimg_tpu on the CPU.

These tests never run vimg_tpu's packet kernel: in Pallas interpret mode
one call on 128 rays of a 450-triangle terrain takes about 50 s on a CPU.
Instead:

- Tables: PacketData byte-identical to vimg_tpu's (native builder on a 2k
  terrain, numpy builder on a soup), octant orders equal.
- Cull: ``_cull_meta`` (kernel X1's plain version) bit-identical to
  vimg_tpu's XLA function (jitted) on the same arrays, without and with
  the f2b orderings, on a terrain's rays and on edge cases (1, 127, 128
  and 129 clusters, a workgroup without a candidate, idle lanes, zero
  direction components); ``PacketTracer.cull`` takes it on the CPU and
  counts no kernel launch.
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


def _cull_edge_case(C, seed=0):
    """Three workgroups against C random boxes in the unit cube:
    workgroups 0 and 2 look down into the boxes, workgroup 1 looks away
    (no candidate at all); every 7th lane is idle (maxT = -inf), every
    3rd has a finite maxT, and direction components are exactly 0 on
    every 5th (x) and 11th (z) ray. One cluster is a box of most of the
    cube. Returns the rays, the boxes and 8 random per-octant
    orderings."""
    r = np.random.default_rng(seed)
    ctr, half = r.random((C, 3)), 0.02 + 0.1 * r.random((C, 3))
    if C == 1:
        ctr, half = np.full((1, 3), 0.5), np.full((1, 3), 0.45)
    lo, hi = (ctr - half).astype(np.float32), (ctr + half).astype(np.float32)
    n = 3 * tpt.WG
    ro = r.random((n, 3)).astype(np.float32)
    ro[:, 1] += 1.5
    rd = r.normal(size=(n, 3))
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.5
    rd[128:256, 1] *= -1.0
    rd[::5, 0] = 0.0
    rd[::11, 2] = 0.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    mx = np.full(n, np.inf, np.float32)
    mx[::3] = 2.0
    mx[::7] = -np.inf
    pi = np.stack([r.permutation(C) for _ in range(8)])
    return (ro, rd, np.full(n, 1e-4, np.float32), mx), lo, hi, pi


CULL_CASES = ([("slist", None), ("f2b", None)]
              + [(v, C) for C in (1, 127, 128, 129) for v in ("slist", "f2b")])


@pytest.mark.parametrize(
    "variant,clusters", CULL_CASES,
    ids=[v if C is None else f"{v}-C{C}" for v, C in CULL_CASES])
def test_cull_bit_identical(terrain, variant, clusters):
    """The plain cull (kernel X1's reference) bit for bit against
    vimg_tpu's jitted _cull_meta: on a terrain's rays, and on the edge
    cases of _cull_edge_case with C clusters (one chunk of 128 or not,
    cp one slot past C or a whole chunk past it)."""
    f2b = variant == "f2b"
    if clusters is None:
        js, ts, td = terrain
        jt = jpt.PacketTracer(js)
        tt = tpt.PacketTracer(ts, variant=variant, data=td)
        assert tt.cp == jt.cp and tt.entry_scale == jt.entry_scale
        assert tt.scene_bounds == jt._bounds_static
        _, rays = tt.pack(*_t(*_rays(ts)))
        cp, pi, scale = jt.cp, jt.pi, jt.entry_scale
        boxes = (jt.cl_lo, jt.cl_hi)
        got = tt.cull(rays).numpy()
    else:
        rays_np, lo, hi, pi_np = _cull_edge_case(clusters, seed=clusters)
        rays = _t(*rays_np)
        cp, scale = -(-(clusters + 1) // 128) * 128, 3.0e5
        pi = jnp.asarray(pi_np.astype(np.int32))
        boxes = (jnp.asarray(lo), jnp.asarray(hi))
        got = tpt._cull_meta(*rays, *_t(lo, hi), cp,
                             torch.from_numpy(pi_np) if f2b else None,
                             scale).numpy()
    cull = jax.jit(functools.partial(jpt._cull_meta, cp=cp,
                                     pi=pi if f2b else None,
                                     entry_scale=scale))
    want = np.asarray(cull(*(jnp.asarray(x.numpy()) for x in rays), *boxes))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    count = got.reshape(-1, 8, cp)[:, 2, 0]
    if clusters is None:
        assert (count > 0).all()
    else:
        assert count[1] == 0 and count[0] > 0 and count[2] > 0
        assert (got.reshape(-1, 8, cp)[1, 0] == cp - 1).all()


def test_cull_wiring_on_cpu(terrain, monkeypatch):
    """PacketTracer.cull takes the plain cull for CPU tensors, with or
    without plain=True, and never counts a kernel launch."""
    _, ts, td = terrain
    calls = []
    plain_cull = tpt._cull_meta

    def spy(*a, **k):
        calls.append(a[0].device.type)
        return plain_cull(*a, **k)

    monkeypatch.setattr(tpt, "_cull_meta", spy)
    before = tpt.LAUNCHES_CULL
    for variant in ("slist", "f2b"):
        metas = []
        for plain in (False, True):
            tr = tpt.PacketTracer(ts, variant=variant, plain=plain, data=td)
            _, rays = tr.pack(*_t(*_rays(ts)))
            metas.append(tr.cull(rays))
        assert torch.equal(*metas)
    assert calls == ["cpu"] * 4 and tpt.LAUNCHES_CULL == before
    with pytest.raises(NotImplementedError, match="meta"):
        tpt.cull_meta(*(x.to("meta") for x in rays), tr.cl_lo, tr.cl_hi,
                      tr.cp)


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
    ro, rd, _, _ = _primary_rays(ts, tir.RenderSettings(width=128, height=64),
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


# ---------------------------------------------------------------------------
# kernel B5's warp design, step by step (csrc/packet_trace.cu)
# ---------------------------------------------------------------------------

def _jmin(a, b):
    return torch.where(torch.isnan(a) | torch.isnan(b), float("nan"),
                       torch.minimum(a, b))


def _merge_quarters(bt, code, s):
    """The kernel's merge of lane l with lane l ^ s (s = 8, 16): the least
    t, then the least code among the two that hold a hit."""
    lane = torch.arange(32)
    obt, ocode = bt[..., lane ^ s], code[..., lane ^ s]
    take = obt < bt
    tie = ~(bt < obt) & (ocode >= 0) & ((code < 0) | (ocode < code))
    return (torch.where(take, obt, bt),
            torch.where(take | (~take & tie), ocode, code))


def _warp_model(tri_t, meta, ro, rd, minT, maxT, n_clusters, any_hit,
                variant="slist", unroll=4, entry_scale=1.0,
                scene_bounds=None):
    """B5's warp design on CPU tensors: the warp owning packet p of
    workgroup w runs p's live pairs in chain order; lane l = (ray l & 7,
    quarter q = l >> 3) tests triangle 4 kk + q at step kk, for the steps
    up to the cluster's last non-zero normal, and keeps (bt, code, mask)
    with the first design's rule; any-hit rays share their occlusion after
    each pair and a packet whose rays are all occluded stops; f2b reduces
    the workgroup after each chunk of ``unroll`` chain entries. Packets
    are independent outside f2b's reductions (and a warp's packets run in
    chain order), so they advance here in lockstep by chain index.
    Returns (t, code, warp test steps)."""
    N = ro.shape[0]
    W, cp = N // tpt.WG, meta.shape[1]
    m = meta.view(W, tpt.META_ROWS, cp).long()
    tri = tri_t.view(-1, tpt.N_CONST, 128)
    f2b = variant == "f2b"
    lane = torch.arange(32)
    q = lane >> 3
    ray = (torch.arange(W)[:, None, None] * tpt.WG
           + torch.arange(tpt.N_PACKETS)[None, :, None] * 8 + (lane & 7))
    o, d, mnt = ro[ray], rd[ray], minT[ray]               # (W, 16, 32, .)
    bt = maxT[ray].clone()
    code = torch.full(bt.shape, -1, dtype=torch.int64)
    mask = torch.zeros(bt.shape, dtype=torch.int64)
    if f2b:
        exit_t = tpt._scene_exits(ro, rd, scene_bounds)[ray]
    done = torch.zeros((W, tpt.N_PACKETS), dtype=torch.bool)
    running = torch.ones(W, dtype=torch.bool)
    count = m[:, 2, 0]
    # the chain: ascending slots whose packet mask is non-zero
    cand = m[:, 1, :] != 0
    order = torch.argsort((~cand).to(torch.int8), dim=1, stable=True)
    bit = torch.arange(tpt.N_PACKETS)
    ch = max(unroll, 1)
    steps = 0
    for i in range(int(count.max())):
        w = torch.nonzero(running & (i < count))[:, 0]
        slot = order[w, i]
        live = ((m[w, 1, slot][:, None] >> bit) & 1).bool() & ~done[w]
        wi, pi = torch.nonzero(live, as_tuple=True)
        if wi.numel():
            wp = w[wi]
            rid = m[wp, 4, slot[wi]] if f2b else slot[wi]
            rows = tri[rid.clamp_max(n_clusters - 1)]         # (R, 12, 128)
            nz = (rows[:, :3, :] != 0).view(-1, 3, 32, 4).any(dim=3).any(1)
            n_steps = torch.where(nz.any(1), 32 - torch.argmax(
                nz.flip(1).to(torch.int8), dim=1), 0)
            steps += int(n_steps.sum())
            b, c, mk = bt[wp, pi], code[wp, pi], mask[wp, pi]
            ox, oy, oz = (o[wp, pi][..., a] for a in range(3))
            dx, dy, dz = (d[wp, pi][..., a] for a in range(3))
            mn = mnt[wp, pi]
            cbase = (rid * 128)[:, None]
            for kk in range(32):
                k = 4 * kk + q
                (nx, ny, nzz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z,
                 c2) = (rows[:, j, k] for j in range(tpt.N_CONST))
                ro_n = ox * nx + oy * ny + oz * nzz
                rd_n = dx * nx + dy * ny + dz * nzz
                par = rd_n.abs() < 1e-22
                t = (d0 - ro_n) / torch.where(par, 1.0, rd_n)
                u = (ox * m1x + oy * m1y + oz * m1z - c1
                     + t * (dx * m1x + dy * m1y + dz * m1z))
                v = (ox * m2x + oy * m2y + oz * m2z - c2
                     + t * (dx * m2x + dy * m2y + dz * m2z))
                hit = ((kk < n_steps)[:, None] & ~par & (u >= 0.0)
                       & (v >= 0.0) & (u + v <= 1.0) & (t >= mn))
                lt = hit & (t < b)
                if any_hit:
                    b = torch.where(lt, -float("inf"), b)
                    continue
                join = (hit & ~lt & (t == b) & (c >= 0)
                        & ((mk >> kk) & 1 == 0))
                b = torch.where(lt, t, b)
                c = torch.where(lt, cbase + k, c)
                mk = torch.where(lt, 1 << kk, mk)
                mk = torch.where(join, mk | (1 << kk), mk)
                c = torch.where(join, torch.minimum(c, cbase + k), c)
            if any_hit:
                occ = (b == -float("inf")).view(-1, 4, 8).any(dim=1)
                b = torch.where(occ.repeat(1, 4), -float("inf"), b)
                done[wp, pi] = occ.all(dim=1)
            bt[wp, pi], code[wp, pi], mask[wp, pi] = b, c, mk
        if f2b and (i + 1) % ch == 0:
            w = torch.nonzero(running & (i + 1 < count))[:, 0]
            r4 = bt[w].view(-1, tpt.N_PACKETS, 4, 8)
            rbt = _jmin(_jmin(r4[:, :, 0], r4[:, :, 1]),
                        _jmin(r4[:, :, 2], r4[:, :, 3]))
            worst = _jmin(rbt, exit_t[w][..., :8]).amax(dim=(1, 2))
            nxt_e = m[w, 3, m[w, 0, order[w, i] + 1]]
            stop = worst * entry_scale < (nxt_e - 1).to(torch.float32)
            running[w[stop]] = False
    for s in (8, 16):
        bt, code = _merge_quarters(bt, code, s)
    return (bt[..., :8].reshape(N), code[..., :8].reshape(N).float(), steps)


def _dup_soup():
    """Every triangle twice (the copy in another lane, often another
    cluster): closest hits tie exactly in t."""
    js, _ = _soup(T=300, spheres=0, seed=7)
    v = np.asarray(js.verts).reshape(-1, 3, 3)
    v = np.concatenate([v, v[::-1]]).reshape(-1, 3)
    b = SceneBuilder()
    m = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    b.add_mesh(v, np.arange(v.shape[0]).reshape(-1, 3), m)
    js = b.build(camera=js.camera)
    return tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _camera_rays(ts, w, h):
    from vimg_tpu_torch.render.integrators import _primary_rays
    n = w * h
    ro, rd, _, _ = _primary_rays(ts, tir.RenderSettings(width=w, height=h),
                           torch.arange(n), torch.zeros(n, dtype=torch.int64))
    return ro, rd, torch.full((n,), 1e-4), torch.full((n,), float("inf"))


@pytest.fixture(scope="module")
def model_cases(terrain, soup):
    """scene -> (tracers by variant, rays): the terrain and soup fixtures'
    rays from above, the duplicated soup's rays from above, and a 5k
    terrain's 32x16 camera rays (where f2b's exit fires at unroll 1)."""
    out = {}
    dup = _dup_soup()
    t5k = tterrain(5000, 32, 16, device="cpu")
    for name, ts, rays in (
            ("terrain", terrain[1], _t(*_rays(terrain[1]))),
            ("soup", soup[1], _t(*_rays(soup[1], n=700, seed=2, lift=0.3))),
            ("dup_soup", dup, _t(*_rays(dup, n=512, seed=3, lift=0.3))),
            ("terrain5k_camera", t5k, _camera_rays(t5k, 32, 16))):
        slist = tpt.PacketTracer(ts, data=terrain[2] if name == "terrain"
                                 else None)
        trs = {"slist": slist,
               "f2b": tpt.PacketTracer(ts, variant="f2b", data=slist.data,
                                       unroll=1)}
        out[name] = (trs, rays)
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("variant", ["slist", "f2b"])
@pytest.mark.parametrize("case", ["terrain", "soup", "dup_soup",
                                  "terrain5k_camera"])
def test_warp_model_matches_plain_walk(model_cases, case, variant, any_hit):
    """B5's schedule (pairs in chain order, a lane's (ray, quarter) state,
    the quarter merge, f2b's chunked exit, the any-hit skip) gives
    packet_walk_plain's (t, code) bit for bit; its warp steps cover the
    tests the plain walk counts as needed."""
    trs, rays = model_cases[case]
    tr = trs[variant]
    _, packed = tr.pack(*rays)
    meta = tr.cull(packed)
    st = {}
    want = tpt.packet_walk_plain(tr.tri_t, meta, *packed,
                                 *tr.walk_args(any_hit), stats=st,
                                 cl_len=tr.data.cl_len)
    t, code, steps = _warp_model(tr.tri_t, meta, *packed,
                                 *tr.walk_args(any_hit))
    assert torch.equal(t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(code, want[1])
    assert (want[0] == -float("inf")).any() if any_hit else (
        code >= 0).sum() > 50
    assert 0 < st["tri_tests"] <= 32 * steps
    if case == "dup_soup" and not any_hit:
        # every hit ties exactly with the duplicate (triangle 599 - id, the
        # same constants): the lesser code wins
        slot = torch.empty_like(tr.perm)
        slot[tr.perm] = torch.arange(tr.perm.numel())
        win = code[code >= 0].long()
        assert (win < slot[599 - tr.perm[win]]).all()


def test_warp_model_exits_early(model_cases):
    """f2b's chunked exit fires in one of the model's cases (unroll 1), so
    the exact test above covers it: the plain walk skips pairs there."""
    trs, rays = model_cases["terrain5k_camera"]
    pairs = {}
    for name, tr in trs.items():
        _, packed = tr.pack(*rays)
        st = {}
        tpt.packet_walk_plain(tr.tri_t, tr.cull(packed), *packed,
                              *tr.walk_args(False), stats=st)
        pairs[name] = st["packet_tests"]
    assert 0 < pairs["f2b"] < pairs["slist"]
