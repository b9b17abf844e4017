"""Kernel X1's octant design (csrc/packet_cull.cu) modelled in PyTorch and
held bit for bit to the plain cull ``packet_trace._cull_meta`` on the CPU.

``_octant_cull`` computes the meta as the kernel does: each workgroup's
live rays (minT <= maxT) bucketed by the sign bits of their inverse
direction; each bucket's bounds (the least and most o, 1/d, minT, maxT)
and whether they hold a non-finite o or 1/d; for a warp of 32 cluster
columns, the buckets that its bounds test cannot rule out for every
column, each tested against the near and far planes that its signs pick
from every box (6 min/max a test); the plain min/max form for a warp with
a box not ordered on some axis; a point box for the columns past the
clusters; rows 0 and 3 as suffix minima by chunks of 128 columns from the
last, with the carry of the chunks already done. The bounds test is
``cull_schedule.misses`` (the kernel's directed roundings, emulated
exactly), and the model checks that no bucket it leaves out holds a ray
that meets the box. It counts the work as the kernel's counted launch
does, and the tests hold ``cull_schedule.cull_steps``, the vectorised
replay of those counts, to the model's. The tests hold it to ``_cull_meta`` in
slist and f2b on a terrain's camera, bounce and shadow rays, and on edge
rays: zero and signed-zero directions, denormal directions (1/d = inf),
origins on a box's planes, NaN and inf origins, idle lanes (maxT = -inf)
and NaN minT, boxes with lo == hi, an empty cluster's box (+inf / -inf)
and a NaN box.
"""
import numpy as np
import pytest
import torch

from vimg_tpu_torch.geometry import cluster_trace as ct
from vimg_tpu_torch.geometry import cull_schedule as cs
from vimg_tpu_torch.geometry import packet_trace as pt
from vimg_tpu_torch.render.integrators import _primary_rays
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.synthetic import terrain_scene

WARP = 32                 # a warp's cluster columns
NO_ENTRY = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The model runs many small tensor ops, which threads only slow
    down; the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _test(o, iv, mn, mx, near, far, plain):
    """(tin, hit) of rays (r, 3) against boxes (n, 3): the select form on
    near / far planes, or the plain min/max form (near = lo, far = hi)."""
    tin, tout = mn[:, None], mx[:, None]
    for a in range(3):
        t0 = (near[None, :, a] - o[:, None, a]) * iv[:, None, a]
        t1 = (far[None, :, a] - o[:, None, a]) * iv[:, None, a]
        if plain:
            t0, t1 = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tin, tout = torch.maximum(tin, t0), torch.minimum(tout, t1)
    return tin, tin <= tout


def _octant_cull(ro, rd, mn, mx, cl_lo, cl_hi, cp, pi=None,
                 entry_scale=None, stats=None):
    """Kernel X1's meta, its design step by step (see the module
    docstring). ``stats`` counts cull_schedule.KEYS over the columns
    below C (select-form and plain-form slab tests, bounds tests, slab
    tests skipped) and the live (ray, cluster) pairs."""
    B, C = ro.shape[0], cl_lo.shape[0]
    W = B // pt.WG
    inv = 1.0 / torch.where(rd == 0.0, 1e-30, rd)
    sign = (inv.view(torch.int32) < 0).to(torch.int64)
    key = sign[:, 0] | (sign[:, 1] << 1) | (sign[:, 2] << 2)
    key = torch.where(mn <= mx, key, 8)
    packet = torch.arange(B) % pt.WG // 8
    octs = pt._octants(rd) if pi is not None else None
    stats = {} if stats is None else stats
    for k in (*cs.KEYS, "pairs"):
        stats.setdefault(k, 0)
    meta = torch.zeros((W, pt.META_ROWS, cp), dtype=torch.int32)
    j = torch.arange(cp)
    for w in range(W):
        ids = pi[octs[w]] if pi is not None else torch.arange(C)
        ids = torch.cat([ids.to(torch.int64),
                         torch.full((cp - C,), -1, dtype=torch.int64)])
        valid = ids >= 0
        # a column past the clusters tests the point box at the origin
        lo = torch.where(valid[:, None], cl_lo[ids.clamp(min=0)], 0.0)
        hi = torch.where(valid[:, None], cl_hi[ids.clamp(min=0)], 0.0)
        ordered = (lo <= hi).all(1).view(-1, WARP).all(1).repeat_interleave(
            WARP)
        r = torch.arange(w * pt.WG, (w + 1) * pt.WG)
        r = r[torch.argsort(key[r], stable=True)]          # bucket order
        r = r[key[r] < 8]
        stats["pairs"] += r.numel() * C
        bits = torch.zeros(cp, dtype=torch.int64)
        entry = torch.full((cp,), float("inf"))

        def add(rr, cols, near, far, plain):
            tin, hit = _test(ro[rr], inv[rr], mn[rr], mx[rr], near, far,
                             plain)
            per = torch.zeros((pt.N_PACKETS, cols.numel()),
                              dtype=torch.int64)
            per.index_add_(0, packet[rr], hit.to(torch.int64))
            bits[cols] |= ((per > 0).to(torch.int64)
                           << torch.arange(pt.N_PACKETS)[:, None]).sum(0)
            entry[cols] = torch.minimum(
                entry[cols], torch.where(hit, tin, float("inf")).amin(0))
            return hit
        fast = torch.nonzero(ordered)[:, 0]
        for o in range(8):
            rr = r[key[r] == o]
            if not rr.numel():
                continue
            near, far = cs.planes(lo[fast], hi[fast], o)
            safe = bool(torch.isfinite(ro[rr]).all()
                        & torch.isfinite(inv[rr]).all())
            need = valid[fast].clone()
            if safe:
                out = cs.misses(o, near, far, ro[rr].amin(0), ro[rr].amax(0),
                                inv[rr].amin(0), inv[rr].amax(0),
                                mn[rr].amin(), mx[rr].amax())
                # no ray of a bucket left out meets the box
                assert not bool(_test(ro[rr], inv[rr], mn[rr], mx[rr],
                                      near, far, False)[1][:, out].any())
                need &= ~out
                stats["bound_tests"] += int(valid[fast].sum())
            # a warp tests the bucket when a column of it needs it
            warp = fast // WARP
            run = torch.zeros(cp // WARP, dtype=torch.bool)
            run[warp[need]] = True
            cols = fast[run[warp]]
            stats["skipped_tests"] += rr.numel() * int(
                valid[fast[~run[warp]]].sum())
            if cols.numel():
                stats["select_tests"] += rr.numel() * int(valid[cols].sum())
                add(rr, cols, near[run[warp]], far[run[warp]], False)
        slow = torch.nonzero(~ordered)[:, 0]
        if slow.numel() and r.numel():
            stats["plain_tests"] += r.numel() * int(valid[slow].sum())
            add(r, slow, lo[slow], hi[slow], True)
        bits[~valid] = 0
        v0 = torch.where(bits != 0, j, cp - 1)
        v3 = torch.full((cp,), NO_ENTRY, dtype=torch.int64)
        if pi is not None:
            q = torch.clamp(entry * entry_scale, 0.0, 2.0 ** 30)
            v3 = torch.where(bits != 0, q.to(torch.int32).to(torch.int64),
                             NO_ENTRY)
        # chunks of 128 columns from the last; each column's suffix
        # minimum within its chunk, then the carry of the later chunks
        carry0, carry3, count = cp - 1, NO_ENTRY, 0
        m = meta[w]
        for base in range(cp - pt.WG, -1, -pt.WG):
            cols = torch.arange(base, base + pt.WG)
            s0 = torch.cummin(v0[cols].flip(0), 0).values.flip(0)
            s3 = torch.cummin(v3[cols].flip(0), 0).values.flip(0)
            count += int((bits[cols] != 0).sum())
            m[0, cols] = torch.clamp(s0, max=carry0).to(torch.int32)
            m[1, cols] = bits[cols].to(torch.int32)
            if pi is not None:
                m[3, cols] = torch.clamp(s3, max=carry3).to(torch.int32)
                m[4, cols] = ids[cols].clamp(min=0).to(torch.int32)
            carry0, carry3 = min(carry0, int(s0[0])), min(carry3, int(s3[0]))
        m[2, 0] = count
    return meta.view(W * pt.META_ROWS, cp)


@pytest.fixture(scope="module")
def terrain():
    """Terrain 20k and its camera (32x16), bounce and shadow rays, made as
    tests/test_torch_cuda.py's _ray_kinds makes them on the card."""
    scene = terrain_scene(20_000, 32, 16, device="cpu")
    n = 32 * 16
    ro, rd, _, _ = _primary_rays(scene, ir.RenderSettings(width=32,
                                                          height=16),
                                 torch.arange(n),
                                 torch.zeros(n, dtype=torch.int64))
    mn, inf = torch.full((n,), 1e-4), torch.full((n,), float("inf"))
    hr = ct.ClusterTracer(scene, walk="skip").closest(scene, ro, rd, mn, inf)
    idx = torch.nonzero(hr.hit)[:, 0]
    p = (ro[idx] + rd[idx] * hr.t[idx, None]).contiguous()
    r = np.random.default_rng(1)
    d = r.normal(size=(idx.numel(), 3))
    d[:, 1] = np.abs(d[:, 1])
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32)
    wl = torch.tensor([0.3, 4.0, -0.2]) - p
    dist = wl.norm(dim=1)
    m = idx.numel()
    kinds = {"camera": (ro, rd, mn, inf),
             "bounce": (p, d, mn[:m], inf[:m]),
             "shadow": (p, (wl / dist[:, None]).contiguous(), mn[:m],
                        dist * 0.999)}
    return scene, pt.PacketData(scene), kinds


KINDS = ("camera", "bounce", "shadow")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_octant_model_matches_plain_cull_on_terrain(terrain, variant, kind):
    """The model of X1's design gives _cull_meta's meta bit for bit on a
    terrain's rays in PacketTracer's order (padded to whole workgroups
    with idle lanes)."""
    scene, data, kinds = terrain
    tr = pt.PacketTracer(scene, variant=variant, data=data)
    _, packed = tr.pack(*kinds[kind])
    pi = tr.pi if variant == "f2b" else None
    st = {}
    got = _octant_cull(*packed, tr.cl_lo, tr.cl_hi, tr.cp, pi,
                       tr.entry_scale, stats=st)
    want = pt._cull_meta(*packed, tr.cl_lo, tr.cl_hi, tr.cp, pi,
                         tr.entry_scale)
    assert torch.equal(got, want)
    assert int(got.view(-1, 8, tr.cp)[:, 2, 0].sum()) > 0
    # ClusterData's boxes are ordered; the bounds leave tests out, and the
    # replay of X1's counts gives the model's
    assert st["plain_tests"] == 0 and st["select_tests"] > 0
    assert st["skipped_tests"] > 0 and st["bound_tests"] > 0
    assert st["select_tests"] + st["skipped_tests"] == st["pairs"]
    assert cs.cull_steps(*packed, tr.cl_lo, tr.cl_hi, tr.cp, pi) == {
        k: st[k] for k in cs.KEYS}


def _edge_case(C, seed):
    """Three workgroups against C boxes in the unit cube, workgroup 1
    looking away. Boxes: random; one with lo == hi on y, one a point, an
    empty cluster's (+inf, -inf) and one with a NaN corner. Rays: zero and
    -0 direction components, denormal ones (1/d = +-inf), origins on a
    box's lo or hi plane (0 * inf = NaN), NaN and inf origins, idle lanes
    (maxT = -inf), a NaN minT, a second minT on every 17th ray, finite
    maxT."""
    r = np.random.default_rng(seed)
    ctr, half = r.random((C, 3)), 0.02 + 0.1 * r.random((C, 3))
    ctr[0], half[0] = 0.5, 0.45                 # most of the cube
    lo, hi = (ctr - half).astype(np.float32), (ctr + half).astype(np.float32)
    lo[1, 1] = hi[1, 1]
    lo[2] = hi[2]
    lo[3], hi[3] = np.inf, -np.inf
    lo[4, 2] = np.nan
    n = 3 * pt.WG
    ro = r.random((n, 3)).astype(np.float32)
    ro[:, 1] += 1.5
    rd = r.normal(size=(n, 3))
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.5
    rd[128:256, 1] *= -1.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[::5, 0] = 0.0
    rd[1::10, 0] = -0.0
    rd[::11, 2] = -0.0
    rd[3::13, 0] = 1e-40
    rd[4::13, 2] = -1e-40
    ro[3::26, 0] = lo[0, 0]                     # on a plane, 1/d = inf
    ro[5::10, 0] = hi[0, 0]                     # on a plane, d = -0
    ro[6::17, 2] = lo[1, 2]
    ro[7::31, 1] = np.nan
    ro[8::37, 0] = np.inf
    ro[9::41, 2] = -np.inf
    mn = np.full(n, 1e-4, np.float32)
    mn[10::43] = np.nan
    mn[2::17] = 0.05              # buckets with more than one minT
    mx = np.full(n, np.inf, np.float32)
    mx[::3] = 2.0
    mx[::7] = -np.inf
    pi = np.stack([r.permutation(C) for _ in range(8)])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return (t(ro), t(rd), t(mn), t(mx)), t(lo), t(hi), t(pi)


@pytest.mark.parametrize("clusters", [5, 127, 300])
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_octant_model_matches_plain_cull_on_edge_rays(variant, clusters):
    """The model gives _cull_meta's meta bit for bit on edge rays and
    boxes: both forms run (the warp with the unordered boxes takes the
    plain one). The workgroup that looks away has one candidate, the
    empty cluster: in the plain form its +inf / -inf box bounds no axis,
    so every ray with minT <= maxT meets it (the select form would not)."""
    rays, lo, hi, pi = _edge_case(clusters, seed=clusters)
    cp = -(-(clusters + 1) // 128) * 128
    args = (*rays, lo, hi, cp, pi if variant == "f2b" else None, 3.0e5)
    st = {}
    got = _octant_cull(*args, stats=st)
    want = pt._cull_meta(*args)
    assert torch.equal(got, want)
    count = got.view(-1, 8, cp)[:, 2, 0]
    assert count[1] == 1 and count[0] > 1 and count[2] > 1
    # the first warp's columns hold the unordered boxes
    assert st["plain_tests"] > 0
    assert (st["select_tests"] > 0) == (clusters > WARP)
    assert (st["select_tests"] + st["plain_tests"] + st["skipped_tests"]
            == st["pairs"])
    assert cs.cull_steps(*args[:8]) == {k: st[k] for k in cs.KEYS}


def test_directed_rounding_is_exact():
    """cull_schedule's sub32 / mul32 round as __fsub_rd / __fsub_ru /
    __fmul_rd / __fmul_ru do: down is the largest float32 at or below the
    exact result, up the least at or above it, for pairs whose exponents
    differ by up to 2^+-60 (the float64 difference alone is then not
    always exact), near overflow and in the denormals."""
    from fractions import Fraction
    r = np.random.default_rng(7)
    n = 400
    a = (r.standard_normal(n) * 2.0 ** r.integers(-60, 60, n)).astype(
        np.float32)
    b = (r.standard_normal(n) * 2.0 ** r.integers(-60, 60, n)).astype(
        np.float32)
    a[:4] = [1.0, 1.0, 3.0e38, 1e-30]
    b[:4] = [1e-20, -1e-20, -3.0e38, 1e-30]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    big = np.float32(np.finfo(np.float32).max)
    for fn, op in ((cs.sub32, lambda x, y: x - y),
                   (cs.mul32, lambda x, y: x * y)):
        down, up = fn(ta, tb, up=False), fn(ta, tb, up=True)
        for i in range(n):
            exact = op(Fraction(float(a[i])), Fraction(float(b[i])))
            d, u = float(down[i]), float(up[i])
            assert d == -np.inf or Fraction(d) <= exact, (fn, i)
            assert u == np.inf or exact <= Fraction(u), (fn, i)
            assert d == float(big) or d == -np.inf or exact < Fraction(
                float(np.nextafter(np.float32(d), np.float32(np.inf)))), i
            assert (d == u) == (Fraction(d) == exact if abs(d) < np.inf
                                else False), (fn, i)
    # 1 - 1e-20 lies just below 1: down is the float below, up is 1
    assert float(cs.sub32(ta[:1], tb[:1], up=False)) == float(
        np.nextafter(np.float32(1), np.float32(0)))
    assert float(cs.sub32(ta[:1], tb[:1], up=True)) == 1.0
    # past the largest float: up is inf, down the largest float
    assert float(cs.sub32(ta[2:3], tb[2:3], up=True)) == np.inf
    assert float(cs.sub32(ta[2:3], tb[2:3], up=False)) == float(big)
    # 1e-60 is below the least denormal: up is that denormal, down 0
    assert float(cs.mul32(ta[3:4], tb[3:4], up=True)) == float(
        np.nextafter(np.float32(0), np.float32(1)))
    assert float(cs.mul32(ta[3:4], tb[3:4], up=False)) == 0.0
