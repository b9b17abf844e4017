"""BVH build on the host and the per-ray BVH walk (port of
vimg_tpu.geometry.bvh).

Build (host, numpy): binned SAH, 16 bins, at most 8 primitives per leaf,
SAH costs Ci = 1 and Ct = 0.5 and a median-split fallback: the algorithm
of the reference's src/bvh/bin_bvh.cpp, iterative over numpy slices.
``build_bvh_numpy`` is the oracle; ``runtime.native.build_bvh_native`` is
the C++ builder with the same output format (mode 1: the reference's
``-b 1`` exact sweep SAH). The cluster tracer cuts either tree into
treelet clusters (geometry/cluster_trace.py); ``BVHTracer`` walks it.

Walk: the tree is laid out in DFS preorder and threaded with skip links,
``next = aabb_hit(node) ? node + 1 : skip[node]``, and a leaf tests up to
LEAF_SIZE primitives. ``bvh_traverse`` is that walk in tensor code, ray
by ray as vimg_tpu's lockstep XLA loop computes it, and the plain version
of kernel X2 (``csrc/bvh_walk.cu``), which ``bvh_trace`` launches for
CUDA tensors over the tables ``packed_tables`` packs for it (32-byte node
records, 48-byte primitive rows in leaf-slot order), cached on the tree
and checked against the scene's tensors and their versions. ``refit_bvh``
recomputes the boxes a level at a time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from vimg_tpu_torch.geometry.intersect import (HitResult, sphere_intersect,
                                               tri_intersect)
from vimg_tpu_torch.scene import ir

N_BINS = 16
LEAF_SIZE = 8
COST_INTERSECT = 1.0   # reference BVHConst::intersection_cost
COST_TRAVERSE = 0.5    # reference BVHConst::traversal_cost
# operations of one test, for kernel X2's bound (the slab test as B3's;
# the watertight triangle and the robust quadric sphere counted from
# geometry/intersect.py)
BOX_TEST_OPS = 25
TRI_TEST_OPS = 56
SPHERE_TEST_OPS = 40
MODE_CLOSEST, MODE_ANY_HIT, MODE_COST = 0, 1, 2
# kernel X2's packed tables: a node is 8 words (lo xyz, skip; hi xyz, start
# << COUNT_BITS | count), a primitive row 12 (a triangle's p0 p1 p2 or a
# sphere's centre and radius, then ROW_KIND, ROW_TYPE, ROW_IDX); ints are
# stored as their bits
NODE_WORDS, ROW_WORDS, COUNT_BITS = 8, 12, 4
ROW_KIND, ROW_TYPE, ROW_IDX = 9, 10, 11
KIND_NONE = -1            # a slot whose primitive the walk cannot test
# X2 runs a warp's posted leaves once POST_MIN lanes wait on one, or when no
# lane walks on (csrc/bvh_walk.cu kPostMin; 33 would wait for every lane,
# 1 run a round at every post); 8 gave the least time on 4 of terrain
# 100k's 6 ray sets of the thresholds 1-33 (x2_study.py post-min; PERF.md)
POST_MIN = 8

X2_BLOCK = 128     # csrc/bvh_walk.cu kThreads
LAUNCHES = 0       # kernel X2 launches (bvh_trace on CUDA tensors)


@dataclass(frozen=True)
class BVHArrays:
    """The flat tables of a preorder BVH, on the scene's device."""
    node_min: torch.Tensor    # (N, 3) f32
    node_max: torch.Tensor    # (N, 3) f32
    node_start: torch.Tensor  # (N,) i32: first prim (leaf) / 0 (inner)
    node_count: torch.Tensor  # (N,) i32: prim count; 0 == inner node
    node_skip: torch.Tensor   # (N,) i32: DFS skip pointer
    node_right: torch.Tensor  # (N,) i32: right child (inner; -1 leaf)
    prim_type: torch.Tensor   # (P,) i32 (PRIM_TRI / PRIM_SPHERE)
    prim_idx: torch.Tensor    # (P,) i32 index into the tri/sphere tables
    # kernel X2's packed tables (packed_tables); a refit's new tree starts
    # empty
    packed: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def n_nodes(self):
        return self.node_min.shape[0]


def _np(x):
    return x.detach().cpu().numpy()


def scene_prim_bounds(scene: ir.Scene):
    """Per-primitive AABBs, centers, types and indices of the unified
    primitive table (triangles, then spheres), numpy."""
    mins, maxs, centers, ptype, pidx = [], [], [], [], []
    if scene.n_tris() > 0:
        p = _np(scene.verts)[_np(scene.tri_vidx)]          # (T, 3, 3)
        mins.append(p.min(axis=1))
        maxs.append(p.max(axis=1))
        centers.append(p.mean(axis=1))
        ptype.append(np.full(p.shape[0], ir.PRIM_TRI, np.int32))
        pidx.append(np.arange(p.shape[0], dtype=np.int32))
    if scene.n_spheres() > 0:
        c = _np(scene.sph_center)
        r = _np(scene.sph_radius)[:, None]
        mins.append(c - r)
        maxs.append(c + r)
        centers.append(c)
        ptype.append(np.full(c.shape[0], ir.PRIM_SPHERE, np.int32))
        pidx.append(np.arange(c.shape[0], dtype=np.int32))
    return (np.concatenate(mins), np.concatenate(maxs),
            np.concatenate(centers), np.concatenate(ptype),
            np.concatenate(pidx))


def _half_sa(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2]


def build_bvh_numpy(bmin, bmax, centers):
    """Binned-SAH build. Returns a dict of flat arrays in DFS preorder
    (left child = parent + 1) plus the primitive permutation ``order``."""
    P = bmin.shape[0]
    order = np.arange(P, dtype=np.int32)

    node_min, node_max = [], []
    node_start, node_count, node_right = [], [], []

    def new_node():
        node_min.append(None)
        node_max.append(None)
        node_start.append(0)
        node_count.append(0)
        node_right.append(-1)
        return len(node_min) - 1

    stack = [(0, P, -1, False)]  # (start, end, parent, is_right_child)
    while stack:
        s, e, parent, is_right = stack.pop()
        idx = new_node()
        if parent >= 0 and is_right:
            node_right[parent] = idx

        sel = order[s:e]
        nb_min = bmin[sel].min(axis=0)
        nb_max = bmax[sel].max(axis=0)
        node_min[idx] = nb_min
        node_max[idx] = nb_max
        n = e - s

        do_leaf = n <= 1
        best = None
        if not do_leaf:
            cen = centers[sel]
            c_min = cen.min(axis=0)
            c_max = cen.max(axis=0)
            ext = c_max - c_min
            best_cost = np.inf
            for axis in range(3):
                if ext[axis] <= 0:
                    continue
                scale = N_BINS * (1.0 - 1e-6) / ext[axis]
                b = np.minimum(((cen[:, axis] - c_min[axis]) * scale)
                               .astype(np.int32), N_BINS - 1)
                counts = np.bincount(b, minlength=N_BINS)
                binmin = np.full((N_BINS, 3), np.inf, np.float32)
                binmax = np.full((N_BINS, 3), -np.inf, np.float32)
                for k in range(3):
                    np.minimum.at(binmin[:, k], b, bmin[sel][:, k])
                    np.maximum.at(binmax[:, k], b, bmax[sel][:, k])
                # prefix (left) and suffix (right) sweeps
                lmin = np.minimum.accumulate(binmin, axis=0)
                lmax = np.maximum.accumulate(binmax, axis=0)
                lcount = np.cumsum(counts)
                rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
                rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
                rcount = np.cumsum(counts[::-1])[::-1]
                # split after bin i: left bins [0..i], right [i+1..]
                sa_l = _half_sa(lmin[:-1], lmax[:-1])
                sa_r = _half_sa(rmin[1:], rmax[1:])
                nl = lcount[:-1].astype(np.float64)
                nr = rcount[1:].astype(np.float64)
                with np.errstate(invalid="ignore"):
                    cost = sa_l * nl + sa_r * nr
                cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
                i = int(np.argmin(cost))
                if cost[i] < best_cost:
                    best_cost = cost[i]
                    best = (axis, i, c_min[axis], scale)
            # SAH termination: split cost vs leaf cost, reference form
            sa_node = max(_half_sa(nb_min, nb_max), 1e-12)
            if best is not None:
                split_cost = COST_TRAVERSE + COST_INTERSECT * best_cost / sa_node
                if split_cost >= COST_INTERSECT * n and n <= LEAF_SIZE:
                    do_leaf = True
            else:
                # degenerate centroid bounds: leaf if small, median otherwise
                if n <= LEAF_SIZE:
                    do_leaf = True
                else:
                    best = ("median", 0, 0.0, 0.0)

        if do_leaf:
            node_start[idx] = s
            node_count[idx] = n
            continue

        if best[0] == "median":
            axis = int(np.argmax(bmax[sel].max(0) - bmin[sel].min(0)))
            key = centers[sel][:, axis]
            part = np.argsort(key, kind="stable")
            mid = n // 2
            order[s:e] = sel[part]
        else:
            axis, i, c0, scale = best
            b = np.minimum(((centers[sel][:, axis] - c0) * scale)
                           .astype(np.int32), N_BINS - 1)
            left_mask = b <= i
            mid = int(left_mask.sum())
            if mid == 0 or mid == n:
                part = np.argsort(centers[sel][:, axis], kind="stable")
                order[s:e] = sel[part]
                mid = n // 2
            else:
                order[s:e] = np.concatenate([sel[left_mask], sel[~left_mask]])

        # push right first so left is processed (appended) immediately after
        node_start[idx] = 0
        node_count[idx] = 0
        stack.append((s + mid, e, idx, True))
        stack.append((s, s + mid, idx, False))

    N = len(node_min)
    node_min = np.stack(node_min).astype(np.float32)
    node_max = np.stack(node_max).astype(np.float32)
    node_start = np.asarray(node_start, np.int32)
    node_count = np.asarray(node_count, np.int32)
    node_right = np.asarray(node_right, np.int32)

    # skip links: preorder DFS; skip(root) = N, skip(left) = right sibling,
    # skip(right) = skip(parent)
    node_skip = np.full(N, N, np.int32)
    stack2 = [(0, N)]
    while stack2:
        i, skip = stack2.pop()
        node_skip[i] = skip
        if node_count[i] == 0:  # inner
            r = node_right[i]
            stack2.append((i + 1, r))
            stack2.append((r, skip))
    return dict(node_min=node_min, node_max=node_max, node_start=node_start,
                node_count=node_count, node_skip=node_skip, order=order,
                node_right=node_right)


def _bvh_levels(node_count, node_right):
    """Depth of every node (preorder walk) -> list of per-level index
    arrays, deepest first: the schedule of ``refit_bvh``."""
    N = node_count.shape[0]
    depth = np.zeros(N, np.int32)
    stack = [(0, 0)]
    while stack:
        i, d = stack.pop()
        depth[i] = d
        if node_count[i] == 0:
            stack.append((i + 1, d + 1))
            stack.append((node_right[i], d + 1))
    levels = []
    for d in range(depth.max(), -1, -1):
        idx = np.nonzero(depth == d)[0].astype(np.int32)
        if idx.size:
            levels.append(idx)
    return levels


def build_scene_bvh(scene: ir.Scene, builder="auto") -> BVHArrays:
    """The scene's BVH on its device. ``builder``: auto | native | sweep
    | device | numpy. "sweep" is the reference's ``-b 1`` exact sweep SAH
    (native); "device" the same sweep SAH level by level on the scene's
    device (geometry/device_build.py: kernel X3 on the card, its plain
    version on the CPU); "auto" and "native" the binned SAH in C++, "auto"
    falling back to numpy where the C++ builder cannot be built, as
    vimg_tpu's."""
    if builder not in ("auto", "native", "sweep", "device", "numpy"):
        raise ValueError(f"unknown BVH builder {builder!r}")
    bmin, bmax, centers, ptype, pidx = scene_prim_bounds(scene)
    built = None
    if builder == "device":
        from vimg_tpu_torch.geometry.device_build import \
            build_sweep_sah_device
        built = build_sweep_sah_device(bmin, bmax, centers,
                                       device=scene.device)
    if builder in ("auto", "native", "sweep"):
        try:
            from vimg_tpu_torch.runtime.native import build_bvh_native
            built = build_bvh_native(bmin, bmax, centers,
                                     mode=1 if builder == "sweep" else 0)
        except Exception:
            if builder in ("native", "sweep"):
                raise
    if built is None:
        built = build_bvh_numpy(bmin, bmax, centers)
    order = built["order"]
    if "node_right" in built:
        node_right = built["node_right"]
    else:
        # preorder invariant: left child = i + 1, and skip(left) = right
        count = built["node_count"]
        skip = built["node_skip"]
        N = count.shape[0]
        node_right = np.full(N, -1, np.int32)
        inner = np.nonzero(count == 0)[0]
        node_right[inner] = skip[np.minimum(inner + 1, N - 1)]
    dev = scene.device

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    return BVHArrays(
        node_min=t(built["node_min"], np.float32),
        node_max=t(built["node_max"], np.float32),
        node_start=t(built["node_start"], np.int32),
        node_count=t(built["node_count"], np.int32),
        node_skip=t(built["node_skip"], np.int32),
        node_right=t(node_right, np.int32),
        prim_type=t(ptype[order], np.int32),
        prim_idx=t(pidx[order], np.int32))


# ---------------------------------------------------------------------------
# the walk in tensor code: kernel X2's plain version
# ---------------------------------------------------------------------------

def _aabb_hit(node_min, node_max, ro, inv_rd, minT, maxT):
    """Slab test over [minT, maxT] with NaN-propagating min / max (XLA's
    and kernel X2's)."""
    t_lo = (node_min - ro) * inv_rd
    t_hi = (node_max - ro) * inv_rd
    t_near = torch.minimum(t_lo, t_hi)
    t_far = torch.maximum(t_lo, t_hi)
    t0 = torch.maximum(torch.maximum(torch.maximum(t_near[..., 0],
                                                   t_near[..., 1]),
                                     t_near[..., 2]), minT)
    t1 = torch.minimum(torch.minimum(torch.minimum(t_far[..., 0],
                                                   t_far[..., 1]),
                                     t_far[..., 2]), maxT)
    return t0 <= t1


def _leaf_test(scene, bvh: BVHArrays, start, count, ro, rd, minT, maxT):
    """Test up to LEAF_SIZE primitives of each ray's leaf: (t (R, K),
    ptype, pidx, u, v) with +inf where missed, as vimg_tpu's."""
    lanes = torch.arange(LEAF_SIZE, device=ro.device)[None, :]
    slot = torch.clamp(start[:, None].long() + lanes, 0,
                       bvh.prim_type.shape[0] - 1)
    valid = lanes < count[:, None].long()
    ptype = bvh.prim_type[slot]
    pidx = bvh.prim_idx[slot]
    t = torch.full(slot.shape, float("inf"), device=ro.device)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    if scene.n_tris() > 0:
        tid = torch.clamp(pidx.long(), 0, scene.n_tris() - 1)
        p = scene.verts[scene.tri_vidx[tid]]                # (R, K, 3, 3)
        tt, tu, tv, _, ok = tri_intersect(
            ro[:, None, :], rd[:, None, :], p[..., 0, :], p[..., 1, :],
            p[..., 2, :], minT[:, None], maxT[:, None])
        m = (ptype == ir.PRIM_TRI) & valid & ok
        t = torch.where(m, tt, t)
        u = torch.where(m, tu, u)
        v = torch.where(m, tv, v)
    if scene.n_spheres() > 0:
        sid = torch.clamp(pidx.long(), 0, scene.n_spheres() - 1)
        st, ok = sphere_intersect(
            ro[:, None, :], rd[:, None, :], scene.sph_center[sid],
            scene.sph_radius[sid], minT[:, None], maxT[:, None])
        m = (ptype == ir.PRIM_SPHERE) & valid & ok
        t = torch.where(m, st, t)
    return t, ptype, pidx, u, v


def bvh_traverse(scene, bvh: BVHArrays, ro, rd, minT, maxT, any_hit=False,
                 count_cost=False, stats=None):
    """The skip-link walk of every ray (kernel X2's plain version).

    Returns a HitResult (closest), a bool occlusion mask (``any_hit``),
    or (HitResult, cost) with the reference's heatmap cost, 0.5 a node
    visit and 1.0 a primitive test (bvh.h:17-20), when ``count_cost``.
    Each ray computes what it computes in vimg_tpu's lockstep loop; here
    only the rays still walking are carried. ``stats`` (a dict) counts
    box_tests, tri_tests and sphere_tests."""
    B, dev = ro.shape[0], ro.device
    N = bvh.n_nodes
    ro, rd = ro.detach(), rd.detach()
    minT = minT.detach().expand(B)
    inv_rd = 1.0 / torch.where(rd == 0.0, 1e-20, rd)
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    best_t = maxT.detach().expand(B).clone()
    ptype = torch.zeros(B, dtype=torch.int64, device=dev)
    pidx = torch.full((B,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(B, device=dev)
    bv = torch.zeros(B, device=dev)
    occ = torch.zeros(B, dtype=torch.bool, device=dev)
    cost = torch.zeros(B, device=dev)
    act = torch.arange(B, device=dev)
    lanes = torch.arange(LEAF_SIZE, device=dev)[None, :]
    tables = (bvh.node_min, bvh.node_max, bvh.node_count, bvh.node_start,
              bvh.node_skip)
    while act.numel():
        n = cur[act]
        nmin, nmax, count, start, skip = (x[n] for x in tables)
        hit_box = _aabb_hit(nmin, nmax, ro[act], inv_rd[act], minT[act],
                            best_t[act])
        is_leaf = count > 0
        do_leaf = hit_box & is_leaf
        cost[act] += COST_TRAVERSE
        _count(stats, "box_tests", act.numel())
        if bool(do_leaf.any()):
            i = act[do_leaf]
            cnt = count[do_leaf]
            t, lt, li, u, v = _leaf_test(scene, bvh, start[do_leaf], cnt,
                                         ro[i], rd[i], minT[i], best_t[i])
            if stats is not None:
                valid = lanes < cnt[:, None]
                _count(stats, "tri_tests",
                       int((valid & (lt == ir.PRIM_TRI)).sum()))
                _count(stats, "sphere_tests",
                       int((valid & (lt == ir.PRIM_SPHERE)).sum()))
            # the first lane of least t (vimg_tpu's argmin)
            tmin = t.amin(dim=1)
            lane = torch.where(t == tmin[:, None], lanes, LEAF_SIZE).amin(
                dim=1, keepdim=True)
            better = tmin < best_t[i]
            j = i[better]
            best_t[j] = tmin[better]
            ptype[j] = lt.gather(1, lane)[better, 0].long()
            pidx[j] = li.gather(1, lane)[better, 0].long()
            bu[j] = u.gather(1, lane)[better, 0]
            bv[j] = v.gather(1, lane)[better, 0]
            cost[i] += COST_INTERSECT * cnt.float()
            if any_hit:
                occ[j[torch.isfinite(tmin[better])]] = True
        nxt = torch.where(hit_box & ~is_leaf, n + 1, skip.long())
        if any_hit:
            nxt = torch.where(occ[act], N, nxt)
        cur[act] = nxt
        act = act[nxt < N]
    if any_hit:
        return occ
    found = pidx >= 0
    hr = HitResult(t=torch.where(found, best_t, float("inf")),
                   prim_type=ptype, prim_id=torch.where(found, pidx, 0),
                   u=bu, v=bv)
    return (hr, cost) if count_cost else hr


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


# ---------------------------------------------------------------------------
# kernel X2's packed tables
# ---------------------------------------------------------------------------

def pack_nodes(bvh: BVHArrays):
    """X2's node records, (N, NODE_WORDS) float32: lo xyz and the skip
    link's bits, hi xyz and the bits of start << COUNT_BITS | count."""
    start = bvh.node_start.to(torch.int32)
    count = bvh.node_count.to(torch.int32)
    if bvh.n_nodes and (int(count.min()) < 0 or int(start.min()) < 0
                        or int(count.max()) >= 1 << COUNT_BITS
                        or int(start.max()) >= 1 << (31 - COUNT_BITS)):
        raise ValueError("X2's node record holds 0 <= count < "
                         f"{1 << COUNT_BITS} and 0 <= start < "
                         f"{1 << (31 - COUNT_BITS)}")
    words = torch.cat([
        bvh.node_min.contiguous().view(torch.int32),
        bvh.node_skip.to(torch.int32)[:, None],
        bvh.node_max.contiguous().view(torch.int32),
        ((start << COUNT_BITS) | count)[:, None]], dim=1)
    return words.contiguous().view(torch.float32)


def pack_rows(scene: ir.Scene, bvh: BVHArrays):
    """X2's primitive rows, (P, ROW_WORDS) float32 in leaf-slot order: the
    triangle's vertices ``verts[tri_vidx[i]]`` or the sphere's centre and
    radius, as bvh_traverse reads them (the index clamped as there), then
    the test kind, the prim type and the prim index as int bits."""
    P, dev = bvh.prim_type.shape[0], bvh.prim_type.device
    ptype = bvh.prim_type.to(torch.int32)
    words = torch.zeros((P, ROW_WORDS), dtype=torch.int32, device=dev)
    kind = torch.full((P,), KIND_NONE, dtype=torch.int32, device=dev)
    if scene.n_tris() > 0:
        tid = torch.clamp(bvh.prim_idx.long(), 0, scene.n_tris() - 1)
        verts = scene.verts.detach().contiguous().view(torch.int32)
        p = verts[scene.tri_vidx[tid].long()].reshape(P, 9)
        is_tri = ptype == ir.PRIM_TRI
        words[:, 0:9] = torch.where(is_tri[:, None], p, words[:, 0:9])
        kind = torch.where(is_tri, ir.PRIM_TRI, kind)
    if scene.n_spheres() > 0:
        sid = torch.clamp(bvh.prim_idx.long(), 0, scene.n_spheres() - 1)
        c = scene.sph_center.detach().contiguous().view(torch.int32)[sid]
        r = scene.sph_radius.detach().contiguous().view(torch.int32)[sid]
        is_sph = ptype == ir.PRIM_SPHERE
        words[:, 0:3] = torch.where(is_sph[:, None], c, words[:, 0:3])
        words[:, 3] = torch.where(is_sph, r, words[:, 3])
        kind = torch.where(is_sph, ir.PRIM_SPHERE, kind)
    words[:, ROW_KIND] = kind
    words[:, ROW_TYPE] = ptype
    words[:, ROW_IDX] = bvh.prim_idx.to(torch.int32)
    return words.view(torch.float32)


def node_fields(nodes):
    """A packed node table's fields: (lo, hi, skip, start, count)."""
    w = nodes.view(torch.int32)
    return (nodes[:, 0:3], nodes[:, 4:7], w[:, 3], w[:, 7] >> COUNT_BITS,
            w[:, 7] & ((1 << COUNT_BITS) - 1))


def row_fields(rows):
    """A packed row table's int fields: (test kind, prim type, prim idx)."""
    w = rows.view(torch.int32)
    return w[:, ROW_KIND], w[:, ROW_TYPE], w[:, ROW_IDX]


def _cached(bvh, tag, sources, make):
    """``make()``, kept in ``bvh.packed`` while every source is the same
    tensor at the same version (an in-place write bumps the version, so
    nothing is read stale)."""
    versions = tuple(x._version for x in sources)
    hit = bvh.packed.get(tag)
    if (hit is not None and hit[1] == versions
            and all(a is b for a, b in zip(hit[0], sources))):
        return hit[2]
    with torch.no_grad():
        out = make()
    bvh.packed[tag] = (sources, versions, out)
    return out


def packed_tables(scene: ir.Scene, bvh: BVHArrays):
    """Kernel X2's (nodes, rows) for this tree and scene: packed once per
    tree, packed anew when a node table or a geometry tensor (``verts``,
    ``tri_vidx``, ``sph_center``, ``sph_radius``) is another tensor or was
    written in place. They live as long as the tree."""
    nodes = _cached(bvh, "nodes", (bvh.node_min, bvh.node_max,
                                   bvh.node_start, bvh.node_count,
                                   bvh.node_skip), lambda: pack_nodes(bvh))
    rows = _cached(bvh, "rows", (bvh.prim_type, bvh.prim_idx, scene.verts,
                                 scene.tri_vidx, scene.sph_center,
                                 scene.sph_radius),
                   lambda: pack_rows(scene, bvh))
    return nodes, rows


# ---------------------------------------------------------------------------
# kernel X2's wrapper
# ---------------------------------------------------------------------------

def _check(x, name, dtype, shape, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def bvh_trace(scene, bvh: BVHArrays, ro, rd, minT, maxT, any_hit=False,
              count_cost=False, steps=None):
    """Kernel X2 (CUDA tensors) or ``bvh_traverse`` (CPU tensors), with
    bvh_traverse's returns.

    X2 has no Pallas counterpart: vimg_tpu walks the BVH with XLA (every
    lane in lockstep, leaves tested 8 primitives wide by one-hot selects,
    vimg_tpu/geometry/bvh.py:341-433). On the card each lane walks its
    ray's skip links over ``packed_tables`` and posts each live leaf; the
    warp runs the posted leaves together, a lane a (leaf, slot) pair, in
    one of three modes: closest, any hit (leaving at its first occluding
    leaf) and closest with the cost counter. ``steps`` (CUDA int64 (2,)):
    the launch adds its warp node and leaf steps (geometry/bvh_schedule.py
    replays them). See csrc/bvh_walk.cu."""
    global LAUNCHES
    dev = ro.device
    if dev.type == "cpu":
        return bvh_traverse(scene, bvh, ro, rd, minT, maxT, any_hit=any_hit,
                            count_cost=count_cost)
    if dev.type != "cuda":
        raise NotImplementedError(f"no BVH walk for device {dev}")
    from vimg_tpu_torch.runtime.cuda import check, load_library
    B, N = ro.shape[0], bvh.n_nodes
    P = bvh.prim_type.shape[0]
    nodes, rows = packed_tables(scene, bvh)
    ro = ro.detach().contiguous()
    rd = rd.detach().contiguous()
    minT = minT.detach().expand(B).contiguous()
    maxT = maxT.detach().expand(B).contiguous()
    tables = (("nodes", nodes, torch.float32, (N, NODE_WORDS)),
              ("rows", rows, torch.float32, (P, ROW_WORDS)),
              ("ro", ro, torch.float32, (B, 3)),
              ("rd", rd, torch.float32, (B, 3)),
              ("minT", minT, torch.float32, (B,)),
              ("maxT", maxT, torch.float32, (B,)))
    for name, x, dtype, shape in tables:
        _check(x, name, dtype, shape, dev)
    if steps is not None:
        _check(steps, "steps", torch.int64, (2,), dev)
    mode = (MODE_ANY_HIT if any_hit else
            MODE_COST if count_cost else MODE_CLOSEST)
    t = torch.empty(B, dtype=torch.float32, device=dev)
    ptype = torch.empty(B, dtype=torch.int32, device=dev)
    pidx = torch.empty(B, dtype=torch.int32, device=dev)
    u = torch.empty(B, dtype=torch.float32, device=dev)
    v = torch.empty(B, dtype=torch.float32, device=dev)
    occ = torch.empty(B, dtype=torch.uint8, device=dev)
    cost = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.vimg_bvh_walk(
                *(x.data_ptr() for _, x, _, _ in tables), B, N, P, mode,
                t.data_ptr(), ptype.data_ptr(), pidx.data_ptr(),
                u.data_ptr(), v.data_ptr(), occ.data_ptr(), cost.data_ptr(),
                None if steps is None else steps.data_ptr(), stream)
        check(rc, "vimg_bvh_walk")
        LAUNCHES += 1
    if any_hit:
        return occ.bool()
    hr = HitResult(t=t, prim_type=ptype.long(), prim_id=pidx.long(), u=u,
                   v=v)
    return (hr, cost) if count_cost else hr


def occupancy(mode):
    """X2's registers a thread, local bytes a thread (stack frame and
    spills) and resident blocks and warps per SM in ``mode`` (MODE_*), from
    cudaFuncGetAttributes and the occupancy API."""
    import ctypes
    from vimg_tpu_torch.runtime.cuda import check, load_library
    per_sm, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(load_library().vimg_bvh_occupancy(
        mode, ctypes.byref(per_sm), ctypes.byref(regs), ctypes.byref(local)),
        "vimg_bvh_occupancy")
    return dict(regs=regs.value, local_bytes=local.value,
                blocks_per_sm=per_sm.value,
                warps_per_sm=per_sm.value * X2_BLOCK // 32)


# ---------------------------------------------------------------------------
# refit and the tracer facade
# ---------------------------------------------------------------------------

def refit_bvh(scene: ir.Scene, bvh: BVHArrays, levels) -> BVHArrays:
    """Recompute every box bottom-up for the scene's current vertex and
    sphere positions, keeping the topology (tensor code, a level at a
    time; ``levels`` from ``_bvh_levels``, deepest first)."""
    dev = bvh.node_min.device
    P = bvh.prim_type.shape[0]
    inf = float("inf")
    pmin = torch.full((P, 3), inf, device=dev)
    pmax = torch.full((P, 3), -inf, device=dev)
    if scene.n_tris() > 0:
        tid = torch.clamp(bvh.prim_idx.long(), 0, scene.n_tris() - 1)
        tri = scene.verts[scene.tri_vidx[tid]]               # (P, 3, 3)
        is_tri = (bvh.prim_type == ir.PRIM_TRI)[:, None]
        pmin = torch.where(is_tri, tri.amin(dim=1), pmin)
        pmax = torch.where(is_tri, tri.amax(dim=1), pmax)
    if scene.n_spheres() > 0:
        sid = torch.clamp(bvh.prim_idx.long(), 0, scene.n_spheres() - 1)
        c = scene.sph_center[sid]
        r = scene.sph_radius[sid][:, None]
        is_sph = (bvh.prim_type == ir.PRIM_SPHERE)[:, None]
        pmin = torch.where(is_sph, c - r, pmin)
        pmax = torch.where(is_sph, c + r, pmax)

    node_min = bvh.node_min.clone()
    node_max = bvh.node_max.clone()
    n_nodes = node_min.shape[0]
    lanes = torch.arange(LEAF_SIZE, device=dev)[None, :]
    for idx in levels:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        count = bvh.node_count[idx].long()
        start = bvh.node_start[idx].long()
        is_leaf = (count > 0)[:, None]
        slot = torch.clamp(start[:, None] + lanes, 0, P - 1)
        valid = (lanes < count[:, None])[..., None]
        leaf_min = torch.where(valid, pmin[slot], inf).amin(dim=1)
        leaf_max = torch.where(valid, pmax[slot], -inf).amax(dim=1)
        left = torch.clamp(idx + 1, 0, n_nodes - 1)
        right = torch.clamp(bvh.node_right[idx].long(), 0, n_nodes - 1)
        in_min = torch.minimum(node_min[left], node_min[right])
        in_max = torch.maximum(node_max[left], node_max[right])
        node_min[idx] = torch.where(is_leaf, leaf_min, in_min)
        node_max[idx] = torch.where(is_leaf, leaf_max, in_max)
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max)


class BVHTracer:
    """The per-ray BVH tracer: kernel X2 on CUDA, ``bvh_traverse`` on the
    CPU (``plain=True``: bvh_traverse on any device, X2's reference on the
    card). ``builder`` as build_scene_bvh's."""

    # the rays reach the walk detached (zero tangent through traversal,
    # as the cluster and packet tracers): vimg_tpu's lax.while_loop walk
    # cannot be reverse-differentiated either
    differentiable = True

    def __init__(self, scene: ir.Scene, builder="auto", plain=False):
        if scene.device.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"no BVH walk for device "
                                      f"{scene.device}")
        self.builder = builder
        self.plain = plain
        self.bvh = build_scene_bvh(scene, builder=builder)
        self.levels = _bvh_levels(_np(self.bvh.node_count),
                                  _np(self.bvh.node_right))

    def refit(self, scene):
        """Update the boxes for moved geometry (topology kept); X2 packs
        the new tree's tables at its next walk."""
        self.bvh = refit_bvh(scene, self.bvh, self.levels)
        return self

    def trace(self, scene, ro, rd, minT, maxT, any_hit=False,
              count_cost=False):
        walk = bvh_traverse if self.plain else bvh_trace
        return walk(scene, self.bvh, ro, rd, minT, maxT, any_hit=any_hit,
                    count_cost=count_cost)

    def closest(self, scene, ro, rd, minT, maxT) -> HitResult:
        return self.trace(scene, ro, rd, minT, maxT)

    def occluded(self, scene, ro, rd, minT, maxT):
        return self.trace(scene, ro, rd, minT, maxT, any_hit=True)
