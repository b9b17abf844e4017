"""Mesh tracer over treelet clusters (port of
vimg_tpu.geometry.cluster_trace).

Host half (numpy, byte-identical to vimg_tpu's tables for the same
builder): the SAH tree is cut into treelet clusters of <= 64 triangles
(``cut_clusters``); each cluster is a (64, 16) block of plane/dual-basis
triangle constants whose spare slots carry the material id and the boxes of
its four 16-triangle sub-blocks. The tree restricted to the clusters is
kept two ways: a binary tree threaded with skip links (``node_aabbs``,
``node_cid``, ``node_skip``) and an 8-ary tree (``ClusterData.wide_tables``).

Device half: closest or any hit of each ray against one of the two trees.

- ``trace_wide`` (kernel B3, ``csrc/cluster_trace.cu``) walks the 8-ary tree
  with a per-lane stack; ``trace_skip`` (kernel B4) walks the binary tree
  stacklessly (``n = live ? n + 1 : skip[n]``); in both the warp runs the
  clusters its lanes reach together (``csrc/cluster_walk.cuh``,
  ``leaf_round``). Each wrapper launches its CUDA kernel for CUDA tensors,
  counts the launch in ``LAUNCHES_WIDE`` / ``LAUNCHES_SKIP``, and takes
  the plain version for CPU tensors only.
- ``wide_walk_plain`` and ``skip_walk_plain`` are the plain versions: the
  same per-ray walks vectorised over rays in PyTorch, with the same float32
  operations in the same order, so kernel and plain walk agree bit for bit.

Why a per-ray walk returns the TPU tile walk's hits exactly: child boxes
are nested in their parents, the slab test is monotone in the box bounds,
and a ray's best t only shrinks. So a ray's walk in preorder tests exactly
the (cluster, sub-box, triangle) candidates that its lane tests in the
tile walk, in the same order, with the same arithmetic. Leaf liveness comes
from the cluster box; each sub-box gate uses the ray's t at leaf entry;
ties go to the first triangle in visit order.

``ClusterTracer`` is the facade: Morton ray sort above 8,192 rays (inert
lanes, maxT = -inf, to the tail), the walk, unsort, prim ids through the
build permutation, and a dense merge with the scene's spheres.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.geometry.bvh import build_bvh_numpy
from vimg_tpu_torch.geometry.intersect import HitResult
from vimg_tpu_torch.geometry.soa_intersect import (_trace_impl,
                                                   build_constants,
                                                   tri_constants)
from vimg_tpu_torch.scene import ir

CLUSTER_K = 64          # triangles per cluster (the kernels' compile-time K)
ROW16 = 16              # floats per packed triangle row (12 used)
SUB = 16                # triangles per sub-box gate
N_SUB = CLUSTER_K // SUB
FAN = 8                 # children per wide node
EMPTY = 0x3FFFFFFF      # ref of an empty wide-node slot
# compile-time stack bound of kernel B3 (csrc/cluster_trace.cu MAX_STACK)
WIDE_MAX_STACK = 128
# wide walk up to this many clusters, else the skip walk. Inherited from
# vimg_tpu, where the wide tables had to fit the TPU's 1 MB SMEM; kept so
# the default paths match (terrain 100k -> wide, terrain 500k -> skip).
WIDE_MAX_CLUSTERS = 4096
# rays are Morton-sorted above this batch (vimg_tpu's 64 x 128 ray tile)
SORT_MIN_RAYS = 64 * 128
# float32 operations per slab test and per triangle test, counted from the
# plain walks' arithmetic (for the bound in chip_smoke.py): a slab test is
# 6 sub + 6 mul + 6 min/max + 3 max + 3 min + 1 compare; a triangle test is
# 2 dot products (10), |.| < eps and a select (3), sub + div (2), two
# barycentrics of 13 each, 11 compares/ands for the hit mask, 4 selects.
BOX_TEST_OPS = 25
TRI_TEST_OPS = 56

LAUNCHES_WIDE = 0
LAUNCHES_SKIP = 0


# ---------------------------------------------------------------------------
# host-side build: SAH tree -> treelet clusters
# ---------------------------------------------------------------------------

def cut_clusters(built: dict, node_start, max_k=CLUSTER_K):
    """Greedy treelet cut: maximal subtrees with <= max_k prims become
    clusters (contiguous ranges of the build permutation). Also emits the
    SAH tree's restriction to the cut (internal nodes are the cut nodes'
    ancestors, leaves are the clusters in preorder), threaded with skip
    links.

    Returns (ranges, tree) where tree = dict(lo (M,3), hi (M,3),
    cid (M,) int32 cluster id or -1, skip (M,) int32, right, order)."""
    node_count = built["node_count"]
    node_min = built["node_min"]
    node_max = built["node_max"]
    node_skip = built["node_skip"]
    N = node_count.shape[0]
    node_right = built.get("node_right")
    if node_right is None:
        # preorder invariant: left child = i+1, skip(left) = right sibling
        node_right = np.full(N, -1, np.int32)
        inner_n = np.nonzero(node_count == 0)[0]
        node_right[inner_n] = node_skip[np.minimum(inner_n + 1, N - 1)]
    # subtree prim ranges: node n's subtree is the preorder block
    # [n, skip[n]) and SAH splits keep prim ranges contiguous
    leaf_pos = np.nonzero(node_count > 0)[0]
    leaf_start = node_start[leaf_pos].astype(np.int64)
    leaf_end = leaf_start + node_count[leaf_pos]
    first_leaf = np.searchsorted(leaf_pos, np.arange(N))
    last_leaf = np.searchsorted(leaf_pos, node_skip) - 1
    lo = leaf_start[np.minimum(first_leaf, len(leaf_pos) - 1)]
    hi = leaf_end[np.clip(last_leaf, 0, len(leaf_pos) - 1)]

    ranges = []
    t_min, t_max, t_cid, t_right = [], [], [], []
    stack = [(0, -1, False)]           # (orig node, parent new idx, is_right)
    while stack:
        n, parent, is_right = stack.pop()
        idx = len(t_min)
        if parent >= 0 and is_right:
            t_right[parent] = idx
        t_min.append(node_min[n])
        t_max.append(node_max[n])
        t_right.append(-1)
        if hi[n] - lo[n] <= max_k or node_count[n] > 0:
            t_cid.append(len(ranges))
            ranges.append((int(lo[n]), int(hi[n])))
        else:
            t_cid.append(-1)
            stack.append((int(node_right[n]), idx, True))
            stack.append((n + 1, idx, False))

    M = len(t_min)
    # preorder skip links: skip(root)=M, skip(left)=right sibling,
    # skip(right)=skip(parent); for a leaf skip == idx+1
    t_skip = np.full(M, M, np.int32)
    st2 = [(0, M)]
    while st2:
        i, s = st2.pop()
        t_skip[i] = s
        if t_cid[i] < 0:
            r = t_right[i]
            st2.append((i + 1, r))
            st2.append((r, s))
    lo_a = np.stack(t_min).astype(np.float32)
    hi_a = np.stack(t_max).astype(np.float32)
    right = np.asarray(t_right, np.int32)
    # per-node, per-direction-octant child order (for near-first stack
    # walks): order bit o set => visit the right child first for octant o
    order = np.zeros(M, np.int32)
    inner = right >= 0
    if inner.any():
        li = np.minimum(np.arange(M) + 1, M - 1)   # left child = n+1
        ri = np.maximum(right, 0)
        cl = (lo_a[li] + hi_a[li]) * 0.5
        cr = (lo_a[ri] + hi_a[ri]) * 0.5
        sep = np.abs(cr - cl)
        axis = np.argmax(sep, axis=1)
        r_lower = np.take_along_axis(cr, axis[:, None], 1)[:, 0] < \
            np.take_along_axis(cl, axis[:, None], 1)[:, 0]
        for o in range(8):
            neg = (o >> axis) & 1            # octant sign on split axis
            right_first = np.where(neg.astype(bool), ~r_lower, r_lower)
            order |= np.where(inner, right_first.astype(np.int32) << o, 0)
    tree = dict(lo=lo_a, hi=hi_a, cid=np.asarray(t_cid, np.int32),
                skip=t_skip, right=right, order=order)
    return ranges, tree


def build_wide_tree(tree, fan=FAN):
    """Collapse the binary cluster tree into a ``fan``-ary one: each wide
    node's children are the frontier obtained by repeatedly expanding the
    largest binary inner entry until every entry is a cluster or the
    frontier holds ``fan`` entries.

    Returns dict(boxes (W, fan, 6) f32, refs (W, fan) i32, depth,
    max_stack). refs: >= 0 -> wide node id; < 0 -> cluster id encoded as
    -(cid+1); empty slots hold ref EMPTY and the box lo=+inf, hi=-inf
    (which passes the slab test: walks gate empty slots on the ref)."""
    cid = tree["cid"]
    right = tree["right"]
    lo, hi = tree["lo"], tree["hi"]
    skip = tree["skip"]

    id_of = {}
    roots = []              # binary node backing each wide node

    def make(b):
        if b not in id_of:
            id_of[b] = len(roots)
            roots.append(b)
        return id_of[b]

    make(0)
    boxes, refs = [], []
    w = 0
    while w < len(roots):
        b = roots[w]
        frontier = [b]
        while len(frontier) < fan:
            inner = [(int(skip[n]) - n, i) for i, n in enumerate(frontier)
                     if cid[n] < 0]
            if not inner:
                break
            _, i = max(inner)
            n = frontier[i]
            frontier[i: i + 1] = [n + 1, int(right[n])]
        nb = np.zeros((fan, 6), np.float32)
        nb[:, 0:3] = np.inf
        nb[:, 3:6] = -np.inf
        nr = np.full((fan,), EMPTY, np.int32)
        for i, n in enumerate(frontier):
            nb[i, 0:3] = lo[n]
            nb[i, 3:6] = hi[n]
            nr[i] = -(int(cid[n]) + 1) if cid[n] >= 0 else make(n)
        boxes.append(nb)
        refs.append(nr)
        w += 1

    boxes = np.stack(boxes)
    refs = np.stack(refs)
    # max stack depth of the wide DFS: along any root->leaf path each
    # pushed level adds at most fan-1 siblings plus the descent
    W = len(roots)
    depth = np.ones(W, np.int32)
    for w in range(W - 1, -1, -1):
        d = 1
        for r in refs[w]:
            if 0 <= r < EMPTY:
                d = max(d, 1 + depth[r])
        depth[w] = d
    max_stack = int(depth[0]) * fan + fan
    return dict(boxes=boxes, refs=refs, depth=int(depth[0]),
                max_stack=max_stack)


class ClusterData:
    """Packed cluster tables (host numpy).

    ``builder``: "auto" = the native C++ binned-SAH builder (no fallback:
    it raises if it cannot be built), "device" = the sweep SAH level by
    level on the scene's device (geometry/device_build.py: kernel X3 on
    the card), "numpy" = the oracle builder. The tables are
    byte-identical to vimg_tpu's ClusterData for the same builder (for
    "device", vimg_tpu's build computed as written, without fused
    multiply-adds). vimg_tpu's ``with_attrs`` table (vertex normals for
    the mesh megakernel) comes with kernel B2."""

    def __init__(self, scene: ir.Scene, max_k=CLUSTER_K, builder="auto"):
        verts = scene.verts.cpu().numpy()
        tvidx = scene.tri_vidx.cpu().numpy()
        T = tvidx.shape[0]
        p = verts[tvidx]
        bmin = p.min(axis=1)
        bmax = p.max(axis=1)
        centers = p.mean(axis=1)
        if builder == "numpy":
            built = build_bvh_numpy(bmin, bmax, centers)
        elif builder == "auto":
            from vimg_tpu_torch.runtime.native import build_bvh_native
            built = build_bvh_native(bmin, bmax, centers, mode=0)
        elif builder == "device":
            from vimg_tpu_torch.geometry.device_build import \
                build_sweep_sah_device
            built = build_sweep_sah_device(bmin, bmax, centers,
                                           device=scene.device)
        else:
            raise ValueError(f"unknown builder {builder!r} "
                             f"(auto | device | numpy)")
        if "node_right" not in built:
            # preorder invariant: left child = i+1, skip(left) = right
            count = built["node_count"]
            skip = built["node_skip"]
            N = count.shape[0]
            node_right = np.full(N, -1, np.int32)
            inner = np.nonzero(count == 0)[0]
            node_right[inner] = skip[np.minimum(inner + 1, N - 1)]
            built["node_right"] = node_right
        order = built["order"]
        ranges, tree = cut_clusters(built, built["node_start"], max_k)

        C = len(ranges)
        # spare float slots (12..15 of each 16-wide tri row): slot 12 =
        # material id of tri k; tris 2s, 2s+1, slots 13..15 = the AABB lo /
        # hi of the 16-tri sub-block s
        n_sub = max(max_k // 16, 1)
        # hit codes (c*max_k + k) rode the TPU kernels as f32: above 2^24
        # they stop being exact, so vimg_tpu refuses such meshes; the port
        # keeps the same limit so both accept the same scenes
        if C * max_k > (1 << 24):
            raise ValueError(
                f"mesh too large for the f32 hit-code space: "
                f"{C} clusters x {max_k} slots > 2^24 "
                f"({T} tris: shard the mesh)")
        consts = tri_constants(verts, tvidx)
        tri_mat = (scene.tri_mat.cpu().numpy().astype(np.float32)
                   if T else np.zeros(T, np.float32))
        starts = np.asarray([s for s, _ in ranges], np.int64)
        ends = np.asarray([e for _, e in ranges], np.int64)
        lens = ends - starts
        kk = np.arange(max_k)
        valid = kk[None, :] < lens[:, None]                       # (C, K)
        ids = order[np.minimum(starts[:, None] + kk[None, :],
                               ends[:, None] - 1)]                # (C, K)
        tri_rows = np.zeros((C, max_k, ROW16), np.float32)
        tri_rows[:, :, :12] = np.where(valid[..., None], consts[ids], 0.0)
        tri_rows[:, :, 12] = np.where(valid, tri_mat[ids], 0.0)
        perm = np.where(valid, ids, 0).astype(np.int32).reshape(-1)

        def sub_boxes(width):
            g = max_k // width
            idsr = ids[:, :g * width].reshape(C, g, width)
            mr = valid[:, :g * width].reshape(C, g, width)[..., None]
            lo = np.where(mr, bmin[idsr], np.inf).min(axis=2)
            hi = np.where(mr, bmax[idsr], -np.inf).max(axis=2)
            return lo.astype(np.float32), hi.astype(np.float32)

        lo16, hi16 = sub_boxes(16)
        tri_rows[:, 0:2 * n_sub:2, 13:16] = lo16
        tri_rows[:, 1:2 * n_sub:2, 13:16] = hi16
        # vimg_tpu also packs 8-tri sub-boxes in the next spare slots; kept
        # so the tables stay byte-identical (the walks here gate on 16)
        n_sub8 = max(max_k // 8, 1)
        if 2 * n_sub + 2 * n_sub8 <= max_k:
            lo8, hi8 = sub_boxes(8)
            tri_rows[:, 2 * n_sub: 2 * n_sub + 2 * n_sub8: 2, 13:16] = lo8
            tri_rows[:, 2 * n_sub + 1: 2 * n_sub + 2 * n_sub8: 2,
                     13:16] = hi8
        self.n_clusters = C
        self.max_k = max_k
        # (C * max_k*16/128, 128), row-major within each cluster: flat
        # index c*max_k*16 + k*16 + j
        self.tri_rows = tri_rows.reshape(C * (max_k * ROW16 // 128), 128)
        self.perm = perm
        self.cl_len = lens.astype(np.int32)     # valid tris per cluster
        self.n_tris = T

        # binary cluster-tree tables, packed as vimg_tpu packs them: 16
        # node AABBs (8 f32 each) per 128-wide row, 128 node ints per row
        M = tree["cid"].shape[0]
        self.n_nodes = M
        self.scene_lo = tree["lo"][0].copy()
        self.scene_hi = tree["hi"][0].copy()
        M16 = -(-M // 16) * 16
        ab = np.zeros((M16, 8), np.float32)
        ab[:M, 0:3] = tree["lo"]
        ab[:M, 3:6] = tree["hi"]
        self.node_aabbs = ab.reshape(M16 // 16, 128)
        M128 = -(-M // 128) * 128
        cid = np.full((M128,), 0, np.int32)
        cid[:M] = tree["cid"]
        skip = np.full((M128,), M, np.int32)
        skip[:M] = tree["skip"]
        self.node_cid = cid.reshape(-1, 128)
        self.node_skip = skip.reshape(-1, 128)
        right = np.full((M128,), -1, np.int32)
        right[:M] = tree["right"]
        order = np.zeros((M128,), np.int32)
        order[:M] = tree["order"]
        self.node_right = right.reshape(-1, 128)
        self.node_order = order.reshape(-1, 128)
        # root->leaf path length of the binary tree
        st3 = [(0, 1)]
        maxd = 1
        while st3:
            i, d = st3.pop()
            maxd = max(maxd, d)
            if tree["cid"][i] < 0:
                st3.append((i + 1, d + 1))
                st3.append((int(tree["right"][i]), d + 1))
        self.tree_depth = maxd
        self._tree = tree
        self._wide = None

    def wide_tables(self, fan=FAN):
        """Tables of the wide walk (built lazily): boxes: child c of wide
        node w at flat [w*64 + c*8 + j] (6 of 8 slots used); refs: flat
        [w*8 + c]; cl_boxes: cluster cid's box at flat [cid*8 + j]."""
        if self._wide is None:
            wt = build_wide_tree(self._tree, fan)
            W = wt["boxes"].shape[0]
            arr = np.zeros((W, fan, 8), np.float32)
            arr[:, :, :6] = wt["boxes"]
            arr = arr.reshape(W, fan * 8)
            W2 = -(-W // 2) * 2
            wb = np.zeros((W2, 64), np.float32)
            wb[:W] = arr
            wb = wb.reshape(W2 // 2, 128)
            W16 = -(-W // 16) * 16
            rr = np.full((W16, fan), EMPTY, np.int32)
            rr[:W] = wt["refs"]
            rr = rr.reshape(W16 // 16, 128)
            tree = self._tree
            C = self.n_clusters
            cb = np.zeros((-(-C // 16) * 16, 8), np.float32)
            leaf = tree["cid"] >= 0
            cb[tree["cid"][leaf], 0:3] = tree["lo"][leaf]
            cb[tree["cid"][leaf], 3:6] = tree["hi"][leaf]
            self._wide = dict(boxes=wb, refs=rr,
                              cl_boxes=cb.reshape(-1, 128),
                              n_wide=W, max_stack=wt["max_stack"])
        return self._wide


# ---------------------------------------------------------------------------
# plain walks: per-ray walks vectorised over rays (the kernels' plain
# versions)
# ---------------------------------------------------------------------------

def _inv_dir(rd):
    return 1.0 / torch.where(rd == 0.0, 1e-30, rd)


def _slab(lo, hi, o, inv, minT, bt):
    """Slab test over [minT, bt] with NaN-propagating min/max (the
    kernels' jmin/jmax, JAX's minimum/maximum). lo, hi, o, inv: (..., 3)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    a = torch.minimum(t0, t1)
    b = torch.maximum(t0, t1)
    tin = torch.maximum(torch.maximum(a[..., 0], a[..., 1]),
                        torch.maximum(a[..., 2], minT))
    tout = torch.minimum(torch.minimum(b[..., 0], b[..., 1]),
                         torch.minimum(b[..., 2], bt))
    return tin <= tout


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _leaf_tests(tri, i, c, ro, rd, inv, minT, st, any_hit, stats):
    """The 64-triangle leaf of cluster ``c`` for the rays ``i`` (already
    live against the cluster box at their current t). Updates the walk
    state ``st`` = (t, slot, u, v) in place."""
    t_all, slot, u_all, v_all = st
    rows = tri.view(-1, CLUSTER_K, ROW16)[c]                 # (R, 64, 16)
    o, d, iv = ro[i], rd[i], inv[i]
    mt, be = minT[i], t_all[i]                               # entry t
    gate = _slab(rows[:, 0:2 * N_SUB:2, 13:16], rows[:, 1:2 * N_SUB:2, 13:16],
                 o[:, None], iv[:, None], mt[:, None], be[:, None])
    _count(stats, "box_tests", gate.numel())
    _count(stats, "tri_tests", SUB * int(gate.sum()))
    gate = gate.repeat_interleave(SUB, dim=1)                # (R, 64)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    nx, ny, nz, d0 = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    m1x, m1y, m1z, c1 = rows[..., 4], rows[..., 5], rows[..., 6], rows[..., 7]
    m2x, m2y, m2z, c2 = rows[..., 8], rows[..., 9], rows[..., 10], rows[..., 11]
    ro_n = ox * nx + oy * ny + oz * nz
    rd_n = dx * nx + dy * ny + dz * nz
    par = rd_n.abs() < 1e-22
    t = (d0 - ro_n) / torch.where(par, 1.0, rd_n)
    u = (ox * m1x + oy * m1y + oz * m1z - c1
         + t * (dx * m1x + dy * m1y + dz * m1z))
    v = (ox * m2x + oy * m2y + oz * m2z - c2
         + t * (dx * m2x + dy * m2y + dz * m2z))
    # a sequential strict-< scan keeps the first candidate of least t
    hit = (~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mt[:, None]) & (t < be[:, None]) & gate)
    found = hit.any(dim=1)
    if any_hit:
        t_all[i[found]] = -float("inf")
        return
    tm = torch.where(hit, t, float("inf"))
    best = tm.amin(dim=1, keepdim=True)
    k = (hit & (tm == best)).to(torch.uint8).argmax(dim=1, keepdim=True)
    j = i[found]
    t_all[j] = t.gather(1, k)[found, 0]
    slot[j] = (c[:, None] * CLUSTER_K + k)[found, 0].to(torch.int32)
    u_all[j] = u.gather(1, k)[found, 0]
    v_all[j] = v.gather(1, k)[found, 0]


def _walk_start(ro, rd, minT, maxT, any_hit):
    """Walk state (t, slot, u, v), the inverse directions and the rays that
    walk at all. A ray with maxT = -inf keeps no node live (tin >= minT >
    -inf), so it leaves at once; an any-hit ray also leaves once its t is
    -inf."""
    st = (maxT.clone(), torch.full(maxT.shape, -1, dtype=torch.int32,
                                   device=maxT.device),
          torch.zeros_like(maxT), torch.zeros_like(maxT))
    ninf = -float("inf")
    go = (maxT != ninf) if any_hit else ~((maxT == ninf) & (minT != ninf))
    return st, _inv_dir(rd), torch.nonzero(go)[:, 0]


def skip_walk_plain(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT,
                    any_hit, stats=None):
    """Plain version of kernel B4: the stackless skip-link walk of the
    binary cluster tree (``n = live ? n + 1 : skip[n]``), per ray.
    Tables are the flat ClusterData arrays. Returns (t, slot, u, v): t the
    best hit t (maxT when none; -inf for an any-hit), slot = c*64 + k of
    the hit triangle or -1, (u, v) its raw barycentrics. ``stats`` counts
    box_tests and tri_tests."""
    st, inv, act = _walk_start(ro, rd, minT, maxT, any_hit)
    t = st[0]
    node = torch.zeros(ro.shape[0], dtype=torch.int64, device=ro.device)
    box = aabbs.view(-1, 8)
    while act.numel():
        n = node[act]
        b = box[n]
        live = _slab(b[:, 0:3], b[:, 3:6], ro[act], inv[act], minT[act],
                     t[act])
        _count(stats, "box_tests", act.numel())
        c = cid[n].to(torch.int64)
        leaf = live & (c >= 0)
        if bool(leaf.any()):
            _leaf_tests(tri, act[leaf], c[leaf], ro, rd, inv, minT, st,
                        any_hit, stats)
        nxt = torch.where(live, n + 1, skip[n].to(torch.int64))
        node[act] = nxt
        keep = nxt < n_nodes
        if any_hit:
            keep &= t[act] != -float("inf")
        act = act[keep]
    return st


def wide_walk_plain(boxes, refs, cl_boxes, tri, max_stack, ro, rd, minT,
                    maxT, any_hit, stats=None):
    """Plain version of kernel B3: the 8-ary stack walk, per ray. Pop a
    ref; a cluster is tested against its box at the ray's current t and
    then leaf-tested; a wide node slab-tests its children and pushes the
    live non-empty ones in reverse, so child 0 is popped first. Same
    returns and ``stats`` as skip_walk_plain."""
    st, inv, act = _walk_start(ro, rd, minT, maxT, any_hit)
    t = st[0]
    N, dev = ro.shape[0], ro.device
    stack = torch.zeros((N, max_stack), dtype=torch.int64, device=dev)
    sp = torch.ones(N, dtype=torch.int64, device=dev)
    wbox = boxes.view(-1, FAN, 8)
    wref = refs.view(-1, FAN).to(torch.int64)
    cbox = cl_boxes.view(-1, 8)
    while act.numel():
        sp[act] -= 1
        top = stack[act, sp[act]]
        is_cl = top < 0
        if bool(is_cl.any()):
            i = act[is_cl]
            c = -top[is_cl] - 1
            b = cbox[c]
            live = _slab(b[:, 0:3], b[:, 3:6], ro[i], inv[i], minT[i], t[i])
            _count(stats, "box_tests", i.numel())
            if bool(live.any()):
                _leaf_tests(tri, i[live], c[live], ro, rd, inv, minT, st,
                            any_hit, stats)
        if not bool(is_cl.all()):
            i = act[~is_cl]
            w = top[~is_cl]
            b = wbox[w]                                       # (R, 8, 8)
            r = wref[w]                                       # (R, 8)
            filled = r != EMPTY
            live = _slab(b[..., 0:3], b[..., 3:6], ro[i][:, None],
                         inv[i][:, None], minT[i][:, None],
                         t[i][:, None]) & filled
            _count(stats, "box_tests", int(filled.sum()))
            # child ci lands above every live child of higher index
            li = live.to(torch.int64)
            above = li.flip(1).cumsum(1).flip(1) - li
            pos = sp[i][:, None] + above
            rr, cc = torch.nonzero(live, as_tuple=True)
            stack[i[rr], pos[rr, cc]] = r[rr, cc]
            sp[i] += li.sum(1)
        keep = sp[act] > 0
        if any_hit:
            keep &= t[act] != -float("inf")
        act = act[keep]
    return st


# ---------------------------------------------------------------------------
# kernel wrappers (B3, B4)
# ---------------------------------------------------------------------------

def _check(x, name, dtype, shape, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _launch(fn_name, tables, tab_specs, n_nodes, ro, rd, minT, maxT,
            any_hit, extra=()):
    """Shared body of the two wrappers: check, allocate, launch on the
    current stream (``extra`` pointers go before it), raise on a CUDA
    error."""
    from vimg_tpu_torch.runtime.cuda import check, load_library
    dev = ro.device
    N = ro.shape[0]
    for x, (name, dtype, numel) in zip(tables, tab_specs):
        _check(x, name, dtype, (numel,), dev)
    _check(ro, "ro", torch.float32, (N, 3), dev)
    _check(rd, "rd", torch.float32, (N, 3), dev)
    _check(minT, "minT", torch.float32, (N,), dev)
    _check(maxT, "maxT", torch.float32, (N,), dev)
    t = torch.empty((N,), dtype=torch.float32, device=dev)
    slot = torch.empty((N,), dtype=torch.int32, device=dev)
    u = torch.empty((N,), dtype=torch.float32, device=dev)
    v = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return (t, slot, u, v), False
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            *(x.data_ptr() for x in tables), ro.data_ptr(), rd.data_ptr(),
            minT.data_ptr(), maxT.data_ptr(), N, n_nodes, int(any_hit),
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            *extra, stream)
    check(rc, fn_name)
    return (t, slot, u, v), True


def _device_of(ro):
    dev = ro.device
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no mesh walk for device {dev}")
    return dev


def trace_wide(boxes, refs, cl_boxes, tri, n_wide, max_stack, ro, rd, minT,
               maxT, any_hit, steps=None, warp_steps=None):
    """Kernel B3 (CUDA tensors) or wide_walk_plain (CPU tensors).

    Replaces vimg_tpu/geometry/cluster_trace.py::_make_wide_kernel, the
    TPU tile walk with an SMEM stack. Here a lane walks its ray's 8-ary
    nodes with a local-memory stack of at most WIDE_MAX_STACK refs and
    posts each live cluster; the warp runs its lanes' posted clusters
    together, 32 triangles a step (``csrc/cluster_walk.cuh``,
    ``leaf_round``, B4's leaf). Every table stays in global memory and is
    read 16 bytes at a time, so each must start 16-byte aligned (a
    misaligned view raises). What bounds it on this card: latency of
    dependent table loads and warp divergence (rays of a warp visit
    different nodes), not bytes or flops; the Morton ray sort in
    ClusterTracer keeps warps coherent. ``steps``, a (2,) int64 CUDA
    tensor, gets the warp node steps (pops) and warp triangle steps added
    to it (``skip_schedule.wide_warp_schedule`` replays the same counts);
    ``warp_steps``, an (n_warps, 2) int64 CUDA tensor (n_warps =
    ceil(N / 32)), gets each warp's two counts written into its row.
    Either counter selects the counted kernel; without both the uncounted
    one runs. The totals are the rows' column sums; both are kept as
    csrc/cluster_trace.cu's launch contract says."""
    global LAUNCHES_WIDE
    if _device_of(ro).type == "cpu":
        return wide_walk_plain(boxes, refs, cl_boxes, tri, max_stack, ro, rd,
                               minT, maxT, any_hit)
    if max_stack > WIDE_MAX_STACK:
        raise ValueError(f"wide tree needs a stack of {max_stack} > the "
                         f"kernel's {WIDE_MAX_STACK}")
    specs = (("boxes", torch.float32, boxes.numel()),
             ("refs", torch.int32, refs.numel()),
             ("cl_boxes", torch.float32, cl_boxes.numel()),
             ("tri", torch.float32, tri.numel()))
    if boxes.numel() < 64 * n_wide or refs.numel() < FAN * n_wide:
        raise ValueError(f"wide tables smaller than {n_wide} wide nodes")
    for x, name in ((boxes, "boxes"), (refs, "refs"), (cl_boxes, "cl_boxes"),
                    (tri, "tri")):
        _check_aligned(x, name, "B3")
    out, launched = _launch("vimg_cluster_wide", (boxes, refs, cl_boxes, tri),
                            specs, n_wide, ro, rd, minT, maxT, any_hit,
                            _steps_arg(steps, warp_steps, ro))
    LAUNCHES_WIDE += launched
    return out


def _check_aligned(x, name, kernel):
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: kernel {kernel} reads 16-byte rows, the "
                         f"tensor must start 16-byte aligned")


def _steps_arg(steps, warp_steps, ro):
    """The launcher's two counter pointers: a checked (2,) int64 tensor or
    null, and a checked (ceil(N / 32), 2) int64 tensor or null."""
    if steps is not None:
        _check(steps, "steps", torch.int64, (2,), ro.device)
    if warp_steps is not None:
        _check(warp_steps, "warp_steps", torch.int64,
               (-(-ro.shape[0] // 32), 2), ro.device)
    return tuple(None if x is None else x.data_ptr()
                 for x in (steps, warp_steps))


def trace_skip(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT, any_hit,
               steps=None, warp_steps=None):
    """Kernel B4 (CUDA tensors) or skip_walk_plain (CPU tensors).

    Replaces vimg_tpu/geometry/cluster_trace.py::_make_trace_kernel, the
    TPU tile walk of the skip-linked binary tree (with per-leaf DMA
    streaming for tables above VMEM). Here a lane walks its ray's nodes
    stacklessly and the warp runs its lanes' leaves together, 32
    triangles a step (``csrc/cluster_walk.cuh``, ``warp_skip_walk``);
    every table stays in global memory, where the 50 MB L2 holds the node
    tables and the hot triangle blocks. The node boxes and triangle rows
    are read 16 bytes at a time, so ``aabbs`` and ``tri`` must start
    16-byte aligned (a misaligned view raises). ``steps``, a (2,) int64
    CUDA tensor, gets the warp node steps and warp triangle steps added to
    it (the lane fill is the plain walk's tri_tests / (32 x triangle
    steps); ``skip_schedule.warp_schedule`` replays the same counts);
    ``warp_steps`` as trace_wide's."""
    global LAUNCHES_SKIP
    if _device_of(ro).type == "cpu":
        return skip_walk_plain(aabbs, cid, skip, tri, n_nodes, ro, rd, minT,
                               maxT, any_hit)
    specs = (("aabbs", torch.float32, aabbs.numel()),
             ("cid", torch.int32, cid.numel()),
             ("skip", torch.int32, skip.numel()),
             ("tri", torch.float32, tri.numel()))
    if aabbs.numel() < 8 * n_nodes or cid.numel() < n_nodes:
        raise ValueError(f"node tables smaller than {n_nodes} nodes")
    for x, name in ((aabbs, "aabbs"), (tri, "tri")):
        _check_aligned(x, name, "B4")
    out, launched = _launch("vimg_cluster_skip", (aabbs, cid, skip, tri),
                            specs, n_nodes, ro, rd, minT, maxT, any_hit,
                            _steps_arg(steps, warp_steps, ro))
    LAUNCHES_SKIP += launched
    return out


# ---------------------------------------------------------------------------
# ray sort key
# ---------------------------------------------------------------------------

def _spread3(x):
    """Insert two zero bits between the low 10 bits of x (Morton spread)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton3(qx, qy, qz):
    return (_spread3(qx) << 2) | (_spread3(qy) << 1) | _spread3(qz)


def ray_sort_key(ro, rd, lo, hi, mode="origin"):
    """Coherence key for ray re-binning (int32 interleaved Morton codes).

    mode="origin": origin-major (5 bits/axis), direction-minor (2
    bits/axis octant); mode="dir": direction-major (6 bits/axis),
    origin-minor (4 bits/axis)."""
    ext = torch.clamp_min(hi - lo, 1e-6)
    if mode == "dir":
        qd = torch.clip((rd + 1.0) * 32.0, 0.0, 63.0).to(torch.int32)
        qo = torch.clip((ro - lo) / ext * 16.0, 0.0, 15.0).to(torch.int32)
        kd = _morton3(qd[:, 0], qd[:, 1], qd[:, 2])      # 18 bits
        ko = _morton3(qo[:, 0], qo[:, 1], qo[:, 2])      # 12 bits
        return (kd << 12) | ko
    qo = torch.clip((ro - lo) / ext * 32.0, 0.0, 31.0).to(torch.int32)
    qd = torch.clip((rd + 1.0) * 2.0, 0.0, 3.0).to(torch.int32)
    ko = _morton3(qo[:, 0], qo[:, 1], qo[:, 2])          # 15 bits
    kd = _morton3(qd[:, 0], qd[:, 1], qd[:, 2])          # 6 bits
    return (ko << 6) | kd


# ---------------------------------------------------------------------------
# tracer facade
# ---------------------------------------------------------------------------

class ClusterTracer:
    """Mesh tracer: cluster-tree walks for the triangles (kernel B3 or B4
    on CUDA, their plain versions on the CPU) plus a dense test of the
    scene's spheres, merged by least t.

    ``walk``: "wide" (B3), "skip" (B4) or "auto" = wide up to
    WIDE_MAX_CLUSTERS clusters. ``sort_rays=False`` skips the Morton sort
    (hits do not depend on it); ``sort_mode`` is its key's (``ray_sort_key``:
    "origin" or "dir"). ``plain=True`` runs the plain walks on any
    device (the kernels' reference on the card). ``builder`` picks
    ClusterData's tree builder (auto | device | numpy, vimg_tpu's
    keyword); ``data`` reuses the ClusterData of another tracer of the
    same scene instead. vimg_tpu's TPU scheduling options
    (tile_rows, mode, group_gate, walks, wide_batch, probe_leaf,
    sub_width) are not ported: its tests show they do not change hits.
    """

    # traversal inputs are detached (zero-tangent semantics, as vimg_tpu's
    # stop_gradient): gradients never flow through the walk
    differentiable = True
    # closest / occluded take ``sort``: the wavefront's primary pre-pass
    # hands over coherent batches with sort=False
    presortable = True

    def __init__(self, scene: ir.Scene, walk="auto", sort_rays=True,
                 plain=False, data=None, builder="auto",
                 sort_mode="origin"):
        dev = scene.device
        if dev.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"no cluster walk for device {dev}")
        self.data = data or ClusterData(scene, CLUSTER_K, builder=builder)
        if walk == "auto":
            walk = ("wide" if self.data.n_clusters <= WIDE_MAX_CLUSTERS
                    else "skip")
        if walk not in ("wide", "skip"):
            raise ValueError(f"unknown walk {walk!r} (wide | skip | auto)")
        self.walk = walk
        self.plain = plain
        self.sort_rays = sort_rays
        self.sort_mode = sort_mode

        def flat(a):
            return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(dev)

        self.tri_rows = flat(self.data.tri_rows)
        if walk == "wide":
            wt = self.data.wide_tables()
            self.n_wide = wt["n_wide"]
            self.max_stack = wt["max_stack"]
            self.node_tables = (flat(wt["boxes"]), flat(wt["refs"]),
                                flat(wt["cl_boxes"]))
        else:
            self.node_tables = (flat(self.data.node_aabbs),
                                flat(self.data.node_cid),
                                flat(self.data.node_skip))
        self.bounds = (torch.from_numpy(self.data.scene_lo).to(dev),
                       torch.from_numpy(self.data.scene_hi).to(dev))
        self.perm = torch.from_numpy(self.data.perm.astype(np.int64)).to(dev)
        _, self.sph_c = build_constants(scene)

    def sort_order(self, ro, rd, maxT):
        """The Morton permutation of the rays; idle lanes (maxT = -inf)
        go to the tail."""
        key = ray_sort_key(ro, rd, *self.bounds, mode=self.sort_mode)
        key = torch.where(maxT == -float("inf"), 2 ** 31 - 1, key)
        return torch.argsort(key, stable=True)

    def _walk_rays(self, ro, rd, minT, maxT, sort):
        """The rays as the walk takes them: contiguous, minT and maxT one
        a ray, in Morton order above SORT_MIN_RAYS unless ``sort`` or else
        ``sort_rays`` is false. Returns (rays, order or None)."""
        B = ro.shape[0]
        ro, rd = ro.contiguous(), rd.contiguous()
        minT = minT.expand(B).contiguous()
        maxT = maxT.expand(B).contiguous()
        do_sort = (self.sort_rays if sort is None else sort) \
            and B > SORT_MIN_RAYS
        if not do_sort:
            return (ro, rd, minT, maxT), None
        order = self.sort_order(ro, rd, maxT)
        return (ro[order], rd[order], minT[order], maxT[order]), order

    def trace(self, ro, rd, minT, maxT, any_hit, sort=None):
        """(t, slot, u, v) of the configured walk on the given rays, in
        their order (the Morton sort above SORT_MIN_RAYS, on unless
        ``sort`` or else ``sort_rays`` is false, is undone)."""
        (ro, rd, minT, maxT), order = self._walk_rays(ro, rd, minT, maxT,
                                                      sort)
        do_sort = order is not None
        rays = (ro, rd, minT, maxT, any_hit)
        if self.walk == "wide" and self.plain:
            out = wide_walk_plain(*self.node_tables, self.tri_rows,
                                  self.max_stack, *rays)
        elif self.walk == "wide":
            out = trace_wide(*self.node_tables, self.tri_rows, self.n_wide,
                             self.max_stack, *rays)
        elif self.plain:
            out = skip_walk_plain(*self.node_tables, self.tri_rows,
                                  self.data.n_nodes, *rays)
        else:
            out = trace_skip(*self.node_tables, self.tri_rows,
                             self.data.n_nodes, *rays)
        if do_sort:
            def unsort(x):
                y = torch.empty_like(x)
                y[order] = x
                return y
            out = tuple(unsort(x) for x in out)
        return out

    def trace_stats(self, ro, rd, minT, maxT, any_hit=False):
        """Per-warp work of the walk on a ray batch: a numpy (n_warps, 2)
        float32 array, row w = (node steps, triangle steps) of warp w, the
        32 rays w*32 .. w*32 + 31 in the tracer's ray order (Morton-sorted
        as ``trace`` sorts them; a ragged last warp has fewer rays).

        vimg_tpu's ``trace_stats`` returns (node visits, live leaf visits)
        per ray tile of tile_rows x 128 rays, counts that depend on its TPU
        tiling. Here a group is a warp, the unit that walks together on
        the card, and its counts are the warp steps that kernels B3 and B4
        count: a node step is the most nodes any lane tested in a round's
        node phase (summed over rounds), a triangle step runs two gated
        16-triangle units of the warp's live leaves (ROADMAP C27). On the
        card they come from a counted launch of the walk (its
        ``warp_steps`` counter); on the CPU, or with ``plain=True``, from
        the replay of the warp's schedule (skip_schedule.warp_schedule /
        wide_warp_schedule), which equals it."""
        from vimg_tpu_torch.geometry import skip_schedule as ss
        ro, rd, minT, maxT = detached_rays(ro, rd, minT, maxT)
        rays, _ = self._walk_rays(ro, rd, minT, maxT, None)
        ro = rays[0]
        if ro.device.type == "cpu" or self.plain:
            if self.walk == "wide":
                _, c = ss.wide_warp_schedule(*self.node_tables,
                                             self.tri_rows, self.max_stack,
                                             *rays, any_hit)
            else:
                _, c = ss.warp_schedule(*self.node_tables, self.tri_rows,
                                        self.data.n_nodes, *rays, any_hit)
            per = c["warp_steps"]
        else:
            per = torch.zeros((-(-ro.shape[0] // 32), 2), dtype=torch.int64,
                              device=ro.device)
            if self.walk == "wide":
                trace_wide(*self.node_tables, self.tri_rows, self.n_wide,
                           self.max_stack, *rays, any_hit, warp_steps=per)
            else:
                trace_skip(*self.node_tables, self.tri_rows,
                           self.data.n_nodes, *rays, any_hit,
                           warp_steps=per)
        return per.cpu().numpy().astype(np.float32)

    # Gradients: the rays reach the walk detached (vimg_tpu's zero-tangent
    # traversal, the detached-sampling estimator's treatment of discrete
    # traversal), on the card and on the CPU alike, so no kernel needs a
    # backward; material, emission, texture and env gradients equal the
    # tensor-code tracers', and the hit point's motion with t is dropped.
    def closest(self, scene, ro, rd, minT, maxT, sort=None) -> HitResult:
        ro, rd, minT, maxT = detached_rays(ro, rd, minT, maxT)
        kw = {} if sort is None else dict(sort=sort)
        bt, slot, bu, bv = self.trace(ro, rd, minT, maxT, False, **kw)
        found = slot >= 0
        tri_id = self.perm[slot.clamp(0, self.perm.shape[0] - 1).long()]
        zero = torch.zeros_like(bt)
        hr = HitResult(
            t=torch.where(found, bt, float("inf")),
            prim_type=torch.full(bt.shape, ir.PRIM_TRI, dtype=torch.int64,
                                 device=bt.device),
            prim_id=torch.where(found, tri_id, 0),
            u=torch.where(found, 1.0 - bu - bv, zero),
            v=torch.where(found, bu, zero))
        if self.sph_c is not None:
            hr = merge_spheres(self.sph_c, hr, ro, rd, minT, maxT)
        return hr

    def occluded(self, scene, ro, rd, minT, maxT, sort=None):
        ro, rd, minT, maxT = detached_rays(ro, rd, minT, maxT)
        kw = {} if sort is None else dict(sort=sort)
        bt = self.trace(ro, rd, minT, maxT, True, **kw)[0]
        occ = bt == -float("inf")
        if self.sph_c is not None:
            occ = occ | _trace_impl(None, self.sph_c, ro, rd, minT, maxT,
                                    True)
        return occ


def detached_rays(ro, rd, minT, maxT):
    """The rays cut from autograd, minT and maxT expanded to one a ray:
    what a tracer facade hands its walk."""
    B = ro.shape[0]
    return (ro.detach(), rd.detach(), minT.detach().expand(B),
            maxT.detach().expand(B))


def merge_spheres(sph_c, hr, ro, rd, minT, maxT):
    """A dense test of the spheres ``sph_c`` merged into the triangle hits
    ``hr`` (rays as ``detached_rays`` gives them): a sphere wins only on a
    strictly smaller t."""
    sh = _trace_impl(None, sph_c, ro, rd, minT, maxT, False)
    better = sh.t < hr.t
    return HitResult(
        t=torch.where(better, sh.t, hr.t),
        prim_type=torch.where(better, ir.PRIM_SPHERE, hr.prim_type),
        prim_id=torch.where(better, sh.prim_id, hr.prim_id),
        u=torch.where(better, sh.u, hr.u),
        v=torch.where(better, sh.v, hr.v))
