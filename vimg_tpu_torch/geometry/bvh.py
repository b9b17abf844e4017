"""Binned-SAH BVH build on the host (port of vimg_tpu.geometry.bvh's
builder).

16 centroid bins, at most 8 primitives per leaf, SAH costs Ci = 1 and
Ct = 0.5 and a median-split fallback: the algorithm of the reference's
src/bvh/bin_bvh.cpp, iterative over numpy slices. ``build_bvh_numpy`` is
the oracle; ``vimg_tpu_torch.runtime.native.build_bvh_native`` is the fast
C++ builder with the same output format. The cluster tracer cuts either
tree into treelet clusters (geometry/cluster_trace.py).

The per-ray BVH walk of vimg_tpu (``BVHTracer``, ``bvh_traverse``,
``refit_bvh``) is not ported yet (ROADMAP queue A, item A4).
"""
from __future__ import annotations

import numpy as np

N_BINS = 16
LEAF_SIZE = 8
COST_INTERSECT = 1.0   # reference BVHConst::intersection_cost
COST_TRAVERSE = 0.5    # reference BVHConst::traversal_cost


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
