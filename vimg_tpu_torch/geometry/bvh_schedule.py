"""Warp schedules of kernel X2 (csrc/bvh_walk.cu), the BVH tracer's skip
walk, replayed in plain PyTorch over X2's packed tables
(``bvh.packed_tables``).

The replays group the rays 32 to a warp, in order (a ragged last warp is
padded with lanes that do not walk), walk each ray as ``bvh_traverse``
does and count what a warp of the kernel executes. A node step is one
node a lane tests; a leaf step is one step of the leaf tests.

- ``lane_schedule``: the first design of X2, a thread a ray for
  the whole walk, leaf included. The warp runs its lanes in lockstep: an
  iteration takes one node step on every lane still walking, and the
  lanes whose node is a live leaf test its slots one after another, so
  the iteration's leaf steps are the most slots any of them tests.
- ``warp_schedule``: the kernel's walk. Nodes stay per lane: a node step
  takes one node on every lane that walks and waits on no leaf; a lane
  that meets a live leaf posts it and waits. Once ``bvh.POST_MIN`` lanes
  of the warp wait, or lanes wait and none walks on, the warp runs the
  posted leaves together, a lane to each (leaf, slot) pair, 32 pairs a
  step. A pair whose primitive is hit below the owner's best t merges
  into the owner's least (t, k) key, t's bits made order-preserving with
  -0 as +0; the owner takes that hit and walks on. An any-hit owner needs
  a hit at all, and its walk ends.

Both return ``bvh_traverse``'s results bit for bit: a lane sees the same
nodes with the same best t, and within a leaf the plain walk's first
least t, replacing the best only when strictly smaller, is the least (t,
k) among the hits strictly below the best; a NaN t never hits. The lane
replay keeps the plain walk's formulation (the first least t of the leaf,
then the strict comparison); the warp replay the kernel's key merge.

Each returns (result, counts): the result as ``bvh_traverse`` returns it
(a HitResult, the occlusion mask, or (HitResult, cost) with
``count_cost``), and ``node_steps`` and ``leaf_steps`` summed over warps
with the plain walk's ``box_tests`` and ``prim_tests`` (the slots tested,
up to LEAF_SIZE a leaf). The leaf lane fill is prim_tests / (32 x
leaf_steps). Kernel X2 counts the same two warp steps on the card
(``bvh_trace(..., steps=)``), so the warp replay's counts are the
kernel's exactly.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.geometry.bvh import (COST_INTERSECT, COST_TRAVERSE,
                                         LEAF_SIZE, POST_MIN, _aabb_hit,
                                         node_fields, row_fields)
from vimg_tpu_torch.geometry.intersect import (HitResult, sphere_intersect,
                                               tri_intersect)
from vimg_tpu_torch.geometry.skip_schedule import (WARP, _ordered, _pad,
                                                   _warps)
from vimg_tpu_torch.scene import ir

INF = float("inf")


class _Walk:
    """The padded rays and every lane's walk state over the packed
    tables: its next node (n_nodes once done), best t, cost and best hit
    (u, v, slot, whether found)."""

    def __init__(self, nodes, rows, ro, rd, minT, maxT):
        self.lo, self.hi, self.skip, self.start, self.count = (
            x.long() if x.dtype == torch.int32 else x
            for x in node_fields(nodes))
        self.kind, self.ptype, self.pidx = row_fields(rows)
        self.rows = rows
        self.n_nodes, self.n_prims = nodes.shape[0], rows.shape[0]
        n = ro.shape[0]
        self.n = n
        m = _warps(n) * WARP
        self.ro = _pad(ro.detach(), m, 0.0)
        self.rd = _pad(rd.detach(), m, 1.0)
        self.mn = _pad(minT.detach().expand(n), m, 0.0)
        self.best = _pad(maxT.detach().expand(n), m, 0.0).clone()
        self.inv = 1.0 / torch.where(self.rd == 0.0, 1e-20, self.rd)
        dev = ro.device
        self.node = torch.zeros(m, dtype=torch.int64, device=dev)
        self.node[n:] = self.n_nodes
        self.cost = torch.zeros(m, device=dev)
        self.u = torch.zeros(m, device=dev)
        self.v = torch.zeros(m, device=dev)
        self.slot = torch.zeros(m, dtype=torch.int64, device=dev)
        self.found = torch.zeros(m, dtype=torch.bool, device=dev)
        self.counts = dict(node_steps=0, leaf_steps=0, box_tests=0,
                           prim_tests=0)

    @property
    def warps(self):
        return self.node.shape[0] // WARP

    def step(self, act):
        """One node step of the lanes ``act``: returns which of them met a
        live leaf; inner nodes they meet lead to node + 1, the rest (leaves
        included) to the skip link."""
        n = self.node[act]
        hit = _aabb_hit(self.lo[n], self.hi[n], self.ro[act], self.inv[act],
                        self.mn[act], self.best[act])
        self.counts["box_tests"] += act.numel()
        self.cost[act] += COST_TRAVERSE
        c = self.count[n]
        self.node[act] = torch.where(hit & (c == 0), n + 1, self.skip[n])
        return hit & (c > 0), n

    def leaf(self, i, leaf_node):
        """The slot tests of the leaves ``leaf_node`` posted by lanes
        ``i``: (t, u, v, slot, valid), each (R, LEAF_SIZE), t = +inf where
        a slot is missed or not tested; adds the leaves' cost."""
        lanes = torch.arange(LEAF_SIZE, device=i.device)[None, :]
        cnt = self.count[leaf_node]
        slot = torch.clamp(self.start[leaf_node][:, None] + lanes, 0,
                           self.n_prims - 1)
        valid = lanes < cnt[:, None]
        q = self.rows[slot]
        kind = self.kind[slot]
        o, d = self.ro[i][:, None], self.rd[i][:, None]
        mn, mx = self.mn[i][:, None], self.best[i][:, None]
        tt, tu, tv, _, ok = tri_intersect(o, d, q[..., 0:3], q[..., 3:6],
                                          q[..., 6:9], mn, mx)
        st, sok = sphere_intersect(o, d, q[..., 0:3], q[..., 3], mn, mx)
        tri = valid & (kind == ir.PRIM_TRI) & ok
        sph = valid & (kind == ir.PRIM_SPHERE) & sok
        t = torch.where(tri, tt, torch.where(sph, st, INF))
        u = torch.where(tri, tu, 0.0)
        v = torch.where(tri, tv, 0.0)
        self.counts["prim_tests"] += int(valid.sum())
        self.cost[i] += COST_INTERSECT * cnt.float()
        return t, u, v, slot, valid

    def take(self, j, t, u, v, slot):
        """Lanes ``j`` replace their best hit."""
        self.best[j], self.u[j], self.v[j], self.slot[j] = t, u, v, slot
        self.found[j] = True

    def result(self, any_hit, count_cost):
        n, f = self.n, self.found[:self.n]
        if any_hit:
            return f
        s = self.slot[:n]
        hr = HitResult(t=torch.where(f, self.best[:n], INF),
                       prim_type=torch.where(f, self.ptype[s], 0).long(),
                       prim_id=torch.where(f, self.pidx[s], 0).long(),
                       u=self.u[:n], v=self.v[:n])
        return (hr, self.cost[:n]) if count_cost else hr


def lane_schedule(nodes, rows, ro, rd, minT, maxT, any_hit=False,
                  count_cost=False):
    """X2's first design, a thread a ray, warps in lockstep; see the
    module docstring. ``nodes``, ``rows``: ``bvh.packed_tables``."""
    w = _Walk(nodes, rows, ro, rd, minT, maxT)
    lanes = torch.arange(LEAF_SIZE, device=ro.device)
    act = torch.nonzero(w.node < w.n_nodes)[:, 0]
    while act.numel():
        w.counts["node_steps"] += torch.unique(act // WARP).numel()
        leaf, n = w.step(act)
        if bool(leaf.any()):
            i = act[leaf]
            t, u, v, slot, valid = w.leaf(i, n[leaf])
            per = torch.zeros(w.warps, dtype=torch.int64, device=ro.device)
            per.scatter_reduce_(0, i // WARP, valid.sum(1), "amax")
            w.counts["leaf_steps"] += int(per.sum())
            # the plain walk's leaf: its first least t, taken if strictly
            # below the best
            tmin = t.amin(1)
            k = torch.where(t == tmin[:, None], lanes, LEAF_SIZE).amin(
                1, keepdim=True)
            better = tmin < w.best[i]
            j = i[better]
            w.take(j, tmin[better], u.gather(1, k)[better, 0],
                   v.gather(1, k)[better, 0], slot.gather(1, k)[better, 0])
            if any_hit:
                w.node[j] = w.n_nodes
        act = act[w.node[act] < w.n_nodes]
    return w.result(any_hit, count_cost), w.counts


def warp_schedule(nodes, rows, ro, rd, minT, maxT, any_hit=False,
                  count_cost=False):
    """Kernel X2's walk: per-lane node steps and the warp's leaf rounds;
    see the module docstring. ``nodes``, ``rows``: ``bvh.packed_tables``."""
    w = _Walk(nodes, rows, ro, rd, minT, maxT)
    dev = ro.device
    m = w.node.shape[0]
    lanes = torch.arange(LEAF_SIZE, device=dev)
    post = torch.full((m,), -1, dtype=torch.int64, device=dev)
    while True:
        # a node step of every lane that walks and has posted nothing
        walking = (post < 0) & (w.node < w.n_nodes)
        act = torch.nonzero(walking)[:, 0]
        if act.numel():
            leaf, n = w.step(act)
            post[act[leaf]] = n[leaf]
        w.counts["node_steps"] += int(walking.view(-1, WARP).any(1).sum())
        # a leaf round in each warp where POST_MIN lanes wait, or where
        # lanes wait and none walks on
        waiting = (post >= 0).view(-1, WARP)
        left = ((post < 0) & (w.node < w.n_nodes)).view(-1, WARP).any(1)
        n_wait = waiting.sum(1)
        if not bool(left.any()) and not bool(n_wait.any()):
            break
        run = (n_wait > 0) & (~left | (n_wait >= POST_MIN))
        i = torch.nonzero((waiting & run[:, None]).view(-1))[:, 0]
        if not i.numel():
            continue
        t, u, v, slot, valid = w.leaf(i, post[i])
        post[i] = -1
        pairs = torch.zeros(w.warps, dtype=torch.int64, device=dev)
        pairs.index_add_(0, i // WARP, valid.sum(1))
        w.counts["leaf_steps"] += int(((pairs + WARP - 1) // WARP).sum())
        cand = t < w.best[i][:, None]
        found = cand.any(1)
        j = i[found]
        if any_hit:
            w.found[j] = True
            w.node[j] = w.n_nodes
            continue
        key = torch.where(cand, _ordered(t) * LEAF_SIZE + lanes,
                          torch.iinfo(torch.int64).max)
        k = key.argmin(1, keepdim=True)[found]
        w.take(j, t[found].gather(1, k)[:, 0], u[found].gather(1, k)[:, 0],
               v[found].gather(1, k)[:, 0], slot[found].gather(1, k)[:, 0])
    return w.result(any_hit, count_cost), w.counts
