"""Warp schedules of the cluster-tree walks, replayed in plain PyTorch:
the binary skip walk (kernel B4 and the mesh mode of the megakernel B2)
and the 8-ary stack walk (kernel B3).

The replays group the rays 32 to a warp, in order (a ragged last warp is
padded with lanes that do not walk), run the per-ray walk of
``cluster_trace.skip_walk_plain`` or ``wide_walk_plain`` and count what a
warp of the kernel executes. A node step is one node a lane tests: a
binary node of the skip walk, a popped ref of the stack walk (a wide node
with its children's slab tests and pushes, or a cluster box).

- ``lane_schedule`` / ``wide_lane_schedule``: one lane a ray for the whole
  walk, leaf included (the first design of B4, B2 and B3). The warp runs
  its lanes in lockstep: an iteration takes one node step on every lane
  still walking, and the lanes whose step reaches a live leaf scan its
  gated triangles in order (sub-box s, then k), strict < on the running
  t, so the first of equal t stays. A warp triangle step is a (sub-box,
  triangle) position that some lane of the warp executes: 16 for each
  sub-box that a leaf lane gates, fewer for an any-hit lane that returns
  at its first hit.
- ``warp_schedule`` / ``wide_warp_schedule``: the kernels' walk
  (``csrc/cluster_walk.cuh``, ``leaf_round``). Nodes stay per lane: in a
  round every lane walks until it reaches a live leaf (it posts the leaf
  and waits) or the end of its walk; the round's node steps are the most
  any lane took. Then the warp runs the posted leaves together: each
  posted lane's four sub-box gates at its entry t, then the gated
  sub-boxes of all posted lanes as units of 16 triangles, two units a
  step (a half-warp each). A lane with a hit (t >= minT, t < the owner's
  entry t) merges it into its owner's least (t, k) key, t's bits made
  order-preserving with -0 as +0; the owner then takes that triangle's
  (t, u, v). An any-hit owner only needs a hit at all, and its walk ends.

Why all four return the plain walk's hits bit for bit: a lane sees the
same nodes with the same t, and within a leaf the sequential strict-<
scan keeps the least t among the hits below the entry t and the first k
among equal t, which is the least (t, k) the warp merge computes; a NaN t
never hits. The replays compute the leaf each in its own way (a
running-minimum replay of the scan, a key merge) so that the tests hold
each against the plain walk's own formulation.

``unit_steps`` and ``merge_hits`` (the leaf round's triangle steps and
its least (t, k) merge) also serve the replay of kernel P1's full walk,
``probes/probe_walkablate.py::walk_schedule``.

Each returns ((t, slot, u, v), counts): ``node_steps`` and ``tri_steps``
summed over warps, and the plain walk's ``box_tests`` and ``tri_tests``
(16 per gated sub-box). The lane fill is tri_tests / (32 x tri_steps).
Kernels B4 and B3 count the same two warp steps on the card
(``trace_skip``'s and ``trace_wide``'s ``steps``), so the warp
schedules' counts are the kernels' exactly. The warp schedules also
return ``warp_steps``, an (n_warps, 2) int64 tensor of each warp's node
and triangle steps (their column sums are ``node_steps`` and
``tri_steps``): the rows of ``ClusterTracer.trace_stats`` on the CPU, and
what the kernels' per-warp counter (``warp_steps``) writes on the card.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.geometry.cluster_trace import (CLUSTER_K, EMPTY, FAN,
                                                   N_SUB, ROW16, SUB, _slab,
                                                   _walk_start)

WARP = 32


def _warps(n):
    return -(-n // WARP)


def _pad(x, n, fill):
    """x padded to n entries along dim 0 with ``fill``."""
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _start(ro, rd, minT, maxT, any_hit, mask):
    """Padded walk state: ((t, slot, u, v), inverse directions, rays,
    which lanes walk), N rounded up to whole warps."""
    N = ro.shape[0]
    M = _warps(N) * WARP
    ro, rd = _pad(ro, M, 0.0), _pad(rd, M, 1.0)
    minT, maxT = _pad(minT, M, 0.0), _pad(maxT, M, -float("inf"))
    st, inv, act = _walk_start(ro, rd, minT, maxT, any_hit)
    go = torch.zeros(M, dtype=torch.bool, device=ro.device)
    go[act] = True
    go[N:] = False
    if mask is not None:
        go[:N] &= mask
    return st, inv, (ro, rd, minT, maxT), go


def _tests(rows, o, d):
    """The triangle test of every row: (t, u, v, geometric hit) with the
    kernels' float32 expressions. rows (R, n, 16), o and d (R, 3)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    q = [rows[..., j] for j in range(12)]
    ro_n = ox * q[0] + oy * q[1] + oz * q[2]
    rd_n = dx * q[0] + dy * q[1] + dz * q[2]
    par = rd_n.abs() < 1e-22
    t = (q[3] - ro_n) / torch.where(par, 1.0, rd_n)
    u = (ox * q[4] + oy * q[5] + oz * q[6] - q[7]
         + t * (dx * q[4] + dy * q[5] + dz * q[6]))
    v = (ox * q[8] + oy * q[9] + oz * q[10] - q[11]
         + t * (dx * q[8] + dy * q[9] + dz * q[10]))
    geo = ~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, geo


def _leaf(tri, c, o, d, iv, mt, be):
    """Gates at the entry t ``be`` and every triangle of the leaves ``c``:
    (gate (R, 4), t, u, v, candidate (R, 64)); a candidate hits below the
    entry t inside a gated sub-box."""
    rows = tri.view(-1, CLUSTER_K, ROW16)[c]
    gate = _slab(rows[:, 0:2 * N_SUB:2, 13:16], rows[:, 1:2 * N_SUB:2, 13:16],
                 o[:, None], iv[:, None], mt[:, None], be[:, None])
    t, u, v, geo = _tests(rows, o, d)
    cand = (geo & (t >= mt[:, None]) & (t < be[:, None])
            & gate.repeat_interleave(SUB, dim=1))
    return gate, t, u, v, cand


def _add(counts, key, x):
    counts[key] += int(x)


class _SkipWalk:
    """A lane's state in the stackless skip walk: its next node
    (n_nodes once it is done)."""

    def __init__(self, aabbs, cid, skip, n_nodes, go):
        self.box, self.cid, self.skip = aabbs.view(-1, 8), cid, skip
        self.n_nodes = n_nodes
        self.node = torch.where(go, 0, n_nodes).to(torch.int64)

    def walking(self, idx):
        return self.node[idx] < self.n_nodes

    def stop(self, idx):
        self.node[idx] = self.n_nodes

    def step(self, act, t, rays, inv, counts):
        """One node step of the lanes ``act`` at their current t: (whether
        the node is a live leaf, its cluster id)."""
        ro, _, minT, _ = rays
        n = self.node[act]
        b = self.box[n]
        live = _slab(b[:, 0:3], b[:, 3:6], ro[act], inv[act], minT[act],
                     t[act])
        _add(counts, "box_tests", act.numel())
        c = self.cid[n].to(torch.int64)
        self.node[act] = torch.where(live, n + 1,
                                     self.skip[n].to(torch.int64))
        return live & (c >= 0), c


class _WideWalk:
    """A lane's state in the 8-ary stack walk: its stack of refs (a wide
    node >= 0, a cluster -(cid + 1)) and stack pointer (0 once done)."""

    def __init__(self, boxes, refs, cl_boxes, max_stack, go):
        self.wbox = boxes.view(-1, FAN, 8)
        self.wref = refs.view(-1, FAN).to(torch.int64)
        self.cbox = cl_boxes.view(-1, 8)
        self.stack = torch.zeros((go.shape[0], max_stack), dtype=torch.int64,
                                 device=go.device)
        self.sp = go.to(torch.int64)          # the root wide node 0 pushed

    def walking(self, idx):
        return self.sp[idx] > 0

    def stop(self, idx):
        self.sp[idx] = 0

    def step(self, act, t, rays, inv, counts):
        """Pop a ref on each lane of ``act``: a cluster is slab-tested at
        the lane's current t (a live one is returned as a leaf); a wide
        node pushes its live non-empty children in reverse."""
        ro, _, minT, _ = rays
        self.sp[act] -= 1
        top = self.stack[act, self.sp[act]]
        is_cl = top < 0
        leaf = torch.zeros_like(is_cl)
        c = torch.where(is_cl, -top - 1, -1)
        if bool(is_cl.any()):
            i = act[is_cl]
            b = self.cbox[c[is_cl]]
            leaf[is_cl] = _slab(b[:, 0:3], b[:, 3:6], ro[i], inv[i], minT[i],
                                t[i])
            _add(counts, "box_tests", i.numel())
        if not bool(is_cl.all()):
            i = act[~is_cl]
            w = top[~is_cl]
            b, r = self.wbox[w], self.wref[w]
            filled = r != EMPTY
            live = _slab(b[..., 0:3], b[..., 3:6], ro[i][:, None],
                         inv[i][:, None], minT[i][:, None],
                         t[i][:, None]) & filled
            _add(counts, "box_tests", filled.sum())
            # child ci lands above every live child of higher index
            li = live.to(torch.int64)
            above = li.flip(1).cumsum(1).flip(1) - li
            pos = self.sp[i][:, None] + above
            rr, cc = torch.nonzero(live, as_tuple=True)
            self.stack[i[rr], pos[rr, cc]] = r[rr, cc]
            self.sp[i] += li.sum(1)
        return leaf, c


def _lane_run(walk, tri, ro, rd, minT, maxT, any_hit, mask):
    """The per-lane walk (leaf in one lane), warps in lockstep; ``walk``
    makes the walk state from the lanes that walk."""
    N = ro.shape[0]
    (t, slot, u, v), inv, rays, go = _start(ro, rd, minT, maxT, any_hit,
                                            mask)
    ro_, rd_, mn_, _ = rays
    dev = ro.device
    counts = dict(node_steps=0, tri_steps=0, box_tests=0, tri_tests=0)
    w = walk(go)
    act = torch.nonzero(go)[:, 0]
    pos = torch.arange(CLUSTER_K, device=dev)
    while act.numel():
        _add(counts, "node_steps", torch.unique(act // WARP).numel())
        leaf, c = w.step(act, t, rays, inv, counts)
        if bool(leaf.any()):
            i, cl = act[leaf], c[leaf]
            gate, tt, uu, vv, cand = _leaf(tri, cl, ro_[i], rd_[i], inv[i],
                                           mn_[i], t[i])
            _add(counts, "box_tests", gate.numel())
            _add(counts, "tri_tests", SUB * gate.sum())
            if any_hit:
                # a lane returns at its first hit, in scan order
                found = cand.any(1)
                stop = torch.where(found, cand.to(torch.uint8).argmax(1),
                                   CLUSTER_K)
                # positions of sub-box s a lane executes
                s0 = torch.arange(N_SUB, device=dev) * SUB
                run = (torch.minimum(stop[:, None], s0 + SUB - 1) - s0 + 1)
                run = torch.where(gate & (stop[:, None] >= s0), run, 0)
                per = torch.zeros((_warps(t.shape[0]), N_SUB),
                                  dtype=torch.int64, device=dev)
                per.scatter_reduce_(0, (i // WARP)[:, None].expand(-1, N_SUB),
                                    run, "amax")
                _add(counts, "tri_steps", per.sum())
                t[i[found]] = -float("inf")
            else:
                per = torch.zeros((_warps(t.shape[0]), N_SUB),
                                  dtype=torch.int64, device=dev)
                per.scatter_reduce_(0, (i // WARP)[:, None].expand(-1, N_SUB),
                                    gate.to(torch.int64), "amax")
                _add(counts, "tri_steps", SUB * per.sum())
                # the scan: k updates the hit iff it is a candidate below
                # the least candidate t before it
                tm = torch.where(cand, tt, float("inf"))
                before = torch.cat([torch.full_like(tm[:, :1], float("inf")),
                                    tm[:, :-1]], 1).cummin(1).values
                upd = cand & (tt < before)
                found = upd.any(1)
                k = torch.where(upd, pos, -1).amax(1, keepdim=True)
                j = i[found]
                kf = k[found]
                t[j] = tt[found].gather(1, kf)[:, 0]
                u[j] = uu[found].gather(1, kf)[:, 0]
                v[j] = vv[found].gather(1, kf)[:, 0]
                slot[j] = (cl[found] * CLUSTER_K + kf[:, 0]).to(torch.int32)
        keep = w.walking(act)
        if any_hit:
            keep &= t[act] != -float("inf")
        act = act[keep]
    return (t[:N], slot[:N], u[:N], v[:N]), counts


def _ordered(t):
    """Order-preserving int64 image of float32 t (-0 taken as +0)."""
    b = torch.where(t == 0.0, 0.0, t).view(torch.int32).to(torch.int64)
    b = b & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def warp_unit_steps(lanes, units, n_warps):
    """Each warp's triangle steps in a leaf round: the posted ``lanes``'
    ``units`` (16 triangles each) run two a step, a half-warp each."""
    per = torch.zeros(n_warps, dtype=torch.int64, device=lanes.device)
    per.index_add_(0, lanes // WARP, units)
    return (per + 1) // 2


def unit_steps(lanes, units, n_warps):
    """Triangle steps of a leaf round, summed over the warps."""
    return int(warp_unit_steps(lanes, units, n_warps).sum())


def merge_hits(cand, tt):
    """The least (t, k) of each owner's candidates, t's bits made
    order-preserving with -0 as +0 (the leaf round's key): (whether the
    owner has a candidate, k as an (R, 1) index)."""
    pos = torch.arange(cand.shape[1], device=cand.device)
    key = torch.where(cand, _ordered(tt) * CLUSTER_K + pos,
                      torch.iinfo(torch.int64).max)
    return cand.any(1), key.argmin(1, keepdim=True) % CLUSTER_K


def _warp_run(walk, tri, ro, rd, minT, maxT, any_hit, mask):
    """The warp-cooperative walk: rounds of per-lane node phases and the
    warp's leaf round; ``walk`` makes the walk state from the lanes that
    walk."""
    N = ro.shape[0]
    (t, slot, u, v), inv, rays, go = _start(ro, rd, minT, maxT, any_hit,
                                            mask)
    ro_, rd_, mn_, _ = rays
    dev = ro.device
    M = t.shape[0]
    W = M // WARP
    counts = dict(node_steps=0, tri_steps=0, box_tests=0, tri_tests=0)
    per_warp = torch.zeros((W, 2), dtype=torch.int64, device=dev)
    w = walk(go)
    every = torch.arange(M, device=dev)
    while True:
        # node phase: each lane walks until it posts a live leaf or ends
        post = torch.full((M,), -1, dtype=torch.int64, device=dev)
        steps = torch.zeros(M, dtype=torch.int64, device=dev)
        act = every[w.walking(every)]
        while act.numel():
            steps[act] += 1
            leaf, c = w.step(act, t, rays, inv, counts)
            post[act[leaf]] = c[leaf]
            act = act[~leaf & w.walking(act)]
        per_warp[:, 0] += steps.view(W, WARP).amax(1)
        i = torch.nonzero(post >= 0)[:, 0]
        if not i.numel():
            break
        # leaf round: gates, then units of 16 triangles two a step
        cl = post[i]
        gate, tt, uu, vv, cand = _leaf(tri, cl, ro_[i], rd_[i], inv[i],
                                       mn_[i], t[i])
        _add(counts, "box_tests", gate.numel())
        _add(counts, "tri_tests", SUB * gate.sum())
        per_warp[:, 1] += warp_unit_steps(i, gate.sum(1), W)
        found, k = merge_hits(cand, tt)
        if any_hit:
            t[i[found]] = -float("inf")
            w.stop(i[found])
            continue
        j, kf = i[found], k[found]
        t[j] = tt[found].gather(1, kf)[:, 0]
        u[j] = uu[found].gather(1, kf)[:, 0]
        v[j] = vv[found].gather(1, kf)[:, 0]
        slot[j] = (cl[found] * CLUSTER_K + kf[:, 0]).to(torch.int32)
    counts.update(node_steps=int(per_warp[:, 0].sum()),
                  tri_steps=int(per_warp[:, 1].sum()), warp_steps=per_warp)
    return (t[:N], slot[:N], u[:N], v[:N]), counts


def lane_schedule(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT,
                  any_hit, mask=None):
    """The per-lane skip walk (leaf in one lane), warps in lockstep; see
    the module docstring. ``mask``: (N,) bool, the lanes that walk (all by
    default)."""
    return _lane_run(lambda go: _SkipWalk(aabbs, cid, skip, n_nodes, go),
                     tri, ro, rd, minT, maxT, any_hit, mask)


def warp_schedule(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT,
                  any_hit, mask=None):
    """The warp-cooperative skip walk of kernels B4 and B2; see the module
    docstring. ``mask``: (N,) bool, the lanes that walk (all by
    default)."""
    return _warp_run(lambda go: _SkipWalk(aabbs, cid, skip, n_nodes, go),
                     tri, ro, rd, minT, maxT, any_hit, mask)


def wide_lane_schedule(boxes, refs, cl_boxes, tri, max_stack, ro, rd, minT,
                       maxT, any_hit, mask=None):
    """The per-lane 8-ary stack walk (kernel B3's first design), warps in
    lockstep; arguments as ``wide_walk_plain``, ``mask`` as
    ``lane_schedule``'s."""
    return _lane_run(
        lambda go: _WideWalk(boxes, refs, cl_boxes, max_stack, go),
        tri, ro, rd, minT, maxT, any_hit, mask)


def wide_warp_schedule(boxes, refs, cl_boxes, tri, max_stack, ro, rd, minT,
                       maxT, any_hit, mask=None):
    """The 8-ary stack walk on the warp's leaf round (kernel B3);
    arguments as ``wide_walk_plain``, ``mask`` as ``lane_schedule``'s."""
    return _warp_run(
        lambda go: _WideWalk(boxes, refs, cl_boxes, max_stack, go),
        tri, ro, rd, minT, maxT, any_hit, mask)
