"""Ablation of the cluster-tree walk (port of tools/probe_walkablate.py).

Five variants of the skip-link closest-hit walk on a fixed Morton-sorted
bounce batch (131,072 rays on the 100k-triangle terrain) take the cost of
one visit apart:

  full        the walk: slab test, leaf branch, 64 triangle tests
  no_tri      the leaf branch kept, the triangle tests emptied
  no_cond     no leaf branch: slab test and skip advance only
  lean_carry  no_cond with the loop state cut to (n, bt)
  no_slab     lean_carry with the slab test replaced by one compare

``group`` is the number of consecutive rays that advance together: a node
is visited when any ray of the group is live in it, and the group takes
``n + 1`` if so, else ``skip[n]``. It is the counterpart of the TPU's ray
tile (tile_rows x 128 rays). ``walkablate`` is kernel P1
(``csrc/probe_walk.cu``) for CUDA tensors, at group 32 (a warp in
lockstep) or 1 (each ray's own walk, kernel B4's schedule);
``walkablate_plain`` is its plain version, for any group. bt does not
depend on the group; the visit counts do. ``walk_schedule`` replays the
full walk as the card runs it (B4's warp leaf round, ungated) and counts
its warp steps, which a counted launch (``walkablate(..., steps=)``)
must reproduce.

The walk reads the binary tables ``ClusterData.node_aabbs / node_cid /
node_skip`` and ``tri_rows``, which is what the TPU kernel was written for
(vimg_tpu's probe takes ``ClusterTracer.node_tables``, which are the wide
tables on an accelerator at 100k triangles: ROADMAP C11).

Run: ``python -m vimg_tpu_torch.probes.probe_walkablate [--device cpu]
[--tris N] [--rays B] [--out records.jsonl]``. Records carry the TPU
probe's keys (variant, secs, visits, us_per_visit) plus the group.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.geometry import skip_schedule as ss
from vimg_tpu_torch.geometry.cluster_trace import (CLUSTER_K, N_SUB, ROW16,
                                                   ClusterData,
                                                   ray_sort_key)
from vimg_tpu_torch.probes import common
from vimg_tpu_torch.probes.rays import bounce_batches
from vimg_tpu_torch.scene.synthetic import terrain_scene

VARIANTS = ("full", "no_tri", "no_cond", "lean_carry", "no_slab")
KERNEL_GROUPS = (32, 1)
MIN_T = 1e-4


def _leaf_tests(rows, r, live, ro, rd, minT, bt):
    """The probe's test16 over all 64 slots of each leaf for the rays ``r``
    ((L, group) ray ids of the groups at a live leaf; ``rows`` (L, 64, 16)
    their cluster rows). Each ray's bt becomes the first of its least hit
    t: a sequential strict-< scan, as the probe's unrolled loop."""
    o, d = ro[r][..., None, :], rd[r][..., None, :]        # (L, g, 1, 3)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    q = rows[:, None]                                       # (L, 1, 64, 16)
    nx, ny, nz, d0 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m1x, m1y, m1z, c1 = q[..., 4], q[..., 5], q[..., 6], q[..., 7]
    m2x, m2y, m2z, c2 = q[..., 8], q[..., 9], q[..., 10], q[..., 11]
    ro_n = ox * nx + oy * ny + oz * nz
    rd_n = dx * nx + dy * ny + dz * nz
    par = rd_n.abs() < 1e-22
    t = (d0 - ro_n) / torch.where(par, 1.0, rd_n)
    u = (ox * m1x + oy * m1y + oz * m1z - c1
         + t * (dx * m1x + dy * m1y + dz * m1z))
    v = (ox * m2x + oy * m2y + oz * m2z - c2
         + t * (dx * m2x + dy * m2y + dz * m2z))
    hit = (~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= minT[r][..., None]) & (t < bt[r][..., None])
           & live[..., None])
    tm = torch.where(hit, t, float("inf"))
    best = tm.amin(-1, keepdim=True)
    k = (hit & (tm == best)).to(torch.uint8).argmax(-1, keepdim=True)
    found = hit.any(-1)
    bt[r[found]] = t.gather(-1, k)[..., 0][found]


def walkablate_plain(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT,
                     variant, group):
    """Plain version of kernel P1 (any group that divides the ray count).
    Tables are the flat ClusterData arrays (node aabbs 8 floats per node,
    cid and skip one int32 per node, tri 64 x 16 floats per cluster).
    Returns (bt (N,) float32, visits (N / group,) int32)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} ({VARIANTS})")
    N = ro.shape[0]
    if group < 1 or N % group:
        raise ValueError(f"{N} rays do not split into groups of {group}")
    dev = ro.device
    inv = 1.0 / torch.where(rd == 0.0, 1e-30, rd)
    oi = ro * inv
    bt = maxT.clone()
    G = N // group
    node = torch.zeros(G, dtype=torch.int64, device=dev)
    nv = torch.zeros(G, dtype=torch.int32, device=dev)
    box = aabbs.view(-1, 8)
    rows = tri.view(-1, CLUSTER_K, ROW16)
    lane = torch.arange(group, device=dev)
    act = torch.arange(G, device=dev) if n_nodes > 0 else lane[:0]
    while act.numel():
        n = node[act]
        r = act[:, None] * group + lane                      # (A, group)
        b = box[n]
        if variant == "no_slab":
            live = (bt[r] + b[:, 0:1]) > 0.0
        else:
            iv, o = inv[r], oi[r]                            # (A, g, 3)
            t0 = b[:, None, 0:3] * iv - o
            t1 = b[:, None, 3:6] * iv - o
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                                torch.maximum(lo[..., 2], minT[r]))
            tout = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                                 torch.minimum(hi[..., 2], bt[r]))
            live = tin <= tout
        any_live = live.any(1)
        nv[act] += 1
        c = cid[n].to(torch.int64)
        if variant == "full":
            leaf = any_live & (c >= 0)
            if bool(leaf.any()):
                _leaf_tests(rows[c[leaf]], r[leaf], live[leaf], ro, rd,
                            minT, bt)
        nxt = torch.where(any_live, n + 1, skip[n].to(torch.int64))
        node[act] = nxt
        act = act[nxt < n_nodes]
    return bt, nv


def walk_schedule(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT,
                  group):
    """Kernel P1's full walk as the card runs it, replayed in plain PyTorch
    on the warp leaf round of ``geometry/skip_schedule.py`` without its
    sub-box gates: the rays 32 to a warp in order (lanes past a ragged
    last warp walk nothing). At group 1 a round is B4's: each lane walks
    its own nodes with the probe's slab until it reaches a live leaf (it
    posts the leaf and waits) or ends; at group 32 the warp visits one node
    at a time (any lane live) and a live leaf posts its live lanes. Then
    the posted (lane, leaf) pairs run as 4 units of 16 triangles each, two
    units a warp step, hits merged by least (t, k).

    Returns (bt, visits, counts) with bt and visits as walkablate_plain's
    and counts: ``node_steps`` (a round's node phase costs the most any
    lane took; at group 32 one a visit), ``tri_steps`` (the kernel's warp
    triangle steps), ``tri_tests`` (64 a posted pair) and ``leaf_visits``
    (group 32: the warps' visits of a live leaf, each 64 triangle steps in
    the per-lane design before). Lane fill = tri_tests / (32 x
    tri_steps)."""
    N = ro.shape[0]
    if group not in KERNEL_GROUPS or N % group:
        raise ValueError(f"kernel P1 runs groups of {KERNEL_GROUPS} rays "
                         f"that divide the ray count, not {group} of {N}")
    dev = ro.device
    W = -(-N // ss.WARP)
    M = W * ss.WARP
    ro, rd = ss._pad(ro, M, 0.0), ss._pad(rd, M, 1.0)
    minT, bt = ss._pad(minT, M, 0.0), ss._pad(maxT.clone(), M, 0.0)
    inv = 1.0 / torch.where(rd == 0.0, 1e-30, rd)
    oi = ro * inv
    box = aabbs.view(-1, 8)
    rows = tri.view(-1, CLUSTER_K, ROW16)
    counts = dict(node_steps=0, tri_steps=0, tri_tests=0, leaf_visits=0)

    def live_at(lanes, n):
        b = box[n]
        iv, o = inv[lanes], oi[lanes]
        t0 = b[:, 0:3] * iv - o
        t1 = b[:, 3:6] * iv - o
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                            torch.maximum(lo[:, 2], minT[lanes]))
        tout = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                             torch.minimum(hi[:, 2], bt[lanes]))
        return tin <= tout

    lane = torch.arange(ss.WARP, device=dev)
    if group == 1:
        node = torch.where(torch.arange(M, device=dev) < N, 0, n_nodes)
        nv = torch.zeros(M, dtype=torch.int32, device=dev)
    else:
        node = torch.zeros(W, dtype=torch.int64, device=dev)
        nv = torch.zeros(W, dtype=torch.int32, device=dev)
    while True:
        # node phase: each lane (group 1) or warp (group 32) walks until it
        # posts a live leaf or ends
        post = torch.full((M,), -1, dtype=torch.int64, device=dev)
        if group == 1:
            steps = torch.zeros(M, dtype=torch.int64, device=dev)
            act = torch.nonzero(node < n_nodes)[:, 0]
            while act.numel():
                n = node[act]
                live = live_at(act, n)
                c = cid[n].to(torch.int64)
                nv[act] += 1
                steps[act] += 1
                leaf = live & (c >= 0)
                post[act[leaf]] = c[leaf]
                node[act] = torch.where(live, n + 1,
                                        skip[n].to(torch.int64))
                act = act[~leaf & (node[act] < n_nodes)]
            counts["node_steps"] += int(steps.view(W, ss.WARP).amax(1).sum())
        else:
            act = torch.nonzero(node < n_nodes)[:, 0]
            while act.numel():
                n = node[act]
                lanes = act[:, None] * ss.WARP + lane
                live = live_at(lanes.reshape(-1),
                               n.repeat_interleave(ss.WARP)).view(-1, ss.WARP)
                any_live = live.any(1)
                c = cid[n].to(torch.int64)
                nv[act] += 1
                counts["node_steps"] += act.numel()
                leaf = any_live & (c >= 0)
                counts["leaf_visits"] += int(leaf.sum())
                held = leaf[:, None] & live
                post[lanes[held]] = c[:, None].expand_as(lanes)[held]
                node[act] = torch.where(any_live, n + 1,
                                        skip[n].to(torch.int64))
                act = act[~leaf & (node[act] < n_nodes)]
        i = torch.nonzero(post >= 0)[:, 0]
        if not i.numel():
            break
        # leaf round: every sub-box a unit, two units a step
        tt, _, _, geo = ss._tests(rows[post[i]], ro[i], rd[i])
        cand = geo & (tt >= minT[i][:, None]) & (tt < bt[i][:, None])
        counts["tri_tests"] += CLUSTER_K * i.numel()
        counts["tri_steps"] += ss.unit_steps(
            i, torch.full_like(i, N_SUB), W)
        found, k = ss.merge_hits(cand, tt)
        bt[i[found]] = tt[found].gather(1, k[found])[:, 0]
    return bt[:N], nv[:N] if group == 1 else nv, counts


def walkablate(aabbs, cid, skip, tri, n_nodes, ro, rd, minT, maxT, variant,
               group, steps=None):
    """Kernel P1 on CUDA tensors (group 32 or 1), walkablate_plain on CPU
    tensors. Same arguments and returns as walkablate_plain. ``steps``, a
    (2,) int64 tensor on the card (the full variant only), collects the
    full walk's warp node and triangle steps (walk_schedule's counts).

    Replaces tools/probe_walkablate.py::make_kernel (pallas_call :204). One
    thread per ray; group 32 is a warp that advances on __any_sync(live).
    The full walk's leaves run on B4's warp leaf round, ungated (see
    csrc/probe_walk.cu). The node boxes and triangle rows are read 16 bytes
    at a time, so aabbs and tri must start 16-byte aligned (a misaligned
    view raises). What bounds it on this card: the latency of dependent
    node loads and the group's lockstep or divergence, not bytes or
    flops."""
    if not common.on_card(ro):
        if steps is not None:
            raise ValueError("steps are counted by kernel P1 on the card")
        return walkablate_plain(aabbs, cid, skip, tri, n_nodes, ro, rd, minT,
                                maxT, variant, group)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} ({VARIANTS})")
    dev, N = ro.device, ro.shape[0]
    if group not in KERNEL_GROUPS or N % group:
        raise ValueError(f"kernel P1 runs groups of {KERNEL_GROUPS} rays "
                         f"that divide the ray count, not {group} of {N}")
    common.check_tensor(aabbs, "aabbs", torch.float32, (aabbs.numel(),), dev)
    common.check_tensor(cid, "cid", torch.int32, (cid.numel(),), dev)
    common.check_tensor(skip, "skip", torch.int32, (skip.numel(),), dev)
    common.check_tensor(tri, "tri", torch.float32, (tri.numel(),), dev)
    if (aabbs.numel() < 8 * n_nodes or cid.numel() < n_nodes
            or skip.numel() < n_nodes or tri.numel() % (CLUSTER_K * ROW16)):
        raise ValueError(f"node tables smaller than {n_nodes} nodes or a "
                         f"triangle table not of whole clusters")
    for x, name in ((aabbs, "aabbs"), (tri, "tri")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: kernel P1 reads 16 bytes at a time; "
                             f"the tensor must start 16-byte aligned")
    if steps is not None:
        if variant != "full":
            raise ValueError("kernel P1 counts the steps of the full walk")
        common.check_tensor(steps, "steps", torch.int64, (2,), dev)
    common.check_tensor(ro, "ro", torch.float32, (N, 3), dev)
    common.check_tensor(rd, "rd", torch.float32, (N, 3), dev)
    common.check_tensor(minT, "minT", torch.float32, (N,), dev)
    common.check_tensor(maxT, "maxT", torch.float32, (N,), dev)
    bt = torch.empty((N,), dtype=torch.float32, device=dev)
    nv = torch.empty((N // group,), dtype=torch.int32, device=dev)
    if N:
        common.launch("probe_walkablate", "vimg_probe_walk", dev, aabbs, cid,
                      skip, tri, n_nodes, ro, rd, minT, maxT, N,
                      VARIANTS.index(variant), group, bt, nv, steps)
    return bt, nv


def probe_tables(data, device):
    """(aabbs, cid, skip, tri, n_nodes): the binary tables of ``data``
    (a ClusterData) as flat tensors on ``device``."""
    def flat(a):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device)
    return (flat(data.node_aabbs), flat(data.node_cid), flat(data.node_skip),
            flat(data.tri_rows), data.n_nodes)


def sorted_bounce_rays(scene, data, n_rays=131072):
    """(ro, rd, minT, maxT): ``n_rays`` bounce rays of ``scene`` in the
    order of their origin Morton key (stable), minT 1e-4, maxT inf."""
    ro, rd = bounce_batches(scene, B=n_rays)
    dev = ro.device
    lo = torch.from_numpy(data.scene_lo).to(dev)
    hi = torch.from_numpy(data.scene_hi).to(dev)
    perm = torch.argsort(ray_sort_key(ro, rd, lo, hi, mode="origin"),
                         stable=True)
    return (ro[perm].contiguous(), rd[perm].contiguous(),
            torch.full((n_rays,), MIN_T, device=dev),
            torch.full((n_rays,), float("inf"), device=dev))


def walk_ablation(scene, n_rays=131072, log=None):
    """The probe on ``scene``'s device: every variant at the kernel's
    groups (32 and 1) on the sorted bounce batch; logs (variant, group,
    secs, visits, us_per_visit) per run (secs = device time of one launch,
    None on the CPU). Returns (tables, rays, {(variant, group): (bt,
    visits, ms)})."""
    dev = scene.verts.device
    log = log or common.Log(dev)
    data = ClusterData(scene)
    tables = probe_tables(data, dev)
    rays = sorted_bounce_rays(scene, data, n_rays)
    out = {}
    for group in KERNEL_GROUPS:
        for variant in VARIANTS:
            def run():
                return walkablate(*tables, *rays, variant, group)
            bt, nv = run()
            ms = common.device_ms(run) if dev.type == "cuda" else None
            visits = int(nv.sum())
            secs = None if ms is None else ms / 1e3
            log(probe="walkablate", variant=variant, group=group, secs=secs,
                visits=visits,
                us_per_visit=None if secs is None
                else secs / max(visits, 1) * 1e6)
            out[(variant, group)] = (bt, nv, ms)
    return tables, rays, out


def main(argv=None):
    args = common.parse_args(__doc__, argv, (
        ("--tris", dict(type=int, default=100_000)),
        ("--rays", dict(type=int, default=131072))))
    dev = common.resolve_device(args.device)
    scene = terrain_scene(args.tris, 512, 256, device=dev)
    walk_ablation(scene, args.rays, log=common.Log(dev, args.out))


if __name__ == "__main__":
    main()
