"""Mesh tracer in packet form (port of vimg_tpu.geometry.packet_trace).

Rays are Morton-sorted and cut into WORKGROUPS of 128 rays, each of 16
PACKETS of 8 rays; the triangles are ClusterData's SAH tree cut into
clusters of up to 128 triangles, packed transposed (row j of cluster c holds
constant j of its 128 triangles). Two passes per trace:

- the cull (``cull_meta``): exact per-ray slab tests against every cluster
  box, reduced to 16 liveness bits per (workgroup, cluster) and a
  per-workgroup chain of candidate clusters (a next-pointer row, the
  suffix minimum of the candidate indices); with the per-octant orderings
  ``pi`` the chain runs front to back and carries quantised entry
  distances for an early exit (variant ``f2b``). Kernel X1
  (``csrc/packet_cull.cu``) for CUDA tensors, counted in
  ``LAUNCHES_CULL``; its plain version ``_cull_meta`` (vimg_tpu's is XLA)
  for CPU tensors only;
- the walk (``trace_packet``): kernel B5 (``csrc/packet_trace.cu``) for
  CUDA tensors, counted in ``LAUNCHES``; ``packet_walk_plain`` for CPU
  tensors only. Each ray tests all 128 triangles of every candidate cluster
  whose bit its packet holds, in chain order. On the card one warp runs
  one live (candidate, packet) pair: lane (ray, quarter) tests every
  fourth triangle.

vimg_tpu's variants ``slist``, ``chase`` and ``prefetch`` consume the same
chain in the same order and differ only in their TPU schedule, so here they
are one code path; ``f2b`` adds the early exit. ``PacketTracer`` is the
facade: the sort (above 128 rays, stable, idle lanes not moved to the tail),
padding to whole workgroups, cull, walk, unsort, u/v rebuilt in the winning
triangle's plane, and a dense merge with the scene's spheres.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.geometry.cluster_trace import (ClusterData, _check,
                                                   _device_of, detached_rays,
                                                   merge_spheres,
                                                   ray_sort_key)
from vimg_tpu_torch.geometry.intersect import HitResult
from vimg_tpu_torch.geometry.soa_intersect import _trace_impl, build_constants
from vimg_tpu_torch.scene import ir

WG = 128                 # rays per workgroup (16 packets x 8 rays)
N_PACKETS = WG // 8
PACK_K = 128             # triangles per cluster = lanes of a packed row
N_CONST = 12             # soa_intersect constants per triangle
META_ROWS = 8            # int32 rows of the cull's output per workgroup
VARIANTS = ("slist", "chase", "prefetch", "f2b")

LAUNCHES = 0
LAUNCHES_CULL = 0


class PacketData:
    """Transposed cluster tables (host numpy), byte-identical to
    vimg_tpu's PacketData for the same builder: ClusterData's tree and
    permutation (a hit code c*128 + k maps through ``perm``), the triangle
    constants re-packed cluster-major and lane-minor, and tight
    per-cluster boxes."""

    def __init__(self, scene: ir.Scene, max_k=PACK_K, builder="auto"):
        base = ClusterData(scene, max_k=max_k, builder=builder)
        C = base.n_clusters
        self.n_clusters = C
        self.max_k = max_k
        self.n_tris = base.n_tris
        self.perm = base.perm                   # (C*max_k,) tri ids
        self.cl_len = base.cl_len               # (C,) valid tris per cluster
        self.scene_lo = base.scene_lo
        self.scene_hi = base.scene_hi

        # (C, max_k, 16) -> (C, 12, max_k): invalid lanes are zero (plane
        # normal 0 -> parallel -> no hit)
        rows = base.tri_rows.reshape(C, max_k, 16)
        tri_t = np.ascontiguousarray(
            rows[:, :, :N_CONST].transpose(0, 2, 1)).astype(np.float32)
        if max_k != 128:
            pad = np.zeros((C, N_CONST, 128 - max_k), np.float32)
            tri_t = np.concatenate([tri_t, pad], axis=2)
        self.tri_rows_t = tri_t.reshape(C * N_CONST, 128)

        # tight per-cluster boxes; padding lanes hold triangle 0 and are
        # masked out of the union
        verts = scene.verts.cpu().numpy()
        tvidx = scene.tri_vidx.cpu().numpy()
        p = verts[tvidx]
        bmin = p.min(axis=1)
        bmax = p.max(axis=1)
        ids = base.perm.reshape(C, max_k)
        valid = np.arange(max_k)[None, :] < base.cl_len[:, None]
        self.cl_lo = np.where(valid[..., None], bmin[ids],
                              np.inf).min(axis=1).astype(np.float32)
        self.cl_hi = np.where(valid[..., None], bmax[ids],
                              -np.inf).max(axis=1).astype(np.float32)
        M = base.n_nodes
        self._t_cid = np.asarray(base.node_cid).reshape(-1)[:M]
        self._t_right = np.asarray(base.node_right).reshape(-1)[:M]
        self._t_order = np.asarray(base.node_order).reshape(-1)[:M]

    def octant_orders(self):
        """(8, C) int32: for each ray-direction octant, the clusters in the
        leaf order of a DFS that descends each inner node's children in the
        node's near-first order for that octant."""
        C = self.n_clusters
        pi = np.empty((8, C), np.int32)
        for o in range(8):
            out = []
            stack = [0]
            while stack:
                n = stack.pop()
                c = int(self._t_cid[n])
                if c >= 0:
                    out.append(c)
                    continue
                left, r = n + 1, int(self._t_right[n])
                right_first = (int(self._t_order[n]) >> o) & 1
                first, second = (r, left) if right_first else (left, r)
                stack.append(second)              # LIFO: first pops first
                stack.append(first)
            pi[o] = np.asarray(out, np.int32)
        return pi


# ---------------------------------------------------------------------------
# the cull: per-packet liveness bits + per-workgroup candidate chains
# ---------------------------------------------------------------------------

def _direction_sums(rd):
    """(W, 3) float32 sums of each workgroup's 128 directions (f2b). The
    order of the sum decides a sign near zero, so kernel and plain cull
    share this one expression."""
    return rd.reshape(-1, WG, 3).sum(dim=1)


def _octants(rd):
    """(W,) majority direction octant of each workgroup (f2b): bit a set
    where the axis-a direction sum is negative (kernel X1 takes the sums
    and forms the same bits)."""
    sgn = _direction_sums(rd) < 0.0
    return (sgn[:, 0].long() + 2 * sgn[:, 1].long()
            + 4 * sgn[:, 2].long())


def _cull_meta(ro, rd, mn, mx, cl_lo, cl_hi, cp, pi=None, entry_scale=None):
    """Plain version of kernel X1: exact per-ray slab tests against every
    cluster box, reduced to per-packet bits and a per-workgroup
    next-pointer chain, in 128-cluster chunks. Rays are (B, 3) / (B,) with
    B a multiple of 128.

    Returns meta (W*8, cp) int32; per workgroup w the (8, cp) block is:
      row 0: nxt[j] = smallest candidate index >= j (cp-1 sentinel)
      row 1: pmask[j] = 16 liveness bits (bit p = packet p touches it)
      row 2, col 0: candidate count (chain length)
    With ``pi`` ((8, C) per-octant orderings) the chain lives in the index
    space of the workgroup's majority ray octant, and
      row 3: the suffix minimum over the chain of the entry distance,
             quantised as int32(clip(entry * entry_scale, 0, 2^30))
      row 4: the real cluster id of candidate j (pi[oct_w][j]).
    Bit-identical to vimg_tpu's _cull_meta."""
    B = ro.shape[0]
    C = cl_lo.shape[0]
    W = B // WG
    dev = ro.device
    inv = 1.0 / torch.where(rd == 0.0, 1e-30, rd)
    o = [ro[:, a].reshape(W, N_PACKETS, 8, 1) for a in range(3)]
    iv = [inv[:, a].reshape(W, N_PACKETS, 8, 1) for a in range(3)]
    mnp = mn.reshape(W, N_PACKETS, 8, 1)
    mxp = mx.reshape(W, N_PACKETS, 8, 1)

    if pi is not None:
        # majority direction octant of each workgroup -> its ordering; the
        # boxes are taken in that permuted index space
        idx = pi[_octants(rd)]                           # (W, C)
        lo_t, hi_t = cl_lo[idx], cl_hi[idx]              # (W, C, 3)

    bits, entries = [], []
    for c0 in range(0, C, 128):
        w = min(128, C - c0)
        if pi is not None:
            lo = [lo_t[:, c0:c0 + w, a].reshape(W, 1, 1, w) for a in range(3)]
            hi = [hi_t[:, c0:c0 + w, a].reshape(W, 1, 1, w) for a in range(3)]
        else:
            lo = [cl_lo[c0:c0 + w, a].reshape(1, 1, 1, w) for a in range(3)]
            hi = [cl_hi[c0:c0 + w, a].reshape(1, 1, 1, w) for a in range(3)]
        tin, tout = mnp, mxp
        for a in range(3):
            t0 = (lo[a] - o[a]) * iv[a]                  # (W, 16, 8, w)
            t1 = (hi[a] - o[a]) * iv[a]
            tin = torch.maximum(tin, torch.minimum(t0, t1))
            tout = torch.minimum(tout, torch.maximum(t0, t1))
        hit = tin <= tout
        bits.append(hit.any(dim=2))                      # (W, 16, w)
        if pi is not None:
            e = torch.where(hit, tin, float("inf")).amin(dim=2)
            entries.append(e.amin(dim=1))                # (W, w)
    pbits = torch.cat(bits, dim=2).to(torch.int32)       # (W, 16, C)
    shift = (1 << torch.arange(N_PACKETS, dtype=torch.int32,
                               device=dev))[None, :, None]
    pmask = (pbits * shift).sum(dim=1, dtype=torch.int32)    # (W, C)
    wmask = pmask > 0

    meta = torch.zeros((W, META_ROWS, cp), dtype=torch.int32, device=dev)
    if pi is not None:
        # the early exit needs the minimum over every candidate still ahead:
        # the ordered DFS is only locally near-first
        entry = torch.cat(entries, dim=1)
        eq = torch.clamp(entry * entry_scale, 0.0, 2.0 ** 30).to(torch.int32)
        eq = torch.where(wmask, eq, 1 << 30)
        meta[:, 3, :] = 1 << 30
        meta[:, 3, :C] = _reverse_cummin(eq)
        meta[:, 4, :C] = idx.to(torch.int32)
    cidx = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    firsts = torch.where(wmask, cidx, cp - 1)
    meta[:, 0, :] = cp - 1
    meta[:, 0, :C] = _reverse_cummin(firsts)
    meta[:, 1, :C] = pmask
    meta[:, 2, 0] = wmask.sum(dim=1, dtype=torch.int32)
    return meta.reshape(W * META_ROWS, cp)


def _reverse_cummin(x):
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def cull_meta(ro, rd, mn, mx, cl_lo, cl_hi, cp, pi=None, entry_scale=None,
              steps=None):
    """Kernel X1 (CUDA tensors) or _cull_meta (CPU tensors), the same meta
    bit for bit. ``steps``, a (4,) int64 CUDA tensor, gets X1's counts
    added to it: its slab tests in the select form and in the plain form,
    its bucket-bounds tests and the slab tests its skipped buckets left
    out (geometry/cull_schedule.py's ``cull_steps`` replays them).

    Replaces vimg_tpu/geometry/packet_trace.py::_cull_meta, an XLA
    function (no Pallas kernel; its plain PyTorch version ran 20 eager ops
    a 128-cluster chunk over (W, 16, 8, 128) temporaries). One block a
    workgroup, a thread a cluster: the workgroup's live rays (minT <=
    maxT) in shared memory, bucketed by the signs of their inverse
    direction, so that a thread picks its box's near and far planes once
    a bucket and a slab test takes 6 min/max instead of 12 (the plain
    min/max form for a warp with a box not ordered on some axis); a warp
    skips a bucket whose bounds (its rays' extent, rounded outward) rule
    out all its 32 boxes; rows 0 and 3 by a block suffix-minimum scan,
    every slot of the meta written by the kernel. What bounds it on this
    card: the float32 operations of the W x C x 128 slab tests. The f2b
    octants come from the PyTorch expression ``_direction_sums`` that the
    plain version uses. See csrc/packet_cull.cu."""
    global LAUNCHES_CULL
    dev = _device_of(ro)
    if dev.type == "cpu":
        if steps is not None:
            raise ValueError("steps are counted by kernel X1 on the card")
        return _cull_meta(ro, rd, mn, mx, cl_lo, cl_hi, cp, pi, entry_scale)
    from vimg_tpu_torch.runtime.cuda import check, load_library
    B, C = ro.shape[0], cl_lo.shape[0]
    if B % WG:
        raise ValueError(f"{B} rays: the cull takes whole workgroups of {WG}")
    if cp % 128 or cp <= C:
        raise ValueError(f"cp {cp}: a multiple of 128 above {C} clusters")
    W = B // WG
    _check(ro, "ro", torch.float32, (B, 3), dev)
    _check(rd, "rd", torch.float32, (B, 3), dev)
    _check(mn, "minT", torch.float32, (B,), dev)
    _check(mx, "maxT", torch.float32, (B,), dev)
    _check(cl_lo, "cl_lo", torch.float32, (C, 3), dev)
    _check(cl_hi, "cl_hi", torch.float32, (C, 3), dev)
    if steps is not None:
        _check(steps, "steps", torch.int64, (4,), dev)
    pi_ptr = sum_ptr = None
    if pi is not None:
        _check(pi, "pi", torch.int64, (8, C), dev)
        sums = _direction_sums(rd)
        pi_ptr, sum_ptr = pi.data_ptr(), sums.data_ptr()
    meta = torch.empty((W * META_ROWS, cp), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vimg_packet_cull(
            ro.data_ptr(), rd.data_ptr(), mn.data_ptr(), mx.data_ptr(),
            cl_lo.data_ptr(), cl_hi.data_ptr(), pi_ptr, sum_ptr, W, C, cp,
            1.0 if entry_scale is None else entry_scale, meta.data_ptr(),
            None if steps is None else steps.data_ptr(), stream)
    check(rc, "vimg_packet_cull")
    LAUNCHES_CULL += W > 0
    return meta


def cull_occupancy(f2b):
    """X1's registers and local bytes a thread, static shared bytes a block
    and resident blocks and warps per SM (slist, or f2b), from
    cudaFuncGetAttributes and the occupancy API."""
    import ctypes
    from vimg_tpu_torch.runtime.cuda import check, load_library
    per_sm, regs, local, smem = (ctypes.c_int() for _ in range(4))
    check(load_library().vimg_packet_cull_occupancy(
        int(f2b), ctypes.byref(per_sm), ctypes.byref(regs),
        ctypes.byref(local), ctypes.byref(smem)),
        "vimg_packet_cull_occupancy")
    return dict(regs=regs.value, local_bytes=local.value,
                smem_bytes=smem.value, blocks_per_sm=per_sm.value,
                warps_per_sm=per_sm.value * WG // 32)


# ---------------------------------------------------------------------------
# the walk: plain version of kernel B5
# ---------------------------------------------------------------------------

def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} "
                         f"({' | '.join(VARIANTS)})")


def _scene_exits(ro, rd, scene_bounds):
    """Per-ray exit t of the scene box (f2b): a ray that has found nothing
    once the front-to-back chain passes its exit never will, so the early
    exit bounds it by this instead of +inf."""
    ex = None
    for a in range(3):
        d = rd[:, a]
        ivd = 1.0 / torch.where(d == 0.0, 1e-30, d)
        m = torch.maximum((scene_bounds[a] - ro[:, a]) * ivd,
                          (scene_bounds[3 + a] - ro[:, a]) * ivd)
        ex = m if ex is None else torch.minimum(ex, m)
    return ex * 1.0001 + 1e-5


def _chains(m, cp):
    """(W, n) candidate slots of each workgroup's chain, chased from row 0
    (entries past a chain's count hold the sentinel cp-1)."""
    W = m.shape[0]
    n = int(m[:, 2, 0].max()) if W else 0
    out = torch.empty((W, n), dtype=torch.int64, device=m.device)
    c = m[:, 0, 0].long()
    for i in range(n):
        out[:, i] = c
        c = m[:, 0, :].gather(1, (c + 1).clamp_max(cp - 1)[:, None])[:, 0]
        c = c.long()
    return out


def _tests_needed(hit, b, n_valid, any_hit):
    """Triangle tests that (packet, cluster) pairs need, for the bound:
    every ray still open (not occluded, not an idle maxT = -inf lane) tests
    its cluster's valid lanes; an any-hit ray stops at its first hit in
    lane order. ``hit``, ``b``: (R, 8, 128); ``n_valid``: (R,)."""
    open_ = ~(b == -float("inf")).any(dim=2)                 # (R, 8)
    n = n_valid[:, None].expand_as(open_)
    if any_hit:
        first = hit.to(torch.uint8).argmax(dim=2) + 1
        n = torch.where(hit.any(dim=2), first, n)
    return int((n * open_).sum())


def packet_walk_plain(tri_t, meta, ro, rd, minT, maxT, n_clusters, any_hit,
                      variant="slist", unroll=4, entry_scale=1.0,
                      scene_bounds=None, stats=None, cl_len=None):
    """Plain version of kernel B5, the semantics of vimg_tpu's packet
    kernel. Rays (N = W*128, in workgroup order), ``meta`` from _cull_meta,
    ``tri_t`` the (C*12, 128) transposed table. Per (ray, lane k) it keeps
    (bt, code), starting at (maxT, -1); for each candidate of the
    workgroup's chain, in order, the rays of every packet whose bit is set
    test triangle k of that cluster with a strict t < bt. ``f2b`` stops
    after each chunk of ``unroll`` candidates once the worst ray's min(best
    t, scene exit) * entry_scale is below the next entry - 1. Returns (t,
    code) float32 per ray: the minimum bt over lanes (-inf for an any-hit)
    and the least code c*128 + k among the lanes at that minimum (-1 for
    none). ``stats`` counts packet_tests (live (packet, cluster) pairs
    walked) and tri_tests (the tests those pairs need: _tests_needed over
    ``cl_len``, the valid lanes per cluster, 128 each when None)."""
    _check_variant(variant)
    N, dev = ro.shape[0], ro.device
    W, P = N // WG, N // 8
    cp = meta.shape[1]
    m = meta.view(W, META_ROWS, cp)
    f2b = variant == "f2b"
    tri = tri_t.view(-1, N_CONST, 128)
    bt = maxT.view(P, 8, 1).expand(P, 8, 128).clone()
    code = torch.full((P, 8, 128), -1.0, device=dev)
    o, d, mnt = ro.view(P, 8, 3), rd.view(P, 8, 3), minT.view(P, 8, 1)
    lane = torch.arange(128, dtype=torch.float32, device=dev)
    bit = torch.arange(N_PACKETS, device=dev)
    count = m[:, 2, 0].long()
    slist = _chains(m, cp)
    ch = max(unroll, 1)
    if f2b:
        exits = _scene_exits(ro, rd, scene_bounds).view(W, WG)
    running = torch.ones(W, dtype=torch.bool, device=dev)
    n_pairs = n_tests = 0
    if stats is not None:
        n_valid = (torch.full((tri.shape[0],), 128, device=dev)
                   if cl_len is None
                   else torch.as_tensor(cl_len, device=dev).long())
    for i in range(slist.shape[1]):
        w = torch.nonzero(running & (i < count))[:, 0]
        cs = slist[w, i]
        rid = m[w, 4, cs].long() if f2b else cs
        live = ((m[w, 1, cs][:, None] >> bit) & 1) > 0       # (|w|, 16)
        wi, pj = torch.nonzero(live, as_tuple=True)
        pk = w[wi] * N_PACKETS + pj
        n_pairs += pk.numel()
        if pk.numel():
            r = rid[wi]
            rc = r.clamp_max(n_clusters - 1)
            rows = tri[rc]                                   # (R, 12, 128)
            nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z, c2 = (
                rows[:, j:j + 1, :] for j in range(N_CONST))
            op, dp = o[pk], d[pk]
            ox, oy, oz = op[..., 0:1], op[..., 1:2], op[..., 2:3]
            dx, dy, dz = dp[..., 0:1], dp[..., 1:2], dp[..., 2:3]
            b = bt[pk]
            ro_n = ox * nx + oy * ny + oz * nz
            rd_n = dx * nx + dy * ny + dz * nz
            par = rd_n.abs() < 1e-22
            t = (d0 - ro_n) / torch.where(par, 1.0, rd_n)
            u = (ox * m1x + oy * m1y + oz * m1z - c1
                 + t * (dx * m1x + dy * m1y + dz * m1z))
            v = (ox * m2x + oy * m2y + oz * m2z - c2
                 + t * (dx * m2x + dy * m2y + dz * m2z))
            hit = (~par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t >= mnt[pk]) & (t < b))
            if stats is not None:
                n_tests += _tests_needed(hit, b, n_valid[rc], any_hit)
            if any_hit:
                bt[pk] = torch.where(hit, -float("inf"), b)
            else:
                bt[pk] = torch.where(hit, t, b)
                cbase = (r * 128).to(torch.float32)[:, None, None]
                code[pk] = torch.where(hit, cbase + lane, code[pk])
        if f2b and (i + 1) % ch == 0 and i + 1 < slist.shape[1]:
            # workgroups with candidates left: worst best-t against the next
            # candidate's conservative entry distance
            w = torch.nonzero(running & (i + 1 < count))[:, 0]
            bound = torch.minimum(bt.view(W, WG, 128)[w].amin(dim=2),
                                  exits[w])
            worst = bound.amax(dim=1)
            nxt_e = m[w, 3, slist[w, i + 1]]
            stop = worst * entry_scale < (nxt_e - 1).to(torch.float32)
            running[w[stop]] = False
    if stats is not None:
        stats["packet_tests"] = stats.get("packet_tests", 0) + n_pairs
        stats["tri_tests"] = stats.get("tri_tests", 0) + n_tests
    btmin = bt.amin(dim=2, keepdim=True)
    win = torch.where(bt == btmin, code, float("inf")).amin(dim=2)
    return btmin.reshape(N), win.reshape(N)


# ---------------------------------------------------------------------------
# kernel wrapper (B5)
# ---------------------------------------------------------------------------

def trace_packet(tri_t, meta, ro, rd, minT, maxT, n_clusters, any_hit,
                 variant="slist", unroll=4, entry_scale=1.0,
                 scene_bounds=None, steps=None):
    """Kernel B5 (CUDA tensors) or packet_walk_plain (CPU tensors).

    Replaces vimg_tpu/geometry/packet_trace.py::_make_packet_kernel. A warp
    owns its packets (one for slist, four for f2b) and runs their live
    (candidate, packet) pairs in chain order: lane (ray lane & 7, quarter
    lane >> 3) tests triangles 4 kk + q, reading their constants from L2,
    and keeps its (ray, quarter)'s best t, code and mask; the quarters
    merge at the end by the plain rule. ``steps``, a (1,) int64 CUDA
    tensor, gets the warp test steps run added to it (the lane fill is the
    plain count of needed tests / (32 x steps)). What bounds it on this
    card: float32 operations of the needed triangle tests (bound_ms in
    chip_smoke.py). See csrc/packet_trace.cu."""
    global LAUNCHES
    _check_variant(variant)
    dev = _device_of(ro)
    if dev.type == "cpu":
        return packet_walk_plain(tri_t, meta, ro, rd, minT, maxT, n_clusters,
                                 any_hit, variant, unroll, entry_scale,
                                 scene_bounds)
    from vimg_tpu_torch.runtime.cuda import check, load_library
    N = ro.shape[0]
    if N % WG:
        raise ValueError(f"{N} rays: the walk takes whole workgroups of {WG}")
    cp = meta.shape[1] if meta.dim() == 2 else -1
    if cp <= n_clusters:
        raise ValueError(f"meta needs more than {n_clusters} slots per row")
    _check(tri_t, "tri_t", torch.float32, (n_clusters * N_CONST, 128), dev)
    _check(meta, "meta", torch.int32, (N // WG * META_ROWS, cp), dev)
    _check(ro, "ro", torch.float32, (N, 3), dev)
    _check(rd, "rd", torch.float32, (N, 3), dev)
    _check(minT, "minT", torch.float32, (N,), dev)
    _check(maxT, "maxT", torch.float32, (N,), dev)
    if steps is not None:
        _check(steps, "steps", torch.int64, (1,), dev)
    t = torch.empty((N,), dtype=torch.float32, device=dev)
    code = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return t, code
    f2b = variant == "f2b"
    bounds = tuple(scene_bounds) if f2b else (0.0,) * 6
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vimg_packet_trace(
            tri_t.data_ptr(), meta.data_ptr(), ro.data_ptr(), rd.data_ptr(),
            minT.data_ptr(), maxT.data_ptr(), N, cp, n_clusters,
            int(any_hit), int(f2b), max(unroll, 1), entry_scale, *bounds,
            t.data_ptr(), code.data_ptr(),
            None if steps is None else steps.data_ptr(), stream)
    check(rc, "vimg_packet_trace")
    LAUNCHES += 1
    return t, code


# ---------------------------------------------------------------------------
# tracer facade
# ---------------------------------------------------------------------------

class PacketTracer:
    """Mesh tracer: the cull X1 and kernel B5 (their plain versions on the
    CPU) for the triangles, plus a dense test of the scene's spheres,
    merged by least t. Same contract as ClusterTracer; arguments as
    vimg_tpu's PacketTracer, plus ``plain=True`` (the plain cull and walk
    on any device: the kernels' reference on the card) and ``data`` (the
    PacketData of another tracer of the same scene). Scenes whose packed
    triangle table exceeds VMEM_BUDGET_BYTES are refused, as vimg_tpu
    refuses them, so both packages accept the same scenes."""

    VMEM_BUDGET_BYTES = 10 * 2 ** 20
    # traversal inputs are detached (zero-tangent semantics)
    differentiable = True

    def __init__(self, scene: ir.Scene, max_k=PACK_K, sort_rays=True,
                 sort_mode="origin", builder="auto", variant="slist",
                 unroll=4, plain=False, data=None):
        dev = scene.device
        if dev.type not in ("cpu", "cuda"):
            raise NotImplementedError(f"no packet walk for device {dev}")
        _check_variant(variant)
        self.data = data or PacketData(scene, max_k=max_k, builder=builder)
        if self.data.tri_rows_t.nbytes > self.VMEM_BUDGET_BYTES:
            raise ValueError(
                f"packed tri table {self.data.tri_rows_t.nbytes >> 20} MB "
                f"exceeds the packet kernel's VMEM budget — use "
                f"ClusterTracer (streaming) for this scene")
        self.sort_rays = sort_rays
        self.sort_mode = sort_mode
        self.variant = variant
        self.unroll = unroll
        self.plain = plain
        C = self.data.n_clusters
        # next-pointer rows need a sentinel slot past the last cluster
        self.cp = -(-(C + 1) // 128) * 128
        self.pi = torch.from_numpy(
            self.data.octant_orders().astype(np.int64)).to(dev)
        # entry distances in 2^21 quanta across the scene diagonal
        diag = float(np.linalg.norm(self.data.scene_hi
                                    - self.data.scene_lo)) or 1.0
        self.entry_scale = float(2.0 ** 21) / (4.0 * diag)
        self.scene_bounds = tuple(float(v) for v in np.concatenate(
            [self.data.scene_lo, self.data.scene_hi]))
        self.bounds = (torch.from_numpy(self.data.scene_lo).to(dev),
                       torch.from_numpy(self.data.scene_hi).to(dev))
        self.tri_t = torch.from_numpy(self.data.tri_rows_t).to(dev)
        self.cl_lo = torch.from_numpy(self.data.cl_lo).to(dev)
        self.cl_hi = torch.from_numpy(self.data.cl_hi).to(dev)
        self.perm = torch.from_numpy(self.data.perm.astype(np.int64)).to(dev)
        _, self.sph_c = build_constants(scene)
        self.verts = scene.verts
        self.tri_vidx = scene.tri_vidx.long()

    def pack(self, ro, rd, minT, maxT):
        """The rays in the walk's order and shape: Morton-sorted (stable)
        above one workgroup, padded to whole workgroups with rd = 1 and
        maxT = -inf (never live in the cull, never a hit). Returns (order or
        None, (ro, rd, minT, maxT))."""
        B = ro.shape[0]
        ro, rd = ro.detach().contiguous(), rd.detach().contiguous()
        minT = minT.detach().expand(B).contiguous()
        maxT = maxT.detach().expand(B).contiguous()
        order = None
        if self.sort_rays and B > WG:
            key = ray_sort_key(ro, rd, *self.bounds, mode=self.sort_mode)
            order = torch.argsort(key, stable=True)
            ro, rd, minT, maxT = ro[order], rd[order], minT[order], maxT[order]
        n = -(-B // WG) * WG - B

        def pad(x, fill):
            return torch.cat([x, torch.full((n, *x.shape[1:]), fill,
                                            dtype=x.dtype, device=x.device)])

        return order, (pad(ro, 0.0), pad(rd, 1.0), pad(minT, 0.0),
                       pad(maxT, -float("inf")))

    def cull(self, rays):
        """meta of the packed rays for this tracer's variant: kernel X1
        (``cull_meta``) on CUDA, the plain cull on the CPU and whenever
        ``plain=True``."""
        f2b = self.variant == "f2b"
        fn = _cull_meta if self.plain else cull_meta
        return fn(*rays, self.cl_lo, self.cl_hi, self.cp,
                  pi=self.pi if f2b else None, entry_scale=self.entry_scale)

    def walk_args(self, any_hit):
        """Arguments of trace_packet / packet_walk_plain after the rays."""
        return (self.data.n_clusters, any_hit, self.variant, self.unroll,
                self.entry_scale, self.scene_bounds)

    def _run(self, ro, rd, minT, maxT, any_hit):
        """(best t, code) per ray in the caller's order."""
        B = ro.shape[0]
        order, rays = self.pack(ro, rd, minT, maxT)
        meta = self.cull(rays)
        walk = packet_walk_plain if self.plain else trace_packet
        bt, code = walk(self.tri_t, meta, *rays, *self.walk_args(any_hit))
        bt, code = bt[:B], code[:B]
        if order is not None:
            bt = torch.empty_like(bt).index_put_((order,), bt)
            code = torch.empty_like(code).index_put_((order,), code)
        return bt, code

    # the same zero-tangent traversal as ClusterTracer's
    def closest(self, scene, ro, rd, minT, maxT) -> HitResult:
        ro, rd, minT, maxT = detached_rays(ro, rd, minT, maxT)
        bt, code = self._run(ro, rd, minT, maxT, any_hit=False)
        found = code >= 0.0
        slot = code.long().clamp(0, self.perm.shape[0] - 1)
        tri_id = self.perm[slot]
        # barycentrics of the winning triangle, solved in its plane (not the
        # walk's dual-basis values); u weighs p0 as in soa_intersect
        vidx = self.tri_vidx[tri_id.clamp(0, self.tri_vidx.shape[0] - 1)]
        p0 = self.verts[vidx[:, 0]]
        p1 = self.verts[vidx[:, 1]]
        p2 = self.verts[vidx[:, 2]]
        hp = ro + rd * torch.where(found, bt, 0.0)[:, None]
        e1, e2, q = p1 - p0, p2 - p0, hp - p0
        d11 = (e1 * e1).sum(dim=1)
        d12 = (e1 * e2).sum(dim=1)
        d22 = (e2 * e2).sum(dim=1)
        q1 = (q * e1).sum(dim=1)
        q2 = (q * e2).sum(dim=1)
        det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-30)
        lam1 = (d22 * q1 - d12 * q2) / det       # weight of p1
        lam2 = (d11 * q2 - d12 * q1) / det       # weight of p2
        zero = torch.zeros_like(bt)
        hr = HitResult(
            t=torch.where(found, bt, float("inf")),
            prim_type=torch.full(bt.shape, ir.PRIM_TRI, dtype=torch.int64,
                                 device=bt.device),
            prim_id=torch.where(found, tri_id, 0),
            u=torch.where(found, 1.0 - lam1 - lam2, zero),
            v=torch.where(found, lam1, zero))
        if self.sph_c is not None:
            hr = merge_spheres(self.sph_c, hr, ro, rd, minT, maxT)
        return hr

    def occluded(self, scene, ro, rd, minT, maxT):
        """Any hit in [minT, maxT); lanes with maxT = -inf report True, as
        in vimg_tpu (bt == -inf)."""
        ro, rd, minT, maxT = detached_rays(ro, rd, minT, maxT)
        bt, _ = self._run(ro, rd, minT, maxT, any_hit=True)
        occ = bt == -float("inf")
        if self.sph_c is not None:
            occ = occ | _trace_impl(None, self.sph_c, ro, rd, minT, maxT, True)
        return occ
