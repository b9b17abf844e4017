"""Sweep-SAH BVH build on the device (port of
vimg_tpu.geometry.device_build).

The reference's sweep builder (runtime/bvh_builder.cpp mode=1) recurses
node by node: sort the node's primitives per axis, sweep prefix and suffix
SAH costs, split at the least. This build is level-synchronous instead:
every level advances ALL active segments (contiguous ranges of the
primitive order) one split, with

  - one stable 2-key sort per axis, (segment start, centroid), so the
    primitives of a segment stay contiguous;
  - the per-axis SAH sweep, ``sah_sweep``: segmented prefix and suffix
    min / max scans of the sorted boxes, the split cost at every position
    and, per segment, its least cost and the least left count that
    reaches it (kernel X3 on CUDA tensors, ``sah_sweep_plain`` on CPU
    tensors);
  - the leaf rule and the median fallback per segment, and one last sort
    that applies each segment's winning axis.

The SAH model (half area x count, costs 1 / 0.5, leaf size 8, the
split-versus-leaf rule) and the tie-breaking (the earlier axis, then the
least left count) are vimg_tpu's, operation for operation. The level loop
emits a per-level table of segment starts; the tree and its skip links
are assembled from it on the host in numpy, as vimg_tpu does.

``build_sweep_sah_device(..., device=)`` runs the level loop on the given
device (the card by default): the sorts, the leaf rule and the apply are
tensor code there, the sweep is X3. On the CPU the whole loop is the plain
version. Both round every product on its own (no fused multiply-add), as
vimg_tpu's build computes as written, so the card's tree equals the CPU's
bit for bit.

Ties in the sorts. ``lax.sort`` treats -0.0 and +0.0 as equal and sorts
NaN last; a stable ``torch.sort`` on the CPU does the same, but the card's
radix sort orders -0.0 before +0.0 and a NaN with its sign bit set before
-inf. So the centroid keys are canonicalised first (``x + 0.0`` turns -0.0
into +0.0; every NaN becomes the positive quiet NaN), which changes no
order that ``lax.sort`` gives. A stable sort by centroid, then a stable
sort by segment start, gives the stable 2-key order: ties keep their
current position.

Non-finite boxes. Scene primitives give finite boxes. A NaN in a box makes
the SAH cost of every split whose side holds it NaN; a segment whose least
cost is NaN never wins an axis (NaN < x is false), as in vimg_tpu, and the
tree still builds (tests/test_torch_device_build.py holds one such soup to
vimg_tpu's tree).
"""
from __future__ import annotations

import time

import numpy as np
import torch

COST_INTERSECT = 1.0   # reference BVHConst::intersection_cost
COST_TRAVERSE = 0.5    # reference BVHConst::traversal_cost
LEAF_SIZE = 8
# jax.ops.segment_min's value at a slot no segment starts at (int32)
EMPTY_J = 2 ** 31 - 1
INF = float("inf")

# csrc/sah_sweep.cu: positions a chunk, and float32 words of scratch a
# chunk (room for a tile's two aggregates, 2 x 8, and the chunk's suffix
# aggregate or right carry, 8); the 64-bit keys take 2 words a position
SWEEP_CHUNK = 1024
SCRATCH_PER_CHUNK = 24

LAUNCHES = 0           # X3 launches, counted by sah_sweep
# timings of the latest build_sweep_sah_device: P, levels (run), max_levels,
# nodes, level_seconds (the loop, synchronised), assembly_seconds (host)
LAST_STATS = None


# ---------------------------------------------------------------------------
# the per-axis sweep: kernel X3's plain version
# ---------------------------------------------------------------------------

def _seg_scan(flags, lo, hi):
    """Segmented running (min lo, max hi) along dim 0: ``flags`` marks the
    segment starts. ceil(log2 P) shifted passes of the segmented-scan
    monoid (vimg_tpu's ``associative_scan``); min and max are exact in any
    association and propagate NaN."""
    f, lo, hi = flags.clone(), lo.clone(), hi.clone()
    P, k = f.shape[0], 1
    while k < P:
        keep = ~f[k:, None]
        lo_n, hi_n, f_n = lo.clone(), hi.clone(), f.clone()
        lo_n[k:] = torch.where(keep, torch.minimum(lo[:-k], lo[k:]), lo[k:])
        hi_n[k:] = torch.where(keep, torch.maximum(hi[:-k], hi[k:]), hi[k:])
        f_n[k:] = f[:-k] | f[k:]
        lo, hi, f = lo_n, hi_n, f_n
        k *= 2
    return lo, hi


def _seg_flags(seg_s):
    """(starts, ends) of the contiguous runs of equal segment starts."""
    one = torch.ones(1, dtype=torch.bool, device=seg_s.device)
    starts = torch.cat([one, seg_s[1:] != seg_s[:-1]])
    return starts, torch.cat([starts[1:], one])


def _half_sa(lo, hi):
    """d0 d1 + d0 d2 + d1 d2 of d = max(hi - lo, 0), each product rounded
    on its own. A -0.0 difference gives +0.0 (jnp.maximum may keep either
    zero; the sign of a zero cost changes no comparison) and NaN stays."""
    x = hi - lo
    d = torch.where(x > 0, x, torch.where(torch.isnan(x), x, 0.0))
    return d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2]


def sah_sweep_plain(seg_s, lo, hi):
    """Plain version of kernel X3: for one axis of one level, the segment
    start of each sorted position ``seg_s`` ((P,) int32) and the boxes
    ``lo``, ``hi`` ((P, 3) float32) in that order. Returns (seg_cost,
    seg_j), (P,) float32 and int32 indexed by segment-start slot: the
    least split cost of the segment (sa_l nl + sa_r nr after each
    position, INF where nothing lies to the right) and the least left count
    nl whose cost equals it; INF and EMPTY_J at slots that start no
    segment. vimg_tpu/geometry/device_build.py:104-134, op for op."""
    P = seg_s.shape[0]
    dev = seg_s.device
    seg = seg_s.long()
    pos = torch.arange(P, device=dev)
    starts, ends = _seg_flags(seg)
    lo_l, hi_l = _seg_scan(starts, lo, hi)
    lo_r, hi_r = (x.flip(0) for x in _seg_scan(ends.flip(0), lo.flip(0),
                                                hi.flip(0)))
    # the segment's end: its last position + 1 (a reverse running max)
    seg_end = torch.zeros(P, dtype=torch.long, device=dev).scatter_reduce(
        0, seg, pos + 1, "amax", include_self=False)[seg]
    nl = pos - seg + 1
    nr = seg_end - pos - 1
    sa_l = _half_sa(lo_l, hi_l)
    # the right side starts at pos + 1: the suffix scan shifted by one
    sa_r = _half_sa(torch.roll(lo_r, -1, 0), torch.roll(hi_r, -1, 0))
    cost = sa_l * nl.to(torch.float32) + sa_r * nr.to(torch.float32)
    cost = torch.where(nr > 0, cost, INF)
    seg_cost = torch.full((P,), INF, device=dev).scatter_reduce(
        0, seg, cost, "amin", include_self=True)
    j_here = torch.where(cost == seg_cost[seg], nl, P + 1).to(torch.int32)
    seg_j = torch.full((P,), EMPTY_J, dtype=torch.int32,
                       device=dev).scatter_reduce(0, seg, j_here, "amin",
                                                  include_self=True)
    return seg_cost, seg_j


def sah_sweep(seg_s, lo, hi):
    """Kernel X3 (CUDA tensors) or sah_sweep_plain (CPU tensors).

    Replaces the scans and segment minima of one axis in
    vimg_tpu/geometry/device_build.py::_level (XLA, not Pallas). Torch has
    no segmented scan: the plain version makes about 17 passes over six
    columns in each direction at P = 100,000. X3 (csrc/sah_sweep.cu) is
    one cooperative launch on the current stream, its blocks all resident
    and separated into three phases by grid barriers: each block's tile of
    1,024-position chunks gets its segmented (min, max) aggregates in both
    directions (the tile's inputs kept in shared memory where they fit);
    each tile's carries come from a look-back over the other tiles'
    aggregates, 256 tiles a step, stopping at the first that holds a
    boundary of the segment crossing in; each chunk is rescanned with its
    carries, every position's cost computed, and each segment's least
    (cost, nl), packed into one 64-bit key, taken by a segmented block
    scan and one atomicMin a segment and chunk; the keys are decoded into
    the outputs. Min and max are exact in any order, every product is
    rounded on its own (__fmul_rn / __fadd_rn), and an atomic minimum is
    order-free, so X3 equals the plain version bit for bit (a NaN cost
    makes its segment's minimum NaN and its nl P + 1 in both; NaN payloads
    aside). A refused cooperative launch raises; there is no other launch
    to fall back on. Its bound is bytes (seg_s and six floats a position
    read, two outputs written). geometry/sweep_schedule.py replays the
    decomposition on the CPU."""
    global LAUNCHES
    dev = seg_s.device
    if dev.type == "cpu":
        return sah_sweep_plain(seg_s, lo, hi)
    if dev.type != "cuda":
        raise NotImplementedError(f"no SAH sweep for device {dev}")
    from vimg_tpu_torch.geometry.cluster_trace import _check
    from vimg_tpu_torch.runtime.cuda import check, load_library
    P = seg_s.shape[0]
    _check(seg_s, "seg_s", torch.int32, (P,), dev)
    _check(lo, "lo", torch.float32, (P, 3), dev)
    _check(hi, "hi", torch.float32, (P, 3), dev)
    if not 0 < P < 2 ** 30:
        raise ValueError(f"P = {P} out of range")
    # X3 reads 16-byte vectors from the start of each input
    seg_s, lo, hi = (x if x.data_ptr() % 16 == 0 else x.clone()
                     for x in (seg_s, lo, hi))
    seg_cost = torch.empty(P, dtype=torch.float32, device=dev)
    seg_j = torch.empty(P, dtype=torch.int32, device=dev)
    lib = load_library()
    n_chunks = -(-P // SWEEP_CHUNK)
    # the tiles' and chunks' aggregates, then each slot's 64-bit key
    scratch = torch.empty(n_chunks * SCRATCH_PER_CHUNK + 2 * P,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vimg_sah_sweep(seg_s.data_ptr(), lo.data_ptr(),
                                hi.data_ptr(), P, seg_cost.data_ptr(),
                                seg_j.data_ptr(), scratch.data_ptr(), stream)
    check(rc, "vimg_sah_sweep")
    LAUNCHES += 1
    return seg_cost, seg_j


def sweep_plan(P, device="cuda"):
    """The launch X3 makes for P positions on ``device``: its grid (the
    tiles), chunks a tile, dynamic shared memory bytes (0 where the tiles
    are not staged), resident blocks a multiprocessor at that memory, and
    registers a thread."""
    import ctypes
    from vimg_tpu_torch.runtime.cuda import check, load_library
    out = [ctypes.c_int() for _ in range(5)]
    with torch.cuda.device(torch.device(device)):
        rc = load_library().vimg_sah_sweep_plan(
            P, *(ctypes.byref(x) for x in out))
    check(rc, "vimg_sah_sweep_plan")
    return dict(zip(("grid", "tile_chunks", "smem_bytes", "per_sm", "regs"),
                    (x.value for x in out)))


# ---------------------------------------------------------------------------
# one level
# ---------------------------------------------------------------------------

def _sort_key(x):
    """Centroid keys that every stable sort here orders as lax.sort does:
    -0.0 -> +0.0, every NaN -> the positive quiet NaN."""
    return torch.where(torch.isnan(x), float("nan"), x + 0.0)


def _stable_argsort(key):
    return torch.sort(key, stable=True).indices


def _seg_bounds(seg, lo, hi):
    """Each segment's (min lo, max hi) at its start slot (the reverse
    segmented scan read at the segment's start, as a segment reduction)."""
    P = seg.shape[0]
    idx = seg[:, None].expand(P, 3)
    s_lo = lo.clone().scatter_reduce(0, idx, lo, "amin", include_self=False)
    s_hi = hi.clone().scatter_reduce(0, idx, hi, "amax", include_self=False)
    return s_lo, s_hi


def _level(bmin, bmax, cen, order, seg_start, done, sweep):
    """Advance every active segment one split; vimg_tpu's ``_level``.
    Returns the updated (order, seg_start, done)."""
    P = order.shape[0]
    dev = order.device
    pos = torch.arange(P, device=dev)
    best_cost = torch.full((P,), INF, device=dev)   # per segment-start slot
    best_axis = torch.full((P,), -1, dtype=torch.long, device=dev)
    best_j = torch.full((P,), -1, dtype=torch.long, device=dev)
    axis_pos = []
    for axis in range(3):
        key = _sort_key(cen[order, axis])
        by_cen = _stable_argsort(key)
        perm = by_cen[_stable_argsort(seg_start[by_cen])]
        seg_s = seg_start[perm]
        order_a = order[perm]
        seg_min, seg_jmin = sweep(seg_s.to(torch.int32).contiguous(),
                                  bmin[order_a].contiguous(),
                                  bmax[order_a].contiguous())
        # earlier axis wins ties (strict <)
        improved = seg_min < best_cost
        best_j = torch.where(improved, seg_jmin.long(), best_j)
        best_axis = torch.where(improved, axis, best_axis)
        best_cost = torch.where(improved, seg_min, best_cost)
        # each primitive's position in this axis's order
        axis_pos.append(torch.empty_like(pos).scatter_(0, order_a, pos))

    # the leaf rule, per segment (indexed by segment start slot)
    seg = seg_start
    s_lo, s_hi = _seg_bounds(seg, bmin[order], bmax[order])
    seg_end = torch.zeros(P, dtype=torch.long, device=dev).scatter_reduce(
        0, seg, pos + 1, "amax", include_self=False)[seg]
    n_here = seg_end - seg
    sa_node = torch.maximum(_half_sa(s_lo, s_hi),
                            torch.tensor(1e-12, device=dev))
    cmin_here = best_cost[seg]
    split_cost = COST_TRAVERSE + COST_INTERSECT * cmin_here / sa_node[seg]
    leaf_small = n_here <= 1
    no_split = ~torch.isfinite(cmin_here)
    sah_leaf = ((split_cost >= COST_INTERSECT * n_here.to(torch.float32))
                & (n_here <= LEAF_SIZE))
    new_done = (done | leaf_small | (no_split & (n_here <= LEAF_SIZE))
                | (~no_split & sah_leaf))
    # no finite split and more than LEAF_SIZE: the median on axis 0
    force_median = ~new_done & no_split
    axis_sel = torch.where(force_median, 0, best_axis[seg])
    j_split = torch.where(force_median, n_here // 2, best_j[seg])

    # apply: resort the split segments on their winning axis; done
    # segments keep their order (key = current position)
    ap = torch.stack(axis_pos)[:, order]
    key = torch.where(new_done, pos,
                      torch.where(axis_sel == 0, ap[0],
                                  torch.where(axis_sel == 1, ap[1], ap[2])))
    perm = _stable_argsort(key)
    order_new = order[perm]
    segs_new = seg[perm]
    done_new = new_done[perm]
    j_new = j_split[perm]
    # the left part keeps its start, the right one starts at start + j
    go_right = ~done_new & (pos - segs_new >= j_new)
    return order_new, torch.where(go_right, segs_new + j_new, segs_new), \
        done_new


def max_levels_for(P):
    """vimg_tpu's level budget: max(2 ceil(log2 P) + 8, 12)."""
    return max(2 * int(np.ceil(np.log2(max(P, 2)))) + 8, 12)


def build_levels(bmin, bmax, cen, max_levels, sweep=sah_sweep):
    """The level loop on the tensors' device. Returns (order, seg_hist,
    done): the final primitive order, the (levels, P) segment starts after
    each level and each position's done flag. The loop stops after the
    level at which every segment is done (vimg_tpu's ``lax.scan`` runs all
    ``max_levels``: the later levels change nothing, so the tree is the
    same); ``sweep`` is the per-axis sweep (X3 or its plain version)."""
    P = bmin.shape[0]
    dev = bmin.device
    order = torch.arange(P, device=dev)
    seg_start = torch.zeros(P, dtype=torch.long, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    hist = []
    for _ in range(max_levels):
        order, seg_start, done = _level(bmin, bmax, cen, order, seg_start,
                                        done, sweep)
        hist.append(seg_start)
        if bool(done.all()):
            break
    return order, torch.stack(hist), done


def assemble(order, seg_hist, bmin, bmax):
    """The tree from the per-level segment tables (host numpy,
    vimg_tpu/geometry/device_build.py:232-286 as it is): the same dict as
    bvh.build_bvh_numpy."""
    P = order.shape[0]
    node_min, node_max = [], []
    node_start, node_count, node_right = [], [], []

    def new_node(s, e):
        sel = order[s:e]
        node_min.append(bmin[sel].min(axis=0))
        node_max.append(bmax[sel].max(axis=0))
        node_start.append(0)
        node_count.append(0)
        node_right.append(-1)
        return len(node_min) - 1

    L = seg_hist.shape[0]
    stack = [(0, P, 0, -1, False)]           # (s, e, level, parent, right?)
    while stack:
        s, e, lev, parent, is_right = stack.pop()
        idx = new_node(s, e)
        if parent >= 0 and is_right:
            node_right[parent] = idx
        # the first level where this range splits
        mid = None
        for lv in range(lev, L):
            nz = np.nonzero(seg_hist[lv, s:e] != s)[0]
            if nz.size:
                mid = int(nz[0])
                lev_next = lv + 1
                break
        if mid is None or e - s <= 1:
            node_start[idx] = s
            node_count[idx] = e - s
            continue
        stack.append((s + mid, e, lev_next, idx, True))
        stack.append((s, s + mid, lev_next, idx, False))

    N = len(node_min)
    node_count_arr = np.asarray(node_count, np.int32)
    node_right_arr = np.asarray(node_right, np.int32)
    node_skip = np.full(N, N, np.int32)
    st = [(0, N)]
    while st:
        i, skip = st.pop()
        node_skip[i] = skip
        if node_count_arr[i] == 0:
            r = node_right_arr[i]
            st.append((i + 1, r))
            st.append((r, skip))
    return dict(node_min=np.stack(node_min).astype(np.float32),
                node_max=np.stack(node_max).astype(np.float32),
                node_start=np.asarray(node_start, np.int32),
                node_count=node_count_arr,
                node_skip=node_skip, order=order.astype(np.int32),
                node_right=node_right_arr)


def sah_cost(built):
    """The SAH cost of a built tree (float64): traversal cost x half area
    of each inner node plus intersection cost x count x half area of each
    leaf, over the root's half area."""
    d = np.maximum(built["node_max"].astype(np.float64)
                   - built["node_min"].astype(np.float64), 0.0)
    a = d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2]
    leaf = built["node_count"] > 0
    return float((COST_TRAVERSE * a[~leaf].sum()
                  + COST_INTERSECT * (a[leaf] * built["node_count"][leaf])
                  .sum()) / max(a[0], 1e-300))


def build_sweep_sah_device(bmin, bmax, centers, max_levels=None,
                           device="cuda"):
    """Sweep-SAH build with the sorts and sweeps on ``device`` (the card by
    default; "cpu" runs the plain version). Returns the same dict as
    bvh.build_bvh_numpy;
    raises RuntimeError if the build does not converge in ``max_levels``
    (default: vimg_tpu's budget, max_levels_for(P)). Its timings land in
    LAST_STATS."""
    global LAST_STATS
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("builder='device' runs on the card by default and "
                           "torch.cuda.is_available() is false (pass "
                           "device='cpu' for the plain version)")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no device build for device {dev}")
    P = bmin.shape[0]
    if max_levels is None:
        max_levels = max_levels_for(P)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    t0 = time.time()
    order, seg_hist, done = build_levels(t(bmin), t(bmax), t(centers),
                                         max_levels)
    order = order.cpu().numpy()
    seg_hist = seg_hist.cpu().numpy()         # synchronises the device
    levels_s = time.time() - t0
    if not bool(done.all()):
        raise RuntimeError("device BVH build did not converge; raise "
                           "max_levels")
    t0 = time.time()
    built = assemble(order, seg_hist, np.asarray(bmin), np.asarray(bmax))
    LAST_STATS = dict(P=P, levels=int(seg_hist.shape[0]),
                      max_levels=max_levels,
                      nodes=int(built["node_count"].shape[0]),
                      level_seconds=levels_s,
                      assembly_seconds=time.time() - t0)
    return built
