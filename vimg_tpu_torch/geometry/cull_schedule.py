"""The work of kernel X1, the packet cull (``csrc/packet_cull.cu``),
replayed in plain PyTorch: what its counted launch (``packet_trace.
cull_meta(..., steps=)``) adds up, without running the slab tests.

X1 runs a block a workgroup of 128 rays and a thread a cluster column,
128 columns a chunk (cp columns, those from C on past the clusters). The
workgroup's live rays (minT <= maxT) go into eight buckets by the sign
bits of 1/d, and each bucket keeps its extent: the least and most o and
1/d per axis, the least minT and the most maxT, and whether a ray of it
has a non-finite o or 1/d (an unsafe bucket). A warp of 32 columns whose
boxes are all ordered (lo <= hi on every axis) takes each non-empty
bucket in turn: each column below C that the bucket is safe for runs the
bounds test (``misses``, the kernel's, with its directed roundings), and
the warp runs the bucket's slab tests on every lane when some column
below C needs them (the bucket is unsafe or its bounds do not rule the
box out), else skips them. A warp with a box not ordered tests every live
ray in the plain min/max form. Counted over the columns below C:

- ``select_tests``: slab tests run in the select form (near and far
  planes picked once a bucket: 6 subtracts, 6 multiplies, 6 min/max and
  a compare, ``SELECT_TEST_OPS``);
- ``plain_tests``: slab tests run in the plain form (12 min/max,
  ``cluster_trace.BOX_TEST_OPS``);
- ``bound_tests``: bounds tests run (per axis 2 subtracts, 2 multiplies,
  a max and a min, and a compare: ``BOUND_TEST_OPS``);
- ``skipped_tests``: slab tests a skipped bucket left out.

``select_tests + plain_tests + skipped_tests`` is live rays x C over the
workgroups: every (live ray, cluster) pair the plain cull tests.
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.geometry import cluster_trace as ct
from vimg_tpu_torch.geometry import packet_trace as pt

WARP = 32
N_OCT = 8
SELECT_TEST_OPS = 19
BOUND_TEST_OPS = 19
KEYS = ("select_tests", "plain_tests", "bound_tests", "skipped_tests")


def round32(x, up, err=None):
    """float64 ``x`` (plus a much smaller ``err``, the part of an exact
    result that x could not hold) to float32, rounded toward +inf (up) or
    -inf: the kernel's __fsub_ru / __fmul_rd and so on."""
    f = x.to(torch.float32)
    f64 = f.double()
    if err is None:
        err = torch.zeros_like(x)
    wrong = ((f64 < x) | ((f64 == x) & (err > 0)) if up
             else (f64 > x) | ((f64 == x) & (err < 0)))
    step = torch.full_like(f, float("inf") if up else -float("inf"))
    return torch.where(wrong, torch.nextafter(f, step), f)


def sub32(a, b, up):
    """fl(a - b) of float32 tensors, rounded toward +inf (up) or -inf:
    the float64 difference and its exact error (TwoSum), then rounded."""
    a, nb = a.double(), -b.double()
    s = a + nb
    bp = s - a
    err = torch.nan_to_num((a - (s - bp)) + (nb - bp), nan=0.0)
    return round32(s, up, err)


def mul32(a, b, up):
    """fl(a * b) of float32 tensors, rounded toward +inf (up) or -inf (the
    float64 product of two float32 is exact)."""
    return round32(a.double() * b.double(), up)


def misses(o, near, far, omin, omax, imin, imax, tmin, tmax):
    """The kernel's bounds test: True where no ray of a bucket of octant
    ``o`` (bit a: 1/d <= 0 on axis a) can meet the box whose planes for
    the bucket's signs are ``near`` / ``far`` (..., 3). The bucket's
    extent (omin, omax, imin, imax (..., 3); tmin, tmax (...)) broadcasts
    against the boxes. The least tin the bounds allow is rounded down and
    the most tout up; a NaN rules nothing out."""
    lo, hi = tmin.expand(near.shape[:-1]), tmax.expand(near.shape[:-1])
    for a in range(3):
        if (o >> a) & 1:
            an = sub32(near[..., a], omin[..., a], up=True)
            af = sub32(far[..., a], omax[..., a], up=False)
        else:
            an = sub32(near[..., a], omax[..., a], up=False)
            af = sub32(far[..., a], omin[..., a], up=True)
        mn = torch.where(an >= 0, imin[..., a], imax[..., a])
        mf = torch.where(af >= 0, imax[..., a], imin[..., a])
        lo = torch.maximum(lo, mul32(an, mn, up=False))
        hi = torch.minimum(hi, mul32(af, mf, up=True))
    return lo > hi


def planes(lo, hi, o):
    """The near and far planes of boxes (..., 3) for the rays of octant
    ``o``."""
    neg = torch.tensor([(o >> a) & 1 for a in range(3)], dtype=torch.bool,
                       device=lo.device)
    return torch.where(neg, hi, lo), torch.where(neg, lo, hi)


def buckets(ro, rd, mn, mx):
    """Each workgroup's buckets: (n (W, 8) ray counts, omin, omax, imin,
    imax (W, 8, 3), tmin, tmax (W, 8), unsafe (W, 8) bool)."""
    B = ro.shape[0]
    W = B // pt.WG
    inv = 1.0 / torch.where(rd == 0.0, 1e-30, rd)
    sign = (inv.view(torch.int32) < 0).to(torch.int64)
    key = sign[:, 0] | (sign[:, 1] << 1) | (sign[:, 2] << 2)
    key = torch.where(mn <= mx, key, N_OCT)
    slot = torch.arange(B, device=ro.device) // pt.WG * (N_OCT + 1) + key
    size = W * (N_OCT + 1)

    def reduce(x, how):
        shape = (size,) + x.shape[1:]
        fill = float("inf") if how == "amin" else -float("inf")
        out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        idx = slot.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
        out = out.scatter_reduce(0, idx, x, how, include_self=False)
        return out.view(W, N_OCT + 1, *x.shape[1:])[:, :N_OCT]
    n = torch.zeros(size, dtype=torch.int64, device=ro.device)
    n.index_add_(0, slot, torch.ones_like(slot))
    bad = ~(torch.isfinite(ro).all(1) & torch.isfinite(inv).all(1))
    unsafe = reduce(bad.to(torch.float32), "amax") > 0
    return (n.view(W, N_OCT + 1)[:, :N_OCT], reduce(ro, "amin"),
            reduce(ro, "amax"), reduce(inv, "amin"), reduce(inv, "amax"),
            reduce(mn, "amin"), reduce(mx, "amax"), unsafe)


def cull_steps(ro, rd, mn, mx, cl_lo, cl_hi, cp, pi=None):
    """X1's counts (``KEYS``, ints) for packed rays (B = W x 128) against
    C clusters in cp columns (slist; f2b with ``pi``, (8, C): workgroup
    w's column j is cluster pi[octant_w][j])."""
    B, C = ro.shape[0], cl_lo.shape[0]
    W, dev = B // pt.WG, ro.device
    n, omin, omax, imin, imax, tmin, tmax, unsafe = buckets(ro, rd, mn, mx)
    j = torch.arange(cp, device=dev)
    valid = j < C
    if pi is None:
        ids = j.clamp(max=C - 1).expand(W, cp)
    else:
        ids = pi.to(torch.int64)[pt._octants(rd)]
        ids = torch.cat([ids, ids.new_zeros((W, cp - C))], 1)
    # a column past the clusters holds the point box at the origin
    lo = torch.where(valid[:, None], cl_lo[ids], 0.0)
    hi = torch.where(valid[:, None], cl_hi[ids], 0.0)
    nw = cp // WARP
    ordered = (lo <= hi).all(-1).view(W, nw, WARP).all(-1)
    n_valid = valid.view(nw, WARP).sum(-1).to(torch.int64)
    out = dict.fromkeys(KEYS, 0)
    out["plain_tests"] = int((n_valid * n.sum(1, keepdim=True)
                              * ~ordered).sum())
    for o in range(N_OCT):
        near, far = planes(lo, hi, o)
        need = valid & (unsafe[:, o, None] | ~misses(
            o, near, far, omin[:, None, o], omax[:, None, o],
            imin[:, None, o], imax[:, None, o], tmin[:, o, None],
            tmax[:, o, None]))
        run = need.view(W, nw, WARP).any(-1)
        m = ordered & (n[:, o, None] > 0)
        tests = n_valid * n[:, o, None]
        out["select_tests"] += int((tests * (m & run)).sum())
        out["skipped_tests"] += int((tests * (m & ~run)).sum())
        out["bound_tests"] += int((n_valid * (m & ~unsafe[:, o, None]))
                                  .sum())
    return out


def operations(steps):
    """The float32 operations of X1's counted work (``steps``, KEYS):
    every slab and bounds test it runs."""
    return (steps["select_tests"] * SELECT_TEST_OPS
            + steps["plain_tests"] * ct.BOX_TEST_OPS
            + steps["bound_tests"] * BOUND_TEST_OPS)
