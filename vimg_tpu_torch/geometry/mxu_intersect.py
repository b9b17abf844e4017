"""Brute-force intersection as one product per batch (port of
vimg_tpu.geometry.mxu_intersect).

A ray / triangle test factors into dot products with per-triangle
constants:

  n  = e1 x e2                 (plane normal)
  t  = (p0.n - ro.n) / rd.n
  m1 = (e2 x n) / |n|^2, m2 = (n x e1) / |n|^2   (barycentric dual basis)
  u  = (ro + t rd - p0).m1,  v = (ro + t rd - p0).m2

With X = [ro | rd | 1] (B, 7) and a weight matrix W (7, 6P) whose columns
are (n, 0, -p0.n), (0, n, 0), (m1, 0, -p0.m1), (0, m1, 0), (m2, 0, -p0.m2),
(0, m2, 0) per triangle, the product X W holds every numerator and
denominator of every (ray, triangle) pair; an elementwise pass recovers
(t, u, v) and the closest hit. Spheres get ro.c / rd.c columns the same
way. vimg_tpu built this for the TPU's matrix unit and parks it as an
experiment (``make_tracer(force="mxu")`` warns of its ~2e-3 intersection
error there); the port keeps it as a tracer that vimg_tpu offers.

The product. vimg_tpu computes X W in XLA at ``Precision.HIGHEST``. Here it
is the explicit seven-term sum ((X0 W0 + X1 W1) + X2 W2) + ... + X6 W6,
elementwise in float32: every product and sum is rounded on its own, so
the result does not depend on the caller's TF32 setting (nothing is
changed or restored) nor on how the columns are chunked.

Memory. (B, 6P) float32 is 3.1 GB at B = 131,072 and P = 1,000, so the
pass runs over blocks of rays x primitives of at most ``max_bytes`` (64
MiB by default) of product, keeping each ray's running (t, index, u, v);
about ten block-sized temporaries are alive at once. A later block
replaces the running hit only at a strictly smaller t, so the earlier
primitive stays on equal t, as ``jnp.argmin`` keeps it: the chunked
result equals the unchunked one exactly.

Barycentrics keep vimg_tpu's convention: u = 1 - u_best - v_best,
v = u_best (a miss reports primitive 0's values, as vimg_tpu's one-hot
sum does).
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.geometry.intersect import HitResult
from vimg_tpu_torch.scene import ir

COLS = 6                      # product columns per primitive
MXU_BLOCK_BYTES = 64 << 20    # product bytes a block (rays x columns)


def build_tables(scene: ir.Scene):
    """W (7, 6P) and aux (P, 4) float32 on the scene's device, from float64
    host math (aux: |c|^2 - r^2 and r^2 of each sphere)."""
    nt = scene.n_tris()
    ns = scene.n_spheres()
    P = nt + ns
    W = np.zeros((7, COLS * P), np.float32)
    aux = np.zeros((P, 4), np.float32)
    if nt:
        v = scene.verts.detach().cpu().numpy().astype(np.float64)
        tidx = scene.tri_vidx.cpu().numpy()
        p0 = v[tidx[:, 0]]
        e1 = v[tidx[:, 1]] - p0
        e2 = v[tidx[:, 2]] - p0
        n = np.cross(e1, e2)
        n2 = np.maximum((n * n).sum(1, keepdims=True), 1e-30)
        m1 = np.cross(e2, n) / n2
        m2 = np.cross(n, e1) / n2
        c = COLS * np.arange(nt)
        for j, m in ((0, n), (2, m1), (4, m2)):
            W[0:3, c + j] = m.T
            W[6, c + j] = -np.einsum("ij,ij->i", p0, m)
            W[3:6, c + j + 1] = m.T
    if ns:
        cen = scene.sph_center.detach().cpu().numpy().astype(np.float64)
        rad = scene.sph_radius.detach().cpu().numpy().astype(np.float64)
        c = COLS * (nt + np.arange(ns))
        W[0:3, c + 0] = cen.T      # ro . c
        W[3:6, c + 1] = cen.T      # rd . c
        aux[nt:, 0] = np.einsum("ij,ij->i", cen, cen) - rad * rad
        aux[nt:, 1] = rad * rad
    dev = scene.device
    return torch.from_numpy(W).to(dev), torch.from_numpy(aux).to(dev)


def _product(X, Wc):
    """X (B, 7) times Wc (7, n) as the explicit seven-term sum."""
    Y = X[:, 0:1] * Wc[0]
    for k in range(1, 7):
        Y = Y + X[:, k:k + 1] * Wc[k]
    return Y


def _block_t(X, W, aux, ro, rd, minT, maxT, nt, p0, p1):
    """The candidate t of every (ray, primitive) pair of primitives
    [p0, p1) (+inf where the primitive is missed), and the triangles'
    u and v (columns of the triangles among them)."""
    Y = _product(X, W[:, COLS * p0:COLS * p1]).reshape(X.shape[0], -1, COLS)
    mn, mx = minT[:, None], maxT[:, None]
    parts, tri_u, tri_v = [], None, None
    k = max(min(nt, p1) - p0, 0)        # triangles in the block
    if k:
        Yt = Y[:, :k]
        num = Yt[..., 0]          # ro.n - p0.n  (plane residual)
        den = Yt[..., 1]          # rd.n
        t = -num / torch.where(den == 0.0, 1e-30, den)
        tri_u = Yt[..., 2] + t * Yt[..., 3]
        tri_v = Yt[..., 4] + t * Yt[..., 5]
        hit = ((den != 0.0) & (tri_u >= 0.0) & (tri_v >= 0.0)
               & (tri_u + tri_v <= 1.0) & (t >= mn) & (t <= mx))
        parts.append(torch.where(hit, t, float("inf")))
    if p1 - p0 > k:
        Ys = Y[:, k:]
        ro_c, rd_c = Ys[..., 0], Ys[..., 1]
        ro2 = torch.sum(ro * ro, 1)[:, None]
        rd2 = torch.sum(rd * rd, 1)[:, None]
        ro_rd = torch.sum(ro * rd, 1)[:, None]
        a = rd2
        b_prime = rd_c - ro_rd
        cc = ro2 - 2.0 * ro_c + aux[None, p0 + k:p1, 0]
        disc4 = b_prime * b_prime - a * cc       # a^2 x the roots' disc
        has = disc4 >= 0.0
        sq = torch.sqrt(torch.clamp_min(disc4, 0.0))
        q = b_prime + torch.where(b_prime > 0.0, 1.0, -1.0) * sq
        x0 = cc / torch.where(q == 0.0, 1e-30, q)
        x1 = q / a
        t0 = torch.minimum(x0, x1)
        t1 = torch.maximum(x0, x1)
        t0_ok = (t0 >= mn) & (t0 <= mx)
        t1_ok = (t1 >= mn) & (t1 <= mx)
        st = torch.where(t0_ok, t0, t1)
        parts.append(torch.where(has & (t0_ok | t1_ok), st, float("inf")))
    return torch.cat(parts, 1), tri_u, tri_v


def mxu_intersect(W, aux, ro, rd, minT, maxT, nt, ns, any_hit=False,
                  max_bytes=MXU_BLOCK_BYTES):
    """Closest hit (a HitResult), or any hit (bool (B,)), of a ray batch
    against all nt triangles and ns spheres of the tables, in blocks of at
    most ``max_bytes`` of product (see the module docstring)."""
    B = ro.shape[0]
    P = nt + ns
    dev = ro.device
    minT = minT.expand(B)
    maxT = maxT.expand(B)
    best_t = torch.full((B,), float("inf"), device=dev)
    pid = torch.zeros(B, dtype=torch.int64, device=dev)
    u_best = torch.zeros(B, device=dev)
    v_best = torch.zeros(B, device=dev)
    if B == 0 or P == 0:
        return _result(best_t, pid, u_best, v_best, nt, any_hit)
    rows = max(1, min(B, max_bytes // (4 * COLS * P)))
    prims = max(1, min(P, max_bytes // (4 * COLS * rows)))
    for b0 in range(0, B, rows):
        r = slice(b0, min(b0 + rows, B))
        o, d = ro[r], rd[r]
        X = torch.cat([o, d, torch.ones_like(o[:, :1])], 1)
        for p0 in range(0, P, prims):
            p1 = min(p0 + prims, P)
            t, tu, tv = _block_t(X, W, aux, o, d, minT[r], maxT[r], nt, p0,
                                 p1)
            bt, j = torch.min(t, 1)          # first index of the least t
            gid = p0 + j
            if tu is not None:
                jt = j.clamp_max(tu.shape[1] - 1)[:, None]
                is_tri = gid < nt
                bu = torch.where(is_tri, tu.gather(1, jt)[:, 0], 0.0)
                bv = torch.where(is_tri, tv.gather(1, jt)[:, 0], 0.0)
            else:
                bu = bv = torch.zeros_like(bt)
            # the first block sets the running hit (a miss keeps its
            # primitive 0); later ones replace it at a strictly smaller t
            take = (torch.ones_like(bt, dtype=torch.bool) if p0 == 0
                    else bt < best_t[r])
            best_t[r] = torch.where(take, bt, best_t[r])
            pid[r] = torch.where(take, gid, pid[r])
            u_best[r] = torch.where(take, bu, u_best[r])
            v_best[r] = torch.where(take, bv, v_best[r])
    return _result(best_t, pid, u_best, v_best, nt, any_hit)


def _result(best_t, pid, u_best, v_best, nt, any_hit):
    found = torch.isfinite(best_t)
    if any_hit:
        return found
    is_sph = pid >= nt
    return HitResult(
        t=torch.where(found, best_t, float("inf")),
        prim_type=torch.where(is_sph, ir.PRIM_SPHERE, ir.PRIM_TRI),
        prim_id=torch.where(is_sph, pid - nt, pid),
        # barycentric convention: HitResult carries the weights of (p0, p1)
        u=1.0 - u_best - v_best, v=u_best)


class MXUBruteForceTracer:
    """Brute-force tracer over the product formulation (tensor code on the
    scene's device)."""

    def __init__(self, scene: ir.Scene):
        self.W, self.aux = build_tables(scene)
        self.nt = scene.n_tris()
        self.ns = scene.n_spheres()

    def closest(self, scene, ro, rd, minT, maxT) -> HitResult:
        return mxu_intersect(self.W, self.aux, ro, rd, minT, maxT, self.nt,
                             self.ns)

    def occluded(self, scene, ro, rd, minT, maxT):
        return mxu_intersect(self.W, self.aux, ro, rd, minT, maxT, self.nt,
                             self.ns, any_hit=True)
