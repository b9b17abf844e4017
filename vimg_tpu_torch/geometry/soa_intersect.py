"""Flop-lean brute-force intersection (port of
vimg_tpu.geometry.soa_intersect).

Per-triangle constants are precomputed in float64 and stored as float32:
the plane normal n, d0 = p0.n and the barycentric dual basis m1/m2 with
c1 = p0.m1, c2 = p0.m2. Per (ray, tri): t = (d0 - ro.n)/(rd.n),
u = ro.m1 + t rd.m1 - c1, v likewise. ``tri_constants`` is vimg_tpu's
numpy precompute verbatim, so both packages (and the CUDA megakernel)
test against identical float32 constants.
"""
from __future__ import annotations

import numpy as np
import torch

from vimg_tpu_torch.core.math import sqrt_cr
from vimg_tpu_torch.geometry.intersect import HitResult
from vimg_tpu_torch.scene import ir


def tri_constants(verts, tri_vidx):
    """Plane + dual-basis constants (f64 precompute, f32 store)."""
    v = np.asarray(verts, np.float64)
    tidx = np.asarray(tri_vidx)
    p0 = v[tidx[:, 0]]
    e1 = v[tidx[:, 1]] - p0
    e2 = v[tidx[:, 2]] - p0
    n = np.cross(e1, e2)
    n2 = np.maximum((n * n).sum(1, keepdims=True), 1e-300)
    m1 = np.cross(e2, n) / n2
    m2 = np.cross(n, e1) / n2
    return np.concatenate([
        n, (p0 * n).sum(1, keepdims=True),
        m1, (p0 * m1).sum(1, keepdims=True),
        m2, (p0 * m2).sum(1, keepdims=True)], axis=1).astype(np.float32)


def build_constants(scene: ir.Scene):
    """(tri_c (T, 12), sph_c (S, 4)) float32 numpy tables, None when a
    primitive kind is absent."""
    tri = sph = None
    if scene.n_tris():
        tri = tri_constants(scene.verts.cpu().numpy(),
                            scene.tri_vidx.cpu().numpy())
    if scene.n_spheres():
        c = scene.sph_center.cpu().numpy().astype(np.float64)
        r = scene.sph_radius.cpu().numpy().astype(np.float64)
        sph = np.concatenate([c, (r * r)[:, None]], axis=1).astype(np.float32)
    return tri, sph


def _trace_impl(tri_c, sph_c, ro, rd, minT, maxT, any_hit):
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    best_t = maxT
    best_id = torch.full(rox.shape, -1, dtype=torch.int64, device=ro.device)
    best_u = torch.zeros_like(rox)
    best_v = torch.zeros_like(rox)
    one = torch.ones_like(rox)

    nt = 0 if tri_c is None else tri_c.shape[0]
    for i in range(nt):
        nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z, c2 = \
            (float(tri_c[i, k]) for k in range(12))
        ro_n = rox * nx + roy * ny + roz * nz
        rd_n = rdx * nx + rdy * ny + rdz * nz
        parallel = rd_n.abs() < 1e-22
        t = (d0 - ro_n) / torch.where(parallel, one, rd_n)
        u = (rox * m1x + roy * m1y + roz * m1z - c1
             + t * (rdx * m1x + rdy * m1y + rdz * m1z))
        v = (rox * m2x + roy * m2y + roz * m2z - c2
             + t * (rdx * m2x + rdy * m2y + rdz * m2z))
        hit = (~parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t >= minT) & (t < best_t))
        best_id = torch.where(hit, i, best_id)
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_t = torch.where(hit, t, best_t)

    if sph_c is not None:
        ro_rd = rox * rdx + roy * rdy + roz * rdz
        ro2 = rox * rox + roy * roy + roz * roz
        rd2 = rdx * rdx + rdy * rdy + rdz * rdz
        rd2_bad = rd2 < 1e-30
        for j in range(sph_c.shape[0]):
            cx, cy, cz, r2 = (float(sph_c[j, k]) for k in range(4))
            ro_c = rox * cx + roy * cy + roz * cz
            rd_c = rdx * cx + rdy * cy + rdz * cz
            b_prime = rd_c - ro_rd
            # |c|^2 is a Python (float64) constant, rounded to float32 on use
            cc = ro2 - 2.0 * ro_c + (cx * cx + cy * cy + cz * cz) - r2
            disc4 = b_prime * b_prime - rd2 * cc
            has = disc4 >= 0.0
            sq = sqrt_cr(torch.where(has, torch.clamp_min(disc4, 1e-30),
                                        one))
            sign = torch.where(b_prime > 0.0, one, -one)
            q = b_prime + sign * sq
            q_bad = q.abs() < 1e-30
            x0 = torch.where(q_bad, -one, cc / torch.where(q_bad, one, q))
            x1 = torch.where(rd2_bad, -one, q / torch.where(rd2_bad, one, rd2))
            t0 = torch.minimum(x0, x1)
            t1 = torch.maximum(x0, x1)
            t0_ok = (t0 >= minT) & (t0 < best_t)
            t1_ok = (t1 >= minT) & (t1 < best_t)
            t = torch.where(t0_ok, t0, t1)
            hit = has & ~rd2_bad & (t0_ok | t1_ok)
            best_id = torch.where(hit, nt + j, best_id)
            best_t = torch.where(hit, t, best_t)

    if any_hit:
        return best_id >= 0
    found = best_id >= 0
    is_sph = best_id >= nt
    return HitResult(
        t=torch.where(found, best_t, torch.full_like(best_t, float("inf"))),
        prim_type=torch.where(is_sph, ir.PRIM_SPHERE, ir.PRIM_TRI),
        prim_id=torch.where(is_sph, best_id - nt, best_id.clamp_min(0)),
        u=1.0 - best_u - best_v, v=best_u)


class SoATracer:
    """Default small-scene tracer: exact f32, no gathers."""

    def __init__(self, scene: ir.Scene):
        self.tri_c, self.sph_c = build_constants(scene)

    def closest(self, scene, ro, rd, minT, maxT):
        return _trace_impl(self.tri_c, self.sph_c, ro, rd, minT, maxT, False)

    def occluded(self, scene, ro, rd, minT, maxT):
        return _trace_impl(self.tri_c, self.sph_c, ro, rd, minT, maxT, True)
