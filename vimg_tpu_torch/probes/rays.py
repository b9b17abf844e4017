"""Synthetic bounce rays for the walk probes (copy of vimg_tpu's
tools/probe_r3b.py::bounce_batches, the same RandomState draws in the same
order, so both give the same arrays for the same scene and seed)."""
from __future__ import annotations

import numpy as np
import torch


def bounce_batches(scene, B=131072, seed=0):
    """Synthetic bounce rays: origins on random mesh surface points,
    cosine-hemisphere directions about the face normal. Returns (ro, rd),
    (B, 3) float32 tensors on the scene's device."""
    rs = np.random.RandomState(seed)
    verts = scene.verts.cpu().numpy()
    tv = scene.tri_vidx.cpu().numpy()
    tid = rs.randint(0, tv.shape[0], B)
    p = verts[tv[tid]]
    u = rs.rand(B, 2)
    su = np.sqrt(u[:, 0:1])
    bary = np.concatenate([1 - su, su * (1 - u[:, 1:2]), su * u[:, 1:2]], 1)
    ro = (p * bary[:, :, None]).sum(1)
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    r1, r2 = rs.rand(B), rs.rand(B)
    st = np.sqrt(r1)
    phi = 2 * np.pi * r2
    lx, ly = st * np.cos(phi), st * np.sin(phi)
    lz = np.sqrt(np.maximum(1 - r1, 0))
    up = np.where(np.abs(fn[:, 2:3]) < 0.9,
                  np.array([[0, 0, 1.0]]), np.array([[1.0, 0, 0]]))
    t1 = np.cross(up, fn)
    t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-12)
    t2 = np.cross(fn, t1)
    rd = (t1 * lx[:, None] + t2 * ly[:, None] + fn * lz[:, None])
    ro = ro + fn * 1e-4
    dev = scene.verts.device
    return (torch.from_numpy(ro.astype(np.float32)).to(dev),
            torch.from_numpy(rd.astype(np.float32)).to(dev))
