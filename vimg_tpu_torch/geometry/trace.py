"""Tracer facade (port of vimg_tpu.geometry.trace): picks the intersection
backend for a scene.

- ``soa``: the dense SoA tracer, the default up to BRUTE_FORCE_MAX_PRIMS
  primitives;
- ``brute``: the brute-force tracer;
- ``mxu``: the brute-force tracer over one product per batch
  (``mxu_intersect.MXUBruteForceTracer``), only when asked for and with
  vimg_tpu's warning: an experimental formulation there;
- ``cluster``: the cluster tracer (kernels B3/B4 on CUDA, their plain
  walks on the CPU), the default for larger scenes with triangles and at
  most 64 spheres;
- ``packet``: the packet tracer (kernel B5 on CUDA, its plain walk on the
  CPU), only when asked for, as in vimg_tpu: the same hits as the cluster
  walk, for scenes whose packed triangle table fits its 10 MiB budget;
- ``bvh`` / ``sweep``: the per-ray BVH tracer (kernel X2 on CUDA, its
  plain walk on the CPU) over the binned-SAH or the exact sweep-SAH tree
  (the CLI's ``-b 1``); the default for every other scene: no triangles
  and more than 64 primitives, or more than 64 spheres.

One recorded deviation from vimg_tpu: its CPU backend gives the BVH tracer
also to scenes with triangles and at most 64 spheres; this package gives
them the cluster tracer on the CPU as on the card, whose plain walks
return the same closest hits.
"""
from __future__ import annotations

from vimg_tpu_torch.geometry import intersect
from vimg_tpu_torch.scene import ir

BRUTE_FORCE_MAX_PRIMS = 64
CLUSTER_MAX_SPHERES = 64     # spheres merge densely beside the walk


class BruteForceTracer:
    """Dense all-primitives intersection."""

    def __init__(self, scene: ir.Scene):
        self.scene = scene

    def closest(self, scene, ro, rd, minT, maxT) -> intersect.HitResult:
        return intersect.intersect_bruteforce(scene, ro, rd, minT, maxT)

    def occluded(self, scene, ro, rd, minT, maxT):
        return intersect.occlude_bruteforce(scene, ro, rd, minT, maxT)


def make_tracer(scene: ir.Scene, force=None, differentiable=False):
    """Pick the intersection backend: ``soa``, ``brute``, ``mxu``,
    ``cluster``, ``packet``, ``bvh`` or ``sweep`` (``force`` names one;
    None picks as the module docstring says).

    ``differentiable=True`` (vimg_tpu's keyword) is met by every backend:
    the dense tracers are tensor code that autograd runs through (t and
    so the hit point's motion included), and the cluster, packet and BVH
    tracers detach their rays (zero tangent through traversal, as
    vimg_tpu's Pallas tracers), so kernels B3, B4, B5 and X2 carry
    gradient renders unchanged."""
    del differentiable
    n_prims = scene.n_tris() + scene.n_spheres()
    if force == "brute":
        return BruteForceTracer(scene)
    if force == "mxu":
        import warnings
        warnings.warn("force='mxu' is an experimental formulation with "
                      "~2e-3 intersection error on this platform; use "
                      "'soa'/'cluster' for production renders")
        from vimg_tpu_torch.geometry.mxu_intersect import MXUBruteForceTracer
        return MXUBruteForceTracer(scene)
    if force == "soa" or (force is None and n_prims <= BRUTE_FORCE_MAX_PRIMS):
        from vimg_tpu_torch.geometry.soa_intersect import SoATracer
        return SoATracer(scene)
    if force == "packet":
        from vimg_tpu_torch.geometry.packet_trace import PacketTracer
        return PacketTracer(scene)
    if force == "cluster" or (force is None and scene.n_tris() > 0
                              and scene.n_spheres() <= CLUSTER_MAX_SPHERES):
        from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
        return ClusterTracer(scene)
    from vimg_tpu_torch.geometry.bvh import BVHTracer
    return BVHTracer(scene, builder="sweep" if force == "sweep" else "auto")
