"""Ray sharding over devices (port of vimg_tpu.parallel.sharding).

Rays are data-parallel and the scene is replicated: ``sharded_trace_fn``
splits a batch of (pixel, sample) rays into one contiguous share per
device of a mesh, each device traces its share with ``trace_radiance``
over its own copy of the scene and tracer, and the radiance comes back to
the scene's device. ``render_sharded`` is ``render``'s chunk loop over the
whole frame on top of it; the film accumulates on the scene's device.

A mesh is the list of torch devices of this process and an axis name. It
may name one device more than once (its shares then run in turn there).
Across processes, ``parallel.distributed`` splits the samples and sums
the films.
"""
from __future__ import annotations

import dataclasses

import torch

from vimg_tpu_torch.core.math import div
from vimg_tpu_torch.render import render
from vimg_tpu_torch.render.integrators import trace_radiance
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.ir import check_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices along one axis."""
    devices: tuple
    axis: str = "rays"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self):
        return (self.axis,)


def make_mesh(devices=None, axis="rays") -> Mesh:
    """A mesh over ``devices`` (torch devices or their names; default:
    every visible CUDA device, which raises without CUDA)."""
    if devices is None:
        check_device("cuda")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    return Mesh(tuple(check_device(d) for d in devices), axis)


def _same(a: torch.device, b: torch.device) -> bool:
    """Whether two torch devices are one (an unset index is the current
    card's, or the CPU's 0)."""
    def index(d):
        if d.index is not None:
            return d.index
        return torch.cuda.current_device() if d.type == "cuda" else 0
    return a.type == b.type and index(a) == index(b)


def _kept(store, key, sources, make):
    """``make()``, kept in ``store[key]`` while every source is the same
    object and every tensor among them is at the same version (an in-place
    write, an optimizer's step say, bumps it, so no copy is read stale)."""
    versions = tuple(getattr(x, "_version", None) for x in sources)
    hit = store.get(key)
    if (hit is not None and hit[1] == versions
            and all(a is b for a, b in zip(hit[0], sources))):
        return hit[2]
    with torch.no_grad():
        out = make()
    store[key] = (sources, versions, out)
    return out


def replicate(scene: ir.Scene, device) -> ir.Scene:
    """``scene`` itself on its own device, else its copy on ``device``,
    kept in ``scene.replicas`` (freed with the scene) and made anew once a
    tensor of the scene was written in place."""
    device = torch.device(device)
    if _same(scene.device, device):
        return scene
    return _kept(scene.replicas, str(device), scene.tensors(),
                 lambda: scene.to(device))


def _tracer_like(tracer, scene):
    """A tracer of ``tracer``'s kind and settings over ``scene`` (another
    device's copy); a cluster tracer shares its host tables."""
    from vimg_tpu_torch.geometry.bvh import BVHTracer
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.geometry.packet_trace import PacketTracer
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    from vimg_tpu_torch.geometry.trace import BruteForceTracer, make_tracer
    if isinstance(tracer, ClusterTracer):
        return ClusterTracer(scene, walk=tracer.walk,
                             sort_rays=tracer.sort_rays, plain=tracer.plain,
                             data=tracer.data)
    for kind, force in ((SoATracer, "soa"), (BruteForceTracer, "brute"),
                        (PacketTracer, "packet"), (BVHTracer, "bvh")):
        if isinstance(tracer, kind):
            return make_tracer(scene, force=force)
    raise TypeError(f"cannot replicate a {type(tracer).__name__}")


def sharded_trace_fn(scene_template: ir.Scene, settings: ir.RenderSettings,
                     tracer, mesh: Mesh, integrator=None,
                     bounded_depth=None):
    """Returns ``fn(scene, pix, samp) -> (B, 3)`` radiance on the scene's
    device, the rays split into ``mesh.size`` contiguous shares. Every
    share traces the ``scene`` given at call time, as vimg_tpu replicates
    it: on the scene's own device over ``tracer``, on another over the
    scene's copy there (``replicate``) and a tracer of ``tracer``'s kind
    over that copy, kept with the copy. ``scene_template`` is vimg_tpu's
    argument; nothing is read from it."""
    def fn(scene, pix, samp):
        parts = []
        for d, p, s in zip(mesh.devices, torch.tensor_split(pix, mesh.size),
                           torch.tensor_split(samp, mesh.size)):
            sc, tr = scene, tracer
            if not _same(d, scene.device):
                sc = replicate(scene, d)
                tr = _kept(sc.replicas, "tracer", (tracer,),
                           lambda: _tracer_like(tracer, sc))
            col = trace_radiance(sc, settings, tr, p.to(d), s.to(d),
                                 integrator=integrator,
                                 bounded_depth=bounded_depth)
            parts.append(col.to(scene.device))
        return torch.cat(parts)

    return fn


def film_sum(scene: ir.Scene, settings: ir.RenderSettings, tracer,
             mesh=None, integrator=None, sample_offset=0):
    """``render.film_sum`` (the sum over each pixel's samples
    [sample_offset, sample_offset + spp), in chunks of whole pixels) with
    each chunk's rays sharded over ``mesh`` (default: every visible CUDA
    device); the film accumulates on the scene's device and does not
    depend on the mesh."""
    if integrator is not None:
        settings = dataclasses.replace(settings, integrator=integrator)
    trace = sharded_trace_fn(scene, settings, tracer, mesh or make_mesh())
    return render.film_sum(scene, settings, trace,
                           sample_offset=sample_offset)


def render_sharded(scene: ir.Scene, settings: ir.RenderSettings, tracer,
                   mesh=None, integrator=None, sample_offset=0):
    """Full-frame render with the rays sharded over ``mesh``: the linear
    (H, W, 3) image on the scene's device. ``sample_offset`` shifts every
    sample id, so disjoint slabs of a larger render (checkpoint slabs,
    per-process slabs) draw disjoint RNG streams: the radiance of (pixel,
    sample) depends only on that pair."""
    return div(film_sum(scene, settings, tracer, mesh, integrator,
                        sample_offset), settings.spp)
