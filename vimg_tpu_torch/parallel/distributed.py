"""Multi-process rendering over ``torch.distributed`` (port of
vimg_tpu.parallel.distributed).

Each process renders a disjoint slab of every pixel's sample range
(``split_spp``; disjoint RNG streams through ``sample_offset``) on its own
devices, and the sample-weighted partial films are summed by one
all-reduce. The train step's gradient all-reduce is in ``diff/grad.py``.

A launch under ``torchrun`` (the same command in every process):

    torchrun --nproc_per_node 4 my_render.py

with, in ``my_render.py``,

    from vimg_tpu_torch.parallel.distributed import (initialize,
                                                     render_distributed)
    initialize()                     # from torchrun's environment
    img = render_distributed(scene, settings)   # the same film everywhere

The card takes NCCL; the CPU (``initialize(device="cpu")``) takes gloo.
Neither falls back to the other.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from vimg_tpu_torch.core.math import div
from vimg_tpu_torch.parallel.sharding import Mesh, film_sum, make_mesh
from vimg_tpu_torch.scene.ir import check_device


def initialize(init_method=None, world_size=None, rank=None, device="cuda",
               timeout=None):
    """Join the process group: from ``init_method`` (say
    ``tcp://host:port``), ``world_size`` and ``rank`` where given, else from
    the environment torchrun sets (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``). Without either, or when a group is
    up already, it does nothing: one process needs no group. On CUDA it
    takes NCCL and binds this process to card ``LOCAL_RANK`` (default: the
    rank modulo the cards); on the CPU, gloo. ``timeout`` is a
    ``datetime.timedelta`` (default: torch's)."""
    if dist.is_initialized():
        return
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return
    device = check_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", -1))
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(local if local >= 0
                              else r % torch.cuda.device_count())
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise NotImplementedError(f"no process group for device {device}")
    kw = {} if timeout is None else dict(timeout=timeout)
    if init_method is not None:
        kw.update(init_method=init_method, world_size=int(world_size),
                  rank=int(rank))
    dist.init_process_group(backend, **kw)


def world():
    """(processes, this process's rank): (1, 0) without a group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_mesh(axis="rays") -> Mesh:
    """This process's share of the global mesh: its device in the group
    (its card under NCCL, the CPU under gloo), or without a group every
    visible CUDA device."""
    if not dist.is_initialized():
        return make_mesh(axis=axis)
    if dist.get_backend() == "nccl":
        return Mesh((torch.device("cuda", torch.cuda.current_device()),),
                    axis)
    return Mesh((torch.device("cpu"),), axis)


def split_spp(spp, nproc):
    """Partition ``spp`` samples into ``nproc`` disjoint (count, offset)
    slabs. Counts differ by at most 1 and cover spp exactly; each process's
    sample indices are [offset, offset+count) so RNG streams are disjoint
    (same scheme as render/checkpoint.py slabs)."""
    base, rem = divmod(spp, nproc)
    counts = [base + (1 if p < rem else 0) for p in range(nproc)]
    offsets = [p * base + min(p, rem) for p in range(nproc)]
    return list(zip(counts, offsets))


def render_distributed(scene, settings, tracer=None, integrator=None,
                       stats=None):
    """Full-frame render across the group: each process traces its
    sample slab of every pixel on ``scene``'s device
    (``sharding.film_sum``), then ``reduce_films`` sums the partial films.
    Every process returns the same (H, W, 3) image. ``stats`` (a dict)
    gets the all-reduce's ``allreduce_ms`` (CUDA events on the card)."""
    from vimg_tpu_torch.geometry.trace import make_tracer
    tracer = tracer or make_tracer(scene)
    nproc, pid = world()
    spp_local, offset = split_spp(settings.spp, nproc)[pid]
    if spp_local > 0:
        local = dataclasses.replace(settings, spp=spp_local)
        weighted = film_sum(scene, local, tracer,
                            mesh=Mesh((scene.device,)),
                            integrator=integrator, sample_offset=offset)
    else:  # more processes than samples: this one adds nothing
        weighted = torch.zeros((settings.height, settings.width, 3),
                               dtype=torch.float32, device=scene.device)
    return reduce_films(weighted, settings.spp, stats)


def reduce_films(weighted, total_spp, stats=None):
    """Sum the processes' sample-weighted partial films with one
    ``all_reduce(SUM)`` (none without a group), then divide by the total
    sample count (``core.math.div``). The film is reduced in place.
    ``stats`` as ``render_distributed``'s."""
    if dist.is_initialized():
        ev = None
        if stats is not None and weighted.is_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        dist.all_reduce(weighted, op=dist.ReduceOp.SUM)
        if ev:
            ev[1].record()
            ev[1].synchronize()
            stats["allreduce_ms"] = ev[0].elapsed_time(ev[1])
    return div(weighted, max(total_spp, 1))
