"""Differentiable rendering (port of vimg_tpu.diff.grad): pixel gradients
with respect to scene parameters, and a train step.

Estimator: detached sampling, as in vimg_tpu. Autograd flows through BSDF
eval, emission, textures, the background, the env map and the camera,
while sampled directions, pdf divisors, MIS weights and roulette ratios
are detached inside the integrators (render/integrators.py) and the mesh
tracers detach their rays (zero tangent through traversal, so kernels
B3, B4 and B5 need no backward). ``bounded_depth`` fixes the bounce
count, as vimg_tpu's ``lax.scan``.

Trainable parameters: material base colours and scalar tables, the
background colour, the checker colours, the env radiance scale and mip
levels, and the camera (vfov, cam2world pose, aperture radius, focal
distance). The optimizer is ``torch.optim.Adam`` at 1e-2 by default, the
counterpart of ``optax.adam(1e-2)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vimg_tpu_torch.render.integrators import trace_radiance
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.ir import check_device

_CAMERA_KEYS = dict(cam_vfov="vfov_deg", cam2world="cam2world",
                    cam_aperture="aperture_radius", cam_focal="focal_dist")


def get_params(scene: ir.Scene):
    """The trainable parameters of ``scene`` under vimg_tpu's keys: the
    scene's own tensors (``env_mips`` a tuple, present when the scene has
    an env map)."""
    cam = scene.camera
    p = dict(mat_base=scene.mat_base, mat_scalars=scene.mat_scalars,
             bg_color=scene.bg_color, tex_cols=scene.tex_cols,
             env_scale=scene.env_scale, cam_vfov=cam.vfov_deg,
             cam2world=cam.cam2world, cam_aperture=cam.aperture_radius,
             cam_focal=cam.focal_dist)
    if scene.has_envmap:
        p["env_mips"] = tuple(scene.env_mips)
    return p


def params_from_numpy(params, device="cuda"):
    """A parameter dict of numpy arrays (vimg_tpu's ``get_params`` output
    read with ``np.asarray``) as float32 tensors on ``device``;
    ``env_mips`` becomes a tuple. A CUDA ``device`` (the default) raises
    without CUDA."""
    device = check_device(device)

    def f32(x):
        return torch.tensor(np.array(x, np.float32), device=device)
    out = {k: f32(v) for k, v in params.items() if k != "env_mips"}
    if "env_mips" in params:
        out["env_mips"] = tuple(f32(m) for m in params["env_mips"])
    return out


def apply_params(scene: ir.Scene, params) -> ir.Scene:
    """``scene`` with the parameters' tensors themselves in place of its
    own (no copies, so gradients reach them)."""
    params = dict(params)
    cam_fields = {_CAMERA_KEYS[k]: params.pop(k)
                  for k in list(params) if k in _CAMERA_KEYS}
    if cam_fields:
        scene = scene.replace(
            camera=dataclasses.replace(scene.camera, **cam_fields))
    if "env_mips" in params:
        params["env_mips"] = tuple(params["env_mips"])
    return scene.replace(**params)


def radiance_loss_fn(scene, settings, tracer, pix, samp, target,
                     bounded_depth=6, integrator=None, stats=None):
    """MSE between traced radiance and per-ray target colours; ``stats``
    as trace_radiance's."""
    col = trace_radiance(scene, settings, tracer, pix, samp,
                         integrator=integrator or settings.integrator,
                         bounded_depth=bounded_depth, stats=stats)
    return ((col - target) ** 2).mean()


def _leaves(params):
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


def _like(params, leaves):
    """``leaves`` (in _leaves order) shaped as the dict ``params``."""
    it = iter(leaves)
    return {k: tuple(next(it) for _ in params[k])
            if isinstance(params[k], tuple) else next(it)
            for k in sorted(params)}


def value_and_grad(scene, settings, tracer, params, pix, samp, target,
                   bounded_depth=6, integrator=None, stats=None):
    """``(loss, grads)``: radiance_loss_fn at ``params`` (tensors that
    require grad) applied to ``scene``, and its gradient for every key,
    shaped as ``params`` (zeros where the loss does not read a tensor). A
    ``stats`` dict gets trace_radiance's counts and, on the card,
    ``forward_ms`` and ``backward_ms`` by CUDA events (the timing
    synchronises, so pass it only to measure)."""
    marks = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
             if stats is not None and pix.is_cuda else None)
    if marks:
        marks[0].record()
    loss = radiance_loss_fn(apply_params(scene, params), settings, tracer,
                            pix, samp, target, bounded_depth=bounded_depth,
                            integrator=integrator, stats=stats)
    if marks:
        marks[1].record()
    leaves = _leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if marks:
        marks[2].record()
        marks[2].synchronize()
        stats["forward_ms"] = marks[0].elapsed_time(marks[1])
        stats["backward_ms"] = marks[1].elapsed_time(marks[2])
    return loss.detach(), _like(params, grads)


def make_train_step(scene: ir.Scene, settings: ir.RenderSettings, tracer,
                    bounded_depth=6, integrator="mis", optimizer=None,
                    mesh=None):
    """Returns ``(step, opt_state, params0)``, as vimg_tpu does.
    ``step(params, opt_state, pix, samp, target, stats=None) -> (params,
    opt_state, loss)`` takes one optimizer step; ``params0`` holds leaf
    copies of the scene's parameters (the scene itself is not written) and
    ``opt_state`` is the optimizer over them, which ``step`` updates in
    place; ``stats`` as value_and_grad's.

    ``optimizer`` is a callable from the parameter dict to a
    ``torch.optim.Optimizer`` over its tensors (default Adam at lr 1e-2
    over all of them; param groups can give keys their own rates). Every
    parameter
    takes a step each call, with a zero gradient where the loss does not
    read it (``cam_aperture`` at aperture 0, say), so each one's Adam count
    is the step count, as optax counts once for the whole tree.

    ``tracer`` comes from ``make_tracer(scene, differentiable=True)``:
    every backend qualifies (a mesh's cluster tracer runs B3/B4 at zero
    tangent).

    With a ``mesh`` (``parallel.sharding.Mesh``, say ``global_mesh()``)
    the step is sharded over the processes of the ``torch.distributed``
    group (one process without a group): each rank takes its contiguous
    slice of the step's rays (their count must divide by the group's
    size), and the loss and every gradient are averaged across ranks by
    one SUM all-reduce and a division by the group's size (vimg_tpu's
    ``pmean``; gloo has no AVG), so Adam steps every rank with the same
    gradients. ``stats`` then also gets ``allreduce_ms`` on the card.
    A process runs its share on one device: a mesh of more devices raises
    ``ValueError``."""
    if mesh is not None and mesh.size > 1:
        raise ValueError(f"the sharded step runs one device a process, not "
                         f"the mesh's {mesh.size}: give each process a mesh "
                         f"of its own device (distributed.global_mesh())")
    if optimizer is None:
        def optimizer(params):
            return torch.optim.Adam(_leaves(params), lr=1e-2)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    params0 = {k: tuple(leaf(m) for m in v) if isinstance(v, tuple)
               else leaf(v) for k, v in get_params(scene).items()}

    def step(params, opt_state, pix, samp, target, stats=None):
        if mesh is not None:
            pix, samp, target = (_rank_slice(x) for x in (pix, samp, target))
        loss, grads = value_and_grad(scene, settings, tracer, params, pix,
                                     samp, target, bounded_depth, integrator,
                                     stats)
        if mesh is not None:
            loss, grads = _mean_over_ranks(loss, grads, stats)
        for t, g in zip(_leaves(params), _leaves(grads)):
            t.grad = g
        opt_state.step()
        return params, opt_state, loss

    return step, optimizer(params0), params0


def _rank_slice(x):
    """This rank's contiguous share of the step's rays."""
    from vimg_tpu_torch.parallel.distributed import world
    n, rank = world()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rays do not split over {n} ranks")
    per = x.shape[0] // n
    return x[rank * per:(rank + 1) * per]


def _mean_over_ranks(loss, grads, stats=None):
    """The loss and the gradients averaged over the group's ranks: one
    SUM all-reduce of them packed flat, then ``div`` by the group's size
    (the identity without a group)."""
    import torch.distributed as dist
    from vimg_tpu_torch.core.math import div
    from vimg_tpu_torch.parallel.distributed import world
    if not dist.is_initialized():
        return loss, grads
    n, _ = world()
    leaves = _leaves(grads)
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in leaves])
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
          if stats is not None and flat.is_cuda else None)
    if ev:
        ev[0].record()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    if ev:
        ev[1].record()
        ev[1].synchronize()
        stats["allreduce_ms"] = ev[0].elapsed_time(ev[1])
    flat = div(flat, n)
    out, i = [], 1
    for g in leaves:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[0], _like(grads, out)
