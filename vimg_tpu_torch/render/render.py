"""Frame renderer and dispatch (port of vimg_tpu.render.render).

``render`` is the chunked loop over (pixel, sample) work (``film_sum``):
every chunk holds whole pixels with all their samples, and each pixel's
samples are summed in sample order, as vimg_tpu's film accumulates them.
``render_frame`` dispatches as vimg_tpu does: on CUDA the frames that the
megakernel covers go to the hand-written kernel of the scene's mode (B1
analytic, B2 mesh), except mesh MIS frames at production sample counts;
on the CPU no frame takes the megakernel. Every other MIS frame goes to
the refill wavefront, and every other frame (``s_normal``, ``g_normal``,
a ``material`` frame the megakernel refuses) to ``render`` over
``make_tracer``'s tracer, whose walks are kernels B3/B4/B5 on CUDA.
Nothing moves between devices.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from vimg_tpu_torch.core.math import div
from vimg_tpu_torch.geometry.trace import make_tracer
from vimg_tpu_torch.render import film
from vimg_tpu_torch.render.integrators import trace_radiance
from vimg_tpu_torch.scene import ir


def render(scene: ir.Scene, settings: ir.RenderSettings, tracer=None,
           progress=False, integrator=None, sample_offset=0, stats=None,
           pixels=None):
    """Render a full frame with the loop integrator. Returns the linear
    (H, W, 3) float32 image on the scene's device. ``tracer`` defaults to
    ``make_tracer(scene)``; ``integrator`` overrides
    ``settings.integrator``; ``sample_offset`` shifts every sample id (and
    so every RNG stream); ``stats`` (a dict) collects segment and shadow-ray
    counts; ``pixels`` (an int64 tensor of pixel ids) renders only those
    pixels, the rest of the image staying 0."""
    if integrator is not None:
        settings = dataclasses.replace(settings, integrator=integrator)
    tracer = tracer or make_tracer(scene)

    def trace(sc, pix, samp):
        return trace_radiance(sc, settings, tracer, pix, samp, stats=stats)

    return div(film_sum(scene, settings, trace, progress, sample_offset,
                        pixels), settings.spp)


def film_sum(scene: ir.Scene, settings: ir.RenderSettings, trace,
             progress=False, sample_offset=0, pixels=None):
    """The (H, W, 3) sum over each pixel's ``settings.spp`` samples
    [sample_offset, sample_offset + spp): the loop of ``render`` and of
    ``parallel.sharding.render_sharded``. ``trace(scene, pix, samp)``
    gives the (B, 3) radiance of a chunk of whole pixels (about
    ``settings.batch_size`` rays, default 2^20); each pixel's samples are
    summed in sample order, so the film has no atomic adds. ``pixels`` as
    ``render``'s."""
    W, H, spp = settings.width, settings.height, settings.spp
    dev = scene.device
    n_pix = W * H if pixels is None else pixels.shape[0]
    pix_per_chunk = max((settings.batch_size or (1 << 20)) // spp, 1)
    accum = torch.zeros((W * H, 3), dtype=torch.float32, device=dev)
    samp_ids = torch.arange(spp, device=dev) + sample_offset
    t0 = time.time()
    for p0 in range(0, n_pix, pix_per_chunk):
        p1 = min(p0 + pix_per_chunk, n_pix)
        ids = (torch.arange(p0, p1, device=dev) if pixels is None
               else pixels[p0:p1])
        col = trace(scene, ids.repeat_interleave(spp),
                    samp_ids.repeat(p1 - p0)).view(p1 - p0, spp, 3)
        acc = (accum[p0:p1] if pixels is None else
               torch.zeros((p1 - p0, 3), dtype=torch.float32, device=dev))
        for s in range(spp):
            acc += col[:, s]
        if pixels is not None:
            accum[ids] = acc
        if progress:
            rate = (p1 * spp) / max(time.time() - t0, 1e-9)
            print(f"\r{100.0 * p1 / n_pix:.2f} % done "
                  f"({rate / 1e6:.2f} Mpaths/s)", end="", flush=True)
    if progress:
        print("\nRender Completed")
    return accum.view(H, W, 3)


MESH_WAVEFRONT_MIN_SPP = 8


def prefer_wavefront_for_mesh(scene, settings):
    """vimg_tpu's dispatch rule: mesh MIS frames at production sample
    counts (spp >= MESH_WAVEFRONT_MIN_SPP) go to the refill wavefront even
    though the mesh-mode megakernel B2 covers them (on the TPU the
    wavefront measured faster there). Low-spp MIS previews, material
    frames and smooth-shaded scenes of <= 64 triangles stay on B2."""
    return (scene.n_tris() > 64
            and settings.spp >= MESH_WAVEFRONT_MIN_SPP
            and settings.integrator == "mis")


def megakernel_takes(scene, settings):
    """Whether ``render_frame`` sends this MIS or material frame of a CUDA
    scene to the megakernel (B1 or B2)."""
    from vimg_tpu_torch.render.mega import supports_megakernel
    return (settings.integrator in ("mis", "material")
            and supports_megakernel(scene, settings)
            and not prefer_wavefront_for_mesh(scene, settings))


def render_frame(scene, settings, tracer=None, progress=False,
                 integrator=None, use_wavefront=True, tracer_force=None):
    """Render dispatch, vimg_tpu's rule (``integrator`` overrides
    ``settings.integrator``):

    - with ``use_wavefront``, an MIS or material frame that the megakernel
      covers, unless ``prefer_wavefront_for_mesh``: on CUDA the megakernel
      of the scene's mode (B1 or B2); never on the CPU;
    - else, with ``use_wavefront``, an MIS frame: the refill wavefront (by
      default over the cluster kernels B3/B4 on CUDA, their plain walks on
      the CPU);
    - else: the loop ``render`` with the integrator.
    ``tracer`` (or ``make_tracer(scene, force=tracer_force)``, built only
    when needed) is the wavefront's and the loop's tracer; it does not
    change the megakernel dispatch. Devices other than the CPU and CUDA
    raise."""
    from vimg_tpu_torch.render.mega import render_megakernel
    from vimg_tpu_torch.render.wavefront import render_wavefront
    dev = scene.device
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no render path for device {dev}")
    name = integrator or settings.integrator
    if use_wavefront and name in ("mis", "material"):
        st = dataclasses.replace(settings, integrator=name)
        if dev.type == "cuda" and megakernel_takes(scene, st):
            return render_megakernel(scene, st, progress=progress)
        if name == "mis":
            tracer = tracer or make_tracer(scene, force=tracer_force)
            return render_wavefront(scene, st, tracer=tracer,
                                    progress=progress)
    tracer = tracer or make_tracer(scene, force=tracer_force)
    return render(scene, settings, tracer=tracer, progress=progress,
                  integrator=integrator)


def render_to_png(scene, settings, path, **kw):
    img = render_frame(scene, settings, **kw)
    film.write_png(path, film.finalize(img, tonemap=settings.tonemap))
    return img
