"""Frame renderer and dispatch (port of vimg_tpu.render.render).

``render`` is the chunked loop over (pixel, sample) work: every chunk
holds whole pixels with all their samples, and each pixel's samples are
summed in sample order, as vimg_tpu's film accumulates them.
``render_frame`` sends the frames that the megakernel covers to the
hand-written CUDA kernel of the scene's mode (B1 analytic, B2 mesh) on
CUDA, or to its plain version (the loop integrator) on the CPU, except
mesh MIS frames at production sample counts, which go to the refill
wavefront like every other MIS frame. Anything else raises on CUDA:
nothing moves silently between devices.
"""
from __future__ import annotations

import time

import torch

from vimg_tpu_torch.geometry.trace import make_tracer
from vimg_tpu_torch.render import film
from vimg_tpu_torch.render.integrators import trace_radiance
from vimg_tpu_torch.scene import ir


def render(scene: ir.Scene, settings: ir.RenderSettings, progress=False,
           sample_offset=0, stats=None, tracer=None):
    """Render a full frame with the loop integrator. Returns the linear
    (H, W, 3) float32 image on the scene's device. ``sample_offset`` shifts
    every sample id (and so every RNG stream); ``tracer`` defaults to
    ``make_tracer(scene)``."""
    W, H, spp = settings.width, settings.height, settings.spp
    dev = scene.device
    tracer = tracer or make_tracer(scene)
    n_pix = W * H
    pix_per_chunk = max((settings.batch_size or (1 << 20)) // spp, 1)
    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    samp_ids = torch.arange(spp, device=dev) + sample_offset
    t0 = time.time()
    for p0 in range(0, n_pix, pix_per_chunk):
        p1 = min(p0 + pix_per_chunk, n_pix)
        pix = torch.arange(p0, p1, device=dev).repeat_interleave(spp)
        samp = samp_ids.repeat(p1 - p0)
        col = trace_radiance(scene, settings, tracer, pix, samp, stats=stats)
        col = col.view(p1 - p0, spp, 3)
        acc = accum[p0:p1]
        for s in range(spp):
            acc += col[:, s]
        if progress:
            rate = (p1 * spp) / max(time.time() - t0, 1e-9)
            print(f"\r{100.0 * p1 / n_pix:.2f} % done "
                  f"({rate / 1e6:.2f} Mpaths/s)", end="", flush=True)
    if progress:
        print("\nRender Completed")
    return accum.view(H, W, 3) / spp


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


def render_frame(scene, settings, progress=False, tracer=None,
                 tracer_force=None):
    """Render dispatch, the same choice on both devices:

    - a scene and integrator the megakernel covers, unless
      ``prefer_wavefront_for_mesh``: the CUDA megakernel of the scene's
      mode (B1 or B2) on CUDA, its plain version (the loop integrator) on
      the CPU;
    - else an MIS frame: the refill wavefront (by default over the cluster
      kernels B3/B4 on CUDA, their plain walks on the CPU);
    - else: the loop integrator on the CPU; on CUDA it raises (nothing
      falls back to the CPU).
    ``tracer`` (or ``make_tracer(scene, force=tracer_force)``, built only
    when needed) is the wavefront's and the loop's tracer, as in vimg_tpu;
    it does not change the megakernel dispatch. Any other device raises."""
    from vimg_tpu_torch.render.mega import (render_megakernel,
                                            supports_megakernel)
    from vimg_tpu_torch.render.wavefront import render_wavefront
    dev = scene.device
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no render path for device {dev}")
    mega = (supports_megakernel(scene, settings)
            and not prefer_wavefront_for_mesh(scene, settings))
    if mega:
        return render_megakernel(scene, settings, progress=progress)
    if settings.integrator != "mis" and dev.type == "cuda":
        raise NotImplementedError(
            f"on CUDA the {settings.integrator} integrator is ported only "
            f"through the megakernel (see supports_megakernel)")
    tracer = tracer or make_tracer(scene, force=tracer_force)
    if settings.integrator == "mis":
        return render_wavefront(scene, settings, tracer=tracer,
                                progress=progress)
    return render(scene, settings, progress=progress, tracer=tracer)


def render_to_png(scene, settings, path, **kw):
    img = render_frame(scene, settings, **kw)
    film.write_png(path, film.finalize(img, tonemap=settings.tonemap))
    return img
