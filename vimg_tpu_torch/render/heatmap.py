"""BVH-cost heatmap (port of vimg_tpu.render.heatmap; the reference's
src/integrators/heatmap.cpp).

``spp`` jittered primary rays per pixel (the reference forces spp = 4,
main.cpp:249-256, with R2 pixel offsets indexed x + y + s and thin-lens
draws, heatmap.cpp:101-115); the per-pixel traversal cost (0.5 a node, 1.0
a primitive test) is averaged, truncated to an integer
(heatmap.cpp:118-119), divided by the user factor (20 when <= 0,
heatmap.cpp:137-139) and mapped through the Turbo colormap. On CUDA the
cost comes from kernel X2's counter (geometry/bvh.py::bvh_trace).
"""
from __future__ import annotations

import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.core.math import div
from vimg_tpu_torch.geometry.bvh import BVHTracer
from vimg_tpu_torch.render.camera import generate_rays
from vimg_tpu_torch.scene import ir

# polynomial fit of Google's Turbo colormap (Mikhailov 2019)
_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396,
      59.28637943)
_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857,
      2.82956604)
_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912,
      27.34824973)


def turbo(x):
    """Turbo colour of x clipped to [0, 1]: (..., 3). The powers and the
    sum of each 6-term product are taken as vimg_tpu's XLA takes them
    without fused multiply-adds (x^4 = x^2 x^2, x^5 = x^4 x, terms added
    in order): the coefficients reach 153, so another order moves a
    channel by up to 3e-5."""
    x = torch.clamp(x, 0.0, 1.0)
    x2 = x * x
    x4 = x2 * x2
    powers = (x, x2, x2 * x, x4, x4 * x)
    out = []
    for coef in (_R, _G, _B):
        acc = torch.full_like(x, coef[0])
        for p, c in zip(powers, coef[1:]):
            acc = acc + p * c
        out.append(acc)
    return torch.stack(out, dim=-1)


def render_heatmap(scene: ir.Scene, settings: ir.RenderSettings, tracer,
                   factor=1.0, spp=4):
    """An sRGB-ready (H, W, 3) image of traversal cost in [0, 1], on the
    scene's device. ``tracer`` is a BVHTracer (its walk's cost counter) or
    any other tracer, whose every ray then costs one test a primitive (the
    brute-force model)."""
    W, H = settings.width, settings.height
    dev = scene.device
    if factor <= 0:
        factor = 20.0          # reference heatmap.cpp:137-139
    pixels = torch.arange(W * H, device=dev)
    xi = pixels % W
    yr = (H - 1) - pixels // W  # bottom-up y of the film's top-down rows
    cost = torch.zeros(W * H, dtype=torch.float32, device=dev)
    for s in range(spp):
        ox, oy = rng.r2_sequence(xi + yr + s)
        l1, l2 = rng.uniform2(pixels, torch.full_like(pixels, s), 0,
                              rng.Draw.CAMERA_LENS)
        ro, rd, _, _ = generate_rays(scene.camera, xi.to(torch.float32) + ox,
                                     yr.to(torch.float32) + oy, l1, l2)
        minT = torch.full((W * H,), 1e-4, device=dev)
        maxT = torch.full((W * H,), float("inf"), device=dev)
        if isinstance(tracer, BVHTracer):
            _, c = tracer.trace(scene, ro, rd, minT, maxT, count_cost=True)
        else:
            tracer.closest(scene, ro, rd, minT, maxT)
            c = torch.full((W * H,), float(scene.n_tris() + scene.n_spheres()),
                           device=dev)
        cost = cost + c
    # average, then truncate like the reference's uint32 cast
    avg = torch.floor(div(cost, float(spp)))
    img = turbo(div(avg, float(factor))).reshape(H, W, 3)
    return torch.clamp(img, 0.0, 1.0)
