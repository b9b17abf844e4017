"""Thin-lens camera with depth of field (port of vimg_tpu.render.camera)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from vimg_tpu_torch.core import warps
from vimg_tpu_torch.core.math import div, normalize
from vimg_tpu_torch.core.raycone import primary_cone_spread


@dataclass(frozen=True)
class Camera:
    """Camera parameters; ``cam2world`` is a (4, 4) row-major matrix and
    the scalars are 0-d float32 tensors on the scene's device."""
    cam2world: torch.Tensor
    vfov_deg: torch.Tensor
    aperture_radius: torch.Tensor
    focal_dist: torch.Tensor
    width: int = 512
    height: int = 512

    @staticmethod
    def make(cam2world, width, height, vfov_deg, aperture_radius=0.0,
             focal_dist=1.0, device="cuda"):
        """A camera on ``device`` (CUDA by default; raises without CUDA
        unless ``device="cpu"`` is passed)."""
        from vimg_tpu_torch.scene.ir import check_device
        device = check_device(device)

        def f32(x):
            # a copy: the inputs may be read-only views (np.asarray of a
            # JAX array)
            return torch.tensor(np.array(x, np.float32), device=device)
        return Camera(cam2world=f32(cam2world), vfov_deg=f32(vfov_deg),
                      aperture_radius=f32(aperture_radius),
                      focal_dist=f32(focal_dist), width=int(width),
                      height=int(height))

    def to(self, device):
        return Camera(cam2world=self.cam2world.to(device),
                      vfov_deg=self.vfov_deg.to(device),
                      aperture_radius=self.aperture_radius.to(device),
                      focal_dist=self.focal_dist.to(device),
                      width=self.width, height=self.height)


def _rotate(m, v):
    """Rows of the 3x3 ``m`` dotted with v, summed in (x, y, z) order."""
    return torch.stack([m[r, 0] * v[..., 0] + m[r, 1] * v[..., 1]
                        + m[r, 2] * v[..., 2] for r in range(3)], dim=-1)


def generate_rays(cam: Camera, px, py, lens_r1, lens_r2):
    """Primary rays for continuous pixel coords (px, py); y = 0 is the
    bottom row. Returns (origin, direction, cone_width, cone_spread):
    (..., 3), (..., 3), (...,) and (...,)."""
    theta = cam.vfov_deg * (math.pi / 180.0)
    img_h = 2.0 * torch.tan(theta * 0.5)
    img_w = img_h * (cam.width / cam.height)

    x_dir = img_w * div(px, float(cam.width)) - img_w * 0.5
    y_dir = img_h * div(py, float(cam.height)) - img_h * 0.5
    ray_dir = normalize(torch.stack(
        [x_dir, y_dir, -torch.ones_like(x_dir)], dim=-1))
    origin = torch.zeros_like(ray_dir)

    if float(cam.aperture_radius.detach()) > 0.0:
        # aperture-disk origin, aimed through the focal-plane point
        disk = warps.sample_disk(lens_r1, lens_r2) * cam.aperture_radius
        origin = torch.cat([disk, torch.zeros_like(disk[..., :1])], dim=-1)
        ft = cam.focal_dist / torch.abs(ray_dir[..., 2])
        ray_dir = normalize(ray_dir * ft[..., None] - origin)

    rot = cam.cam2world[:3, :3]
    world_o = _rotate(rot, origin) + cam.cam2world[:3, 3]
    world_d = normalize(_rotate(rot, ray_dir))

    cone_width = x_dir * 0.0
    cone_spread = primary_cone_spread(theta, float(cam.height)) + cone_width
    return world_o, world_d, cone_width, cone_spread


def look_at_matrix(look_from, look_to, up):
    from vimg_tpu_torch.core.math import look_at
    return look_at(look_from, look_to, up)
