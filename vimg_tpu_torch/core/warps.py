"""Sampling warps: uniform randoms -> directions/points (port of
vimg_tpu.core.warps). All functions broadcast over leading dims."""
from __future__ import annotations

import math

import torch

from vimg_tpu_torch.core.math import sqrt_cr

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)


def _dir(phi, cos_t):
    sin_t = sqrt_cr(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def sample_disk(r1, r2):
    """Uniform point on the unit disk -> (..., 2)."""
    r = sqrt_cr(r1)
    phi = TWO_PI * r2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def sample_sphere(r1, r2):
    """Uniform direction on the unit sphere; pdf = 1/(4 pi)."""
    return _dir(TWO_PI * r1, 2.0 * r2 - 1.0)


def sample_sphere_cap(r1, r2, cos_theta_max):
    """Uniform direction in the cone around +z of half-angle
    acos(cos_theta_max)."""
    return _dir(TWO_PI * r1, cos_theta_max + (1.0 - cos_theta_max) * r2)


def sample_hemisphere(r1, r2):
    """Uniform direction on the +z hemisphere; pdf = 1/(2 pi)."""
    return _dir(TWO_PI * r1, r2)


def sample_hemisphere_cosine(r1, r2):
    """Cosine-weighted direction on the +z hemisphere; pdf = cos/pi."""
    return _dir(TWO_PI * r1, sqrt_cr(r2))


def sample_triangle_uv(r1, r2):
    """Low-distortion uniform barycentrics (u, v) on a triangle."""
    lt = r1 < r2
    u_a = r1 * 0.5
    v_a = r2 - u_a
    v_b = r2 * 0.5
    u_b = r1 - v_b
    return torch.where(lt, u_a, u_b), torch.where(lt, v_a, v_b)
