"""Vector math over batches of 3-vectors shaped ``(..., 3)`` (port of
vimg_tpu.core.math). Component sums keep vimg_tpu's operand order
(``(x + y) + z``) so float32 results round the same way."""
from __future__ import annotations

import numpy as np
import torch


def vec3(x, y, z, dtype=torch.float32, device=None):
    """(..., 3) tensor of the broadcast components x, y, z."""
    parts = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z)))
    return torch.stack(parts, dim=-1)


def dot(a, b):
    """Dot product along the last axis, keepdims=False."""
    p = a * b
    if p.shape[-1] == 3:
        return p[..., 0] + p[..., 1] + p[..., 2]
    if p.shape[-1] == 2:
        return p[..., 0] + p[..., 1]
    return p.sum(-1)


def dotk(a, b):
    return dot(a, b)[..., None]


def cross(a, b):
    """Cross product with jnp.cross's per-component expressions."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length2(a):
    return dot(a, a)


def length(a):
    return sqrt_cr(length2(a))


def sqrt_cr(x):
    """Correctly rounded float32 square root. On the CPU, torch.sqrt runs
    through MKL's vector math, which is not correctly rounded and whose
    last bit depends on the code path MKL picks (it varied from process to
    process); the float64 root rounded to float32 is correct except in
    double-rounding ties. CUDA's sqrtf is correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def sqrt_pos(x):
    """``sqrt_cr(max(x, 0))`` with the same bits; under autograd its
    derivative is 0 where x <= 0, where the clamp's would let the root's
    infinite derivative at 0 through (ROADMAP C21)."""
    root = sqrt_cr(torch.clamp_min(x, 0.0))
    if not x.requires_grad:
        return root
    pos = x > 0.0
    safe = sqrt_cr(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, safe, root.detach())


def div(x, c):
    """``x / c`` for a Python number ``c``, correctly rounded on every
    device. PyTorch's CUDA division of a tensor by a Python number (or by
    a 0-d CPU tensor) multiplies by the number's float32 reciprocal, which
    is one ulp off x / c unless c is a power of two; vimg_tpu and the CPU
    divide. A 0-d tensor made on x's device by a fill kernel (no copy from
    the host) makes the card divide too."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def normalize(a):
    """Normalize; zero vectors map to zero."""
    n2 = dot(a, a)[..., None]
    inv = 1.0 / sqrt_cr(torch.clamp_min(n2, 1e-38))
    return a * torch.where(n2 > 0, inv, torch.zeros_like(inv))


def reflect(wi, n):
    """Mirror ``wi`` (pointing toward the surface) about the normal n."""
    return wi - 2.0 * dotk(wi, n) * n


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


_LUM = (0.212671, 0.715160, 0.072169)


def luminance(col):
    """Rec.709 luminance."""
    w = torch.tensor(_LUM, dtype=col.dtype, device=col.device)
    return dot(col, w)


def onb_from_normal(n):
    """Tangent/bitangent (u, v) for unit normal n; the frame is (u, v, n),
    with the n.z < -0.9999999 pole handled like vimg_tpu."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    a = 1.0 / torch.clamp_min(1.0 + nz, 1e-7)
    b = -nx * ny * a
    u_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    v_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    sing = (nz < -0.9999999)[..., None]
    u_sing = torch.tensor([0.0, -1.0, 0.0], dtype=n.dtype, device=n.device)
    v_sing = torch.tensor([-1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    return (torch.where(sing, u_sing, u_reg),
            torch.where(sing, v_sing, v_reg))


def onb_to_world(u, v, w, vec):
    """Local direction -> world."""
    return u * vec[..., 0:1] + v * vec[..., 1:2] + w * vec[..., 2:3]


def world_to_onb(u, v, w, vec):
    """World direction -> local frame coordinates."""
    return torch.stack([dot(vec, u), dot(vec, v), dot(vec, w)], dim=-1)


def gram_schmidt(v, w):
    """v minus its projection on the unit vector w."""
    return v - dotk(v, w) * w


def tgather(table, idx, limit=64):
    """Rows ``table[idx]``. vimg_tpu selects rows of a table of at most
    ``limit`` rows by a chain of ``where``s (no per-lane gather on its
    TPU); both forms give the same rows, so here it is one gather."""
    del limit
    return table[idx]


def xform_point(m, p):
    """Points (..., 3) through the affine part of a (4, 4) row-major
    matrix (numpy or tensor, as ``p``)."""
    return p @ m[:3, :3].T + m[:3, 3]


def xform_dir(m, d):
    """Directions (..., 3) through the linear part of a (4, 4) matrix."""
    return d @ m[:3, :3].T


def look_at(look_from, look_to, up):
    """Camera-to-world (4, 4) float32 numpy matrix: world = M @ [cam, 1]."""
    look_from = np.asarray(look_from, np.float32)
    look_to = np.asarray(look_to, np.float32)
    up = np.asarray(up, np.float32)

    def _norm(v):
        return v / np.linalg.norm(v)

    z = _norm(look_from - look_to)
    x = _norm(np.cross(up, z))
    y = _norm(np.cross(z, x))
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = look_from
    return m
