"""Persistent-path megakernel: the MIS / material integrator as one CUDA
kernel (port of vimg_tpu.render.mega.kernel, analytic mode).

- ``render_megakernel`` is the wrapper. A CUDA scene launches the
  hand-written kernel of ``csrc/megakernel.cu`` (one thread per pixel, all
  spp paths back to back); a CPU scene takes the plain PyTorch version.
  Any other device raises.
- ``render_megakernel_plain`` is the plain version: the chunked loop
  renderer over the loop integrators, with the same segment and shadow-ray
  counts the kernel keeps.
- ``LAUNCHES`` counts kernel launches (plain renders do not count);
  ``LAST_COUNTS`` is the (segments, shadow rays) int64 device tensor of
  the latest launch.

Scene tables are small numpy arrays packed on the host exactly as
vimg_tpu's ``_pack_scene`` packs them (triangle normals and areas in
float32 with XLA's operation order), uploaded once per scene.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.scene import ir

LAUNCHES = 0
LAST_COUNTS = None

MEGA_MAX_TRIS = 64           # analytic mode; larger meshes are slice 4
MEGA_MAX_MATERIALS = 256
MEGA_MAX_LIGHTS = 256
MEGA_MAX_SPHERES = 256

# kernel flag bits (csrc/megakernel.cu)
F_MIS, F_DOF, F_BG_EMISSIVE = 1, 2, 4
F_SHEEN, F_CLEAR, F_SPEC_TRANS = 8, 16, 32


def supports_megakernel(scene: ir.Scene, settings: ir.RenderSettings) -> bool:
    """True for the scenes the analytic megakernel covers: mis/material
    integrator, 1..64 triangles without vertex normals, constant-colour
    materials, triangle/sphere lights and a constant background."""
    if settings.integrator not in ("mis", "material"):
        return False
    nt, ns = scene.n_tris(), scene.n_spheres()
    if not 0 < nt + ns or nt > MEGA_MAX_TRIS or ns > MEGA_MAX_SPHERES:
        return False
    if scene.n_mats() > MEGA_MAX_MATERIALS or scene.n_lights() > MEGA_MAX_LIGHTS:
        return False
    if scene.has_envmap or scene.has_image_tex or scene.has_checker:
        return False
    if scene.lights_have_bg or scene.has_normal_maps:
        return False
    if nt and bool((scene.tri_flags & ir.TRI_HAS_NORMALS).any()):
        return False          # smooth shading is mesh mode (slice 4)
    if nt and scene.has_aniso:
        aniso = scene.mat_scalars[:, ir.MS_ANISO] != 0.0
        if bool(aniso[scene.tri_mat].any()):
            return False
    mtex = scene.mat_tex[:, 0]
    has_tex = mtex >= 0
    if bool(has_tex.any()):
        if bool((has_tex & (scene.tex_type[mtex.clamp_min(0)]
                            != ir.TEX_CONST)).any()):
            return False
    return True


# ---------------------------------------------------------------------------
# host-side packing (vimg_tpu.render.mega.kernel._pack_scene, analytic mode)
# ---------------------------------------------------------------------------

def _f32_cross(a, b):
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    return np.stack([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _f32_norm2(c):
    return (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]


def _unit(c):
    return c * (np.float32(1.0)
                / np.sqrt(np.maximum(_f32_norm2(c), np.float32(1e-38))))


def _half_area(c):
    return np.sqrt(np.maximum(_f32_norm2(c), np.float32(0.0))) / np.float32(2.0)


def _resolved_mat_base(scene):
    """Base colours with constant textures resolved host-side."""
    mat_base = scene.mat_base.cpu().numpy().astype(np.float32).copy()
    mtex = scene.mat_tex.cpu().numpy()
    cols = scene.tex_cols.cpu().numpy()
    for k in range(mat_base.shape[0]):
        if mtex[k, 0] >= 0:
            mat_base[k] = cols[mtex[k, 0], 0]
    return mat_base


def _light_rows32(scene, mat_base):
    """32-wide light rows: tri -> p0, p1, p2, unit normal, area, emit, then
    the three vertex normals (the face normal x3); sphere -> center,
    radius, emit."""
    lt = scene.light_type.cpu().numpy()
    li = scene.light_idx.cpu().numpy()
    rows = np.zeros((max(len(lt), 1), 32), np.float32)
    verts = scene.verts.cpu().numpy()
    tvidx = scene.tri_vidx.cpu().numpy()
    tri_mat = scene.tri_mat.cpu().numpy()
    sph_mat = scene.sph_mat.cpu().numpy()
    centers = scene.sph_center.cpu().numpy()
    radii = scene.sph_radius.cpu().numpy()
    for l, (t, idx) in enumerate(zip(lt, li)):
        if t == ir.LIGHT_TRI:
            p0, p1, p2 = verts[tvidx[idx]]
            nrm = _unit(_f32_cross(p1 - p0, p2 - p0))
            area = _half_area(_f32_cross(p2 - p0, p1 - p0))
            rows[l, :25] = np.concatenate(
                [p0, p1, p2, nrm, [area], mat_base[tri_mat[idx]],
                 nrm, nrm, nrm])
        elif t == ir.LIGHT_SPHERE:
            rows[l, :7] = np.concatenate(
                [centers[idx], [radii[idx]], mat_base[sph_mat[idx]]])
    return rows


def _pack_scene(scene: ir.Scene):
    """Numpy tables of the kernel (see the Tables struct in the source)."""
    from vimg_tpu_torch.geometry.soa_intersect import build_constants
    tri_c, _ = build_constants(scene)
    nt, ns = scene.n_tris(), scene.n_spheres()
    tri_v = np.zeros((max(nt, 1), 16), np.float32)
    if nt:
        verts = scene.verts.cpu().numpy()
        tv = scene.tri_vidx.cpu().numpy()
        for i in range(nt):
            p0, p1, p2 = verts[tv[i, 0]], verts[tv[i, 1]], verts[tv[i, 2]]
            # intersect._tri_hit_info's n_g and emitters.surf_pdf's area in
            # float32 with the same operation order
            tri_v[i, :13] = np.concatenate(
                [p0, p1, p2, _unit(_f32_cross(p1 - p0, p2 - p0)),
                 [_half_area(_f32_cross(p2 - p0, p1 - p0))]])
    sph = np.zeros((max(ns, 1), 8), np.float32)
    if ns:
        c = scene.sph_center.cpu().numpy()
        r = scene.sph_radius.cpu().numpy()
        c64 = c.astype(np.float64)
        r64 = r.astype(np.float64)
        sph[:ns, :3] = c
        sph[:ns, 3] = r64 * r64
        # |c|^2: a float64 sum rounded to float32, as the SoA tracer's
        # Python-scalar constant is
        sph[:ns, 4] = (c64[:, 0] * c64[:, 0] + c64[:, 1] * c64[:, 1]
                       + c64[:, 2] * c64[:, 2])
        sph[:ns, 5] = r
    mat_base = _resolved_mat_base(scene)
    return dict(
        tri_c=(tri_c if nt else np.zeros((1, 12), np.float32)),
        tri_v=tri_v, sph=sph,
        prim_mat=np.concatenate([scene.tri_mat.cpu().numpy(),
                                 scene.sph_mat.cpu().numpy(), [0]]
                                ).astype(np.int32),
        mat_type=scene.mat_type.cpu().numpy().astype(np.int32),
        mat_base=mat_base,
        mat_sc=scene.mat_scalars.cpu().numpy().astype(np.float32),
        light_rows=_light_rows32(scene, mat_base),
        light_type=np.concatenate([scene.light_type.cpu().numpy(), [0]]
                                  ).astype(np.int32))


def _cam_table(scene: ir.Scene):
    """24 floats: vfov, aperture, focal, img_h, img_w, rotation (9, row
    major), translation, background, the two R2 constants, camera width and
    height. img_h/img_w use camera.generate_rays's tensor ops on the scene's
    device, so kernel and plain version start from the same image plane."""
    cam = scene.camera
    theta = cam.vfov_deg * (math.pi / 180.0)
    img_h = 2.0 * torch.tan(theta / 2.0)
    img_w = img_h * (cam.width / cam.height)
    c2w = cam.cam2world.cpu().numpy()
    return np.concatenate([
        [float(cam.vfov_deg), float(cam.aperture_radius),
         float(cam.focal_dist), float(img_h), float(img_w)],
        c2w[:3, :3].reshape(-1), c2w[:3, 3],
        scene.bg_color.cpu().numpy(),
        [float(rng._A1), float(rng._A2), cam.width, cam.height]]
    ).astype(np.float32)


def _flags(scene: ir.Scene, settings):
    bits = [(settings.integrator == "mis", F_MIS),
            (float(scene.camera.aperture_radius) > 0.0, F_DOF),
            (scene.bg_is_emissive, F_BG_EMISSIVE),
            (scene.has_sheen, F_SHEEN),
            (scene.has_clearcoat, F_CLEAR),
            (scene.has_spec_trans, F_SPEC_TRANS)]
    return sum(bit for on, bit in bits if on)


_TABLE_ORDER = ("tri_c", "tri_v", "sph", "prim_mat", "mat_type", "mat_base",
                "mat_sc", "light_rows", "light_type", "cam")
_TABLE_CACHE = {}


def _device_tables(scene: ir.Scene):
    """Packed tables as contiguous device tensors, cached per Scene (the
    cache holds the scene itself, so its id cannot be reused)."""
    hit = _TABLE_CACHE.get(id(scene))
    if hit is not None and hit[0] is scene:
        return hit[1]
    tabs = _pack_scene(scene)
    tabs["cam"] = _cam_table(scene)
    dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(scene.device)
           for k, v in tabs.items()}
    if len(_TABLE_CACHE) > 16:
        _TABLE_CACHE.clear()
    _TABLE_CACHE[id(scene)] = (scene, dev)
    return dev


def _table_shapes(scene: ir.Scene):
    """Shape of each table as the kernel indexes it."""
    nt, ns = scene.n_tris(), scene.n_spheres()
    nm, nl = scene.n_mats(), scene.n_lights()
    return dict(tri_c=(max(nt, 1), 12), tri_v=(max(nt, 1), 16),
                sph=(max(ns, 1), 8), prim_mat=(nt + ns + 1,),
                mat_type=(nm,), mat_base=(nm, 3), mat_sc=(nm, 12),
                light_rows=(max(nl, 1), 32), light_type=(nl + 1,),
                cam=(24,))


def _check(t: torch.Tensor, name, dtype, shape, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# wrapper + plain version
# ---------------------------------------------------------------------------

def render_megakernel_plain(scene: ir.Scene, settings: ir.RenderSettings,
                            sample_offset=0, return_stats=False,
                            progress=False):
    """Plain PyTorch version: the loop renderer over trace_radiance, on any
    device, counting segments and shadow rays like the kernel."""
    from vimg_tpu_torch.render.render import render
    stats = {"segments": 0, "shadow_rays": 0}
    t0 = time.time()
    img = render(scene, settings, progress=progress,
                 sample_offset=sample_offset, stats=stats)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    stats["seconds"] = time.time() - t0
    return (img, stats) if return_stats else img


def render_megakernel(scene: ir.Scene, settings: ir.RenderSettings,
                      sample_offset=0, return_stats=False, progress=False):
    """Full-frame render through the CUDA megakernel (CUDA scenes) or its
    plain version (CPU scenes). Returns the linear (H, W, 3) image on the
    scene's device, plus a stats dict (segments, shadow_rays, seconds)
    with ``return_stats``."""
    global LAUNCHES, LAST_COUNTS
    dev = scene.device
    if dev.type == "cpu":
        return render_megakernel_plain(scene, settings, sample_offset,
                                       return_stats, progress)
    if dev.type != "cuda":
        raise NotImplementedError(f"no megakernel for device {dev}")
    if not supports_megakernel(scene, settings):
        raise ValueError("scene/settings outside the megakernel's feature "
                         "set (see supports_megakernel)")
    from vimg_tpu_torch.runtime.cuda import check, load_library
    lib = load_library()
    tabs = _device_tables(scene)
    shapes = _table_shapes(scene)
    for k in _TABLE_ORDER:
        _check(tabs[k], k, torch.int32 if k in ("prim_mat", "mat_type",
                                                "light_type")
               else torch.float32, shapes[k], dev)
    W, H, spp = settings.width, settings.height, settings.spp
    film = torch.empty((H * W, 3), dtype=torch.float32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rc = lib.vimg_mega_render(
            *(tabs[k].data_ptr() for k in _TABLE_ORDER),
            scene.n_tris(), scene.n_spheres(), scene.n_lights(), W, H, spp,
            min(settings.max_depth, 2 ** 31 - 1), int(sample_offset),
            _flags(scene, settings),
            film.data_ptr(), counts.data_ptr(), stream.cuda_stream)
        check(rc, "megakernel")
        LAUNCHES += 1
        LAST_COUNTS = counts
        end.record(stream)
    img = film.view(H, W, 3) / spp
    if not (return_stats or progress):
        return img
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    segs, shadow = (int(v) for v in counts.cpu())
    if progress:
        print(f"Megakernel: {W * H * spp / max(seconds, 1e-9) / 1e6:.2f} "
              f"Mpaths/s, {(segs + shadow) / max(seconds, 1e-9) / 1e6:.2f} "
              f"Mrays/s ({segs / 1e6:.1f}M segments + {shadow / 1e6:.1f}M "
              f"shadow)")
    if return_stats:
        return img, dict(segments=segs, shadow_rays=shadow, seconds=seconds)
    return img
