"""Persistent-path megakernel: the MIS / material integrator as one CUDA
kernel (port of vimg_tpu.render.mega.kernel), in two modes:

- analytic mode (kernel B1): <= 64 triangles without vertex normals, every
  primitive tested densely;
- mesh mode (kernel B2): more than 64 triangles, or any triangle with
  vertex normals; the triangles are traced by the skip walk of the binary
  cluster tree over ClusterData's tables, the spheres densely beside it.

- ``render_megakernel`` is the wrapper. A CUDA scene launches the
  hand-written kernel of ``csrc/megakernel.cu`` for its mode: persistent
  warps over groups of 32 pixels, a lane a pixel, each lane running its
  pixel's spp paths in sample order one segment an iteration. In analytic
  mode a lane whose path ends starts its next sample at once; in mesh
  mode it waits until every lane of the warp has ended the same sample. A
  CPU scene takes the plain PyTorch version. Any other device raises.
- ``render_megakernel_plain`` is the plain version: the chunked loop
  renderer over the loop integrators, traced by the SoA tracer (analytic
  mode) or the cluster tracer's plain skip walk (mesh mode), so it never
  launches a kernel, with the same segment and shadow-ray counts the
  kernel keeps, and in analytic mode its warp steps (``warp_steps``).
- Both shade the frame by pixel groups (``n_groups``, ``group_pixels``):
  32 consecutive pixels in analytic mode, an 8 x 4 tile in mesh mode.
  ``groups=(begin, end)`` renders groups [begin, end) only, the other
  pixels staying 0; ``render_megakernel_sharded`` gives each device of a
  mesh one range and assembles the film, bit for bit the whole-frame
  launch's, since a pixel's value does not depend on who shades it.
- ``LAUNCHES`` counts analytic-mode launches, ``LAUNCHES_MESH`` mesh-mode
  launches (plain renders count neither); ``LAST_COUNTS`` is the int64
  device tensor of the latest launch's counters: segments, shadow rays,
  then warp steps (analytic mode) or box and triangle tests and the
  walk's warp node and triangle steps (mesh mode).

Scene tables are numpy arrays packed on the host as vimg_tpu's
``_pack_scene`` packs them (triangle normals and areas in float32 with
XLA's operation order), uploaded once per scene. Mesh mode reads the
vertex normals through ``tri_vidx`` by index, as
``geometry/intersect.py::_tri_hit_info`` does, instead of vimg_tpu's
per-cluster attribute rows (``ClusterData(with_attrs=True)``), which exist
because a TPU lane cannot gather.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from vimg_tpu_torch.core import rng
from vimg_tpu_torch.core.math import div
from vimg_tpu_torch.scene import ir

LAUNCHES = 0
LAUNCHES_MESH = 0
LAST_COUNTS = None

MEGA_MAX_TRIS = 64           # analytic mode; larger meshes take mesh mode
MESH_MEGA_MAX_TRIS = 2_000_000
MEGA_MAX_MATERIALS = 256
MEGA_MAX_LIGHTS = 256
MEGA_MAX_SPHERES = 256

# kernel flag bits (csrc/megakernel.cu)
F_MIS, F_DOF, F_BG_EMISSIVE = 1, 2, 4
F_SHEEN, F_CLEAR, F_SPEC_TRANS = 8, 16, 32


def is_mesh_mode(scene: ir.Scene) -> bool:
    """vimg_tpu's switch (``_pack_scene``): more than 64 triangles, or any
    triangle with vertex normals."""
    nt = scene.n_tris()
    return nt > MEGA_MAX_TRIS or (
        nt > 0 and bool((scene.tri_flags & ir.TRI_HAS_NORMALS).any()))


def supports_megakernel(scene: ir.Scene, settings: ir.RenderSettings) -> bool:
    """True for the scenes the megakernel covers, as vimg_tpu decides it:
    mis/material integrator, up to MESH_MEGA_MAX_TRIS triangles and 256
    spheres, materials and lights, constant-colour materials (no
    anisotropic triangles), triangle/sphere lights and a constant
    background. Normal maps are refused too (not ported)."""
    if settings.integrator not in ("mis", "material"):
        return False
    nt, ns = scene.n_tris(), scene.n_spheres()
    if not 0 < nt + ns or nt > MESH_MEGA_MAX_TRIS or ns > MEGA_MAX_SPHERES:
        return False
    if scene.n_mats() > MEGA_MAX_MATERIALS or scene.n_lights() > MEGA_MAX_LIGHTS:
        return False
    if scene.has_envmap or scene.has_image_tex or scene.has_checker:
        return False
    if scene.lights_have_bg or scene.has_normal_maps:
        return False
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
# host-side packing (vimg_tpu.render.mega.kernel._pack_scene)
# ---------------------------------------------------------------------------

def _f32_cross(a, b):
    """Cross product of (3, ...) float32 arrays, component by component."""
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
    the three vertex normals (the face normal x3 on a triangle without
    TRI_HAS_NORMALS); sphere -> center, radius, emit."""
    lt = scene.light_type.cpu().numpy()
    li = scene.light_idx.cpu().numpy()
    rows = np.zeros((max(len(lt), 1), 32), np.float32)
    verts = scene.verts.cpu().numpy()
    vnormals = scene.vnormals.cpu().numpy()
    tvidx = scene.tri_vidx.cpu().numpy()
    tri_mat = scene.tri_mat.cpu().numpy()
    tri_flags = scene.tri_flags.cpu().numpy()
    sph_mat = scene.sph_mat.cpu().numpy()
    centers = scene.sph_center.cpu().numpy()
    radii = scene.sph_radius.cpu().numpy()
    for l, (t, idx) in enumerate(zip(lt, li)):
        if t == ir.LIGHT_TRI:
            p0, p1, p2 = verts[tvidx[idx]]
            nrm = _unit(_f32_cross(p1 - p0, p2 - p0))
            area = _half_area(_f32_cross(p2 - p0, p1 - p0))
            vn = (vnormals[tvidx[idx]].reshape(-1)
                  if tri_flags[idx] & ir.TRI_HAS_NORMALS else
                  np.concatenate([nrm, nrm, nrm]))
            rows[l, :25] = np.concatenate(
                [p0, p1, p2, nrm, [area], mat_base[tri_mat[idx]], vn])
        elif t == ir.LIGHT_SPHERE:
            rows[l, :7] = np.concatenate(
                [centers[idx], [radii[idx]], mat_base[sph_mat[idx]]])
    return rows


def _tri_v(scene: ir.Scene):
    """(nt, 16) per-triangle shading rows: p0, p1, p2, unit n_g (as
    intersect._tri_hit_info computes it) and the area (as emitters.surf_pdf
    computes it), in float32 with the same operation order, whole arrays at
    once."""
    nt = scene.n_tris()
    tri_v = np.zeros((max(nt, 1), 16), np.float32)
    if nt:
        verts = scene.verts.cpu().numpy()
        tv = scene.tri_vidx.cpu().numpy()
        p0, p1, p2 = (verts[tv[:, k]] for k in range(3))
        tri_v[:nt, 0:3] = p0
        tri_v[:nt, 3:6] = p1
        tri_v[:nt, 6:9] = p2
        a0, a1, a2 = p0.T, p1.T, p2.T
        tri_v[:nt, 9:12] = _unit(_f32_cross(a1 - a0, a2 - a0)).T
        tri_v[:nt, 12] = _half_area(_f32_cross(a2 - a0, a1 - a0))
    return tri_v


def _pack_common(scene: ir.Scene):
    """The tables both modes read (see the Tables struct in the source)."""
    ns = scene.n_spheres()
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
        tri_v=_tri_v(scene), sph=sph,
        prim_mat=np.concatenate([scene.tri_mat.cpu().numpy(),
                                 scene.sph_mat.cpu().numpy(), [0]]
                                ).astype(np.int32),
        mat_type=scene.mat_type.cpu().numpy().astype(np.int32),
        mat_base=mat_base,
        mat_sc=scene.mat_scalars.cpu().numpy().astype(np.float32),
        light_rows=_light_rows32(scene, mat_base),
        light_type=np.concatenate([scene.light_type.cpu().numpy(), [0]]
                                  ).astype(np.int32))


def _pack_scene(scene: ir.Scene):
    """Numpy tables of analytic mode (see the Tables struct in the
    source)."""
    from vimg_tpu_torch.geometry.soa_intersect import build_constants
    tri_c, _ = build_constants(scene)
    return dict(_pack_common(scene),
                tri_c=(tri_c if scene.n_tris() else
                       np.zeros((1, 12), np.float32)))


def _pack_scene_mesh(scene: ir.Scene, data):
    """Numpy tables of mesh mode: the common tables (``tri_v`` covers every
    triangle, indexed by the triangle id that ``perm`` maps a hit slot to),
    ClusterData ``data``'s binary tree and triangle rows as flat views, and
    the vertex normals with the per-triangle vertex ids and flags."""
    return dict(
        _pack_common(scene),
        node_aabbs=data.node_aabbs.reshape(-1),
        node_cid=data.node_cid.reshape(-1),
        node_skip=data.node_skip.reshape(-1),
        tri_rows=data.tri_rows.reshape(-1),
        perm=data.perm.astype(np.int32),
        vnormals=scene.vnormals.cpu().numpy().astype(np.float32),
        tri_vidx=scene.tri_vidx.cpu().numpy().astype(np.int32),
        tri_flags=scene.tri_flags.cpu().numpy().astype(np.int32))


def _cam_table(scene: ir.Scene):
    """24 floats: vfov, aperture, focal, img_h, img_w, rotation (9, row
    major), translation, background, the two R2 constants, camera width and
    height. img_h/img_w use camera.generate_rays's tensor ops on the scene's
    device, so kernel and plain version start from the same image plane."""
    cam = scene.camera
    theta = cam.vfov_deg * (math.pi / 180.0)
    img_h = 2.0 * torch.tan(theta * 0.5)
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
_MESH_TABLE_ORDER = ("tri_v", "sph", "prim_mat", "mat_type", "mat_base",
                     "mat_sc", "light_rows", "light_type", "cam",
                     "node_aabbs", "node_cid", "node_skip", "tri_rows",
                     "perm", "vnormals", "tri_vidx", "tri_flags")
_INT_TABLES = ("prim_mat", "mat_type", "light_type", "node_cid", "node_skip",
               "perm", "tri_vidx", "tri_flags")
_DATA_CACHE = {}
_TABLE_CACHE = {}


def _cached(cache, scene, build):
    """``build(scene)`` cached per Scene (the cache holds the scene itself,
    so its id cannot be reused)."""
    hit = cache.get(id(scene))
    if hit is not None and hit[0] is scene:
        return hit[1]
    val = build(scene)
    if len(cache) > 16:
        cache.clear()
    cache[id(scene)] = (scene, val)
    return val


def cluster_data(scene: ir.Scene):
    """The scene's ClusterData (native builder), built once and shared by
    the mesh-mode kernel and its plain version."""
    from vimg_tpu_torch.geometry.cluster_trace import ClusterData
    return _cached(_DATA_CACHE, scene, ClusterData)


def _build_device_tables(scene: ir.Scene):
    tabs = (_pack_scene_mesh(scene, cluster_data(scene))
            if is_mesh_mode(scene) else _pack_scene(scene))
    tabs["cam"] = _cam_table(scene)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(scene.device)
            for k, v in tabs.items()}


def _device_tables(scene: ir.Scene):
    """Packed tables of the scene's mode as contiguous device tensors,
    cached per Scene."""
    return _cached(_TABLE_CACHE, scene, _build_device_tables)


def _table_shapes(scene: ir.Scene):
    """Shape of each table as the kernel indexes it."""
    nt, ns = scene.n_tris(), scene.n_spheres()
    nm, nl = scene.n_mats(), scene.n_lights()
    shapes = dict(tri_v=(max(nt, 1), 16), sph=(max(ns, 1), 8),
                  prim_mat=(nt + ns + 1,), mat_type=(nm,), mat_base=(nm, 3),
                  mat_sc=(nm, 12), light_rows=(max(nl, 1), 32),
                  light_type=(nl + 1,), cam=(24,))
    if not is_mesh_mode(scene):
        return dict(shapes, tri_c=(max(nt, 1), 12))
    data = cluster_data(scene)
    m, c = data.n_nodes, data.n_clusters
    return dict(shapes, node_aabbs=(-(-m // 16) * 16 * 8,),
                node_cid=(-(-m // 128) * 128,),
                node_skip=(-(-m // 128) * 128,),
                tri_rows=(c * data.max_k * 16,), perm=(c * data.max_k,),
                vnormals=(scene.verts.shape[0], 3), tri_vidx=(nt, 3),
                tri_flags=(nt,))


def _check(t: torch.Tensor, name, dtype, shape, device):
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# wrapper + plain version
# ---------------------------------------------------------------------------

def plain_tracer(scene: ir.Scene):
    """The plain version's tracer: the SoA tracer (B1's dense loop) in
    analytic mode, the cluster tracer's plain skip walk (B2's walk) in mesh
    mode. Neither launches a kernel on any device."""
    if is_mesh_mode(scene):
        from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
        return ClusterTracer(scene, walk="skip", plain=True,
                             data=cluster_data(scene))
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    return SoATracer(scene)


GROUP_W, GROUP_H = 8, 4      # mesh mode's pixel tile (csrc/megakernel.cu)


def n_groups(scene: ir.Scene, settings: ir.RenderSettings) -> int:
    """The frame's pixel groups in the scene's mode."""
    W, H = settings.width, settings.height
    if not is_mesh_mode(scene):
        return -(-W * H // 32)
    return -(-W // GROUP_W) * -(-H // GROUP_H)


def group_pixels(scene: ir.Scene, settings: ir.RenderSettings, begin, end):
    """The pixel ids (int64, on the scene's device) of groups [begin, end),
    group by group, each in lane order; lanes outside the image drop out."""
    W, H = settings.width, settings.height
    dev = scene.device
    if not is_mesh_mode(scene):
        return torch.arange(32 * begin, min(32 * end, W * H), device=dev)
    g = torch.arange(begin, end, device=dev)[:, None]
    lane = torch.arange(32, device=dev)[None, :]
    gx = -(-W // GROUP_W)
    x = (g % gx) * GROUP_W + lane % GROUP_W
    row = (g // gx) * GROUP_H + lane // GROUP_W
    keep = (x < W) & (row < H)
    return (row * W + x)[keep]


def _group_range(scene, settings, groups):
    n = n_groups(scene, settings)
    begin, end = (0, n) if groups is None else (int(g) for g in groups)
    if not 0 <= begin <= end <= n:
        raise ValueError(f"groups [{begin}, {end}) outside the frame's "
                         f"{n} groups")
    return begin, end, (begin, end) == (0, n)


def warp_steps(pixel_segments: torch.Tensor, group=32) -> int:
    """The analytic kernel's warp steps from the segments of each pixel
    (all its samples): a warp shades ``group`` consecutive pixels and
    iterates until its busiest lane is done, so each group costs its
    largest pixel total."""
    n = pixel_segments.numel()
    padded = torch.zeros(-(-n // group) * group, dtype=torch.int64,
                         device=pixel_segments.device)
    padded[:n] = pixel_segments
    return int(padded.view(-1, group).amax(1).sum())


def render_megakernel_plain(scene: ir.Scene, settings: ir.RenderSettings,
                            sample_offset=0, return_stats=False,
                            progress=False, groups=None):
    """Plain PyTorch version: the loop renderer over trace_radiance with
    ``plain_tracer``, on any device, counting segments and shadow rays
    like the kernel, and in analytic mode (with ``return_stats``) its warp
    steps from the segments of each pixel; ``groups`` as the kernel's."""
    from vimg_tpu_torch.render.render import render
    stats = {"segments": 0, "shadow_rays": 0}
    if return_stats and not is_mesh_mode(scene):
        stats["pixel_segments"] = torch.zeros(
            settings.width * settings.height, dtype=torch.int64,
            device=scene.device)
    begin, end, whole = _group_range(scene, settings, groups)
    t0 = time.time()
    img = render(scene, settings, progress=progress,
                 sample_offset=sample_offset, stats=stats,
                 tracer=plain_tracer(scene),
                 pixels=None if whole else group_pixels(scene, settings,
                                                        begin, end))
    if "pixel_segments" in stats:
        stats["warp_steps"] = warp_steps(stats.pop("pixel_segments"))
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    stats["seconds"] = time.time() - t0
    return (img, stats) if return_stats else img


def render_megakernel(scene: ir.Scene, settings: ir.RenderSettings,
                      sample_offset=0, return_stats=False, progress=False,
                      groups=None):
    """Full-frame render through the CUDA megakernel of the scene's mode
    (CUDA scenes) or its plain version (CPU scenes). Returns the linear
    (H, W, 3) image on the scene's device, plus a stats dict (segments,
    shadow_rays, seconds; in analytic mode also warp_steps, in mesh mode
    the walk's box_tests and tri_tests and its warp_node_steps and
    warp_tri_steps: the lane fill is tri_tests / (32 x warp_tri_steps))
    with ``return_stats``. ``groups=(begin, end)`` shades pixel groups
    [begin, end) only (default: all); the other pixels are 0."""
    dev = scene.device
    if dev.type == "cpu":
        return render_megakernel_plain(scene, settings, sample_offset,
                                       return_stats, progress, groups)
    if dev.type != "cuda":
        raise NotImplementedError(f"no megakernel for device {dev}")
    return _launch(scene, settings, sample_offset, return_stats, progress,
                   groups=groups)


def _launch(scene, settings, sample_offset=0, return_stats=False,
            progress=False, blocks=0, lib=None, groups=None):
    """The kernel launch of ``render_megakernel`` on ``blocks`` persistent
    blocks (0: as many as the card holds at once), from the kernel library
    ``lib`` (default: ``runtime.cuda``'s), over pixel groups ``groups``
    (default: all). The film does not depend on ``blocks``."""
    global LAUNCHES, LAUNCHES_MESH, LAST_COUNTS
    dev = scene.device
    if not supports_megakernel(scene, settings):
        raise ValueError("scene/settings outside the megakernel's feature "
                         "set (see supports_megakernel)")
    from vimg_tpu_torch.runtime.cuda import check, load_library
    lib = load_library() if lib is None else lib
    mesh = is_mesh_mode(scene)
    order = _MESH_TABLE_ORDER if mesh else _TABLE_ORDER
    tabs = _device_tables(scene)
    shapes = _table_shapes(scene)
    for k in order:
        _check(tabs[k], k, torch.int32 if k in _INT_TABLES else torch.float32,
               shapes[k], dev)
    W, H, spp = settings.width, settings.height, settings.spp
    nt, ns, nl = scene.n_tris(), scene.n_spheres(), scene.n_lights()
    begin, end, whole = _group_range(scene, settings, groups)
    run = (W, H, spp, min(settings.max_depth, 2 ** 31 - 1),
           int(sample_offset), _flags(scene, settings), begin, end)
    # a range launch leaves the other pixels unwritten
    film = (torch.empty if whole else torch.zeros)(
        (H * W, 3), dtype=torch.float32, device=dev)
    if mesh:
        # the walk reads node boxes and triangle rows 16 bytes at a time
        for k in ("node_aabbs", "tri_rows"):
            if tabs[k].data_ptr() % 16:
                raise ValueError(f"{k}: not 16-byte aligned")
    # the kernel's counters, then its pixel-group counter, which starts at
    # the range's first group
    counts = torch.zeros((7 if mesh else 4,), dtype=torch.int64, device=dev)
    next_group = counts[-1:].view(torch.int32)
    if begin:
        next_group[0] = begin
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        ptrs = [tabs[k].data_ptr() for k in order]
        if mesh:
            rc = lib.vimg_mega_render_mesh(
                *ptrs, nt, ns, nl, cluster_data(scene).n_nodes, *run,
                blocks, film.data_ptr(), counts.data_ptr(),
                next_group.data_ptr(), stream.cuda_stream)
            check(rc, "megakernel (mesh mode)")
            LAUNCHES_MESH += 1
        else:
            rc = lib.vimg_mega_render(
                *ptrs, nt, ns, nl, *run, blocks,
                film.data_ptr(), counts.data_ptr(), next_group.data_ptr(),
                stream.cuda_stream)
            check(rc, "megakernel")
            LAUNCHES += 1
        LAST_COUNTS = counts[:-1]
        end.record(stream)
    img = div(film.view(H, W, 3), spp)
    if not (return_stats or progress):
        return img
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    vals = [int(v) for v in counts.cpu()]
    segs, shadow = vals[:2]
    if progress:
        print(f"Megakernel: {W * H * spp / max(seconds, 1e-9) / 1e6:.2f} "
              f"Mpaths/s, {(segs + shadow) / max(seconds, 1e-9) / 1e6:.2f} "
              f"Mrays/s ({segs / 1e6:.1f}M segments + {shadow / 1e6:.1f}M "
              f"shadow)")
    if not return_stats:
        return img
    stats = dict(segments=segs, shadow_rays=shadow, seconds=seconds)
    if mesh:
        stats.update(box_tests=vals[2], tri_tests=vals[3],
                     warp_node_steps=vals[4], warp_tri_steps=vals[5])
    else:
        stats.update(warp_steps=vals[2])
    return img, stats


def occupancy(scene: ir.Scene, settings: ir.RenderSettings, lib=None):
    """What the launch of this frame runs on the card: resident blocks of
    128 threads per SM, registers and local-memory bytes a thread (dict;
    CUDA only), from the kernel library ``lib`` as in ``_launch``."""
    import ctypes
    from vimg_tpu_torch.runtime.cuda import check, load_library
    lib = load_library() if lib is None else lib
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(scene.device):
        check(lib.vimg_mega_occupancy(
            int(is_mesh_mode(scene)), int(settings.integrator == "mis"),
            *(ctypes.byref(v) for v in vals)), "megakernel occupancy")
    per_sm, regs, local = (v.value for v in vals)
    return dict(blocks_per_sm=per_sm, warps_per_sm=4 * per_sm,
                registers=regs, local_bytes=local)


def render_megakernel_sharded(scene: ir.Scene, settings: ir.RenderSettings,
                              mesh=None, return_stats=False,
                              sample_offset=0):
    """The frame's pixel groups split into one contiguous range per device
    of ``mesh`` (``parallel.sharding.make_mesh``; default: every visible
    CUDA device), each range rendered by ``render_megakernel`` on its
    device (the scene copied to devices other than its own) and its
    pixels copied into one film on the scene's device: bit for bit the
    whole-frame launch's. A mesh may name one device more than once: its
    ranges then launch in turn there. With ``return_stats`` the shards'
    counts are summed and ``seconds`` is the host's time to the assembled
    film."""
    from vimg_tpu_torch.parallel.sharding import make_mesh, replicate
    mesh = mesh or make_mesh()
    W, H = settings.width, settings.height
    n = n_groups(scene, settings)
    per = -(-n // mesh.size)
    t0 = time.time()
    parts = []
    for i, d in enumerate(mesh.devices):
        begin, end = min(i * per, n), min((i + 1) * per, n)
        sc = replicate(scene, d)
        out = render_megakernel(sc, settings, sample_offset=sample_offset,
                                return_stats=return_stats,
                                groups=(begin, end))
        parts.append((sc, begin, end, out))
    film = torch.zeros((H * W, 3), dtype=torch.float32, device=scene.device)
    stats = {}
    for sc, begin, end, out in parts:
        img, st = out if return_stats else (out, {})
        pix = group_pixels(sc, settings, begin, end)
        film[pix.to(scene.device)] = img.reshape(-1, 3)[pix].to(scene.device)
        for k, v in st.items():
            if k != "seconds":
                stats[k] = stats.get(k, 0) + v
    img = film.view(H, W, 3)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    if not return_stats:
        return img
    return img, dict(stats, seconds=time.time() - t0)
