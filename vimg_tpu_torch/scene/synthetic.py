"""Synthetic mesh scenes for benchmarks and tests (port of
vimg_tpu.scene.synthetic): a displacement-mapped sphere ("bumpy sphere")
and a fractal heightfield ("terrain"), each with an area light, the
env-lit textured terrain, and the many-lights and multi-material scenes.
The meshes, textures and env maps are vimg_tpu's numpy code verbatim, so
both packages build the same bytes from the same seed. The scenes land on
``device``, CUDA by default (raises without CUDA unless ``device="cpu"``
is passed).
"""
from __future__ import annotations

import numpy as np

from vimg_tpu_torch.core.math import look_at
from vimg_tpu_torch.render.camera import Camera
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.json_loader import SceneBuilder


def bumpy_sphere_mesh(n_tris=100_000, seed=0, bump=0.05):
    """(verts, tris) of a displacement-mapped UV sphere with ~n_tris."""
    rs = np.random.RandomState(seed)
    n = int(np.sqrt(n_tris / 2)) + 1
    th = np.linspace(1e-3, np.pi - 1e-3, n)
    ph = np.linspace(0, 2 * np.pi, n)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + bump * rs.randn(n, n)
    verts = np.stack([(r * np.sin(tt) * np.cos(pp)).ravel(),
                      (r * np.cos(tt)).ravel(),
                      (r * np.sin(tt) * np.sin(pp)).ravel()],
                     -1).astype(np.float32)
    idx = np.arange((n - 1) * n).reshape(n - 1, n)[:, :n - 1].ravel()
    a = idx
    tris = np.concatenate([
        np.stack([a, a + 1, a + n], -1),
        np.stack([a + 1, a + n + 1, a + n], -1)], axis=0)
    # interleave the two halves to keep spatial locality in index order
    tris = np.stack([tris[:len(a)], tris[len(a):]], axis=1).reshape(-1, 3)
    return verts, np.ascontiguousarray(tris[:n_tris] if len(tris) > n_tris
                                       else tris)


def bumpy_sphere_scene(n_tris=100_000, width=512, height=256, seed=0,
                       with_light=True, material=ir.MAT_LAMBERTIAN,
                       smooth_normals=False, light_shape="quad",
                       device="cuda"):
    """Mesh benchmark scene: bumpy sphere + emissive quad (or sphere)
    overhead."""
    verts, tris = bumpy_sphere_mesh(n_tris, seed)
    b = SceneBuilder()
    m = b.add_material(material, base=(0.6, 0.55, 0.5))
    normals = None
    if smooth_normals:
        # area-weighted vertex normals
        p = verts[tris]
        fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        normals = np.zeros_like(verts)
        for k in range(3):
            np.add.at(normals, tris[:, k], fn)
        normals /= np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    b.add_mesh(verts, tris, m, normals=normals)
    if with_light:
        light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(18.0, 17.0, 15.0))
        if light_shape == "sphere":
            b.add_sphere((0.0, 2.4, 0.0), 0.35, light)
        else:
            # 1.2x1.2 quad at y=2.4 facing down (emission is one-sided)
            lv = np.array([[-0.6, 2.4, -0.6], [0.6, 2.4, -0.6],
                           [0.6, 2.4, 0.6], [-0.6, 2.4, 0.6]], np.float32)
            b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]]), light)
    cam = Camera.make(look_at([0.0, 0.6, 3.2], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0]), width, height, 40.0,
                      device=device)
    return b.build(camera=cam, bg_color=(0.05, 0.06, 0.08), device=device)


def terrain_mesh(n_tris=100_000, seed=0, size=8.0, relief=0.8):
    """(verts, tris) of a fractal-noise heightfield with ~n_tris."""
    rs = np.random.RandomState(seed)
    n = int(np.sqrt(n_tris / 2)) + 1
    xs = np.linspace(-size / 2, size / 2, n)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
    h = np.zeros((n, n))
    for octave in range(4):
        f = 2.0 ** octave
        h += (np.sin(xx * 1.7 * f + rs.rand() * 9)
              * np.cos(zz * 1.3 * f + rs.rand() * 9)) / (1.6 ** octave)
    h = (h / np.abs(h).max()) * relief
    verts = np.stack([xx.ravel(), h.ravel(), zz.ravel()], -1).astype(
        np.float32)
    idx = np.arange((n - 1) * n).reshape(n - 1, n)[:, :n - 1].ravel()
    a = idx
    tris = np.concatenate([
        np.stack([a, a + 1, a + n], -1),
        np.stack([a + 1, a + n + 1, a + n], -1)], axis=0)
    tris = np.stack([tris[:len(a)], tris[len(a):]], axis=1).reshape(-1, 3)
    return verts, np.ascontiguousarray(tris[:n_tris] if len(tris) > n_tris
                                       else tris)


def terrain_scene(n_tris=100_000, width=512, height=256, seed=0,
                  device="cuda"):
    """Open-terrain mesh benchmark scene: heightfield + overhead light."""
    verts, tris = terrain_mesh(n_tris, seed)
    b = SceneBuilder()
    m = b.add_material(ir.MAT_LAMBERTIAN, base=(0.55, 0.5, 0.42))
    b.add_mesh(verts, tris, m)
    light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(14.0, 13.5, 12.0))
    lv = np.array([[-1.2, 4.0, -1.2], [1.2, 4.0, -1.2],
                   [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2]], np.float32)
    b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]]), light)
    cam = Camera.make(look_at([0.0, 2.2, 4.6], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0]), width, height, 45.0,
                      device=device)
    return b.build(camera=cam, bg_color=(0.25, 0.3, 0.38), device=device)


def textured_terrain_scene(n_tris=100_000, width=512, height=256, seed=0,
                           with_env=True, tex_size=256, env_size=(64, 128),
                           device="cuda"):
    """Env-lit textured mesh benchmark scene: the terrain with a
    mip-mapped image texture on planar UVs, under an HDR sky with a sun
    disk that NEE importance-samples."""
    from vimg_tpu_torch.lights.envmap import build_env_tables
    from vimg_tpu_torch.textures.mipmap import AtlasBuilder

    rs = np.random.RandomState(seed + 7)
    verts, tris = terrain_mesh(n_tris, seed)
    b = SceneBuilder()

    # procedural base-color image (mips built like any loaded texture)
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size),
                         indexing="ij")
    checker = ((xx // 16 + yy // 16) % 2).astype(np.float32)
    noise = rs.rand(tex_size, tex_size).astype(np.float32)
    img = np.stack([0.2 + 0.5 * checker + 0.1 * noise,
                    0.35 + 0.25 * (1 - checker),
                    0.25 + 0.15 * noise], axis=-1).astype(np.float32)
    atlas = AtlasBuilder()
    aid = atlas.add(img, build_mips=True)
    tex = b.add_texture(ir.TEX_IMAGE, atlas_id=aid)

    m = b.add_material(ir.MAT_PRINCIPLED, base=(1.0, 1.0, 1.0),
                       scalars={ir.MS_IOR: 1.5, ir.MS_SPECULAR: 0.5,
                                ir.MS_SPEC_TINT: 0.0, ir.MS_SUBSURFACE: 0.0,
                                ir.MS_SHEEN_TINT: 0.5,
                                ir.MS_CLEARCOAT_GLOSS: 0.5,
                                ir.MS_ROUGHNESS: 0.55},
                       tex=(tex, -1, -1))
    # planar UVs from xz
    ext = verts[:, [0, 2]]
    uvs = (ext - ext.min(0)) / np.maximum(np.ptp(ext, 0), 1e-6) * 6.0
    b.add_mesh(verts, tris, m, uvs=uvs.astype(np.float32))

    env = None
    bg_light = False
    if with_env:
        # sky gradient + a bright sun disk (importance sampling target)
        eh, ew = env_size
        th = (np.arange(eh) + 0.5) / eh * np.pi
        ph = (np.arange(ew) + 0.5) / ew * 2 * np.pi
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        sky = np.stack([0.3 + 0.3 * np.cos(tt), 0.45 + 0.3 * np.cos(tt),
                        0.8 + 0.15 * np.cos(tt)], -1)
        sun_dir = (np.pi * 0.3, np.pi * 0.35)
        d2 = (tt - sun_dir[0]) ** 2 + (pp - sun_dir[1]) ** 2
        sun = np.exp(-d2 / 0.004)[..., None] * np.array([400.0, 380.0,
                                                         330.0])
        env = build_env_tables((sky + sun).astype(np.float32))
        bg_light = True

    cam = Camera.make(look_at([0.0, 2.2, 4.6], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0]), width, height, 45.0,
                      device=device)
    atlas_arr, atlas_meta, _ = atlas.finalize()
    return b.build(camera=cam, bg_color=(0.25, 0.3, 0.38), env=env,
                   atlas=dict(atlas=atlas_arr, atlas_meta=atlas_meta),
                   bg_light=bg_light, device=device)


def many_lights_scene(n_lights=256, width=512, height=256, seed=0,
                      device="cuda"):
    """Analytic scene with ``n_lights`` emissive spheres over a ground
    quad: real glTF scenes register every emissive primitive as a light
    (reference gltf_loading.cpp:87-104). Above 64 spheres make_tracer
    gives it the BVH tracer."""
    rs = np.random.RandomState(seed + 3)
    b = SceneBuilder()
    ground = b.add_material(ir.MAT_LAMBERTIAN, base=(0.55, 0.52, 0.48))
    b.add_quad(ground, np.diag([30.0, 1e-3, 30.0, 1.0]).astype(np.float32))
    # an 8-material emissive palette shared across lights keeps the
    # material count flat while the light count sweeps
    palette = [b.add_material(ir.MAT_DIFFUSE_LIGHT,
                              base=tuple(2.0 + 6.0 * rs.rand(3)))
               for _ in range(8)]
    side = int(np.ceil(np.sqrt(n_lights)))
    for k in range(n_lights):
        i, j = divmod(k, side)
        x = (i - side / 2) * 1.6 + 0.3 * rs.randn()
        z = (j - side / 2) * 1.6 + 0.3 * rs.randn()
        y = 2.0 + rs.rand() * 2.0
        b.add_sphere((x, y, z), 0.12, palette[k % 8])
    cam = Camera.make(look_at([0.0, 3.5, 14.0], [0.0, 1.0, 0.0],
                              [0.0, 1.0, 0.0]), width, height, 50.0,
                      device=device)
    return b.build(camera=cam, bg_color=(0.02, 0.02, 0.03), device=device)


def multi_material_terrain_scene(n_tris=100_000, n_mats=128, width=512,
                                 height=256, seed=0, device="cuda"):
    """Terrain with ``n_mats`` distinct Principled materials striped
    across the mesh: the glTF-scale material count (the reference turns
    every glTF material into a Principled one, gltf_loading.cpp:547-690)."""
    rs = np.random.RandomState(seed + 11)
    verts, tris = terrain_mesh(n_tris, seed)
    b = SceneBuilder()
    mats = []
    for k in range(n_mats):
        base = tuple(0.2 + 0.7 * rs.rand(3))
        mats.append(b.add_material(
            ir.MAT_PRINCIPLED, base=base,
            scalars={ir.MS_IOR: 1.5,
                     ir.MS_SPECULAR: float(rs.rand()),
                     ir.MS_SPEC_TINT: 0.0,
                     ir.MS_SUBSURFACE: 0.0,
                     ir.MS_SHEEN_TINT: 0.5,
                     ir.MS_CLEARCOAT_GLOSS: 0.5,
                     ir.MS_METALLIC: float(0.8 * rs.rand()),
                     ir.MS_ROUGHNESS: float(0.15 + 0.8 * rs.rand())}))
    # stripe materials over contiguous triangle chunks
    order = np.argsort(tris[:, 0], kind="stable")
    chunks = np.array_split(order, n_mats)
    for k, ch in enumerate(chunks):
        if len(ch):
            b.add_mesh(verts, tris[ch], mats[k])
    light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(14.0, 13.5, 12.0))
    lv = np.array([[-1.2, 4.0, -1.2], [1.2, 4.0, -1.2],
                   [1.2, 4.0, 1.2], [-1.2, 4.0, 1.2]], np.float32)
    b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]]), light)
    cam = Camera.make(look_at([0.0, 2.2, 4.6], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0]), width, height, 45.0,
                      device=device)
    return b.build(camera=cam, bg_color=(0.25, 0.3, 0.38), device=device)
