"""The mesh mode of vimg_tpu_torch's megakernel (kernel B2) on the CPU,
where ``render_megakernel`` is its plain version: the loop integrators
over the cluster tracer's plain skip walk. Held against vimg_tpu:

- ``supports_megakernel`` gives vimg_tpu's answer on the same scenes;
- the host tables (mesh light rows with vertex normals, cluster tables)
  equal vimg_tpu's bit for bit, and the vectorised per-triangle rows equal
  a per-triangle loop bit for bit;
- exact slice parity: a smooth-shaded mesh of <= 64 triangles (mesh mode
  only through its vertex normals) through ``render_frame`` against
  vimg_tpu's loop render with its SoA tracer. The cluster rows hold the
  SoA tracer's float32 constants and formula, so the two agree per pixel:
  mean|d| < 1e-4, < 1% of pixels with max|d| > 1e-5, corr > 0.999
  (tests/test_megakernel.py's unit-scale bound);
- statistical parity on real meshes against vimg_tpu's loop render with
  its BVH tracer (numpy builder), whose watertight triangle test is another
  formulation: mean|d| < 5e-3 and corr > 0.99 (the bound of
  tests/test_cluster_trace.py). vimg_tpu's loop render keeps no ray
  counters, so the counts are held within 2% to the port's loop
  integrator over its watertight brute-force tracer;
- dispatch: low-spp mesh MIS and every mesh material frame take B2's plain
  version, 8-spp mesh MIS frames the wavefront, and no launch counter
  moves on the CPU.
vimg_tpu's Pallas megakernel is never run here (interpret mode takes
minutes on this CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from vimg_tpu.core.math import look_at
from vimg_tpu.render.camera import Camera
from vimg_tpu.render.mega import kernel as jkernel
from vimg_tpu.render.render import render as jrender
from vimg_tpu.scene import ir as jir
from vimg_tpu.scene import synthetic as jsyn
from vimg_tpu.scene.json_loader import SceneBuilder
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.render import wavefront as twf
from vimg_tpu_torch.render.mega import kernel as tkernel
from vimg_tpu_torch.render.render import render_frame
from vimg_tpu_torch.scene import ir as tir


def _port(js):
    return tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")


def _settings(W, H, spp, integrator, max_depth=64):
    return jir.RenderSettings(width=W, height=H, spp=spp,
                              max_depth=max_depth, integrator=integrator)


def _tsettings(st):
    return tir.RenderSettings(**dataclasses.asdict(st))


def _counters():
    return (tkernel.LAUNCHES, tkernel.LAUNCHES_MESH, tct.LAUNCHES_WIDE,
            tct.LAUNCHES_SKIP)


def _spheres(n):
    b = SceneBuilder()
    m = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(4.0, 4.0, 4.0))
    for k in range(n):
        b.add_sphere((k % 16 - 8.0, k // 16 - 8.0, -5.0), 0.3,
                     light if k == 0 else m)
    cam = Camera.make(look_at([0, 0, 6], [0, 0, 0], [0, 1, 0]), 8, 8, 45.0)
    return b.build(camera=cam)


def _aniso_tris():
    b = SceneBuilder()
    m = b.add_material(jir.MAT_PRINCIPLED, base=(0.7, 0.6, 0.5),
                       scalars={jir.MS_ANISO: 0.5, jir.MS_ROUGHNESS: 0.3})
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(4.0, 4.0, 4.0))
    b.add_mesh(np.array([[-1, 0, -1], [1, 0, -1], [0, 0, 1]], np.float32),
               np.array([[0, 1, 2]]), m)
    b.add_sphere((0, 2, 0), 0.3, light)
    cam = Camera.make(look_at([0, 1, 4], [0, 0, 0], [0, 1, 0]), 8, 8, 45.0)
    return b.build(camera=cam)


_SUPPORT_CASES = {
    # name: (scene, integrator, expected answer)
    "analytic": (lambda: _spheres(3), "mis", True),
    "terrain300": (lambda: jsyn.terrain_scene(300, 8, 6), "mis", True),
    "smooth_bumpy60": (lambda: jsyn.bumpy_sphere_scene(
        60, 8, 6, smooth_normals=True), "mis", True),
    "bumpy2000_material": (lambda: jsyn.bumpy_sphere_scene(2000, 8, 6),
                           "material", True),
    "aniso_triangle": (_aniso_tris, "mis", False),
    "spheres72": (lambda: _spheres(72), "mis", True),
    "spheres257": (lambda: _spheres(257), "mis", False),
    "s_normal": (lambda: jsyn.terrain_scene(300, 8, 6), "s_normal", False),
}


@pytest.mark.parametrize("name", sorted(_SUPPORT_CASES))
def test_supports_megakernel_matches_vimg_tpu(name):
    make, integ, expected = _SUPPORT_CASES[name]
    js = make()
    st = _settings(8, 6, 1, integ)
    got = tkernel.supports_megakernel(_port(js), _tsettings(st))
    assert got == jkernel.supports_megakernel(js, st) == expected


def _emissive_smooth_mesh():
    """A smooth-shaded emissive bumpy mesh, a flat emissive quad and an
    emissive sphere: every kind of light row."""
    verts, tris = jsyn.bumpy_sphere_mesh(40)
    p = verts[tris]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True),
                          1e-12)
    b = SceneBuilder()
    m = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    glow = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(3.0, 2.0, 1.0))
    b.add_mesh(verts, tris, glow, normals=normals)
    b.add_mesh(np.array([[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]],
                        np.float32), np.array([[0, 1, 2], [0, 2, 3]]), glow)
    b.add_sphere((2, 0, 0), 0.4, glow)
    b.add_sphere((-2, 0, 0), 0.4, m)
    cam = Camera.make(look_at([0, 1, 5], [0, 0, 0], [0, 1, 0]), 8, 8, 45.0)
    return b.build(camera=cam)


def test_mesh_light_rows_match_vimg_tpu():
    """Light rows carry each smooth light triangle's vertex normals,
    bit for bit as vimg_tpu's _light_rows32 packs them."""
    js = _emissive_smooth_mesh()
    ts = _port(js)
    assert tkernel.is_mesh_mode(ts)
    jrows = jkernel._light_rows32(js, jkernel._resolved_mat_base(js))
    trows = tkernel._light_rows32(ts, tkernel._resolved_mat_base(ts))
    assert trows.dtype == np.float32 and np.array_equal(jrows, trows)
    smooth = (ts.tri_flags[ts.light_idx[ts.light_type == tir.LIGHT_TRI]]
              & tir.TRI_HAS_NORMALS) != 0
    tri_rows = trows[(ts.light_type == tir.LIGHT_TRI).numpy()]
    # vertex normals differ from the face normal on the smooth lights only
    differs = (tri_rows[:, 16:25] != np.tile(tri_rows[:, 9:12], 3)).any(1)
    assert np.array_equal(differs, smooth.numpy()) and differs.any()


def test_mesh_tables_match_vimg_tpu():
    """The mesh-mode tables are vimg_tpu's cluster tables (flat views) and
    shading tables; per-triangle rows cover every triangle."""
    js = jsyn.terrain_scene(300, 8, 6)
    ts = _port(js)
    jt, jstatic = jkernel._pack_scene(js)
    assert jstatic["mesh"]
    tt = tkernel._pack_scene_mesh(ts, tkernel.cluster_data(ts))
    for j, t in (("node_aabbs", "node_aabbs"), ("node_cid", "node_cid"),
                 ("node_skip", "node_skip"), ("ctri", "tri_rows")):
        assert np.array_equal(jt[j].reshape(-1), tt[t]), t
    for k in ("light_rows", "mat_base"):
        assert np.array_equal(jt[k], tt[k]), k
    assert tt["tri_v"].shape == (ts.n_tris(), 16)
    shapes = tkernel._table_shapes(ts)
    for k, t in tkernel._device_tables(ts).items():
        assert tuple(t.shape) == shapes[k], k
    assert set(shapes) == set(tkernel._MESH_TABLE_ORDER)


def test_vectorised_tri_v_matches_loop():
    """The whole-array packing equals the per-triangle loop it replaced
    (the same float32 operations in the same order), bit for bit."""
    ts = _port(jsyn.bumpy_sphere_scene(400, 8, 6))
    assert ts.n_tris() >= 300
    verts = ts.verts.numpy()
    tv = ts.tri_vidx.numpy()
    loop = np.zeros((ts.n_tris(), 16), np.float32)
    for i in range(ts.n_tris()):
        p0, p1, p2 = verts[tv[i, 0]], verts[tv[i, 1]], verts[tv[i, 2]]
        loop[i, :13] = np.concatenate(
            [p0, p1, p2,
             tkernel._unit(tkernel._f32_cross(p1 - p0, p2 - p0)),
             [tkernel._half_area(tkernel._f32_cross(p2 - p0, p1 - p0))]])
    assert np.array_equal(tkernel._tri_v(ts).view(np.uint32),
                          loop.view(np.uint32))


@pytest.fixture(scope="module")
def smooth_small():
    """A smooth-shaded bumpy sphere of 18 triangles plus the 2-triangle
    light quad: mesh mode only through its vertex normals. (A larger mesh
    would still run the SoA tracer in vimg_tpu, whose jitted loop render
    unrolls every triangle: compile time grows with the count.)"""
    js = jsyn.bumpy_sphere_scene(18, 16, 8, smooth_normals=True)
    ts = _port(js)
    assert ts.n_tris() <= 64 and tkernel.is_mesh_mode(ts)
    return js, ts


@pytest.mark.parametrize("integ", ["mis", "material"])
def test_exact_parity_smooth_mesh(smooth_small, integ):
    js, ts = smooth_small
    st = _settings(16, 8, 4, integ)
    before = _counters()
    img = render_frame(ts, _tsettings(st)).numpy()
    assert _counters() == before
    ref = np.asarray(jrender(js, st))
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    d = np.abs(img - ref)
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("frame", ["terrain_mis", "smooth_bumpy_material"])
def test_statistical_parity_real_meshes(frame):
    from vimg_tpu.geometry.bvh import BVHTracer
    from vimg_tpu_torch.geometry.trace import BruteForceTracer
    from vimg_tpu_torch.render.render import render as trender
    if frame == "terrain_mis":
        js, st = jsyn.terrain_scene(600, 24, 16), _settings(24, 16, 4, "mis")
    else:
        js = jsyn.bumpy_sphere_scene(800, 24, 16, smooth_normals=True)
        st = _settings(24, 16, 4, "material")
    ts, tst = _port(js), _tsettings(st)
    assert tkernel.is_mesh_mode(ts) and tkernel.supports_megakernel(ts, tst)
    img, ps = tkernel.render_megakernel(ts, tst, return_stats=True)
    img = img.numpy()
    ref = np.asarray(jrender(js, st, tracer=BVHTracer(js, builder="numpy")))
    assert img.shape == (16, 24, 3) and np.isfinite(img).all()
    assert np.abs(img - ref).mean() < 5e-3
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] > 0.99
    ws = {"segments": 0, "shadow_rays": 0}
    trender(ts, tst, stats=ws, tracer=BruteForceTracer(ts))
    for k in ("segments", "shadow_rays"):
        assert abs(ps[k] - ws[k]) <= 0.02 * ws[k], (k, ps[k], ws[k])
    assert ps["segments"] >= 24 * 16 * 4


def test_render_frame_mesh_dispatch_cpu():
    """vimg_tpu's CPU rule: no mesh frame takes B2 (or its plain version)
    on the CPU. Mesh MIS frames at any spp go to the wavefront, mesh
    material frames to the loop render over make_tracer's tracer; nothing
    launches on the CPU."""
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render.render import render as trender
    ts = _port(jsyn.terrain_scene(300, 8, 6))
    before = _counters()
    mis4 = tir.RenderSettings(width=8, height=6, spp=4, integrator="mis")
    assert torch.equal(render_frame(ts, mis4), twf.render_wavefront(ts, mis4))
    mis8 = dataclasses.replace(mis4, spp=8)
    assert torch.equal(render_frame(ts, mis8), twf.render_wavefront(ts, mis8))
    mat = dataclasses.replace(mis4, integrator="material")
    img = render_frame(ts, mat)
    assert torch.equal(img, trender(ts, mat, make_tracer(ts)))
    assert img.shape == (6, 8, 3) and bool(torch.isfinite(img).all())
    assert _counters() == before
    tracer = tkernel.plain_tracer(ts)
    assert isinstance(tracer, tct.ClusterTracer)
    assert tracer.plain and tracer.walk == "skip"
