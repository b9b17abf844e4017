"""The BVH tracer against vimg_tpu on the CPU: the host build for each
builder, the skip-link walk (kernel X2's plain version), the refit, the
tracer choice and a loop render over the tracer.

Criteria. The BVH tables equal vimg_tpu's byte for byte (numpy, native
and sweep builders). The walk: prim type, prim id, occlusion and cost
equal, and t, u, v bit for bit. Bit for bit because vimg_tpu's references
are computed in a child process whose XLA may use no instruction set
above AVX (``--xla_cpu_max_isa=AVX``): in this process XLA's CPU backend
fuses ``a * b + c`` into an FMA inside the watertight triangle test, which
moved t by up to 1.4e-6 relative (above the 1e-6 the comparison would
otherwise allow) and barycentrics near 0 by more; the port, like kernel
X2 (built with -fmad=false), rounds every product. The refit's boxes are
equal. The loop render: per pixel within 1e-5 (test_torch_render.py's
unit-scale criterion). No vimg_tpu Pallas kernel runs here.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vimg_tpu_torch.geometry import bvh as tb
from vimg_tpu_torch.geometry.trace import make_tracer
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N_RAYS = 4096
BUILDERS = ("numpy", "native", "sweep")
TABLES = ("node_min", "node_max", "node_start", "node_count", "node_skip",
          "node_right", "prim_type", "prim_idx")


def _mixed_scene(pkg):
    """About 2,000 terrain triangles and 100 spheres, built by ``pkg``'s
    SceneBuilder ("jax": vimg_tpu's, "torch": the port's, on the CPU)."""
    from vimg_tpu_torch.scene.synthetic import terrain_mesh
    rs = np.random.RandomState(5)
    v, t = terrain_mesh(2000, 3)
    if pkg == "jax":
        from vimg_tpu.render.camera import Camera
        from vimg_tpu.scene.json_loader import SceneBuilder
    else:
        from vimg_tpu_torch.scene.json_loader import SceneBuilder
    b = SceneBuilder()
    m = b.add_material(tir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    b.add_mesh(v, t, m)
    for _ in range(100):
        c = rs.uniform(-3.5, 3.5, 3)
        c[1] = abs(c[1]) * 0.4
        b.add_sphere(c, rs.uniform(0.05, 0.35), m)
    eye = np.eye(4, dtype=np.float32)
    if pkg == "jax":
        return b.build(camera=Camera.make(eye, 8, 8, 40.0))
    return b.build(camera=dict(cam2world=eye, width=8, height=8,
                               vfov_deg=40.0), device="cpu")


def _rays():
    """Rays from above the scene toward points in its box, some along a
    coordinate plane (zero direction components), every fifth with a
    finite maxT."""
    rs = np.random.RandomState(0)
    ro = rs.uniform(-4, 4, (N_RAYS, 3)).astype(np.float32)
    ro[:, 1] = rs.uniform(1, 4, N_RAYS)
    tgt = rs.uniform(-4, 4, (N_RAYS, 3)).astype(np.float32)
    tgt[:, 1] = rs.uniform(-0.8, 0.8, N_RAYS)
    rd = tgt - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[:40, 0] = 0.0
    rd[40:60, 2] = 0.0
    mn = np.full(N_RAYS, 1e-4, np.float32)
    mx = np.full(N_RAYS, np.inf, np.float32)
    mx[::5] = rs.uniform(0.5, 6.0, mx[::5].shape[0])
    return ro, rd, mn, mx


def _references(path):
    """vimg_tpu's jitted walk (closest with cost, any hit) on the numpy
    and sweep trees; run in the AVX child (module docstring)."""
    import jax
    from vimg_tpu.geometry import bvh as jb
    js = _mixed_scene("jax")
    rays = _rays()
    out = {}
    for builder in ("numpy", "sweep"):
        b = jb.build_scene_bvh(js, builder)
        hr, cost = jax.jit(lambda s, b, *r: jb.bvh_traverse(
            s, b, *r, count_cost=True))(js, b, *rays)
        occ = jax.jit(lambda s, b, *r: jb.bvh_traverse(
            s, b, *r, any_hit=True))(js, b, *rays)
        for k in ("t", "prim_type", "prim_id", "u", "v"):
            out[f"{builder}_{k}"] = np.asarray(getattr(hr, k))
        out[f"{builder}_cost"] = np.asarray(cost)
        out[f"{builder}_occ"] = np.asarray(occ)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bvh_refs") / "walk.npz")
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, {HERE!r}]; "
            f"import test_torch_bvh as t; t._references({path!r})")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def scenes():
    return _mixed_scene("jax"), _mixed_scene("torch")


@pytest.mark.parametrize("builder", BUILDERS)
def test_build_scene_bvh_equal(scenes, builder):
    from vimg_tpu.geometry import bvh as jb
    js, ts = scenes
    jbv = jb.build_scene_bvh(js, builder)
    tbv = tb.build_scene_bvh(ts, builder)
    for f in TABLES:
        a, b = np.asarray(getattr(jbv, f)), getattr(tbv, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert [x.tolist() for x in jb._bvh_levels(
        np.asarray(jbv.node_count), np.asarray(jbv.node_right))] == \
        [x.tolist() for x in tb._bvh_levels(tbv.node_count.numpy(),
                                            tbv.node_right.numpy())]


@pytest.mark.parametrize("builder", ("numpy", "sweep"))
def test_walk_bit_equal(scenes, refs, builder):
    _, ts = scenes
    bvh = tb.build_scene_bvh(ts, builder)
    rays = [torch.from_numpy(x) for x in _rays()]
    st = {}
    hr, cost = tb.bvh_traverse(ts, bvh, *rays, count_cost=True, stats=st)
    occ = tb.bvh_traverse(ts, bvh, *rays, any_hit=True)
    for k in ("t", "prim_type", "prim_id", "u", "v"):
        got, ref = getattr(hr, k).numpy(), refs[f"{builder}_{k}"]
        if got.dtype == np.float32:
            assert np.array_equal(got.view(np.int32), ref.view(np.int32)), k
        else:
            assert np.array_equal(got, ref), k
    assert np.array_equal(cost.numpy(), refs[f"{builder}_cost"])
    assert np.array_equal(occ.numpy(), refs[f"{builder}_occ"])
    # the rays reach both kinds of primitive and both outcomes
    assert 0 < int((hr.prim_type == tir.PRIM_SPHERE).sum()) < int(
        hr.hit.sum()) < N_RAYS
    assert st["box_tests"] > 0 and st["tri_tests"] > 0
    assert st["sphere_tests"] > 0


@pytest.mark.parametrize("builder", ("numpy", "sweep"))
def test_warp_replay_matches_reference(scenes, refs, builder):
    """Kernel X2's warp schedule (geometry/bvh_schedule.py), replayed over
    its packed tables, against vimg_tpu's walk: closest with cost and any
    hit, bit for bit."""
    from vimg_tpu_torch.geometry import bvh_schedule as bs
    _, ts = scenes
    bvh = tb.build_scene_bvh(ts, builder)
    nodes, rows = tb.packed_tables(ts, bvh)
    rays = [torch.from_numpy(x) for x in _rays()]
    (hr, cost), _ = bs.warp_schedule(nodes, rows, *rays, count_cost=True)
    occ, _ = bs.warp_schedule(nodes, rows, *rays, any_hit=True)
    for k in ("t", "prim_type", "prim_id", "u", "v"):
        got, ref = getattr(hr, k).numpy(), refs[f"{builder}_{k}"]
        if got.dtype == np.float32:
            assert np.array_equal(got.view(np.int32), ref.view(np.int32)), k
        else:
            assert np.array_equal(got, ref), k
    assert np.array_equal(cost.numpy(), refs[f"{builder}_cost"])
    assert np.array_equal(occ.numpy(), refs[f"{builder}_occ"])


def test_refit(scenes):
    """Unmoved geometry gives the built boxes back; moved vertices and
    spheres give vimg_tpu's refit boxes."""
    from vimg_tpu.geometry import bvh as jb
    from vimg_tpu.scene import ir as jir
    js, ts = scenes
    tr = tb.BVHTracer(ts, builder="numpy")
    built = tr.bvh
    tr.refit(ts)
    for f in ("node_min", "node_max"):
        assert torch.equal(getattr(tr.bvh, f), getattr(built, f))
    rs = np.random.RandomState(9)
    dv = rs.normal(0, 0.05, tuple(ts.verts.shape)).astype(np.float32)
    dc = rs.normal(0, 0.1, tuple(ts.sph_center.shape)).astype(np.float32)
    moved = ts.replace(verts=ts.verts + torch.from_numpy(dv),
                       sph_center=ts.sph_center + torch.from_numpy(dc))
    jmoved = dataclasses.replace(js, verts=js.verts + dv,
                                 sph_center=js.sph_center + dc)
    assert isinstance(jmoved, jir.Scene)
    import jax
    jtr = jb.BVHTracer(js, builder="numpy")
    jref = jax.jit(lambda s, b: jb.refit_bvh(s, b, jtr.levels))(jmoved,
                                                                 jtr.bvh)
    tr.refit(moved)
    for f in ("node_min", "node_max"):
        assert np.array_equal(np.asarray(getattr(jref, f)),
                              getattr(tr.bvh, f).numpy()), f
    # the refit tree still gives the closest hits of a fresh build
    rays = [torch.from_numpy(x) for x in _rays()]
    fresh = tb.BVHTracer(moved, builder="numpy")
    a = tr.closest(moved, *rays)
    b = tb.bvh_traverse(moved, fresh.bvh, *rays)
    assert torch.equal(a.prim_id, b.prim_id) and torch.equal(a.t, b.t)


def test_tracer_facade_on_cpu(scenes):
    """On CPU tensors the wrapper takes the plain walk and counts no
    launch; the facade detaches its rays."""
    _, ts = scenes
    tr = tb.BVHTracer(ts, builder="numpy")
    rays = [torch.from_numpy(x) for x in _rays()]
    before = tb.LAUNCHES
    hr = tr.closest(ts, *rays)
    occ = tr.occluded(ts, *rays)
    _, cost = tr.trace(ts, *rays, count_cost=True)
    assert tb.LAUNCHES == before
    ref = tb.bvh_traverse(ts, tr.bvh, *rays)
    for k in ("t", "prim_type", "prim_id", "u", "v"):
        assert torch.equal(getattr(hr, k), getattr(ref, k))
    # a ray is occluded iff a closest hit lies inside its [minT, maxT]
    assert torch.equal(occ, hr.hit)
    assert bool((cost >= 0.5).all())
    ro = rays[0].clone().requires_grad_(True)
    out = tr.closest(ts, ro, *rays[1:])
    assert not out.t.requires_grad
    # builder="device" (the sweep SAH level by level; on the CPU its plain
    # version): another tree, the same closest t
    dv = tb.build_scene_bvh(ts, "device")
    assert torch.equal(tb.bvh_traverse(ts, dv, *rays).t, ref.t)


def _spheres(scene, n):
    return scene.replace(
        sph_center=torch.arange(3 * n, dtype=torch.float32).view(n, 3),
        sph_radius=torch.full((n,), 0.25),
        sph_mat=torch.zeros(n, dtype=torch.int64))


@pytest.mark.parametrize("case", [
    ("tris, 64 spheres", None, 64, True, "ClusterTracer"),
    ("tris, 65 spheres", None, 65, True, "BVHTracer"),
    ("no tris, 65 spheres", None, 65, False, "BVHTracer"),
    ("no tris, 64 spheres", None, 64, False, "SoATracer"),
    ("bvh", "bvh", 2, True, "BVHTracer"),
    ("sweep", "sweep", 2, True, "BVHTracer"),
    ("sweep, few prims", "sweep", 2, False, "BVHTracer"),
    ("cluster", "cluster", 65, True, "ClusterTracer"),
    ("soa", "soa", 65, True, "SoATracer"),
    ("brute", "brute", 65, True, "BruteForceTracer"),
], ids=lambda c: c[0])
def test_make_tracer_choice(scenes, case):
    """vimg_tpu's rule off the CPU: the BVH tracer for scenes with no
    triangles and more than 64 primitives, or more than 64 spheres, and
    for force="bvh" / "sweep" (the sweep-SAH tree)."""
    _, ts = scenes
    _, force, n_sph, tris, name = case
    scene = _spheres(ts, n_sph)
    if not tris:
        scene = scene.replace(tri_vidx=scene.tri_vidx[:0],
                              tri_mat=scene.tri_mat[:0],
                              tri_flags=scene.tri_flags[:0])
    tr = make_tracer(scene, force=force, differentiable=True)
    assert type(tr).__name__ == name
    if name == "BVHTracer":
        assert tr.builder == ("sweep" if force == "sweep" else "auto")


def test_loop_render_over_bvh():
    """many_lights_scene (256 emissive spheres over a quad: the BVH
    tracer's scene) at 32x16 @ 2 spp, MIS, through the loop integrator
    over each package's BVH tracer: per pixel within 1e-5."""
    from vimg_tpu.geometry.bvh import BVHTracer as JBVH
    from vimg_tpu.render.render import render as jrender
    from vimg_tpu.scene import ir as jir
    from vimg_tpu.scene.synthetic import many_lights_scene as jml
    from vimg_tpu_torch.render.render import render
    js = jml(256, 32, 16)
    ts = tsyn.many_lights_scene(256, 32, 16, device="cpu")
    tracer = make_tracer(ts)
    assert isinstance(tracer, tb.BVHTracer)
    st = dict(width=32, height=16, spp=2, max_depth=8, integrator="mis")
    ref = np.asarray(jrender(js, jir.RenderSettings(**st),
                             tracer=JBVH(js, builder="auto")))
    img = render(ts, tir.RenderSettings(**st), tracer=tracer).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert np.abs(img - ref).max() <= 1e-5
