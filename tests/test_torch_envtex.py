"""The envtex slice against vimg_tpu on the CPU: the textured terrain
scene, hit shading data with every texture kind, the per-hit texture
inputs and the BSDF calls that take them, the refill wavefront on the
env-lit textured terrain, and the loop integrators on a checker + env
scene whose textures come from JSON.

Criteria. The scene's arrays are equal byte for byte. Hit data, texture
inputs and BSDF values: rtol 1e-5, atol 1e-6 (hit data on the port's own
hits), a share FLIP_FRAC of lanes allowed apart where an ulp of a
transcendental (log2 of the LOD, acos / atan2 of sphere UVs, sin / cos in
sampling) flips a discrete choice. Frames: the port's wavefront against
vimg_tpu's (its CPU BVHTracer, numpy builder, as tests/test_torch_
wavefront.py does) at mean|d| < 5e-3, corr > 0.99 and segment and
shadow-ray counts within 2%; the loop renders at unit scale per pixel.
No vimg_tpu Pallas kernel runs here.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.scene import ir as jir
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.render import wavefront as twf
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn

RTOL, ATOL = 1e-5, 1e-6
FLIP_FRAC = 2e-3
SMALL = dict(n_tris=600, width=24, height=16, tex_size=32, env_size=(16, 32))


def _same_scene(js, ts):
    jf, jm = tir.scene_to_numpy(js)
    tf, tm = tir.scene_to_numpy(ts)
    assert jm == tm
    for k in jf:
        if k == "env_mips":
            assert len(jf[k]) == len(tf[k])
            for a, b in zip(jf[k], tf[k]):
                assert np.array_equal(a, b)
        else:
            assert np.array_equal(np.asarray(jf[k]), tf[k]), k
            assert np.asarray(jf[k]).shape == tf[k].shape, k


def test_textured_terrain_scene_exact():
    from vimg_tpu.scene.synthetic import textured_terrain_scene as jtt
    js = jtt(**SMALL)
    ts = tsyn.textured_terrain_scene(**SMALL, device="cpu")
    _same_scene(js, ts)
    assert ts.has_envmap and ts.has_image_tex and ts.needs_cones
    assert ts.lights_have_bg and ts.bg_is_emissive
    # and through the numpy round trip the tests hand vimg_tpu's scenes on
    back = tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")
    _same_scene(js, back)
    bare = tsyn.textured_terrain_scene(**SMALL, with_env=False, device="cpu")
    _same_scene(jtt(**SMALL, with_env=False), bare)
    assert not bare.has_envmap and bare.needs_cones


def _shading_scenes():
    """vimg_tpu's and the port's scene holding every texture kind: a
    checker Lambertian terrain and sphere (sphere UVs), a Principled
    terrain with an image base colour, a metal-rough map on its own UV set
    and a normal map on another, smooth vertex normals, and an anisotropic
    Principled terrain without textures; an env map above."""
    from vimg_tpu.lights.envmap import build_env_tables as jenv
    from vimg_tpu.render.camera import Camera as JCam
    from vimg_tpu.scene.json_loader import SceneBuilder as JB
    from vimg_tpu.textures import mipmap as jmip
    from vimg_tpu_torch.lights.envmap import build_env_tables as tenv
    from vimg_tpu_torch.scene.json_loader import SceneBuilder as TB
    from vimg_tpu_torch.textures import mipmap as tmip
    r = np.random.default_rng(20)
    base = r.random((32, 32, 3)).astype(np.float32)
    mr = r.random((16, 16, 3)).astype(np.float32)
    nmap = jmip.rgb_to_normal(r.integers(90, 255, (16, 16, 3)))
    env_img = (0.5 + r.random((8, 16, 3))).astype(np.float32)
    verts, tris = tsyn.terrain_mesh(200, size=2.0, relief=0.3)
    uv = verts[:, [0, 2]] * 1.5
    uv2 = verts[:, [2, 0]] * 0.7 + 0.1
    p = verts[tris]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    out = []
    for B, mip, env_fn, lib in ((JB, jmip, jenv, "jax"),
                                (TB, tmip, tenv, "torch")):
        b = B()
        ab = mip.AtlasBuilder()
        a_base, a_mr, a_nm = ab.add(base), ab.add(mr), ab.add(nmap, False)
        t_chk = b.add_texture(jir.TEX_CHECKER, col_a=(0.9, 0.8, 0.1),
                              col_b=(0.1, 0.2, 0.8), wh=(6, 5))
        t_img = b.add_texture(jir.TEX_IMAGE, atlas_id=a_base)
        m_chk = b.add_material(jir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5),
                               tex=(t_chk, -1, -1))
        m_img = b.add_material(
            jir.MAT_PRINCIPLED, base=(1.0, 1.0, 1.0),
            scalars={jir.MS_IOR: 1.5, jir.MS_SPECULAR: 0.5,
                     jir.MS_METALLIC: 0.8, jir.MS_ROUGHNESS: 0.6,
                     jir.MS_SHEEN_TINT: 0.5, jir.MS_CLEARCOAT_GLOSS: 0.5},
            tex=(t_img, a_nm, a_mr))
        m_aniso = b.add_material(
            jir.MAT_PRINCIPLED, base=(0.7, 0.4, 0.3),
            scalars={jir.MS_IOR: 1.5, jir.MS_SPECULAR: 0.5,
                     jir.MS_ANISO: 0.6, jir.MS_ROUGHNESS: 0.4,
                     jir.MS_METALLIC: 0.3})
        b.add_mesh(verts + np.float32([-2.2, 0, 0]), tris, m_chk, uvs=uv)
        b.add_mesh(verts, tris, m_img, normals=normals, uvs=uv,
                   uvs_nmap=uv2, uvs_mr=uv2 * 0.5)
        b.add_mesh(verts + np.float32([2.2, 0, 0]), tris, m_aniso)
        b.add_sphere((0.0, 0.9, -1.5), 0.5, m_chk)
        atlas, meta, _ = ab.finalize()
        c2w = np.eye(4, dtype=np.float32)
        kw = dict(env=env_fn(env_img), bg_light=True)
        if lib == "jax":
            out.append(b.build(camera=JCam.make(c2w, 8, 8, 45.0), atlas=dict(
                atlas=jnp.asarray(atlas), atlas_meta=jnp.asarray(meta)), **kw))
        else:
            out.append(b.build(camera=dict(cam2world=c2w, width=8, height=8,
                                           vfov_deg=45.0),
                               atlas=dict(atlas=atlas, atlas_meta=meta),
                               device="cpu", **kw))
    return out


def _shading_hits(n=6000, seed=21):
    """Both scenes, the port's closest hits on rays from above, and
    vimg_tpu's HitInfo / the port's on those hits."""
    from vimg_tpu.geometry import intersect as ji
    from vimg_tpu_torch.geometry import intersect as ti
    js, ts = _shading_scenes()
    _same_scene(js, ts)
    assert ts.has_normal_maps and ts.has_aniso and ts.has_checker
    r = np.random.default_rng(seed)
    ro = np.stack([r.uniform(-3.2, 3.2, n), np.full(n, 3.0),
                   r.uniform(-1.9, 0.9, n)], -1).astype(np.float32)
    rd = np.stack([r.normal(0, 0.05, n), -np.ones(n), r.normal(0, 0.05, n)],
                  -1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    mn = np.full(n, 1e-4, np.float32)
    mx = np.full(n, np.inf, np.float32)
    th = tct.ClusterTracer(ts).closest(ts, *map(torch.as_tensor,
                                                (ro, rd, mn, mx)))
    jh = ji.HitResult(t=jnp.asarray(th.t.numpy()),
                      prim_type=jnp.asarray(th.prim_type.numpy(), jnp.int32),
                      prim_id=jnp.asarray(th.prim_id.numpy(), jnp.int32),
                      u=jnp.asarray(th.u.numpy()), v=jnp.asarray(th.v.numpy()))
    jhi = ji.hit_info(js, jnp.asarray(ro), jnp.asarray(rd), jh)
    thi = ti.hit_info(ts, torch.as_tensor(ro), torch.as_tensor(rd), th)
    return js, ts, jhi, thi, th.hit.numpy(), rd


def _allclose_frac(a, b, mask, rtol=RTOL, atol=ATOL, frac=0.0, name=""):
    a = np.asarray(a, np.float64)[mask]
    b = np.asarray(b, np.float64)[mask]
    bad = np.abs(a - b) > atol + rtol * np.abs(a)
    if bad.ndim > 1:
        bad = bad.any(-1)
    assert bad.mean() <= frac, (name, bad.mean(), np.abs(a - b).max())


def test_hit_info_every_texture_kind():
    js, ts, jhi, thi, f, _ = _shading_hits()
    sph = thi.mat_id.numpy() == 0
    assert f.mean() > 0.6
    mids = thi.mat_id.numpy()[f]
    assert {0, 1, 2} <= set(mids.tolist())
    assert np.array_equal(np.asarray(jhi.mat_id)[f], thi.mat_id.numpy()[f])
    for k in ("p", "n_s", "n_g", "tangent", "bitangent", "uv", "mr_uv",
              "prim_area", "uv_area", "curvature"):
        # sphere UVs come from acos / atan2: an ulp apart
        _allclose_frac(getattr(jhi, k), getattr(thi, k).numpy(), f,
                       rtol=1e-4 if k == "curvature" else RTOL,
                       atol=1e-5, frac=FLIP_FRAC, name=k)
    # the normal map and the anisotropic frame really moved the frame
    nm = f & (thi.mat_id.numpy() == 1)
    assert np.abs(thi.n_s.numpy() - thi.n_g.numpy())[nm].max() > 0.1
    assert sph.any()


def test_texture_inputs_and_bsdf():
    """texture_inputs (base colour at the cone's LOD, metal-rough factors)
    and eval_pdf / sample_mat / eval_div_pdf given them, against
    vimg_tpu's on the same hits."""
    from vimg_tpu.materials import bsdf as jb
    from vimg_tpu_torch.materials import bsdf as tb
    js, ts, jhi, thi, f, rd = _shading_hits(seed=22)
    n = f.shape[0]
    r = np.random.default_rng(23)
    cw = (r.random(n) * 0.02).astype(np.float32)
    jmid, tmid = jhi.mat_id, thi.mat_id
    jtex = jb.texture_inputs(js, jmid, jhi, jnp.asarray(cw), jnp.asarray(rd))
    ttex = tb.texture_inputs(ts, tmid, thi, torch.as_tensor(cw),
                             torch.as_tensor(rd))
    _allclose_frac(jtex["base_col"], ttex["base_col"].numpy(), f,
                   rtol=1e-4, atol=1e-5, frac=FLIP_FRAC, name="base_col")
    _allclose_frac(jtex["mr"], ttex["mr"].numpy(), f, name="mr")
    wo = r.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    reg = r.random(n) < 0.5
    jr, tr = jnp.asarray(reg), torch.as_tensor(reg)
    jf, jp = jb.eval_pdf(js, jmid, jnp.asarray(rd), jnp.asarray(wo), jhi, jr,
                         tex=jtex)
    tf, tp = tb.eval_pdf(ts, tmid, torch.as_tensor(rd), torch.as_tensor(wo),
                         thi, tr, tex=ttex)
    _allclose_frac(jf, tf.numpy(), f, rtol=1e-4, atol=1e-5, frac=5e-3,
                   name="f")
    _allclose_frac(jp, tp.numpy(), f, rtol=1e-4, atol=1e-5, frac=5e-3,
                   name="pdf")
    rands = {k: r.random(n).astype(np.float32)
             for k in ("lobe", "u", "v", "fresnel")}
    js_ = jb.sample_mat(js, jmid, jnp.asarray(rd), jhi,
                        {k: jnp.asarray(v) for k, v in rands.items()}, jr,
                        tex=jtex)
    ts_ = tb.sample_mat(ts, tmid, torch.as_tensor(rd), thi,
                        {k: torch.as_tensor(v) for k, v in rands.items()},
                        tr, tex=ttex)
    agree = f & (np.asarray(js_.valid) == ts_.valid.numpy())
    assert (f & ~agree).mean() <= FLIP_FRAC
    ok = agree & ts_.valid.numpy()
    assert ok.mean() > 0.3
    _allclose_frac(js_.wo, ts_.wo.numpy(), ok, rtol=1e-4, atol=1e-5,
                   frac=5e-3, name="wo")
    # without tex=, the eval fetches the same inputs itself
    jdiv = jb.eval_div_pdf(js, jmid, jnp.asarray(rd), jnp.asarray(wo), jhi,
                           jr, cone_width=jnp.asarray(cw))
    tdiv = tb.eval_div_pdf(ts, tmid, torch.as_tensor(rd),
                           torch.as_tensor(wo), thi, tr,
                           cone_width=torch.as_tensor(cw))
    _allclose_frac(jdiv, tdiv.numpy(), f, rtol=1e-4, atol=1e-5, frac=5e-3,
                   name="div")


def _settings(W, H, spp, integrator="mis"):
    return tir.RenderSettings(width=W, height=H, spp=spp, max_depth=6,
                              integrator=integrator, batch_size=1 << 10)


def test_render_wavefront_textured_matches_vimg_tpu():
    """The slice as a whole: the env-lit textured terrain through the
    port's wavefront (the cluster tracer's plain walk) against vimg_tpu's
    wavefront over its CPU BVHTracer."""
    from vimg_tpu.geometry.bvh import BVHTracer
    from vimg_tpu.render.wavefront import render_wavefront as jrender
    from vimg_tpu.scene.synthetic import textured_terrain_scene as jtt
    js = jtt(**SMALL)
    ts = tsyn.textured_terrain_scene(**SMALL, device="cpu")
    st = _settings(24, 16, 4)
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    ref, rs = jrender(js, jst, tracer=BVHTracer(js, builder="numpy"),
                      return_stats=True)
    img, ps = twf.render_wavefront(ts, st, return_stats=True)
    img = img.numpy()
    assert img.shape == (16, 24, 3) and np.isfinite(img).all()
    d = np.abs(img - ref)
    assert d.mean() < 5e-3
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] > 0.99
    for k in ("segments", "shadow_rays"):
        assert abs(ps[k] - rs[k]) <= 0.02 * rs[k], (k, ps[k], rs[k])


def test_render_frame_sends_envtex_to_the_wavefront():
    """On the CPU an env / texture MIS frame goes to the wavefront (the
    megakernel refuses it) and launches nothing."""
    from vimg_tpu_torch.render.mega import kernel, supports_megakernel
    from vimg_tpu_torch.render.render import render_frame
    ts = tsyn.textured_terrain_scene(**dict(SMALL, width=8, height=6),
                                     device="cpu")
    st = _settings(8, 6, 2)
    assert not supports_megakernel(ts, st)
    before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH, tct.LAUNCHES_WIDE,
              tct.LAUNCHES_SKIP)
    img = render_frame(ts, st)
    assert (kernel.LAUNCHES, kernel.LAUNCHES_MESH, tct.LAUNCHES_WIDE,
            tct.LAUNCHES_SKIP) == before
    assert torch.equal(img, twf.render_wavefront(ts, st))


CHECKER_JSON = {
    "materials": [
        {"name": "floor", "type": "lambertian", "albedo": [0.5, 0.5, 0.5],
         "texture": {"type": "checkered", "col1": [0.9, 0.9, 0.9],
                     "col2": [0.2, 0.3, 0.6], "width": 6, "height": 6}},
        {"name": "ball", "type": "lambertian",
         "texture": {"type": "constant", "albedo": [0.8, 0.3, 0.2]}},
        {"name": "glass", "type": "dielectric", "ior": 1.5}],
}


def _checker_env_scenes(integrator):
    """A checker floor quad, a textured sphere and a glass sphere under an
    env map, the materials' textures parsed from CHECKER_JSON by each
    package's loader, at unit scale."""
    from vimg_tpu.core.math import look_at
    from vimg_tpu.lights.envmap import build_env_tables as jenv
    from vimg_tpu.render.camera import Camera as JCam
    from vimg_tpu.scene import json_loader as jjl
    from vimg_tpu_torch.lights.envmap import build_env_tables as tenv
    from vimg_tpu_torch.scene import json_loader as tjl
    cfg = json.loads(json.dumps(CHECKER_JSON))
    th = (np.arange(8) + 0.5) / 8 * np.pi
    env_img = np.repeat((0.4 + 0.6 * np.cos(th) ** 2)[:, None, None],
                        16, 1) * np.float32([1.0, 0.9, 0.8])
    env_img[1, 3] = 30.0
    c2w = look_at([0.0, 1.5, 4.0], [0.0, 0.3, 0.0], [0, 1, 0])
    out = []
    for jl, env_fn in ((jjl, jenv), (tjl, tenv)):
        b = jl.SceneBuilder()
        mids = []
        for m in cfg["materials"]:
            if m["type"] == "dielectric":
                mids.append(b.add_material(jir.MAT_DIELECTRIC,
                                           scalars={jir.MS_IOR: m["ior"]}))
            else:
                tex = jl._texture_from_json(b, m)
                mids.append(b.add_material(
                    jir.MAT_LAMBERTIAN, base=m.get("albedo", [0.5] * 3),
                    tex=(tex, -1, -1)))
        floor = np.diag([3.0, 3.0, 3.0, 1.0]).astype(np.float32)
        floor[:3, :3] = np.float32([[3, 0, 0], [0, 0, 3], [0, -1, 0]])
        b.add_quad(mids[0], floor)
        b.add_sphere((-0.6, 0.5, 0.0), 0.5, mids[1])
        b.add_sphere((0.7, 0.5, 0.3), 0.5, mids[2])
        env = env_fn(env_img.astype(np.float32))
        if jl is jjl:
            out.append(b.build(camera=JCam.make(c2w, 32, 24, 40.0), env=env,
                               bg_light=True))
        else:
            out.append(b.build(camera=dict(cam2world=c2w, width=32,
                                           height=24, vfov_deg=40.0),
                               env=env, bg_light=True, device="cpu"))
    return out


@pytest.mark.parametrize("integrator", ["mis", "material"])
def test_loop_render_checker_env(integrator):
    """render() (the loop integrators, with ray cones) on the checker +
    env scene against vimg_tpu's render(), both over their SoA tracers:
    unit scale, so per pixel: tests/test_megakernel.py's mean bound, and
    < 1% of pixels off by more than 1e-4 of max(|pixel|, 1e-2). (The
    env lookups' atan2 / acos / log2 differ from XLA's by an ulp, and a
    bilinear fetch next to the 30-unit sun texel magnifies that: some
    pixels sit 1e-5 to 1e-3 of their value apart.)"""
    from vimg_tpu.geometry.soa_intersect import SoATracer as JSoA
    from vimg_tpu.render.render import render as jrender
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer as TSoA
    from vimg_tpu_torch.render.render import render as trender
    js, ts = _checker_env_scenes(integrator)
    _same_scene(js, ts)
    assert ts.has_checker and ts.has_envmap and ts.needs_cones
    st = dataclasses.replace(_settings(32, 24, 4, integrator), max_depth=8)
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    ref = np.asarray(jrender(js, jst, tracer=JSoA(js)))
    img = trender(ts, st, tracer=TSoA(ts)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    d = np.abs(img - ref)
    assert d.mean() < 1e-4, d.mean()
    rel = d.max(-1) / np.maximum(np.abs(ref).max(-1), 1e-2)
    assert (rel > 1e-4).mean() < 0.01, np.sort(rel.ravel())[-10:]
