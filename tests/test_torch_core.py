"""vimg_tpu_torch core math, warps, camera and scene loading against
vimg_tpu on the same numpy inputs.

Tolerance: 1e-6 relative, with a 1e-6 absolute floor for unit-magnitude
values (vector components cross zero, where a relative bound is
meaningless). XLA's CPU code may contract a*b + c into an FMA, and its
transcendentals (sin, cos, tan) differ from ATen's by an ulp or two; the
absolute floor covers both."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.core import math as jm
from vimg_tpu.core import warps as jw
from vimg_tpu.render import camera as jcam
from vimg_tpu_torch.core import math as tm
from vimg_tpu_torch.core import warps as tw
from vimg_tpu_torch.render import camera as tcam
from vimg_tpu_torch.scene import ir as tir

RTOL, ATOL = 1e-6, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_JSON = os.path.join(ROOT, "scenes", "disney_spheres_flagship.json")


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


def _dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_vector_ops():
    a, b = _dirs(2000, 0) * 3.0, _dirs(2000, 1)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    # XLA's CPU code may fuse a*b - c*d into an FMA: ulp-level bounds
    _close(jm.dot(ja, jb), tm.dot(ta, tb), atol=3e-6)
    _close(jm.cross(ja, jb), tm.cross(ta, tb), atol=3e-6)
    _close(jm.normalize(ja), tm.normalize(ta))
    assert np.array_equal(np.asarray(jm.normalize(jnp.zeros((1, 3)))),
                          tm.normalize(torch.zeros(1, 3)).numpy())


def test_onb_from_normal_including_pole():
    n = np.concatenate([_dirs(2000, 2), [[0, 0, -1.0], [0, 0, 1.0]]])
    n = n.astype(np.float32)
    ju, jv = jm.onb_from_normal(jnp.asarray(n))
    tu, tv = tm.onb_from_normal(torch.as_tensor(n))
    _close(ju, tu)
    _close(jv, tv)
    assert np.array_equal(tu.numpy()[-2], [0, -1, 0])   # the -z pole
    d = _dirs(2000 + 2, 3)
    jl = jm.world_to_onb(ju, jv, jnp.asarray(n), jnp.asarray(d))
    tl = tm.world_to_onb(tu, tv, torch.as_tensor(n), torch.as_tensor(d))
    _close(jl, tl)
    _close(jm.onb_to_world(ju, jv, jnp.asarray(n), jl),
           tm.onb_to_world(tu, tv, torch.as_tensor(n), tl))


def test_look_at():
    args = ([0, 20, 1600], [0, -4, 0], [0, 1, 0])
    assert np.array_equal(jm.look_at(*args), tm.look_at(*args))


@pytest.mark.parametrize("name", ["sample_disk", "sample_sphere",
                                  "sample_hemisphere",
                                  "sample_hemisphere_cosine",
                                  "sample_triangle_uv"])
def test_warps(name):
    r = np.random.default_rng(4)
    r1, r2 = (r.random(5000).astype(np.float32) for _ in range(2))
    jo = getattr(jw, name)(jnp.asarray(r1), jnp.asarray(r2))
    to = getattr(tw, name)(torch.as_tensor(r1), torch.as_tensor(r2))
    for a, b in zip(jo if isinstance(jo, tuple) else (jo,),
                    to if isinstance(to, tuple) else (to,)):
        _close(a, b)


def test_sphere_cap_warp():
    r = np.random.default_rng(5)
    r1, r2, c = (r.random(5000).astype(np.float32) for _ in range(3))
    _close(jw.sample_sphere_cap(*map(jnp.asarray, (r1, r2, c))),
           tw.sample_sphere_cap(*map(torch.as_tensor, (r1, r2, c))))


@pytest.mark.parametrize("aperture", [0.0, 0.35])
def test_camera_rays(aperture):
    c2w = jm.look_at([0, 20, 1600], [0, -4, 0], [0, 1, 0])
    jc = jcam.Camera.make(c2w, 180, 80, 25.0, aperture, 1500.0)
    tc = tcam.Camera.make(c2w, 180, 80, 25.0, aperture, 1500.0,
                          device="cpu")
    r = np.random.default_rng(6)
    px = (r.random(4000) * 180).astype(np.float32)
    py = (r.random(4000) * 80).astype(np.float32)
    l1, l2 = (r.random(4000).astype(np.float32) for _ in range(2))
    jo, jd, jw, js = jcam.generate_rays(jc, *map(jnp.asarray,
                                                  (px, py, l1, l2)))
    to, td, tw, ts = tcam.generate_rays(tc, *map(torch.as_tensor,
                                                 (px, py, l1, l2)))
    # origins are ~1600 units from the world origin: ulp-scaled bound
    _close(jo, to, atol=1e-6 * 1600)
    _close(jd, td)
    # the primary cone: zero width, the pixel's spread angle
    assert np.array_equal(np.asarray(jw), tw.numpy())
    _close(js, ts)


def test_primary_ray_indexing():
    from __graft_entry__ import _flagship_scene
    from vimg_tpu.render.integrators import _primary_rays as jpr
    from vimg_tpu_torch.render.integrators import _primary_rays as tpr
    js, st = _flagship_scene()
    ts = tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")
    tst = tir.RenderSettings(**dataclasses.asdict(st))
    r = np.random.default_rng(7)
    pix = r.integers(0, 1800 * 800, 4000).astype(np.int32)
    samp = r.integers(0, 512, 4000).astype(np.int32)
    jo, jd, _, _ = jpr(js, st, jnp.asarray(pix), jnp.asarray(samp))
    to, td, _, _ = tpr(ts, tst, torch.as_tensor(pix).long(),
                       torch.as_tensor(samp).long())
    _close(jo, to, atol=1e-6 * 1600)
    _close(jd, td)


def _assert_same_scene(js, ts):
    fields, meta = tir.scene_to_numpy(js)
    tfields, tmeta = tir.scene_to_numpy(ts)
    assert meta == tmeta
    for k, v in fields.items():
        if k == "env_mips":
            continue
        assert np.array_equal(np.asarray(v), tfields[k]), k


def test_json_loader_matches_flagship_and_vimg_tpu():
    """The committed JSON reproduces __graft_entry__._flagship_scene()
    exactly under both packages' loaders."""
    from __graft_entry__ import _flagship_scene
    from vimg_tpu.scene.json_loader import load_json_scene as jload
    from vimg_tpu_torch.scene.json_loader import load_json_scene as tload
    flag, fst = _flagship_scene()
    js, jst = jload(FLAGSHIP_JSON)
    ts, tst = tload(FLAGSHIP_JSON, device="cpu")
    _assert_same_scene(flag, ts)
    _assert_same_scene(js, ts)
    for f in ("width", "height", "spp", "max_depth", "integrator"):
        assert getattr(fst, f) == getattr(jst, f) == getattr(tst, f), f
    assert (tst.width, tst.height, tst.spp, tst.integrator) == (
        1800, 800, 512, "mis")
    assert ts.n_tris() == 12 and ts.n_spheres() == 6 and ts.n_lights() == 2


def test_scene_numpy_roundtrip_and_builder():
    from vimg_tpu.scene.json_loader import SceneBuilder as JB
    from vimg_tpu_torch.scene.json_loader import SceneBuilder as TB
    from vimg_tpu.scene import ir as jir
    c2w = jm.look_at([0, 0, 6], [0, 0, 0], [0, 1, 0])
    scenes = []
    for B, cam in ((JB, jcam.Camera.make(c2w, 32, 24, 45.0)),
                   (TB, dict(cam2world=c2w, width=32, height=24,
                             vfov_deg=45.0))):
        b = B()
        red = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
        tex = b.add_texture(jir.TEX_CONST, col_a=(0.1, 0.5, 0.9))
        blue = b.add_material(jir.MAT_LAMBERTIAN, base=(0, 0, 0),
                              tex=(tex, -1, -1))
        light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
        b.add_sphere((0, 0, 0), 1.0, red)
        b.add_sphere((0, 3.0, 0), 1.0, light)
        b.add_quad(blue, np.eye(4, dtype=np.float32))
        b.add_quad(light, np.eye(4, dtype=np.float32) * 2)
        scenes.append(b.build(camera=cam) if B is JB
                      else b.build(camera=cam, device="cpu"))
    _assert_same_scene(*scenes)
    ts = scenes[1]
    back = tir.scene_from_numpy(*tir.scene_to_numpy(ts), device="cpu")
    _assert_same_scene(ts, back)


def test_unported_entries_raise(tmp_path):
    """Mesh surfaces (ported with the scene-file loaders) and checkered
    textures (ported with the envtex slice) load into the scene vimg_tpu's
    loader builds; a mesh whose OBJ is missing takes the cube stand-in."""
    from vimg_tpu.scene.json_loader import load_json_scene as jload
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    p = tmp_path / "mesh.json"
    cam = '"camera": {"transform": {"from": [0, 0, 1]}}, '
    p.write_text('{' + cam + '"materials": [{"name": "w", "type": "lambertian"}],'
                 ' "surfaces": [{"type": "mesh", "mat_name": "w",'
                 ' "filename": "cube.obj"}]}')
    ts, tst = load_json_scene(p, device="cpu")
    js, jst = jload(p)
    assert ts.n_tris() == 12
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    _assert_same_scene(js, ts)
    p.write_text('{' + cam + '"materials": [{"name": "w", "type": "lambertian",'
                 ' "texture": {"type": "checkered", "col1": [0,0,0],'
                 ' "col2": [1,1,1], "width": 4, "height": 4}}]}')
    ts, tst = load_json_scene(p, device="cpu")
    js, jst = jload(p)
    assert ts.has_checker and int(ts.tex_type[0]) == tir.TEX_CHECKER
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    _assert_same_scene(js, ts)
