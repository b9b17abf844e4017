"""vimg_tpu_torch.render.wavefront (the slice-2 main path, on the CPU with
the cluster tracer's plain walks) against vimg_tpu.

- Whole slice vs vimg_tpu: terrain_scene(600) at 24x16 @ 4 spp through
  vimg_tpu's render_wavefront with its own CPU mesh tracer (BVHTracer,
  numpy builder). The BVH walk intersects with the watertight formulation,
  the port with the SoA one, so epsilon races may flip single samples:
  mean|d| < 5e-3 (tests/test_cluster_trace.py's bound), corr > 0.99,
  segment and shadow-ray counts within 2%.
- Whole slice inside the port: a <= 64-triangle terrain through the
  cluster tracer and through the SoA tracer (the same float32 constants
  and formula): mean|d| < 1e-5 and equal counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vimg_tpu.scene import ir as jir
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.render import wavefront as twf
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn


def _settings(W, H, spp, max_depth=6, batch=1 << 10):
    return tir.RenderSettings(width=W, height=H, spp=spp,
                              max_depth=max_depth, integrator="mis",
                              batch_size=batch)


def _same_scene(js, ts):
    jf, jm = tir.scene_to_numpy(js)
    tf, tm = tir.scene_to_numpy(ts)
    assert jm == tm
    for k in jf:
        if k != "env_mips":
            assert np.array_equal(np.asarray(jf[k]), tf[k]), k


@pytest.mark.parametrize("wh", [(24, 16), (37, 5), (64, 64)])
def test_morton_pixel_order_matches(wh):
    from vimg_tpu.render.wavefront import morton_pixel_order as jorder
    a, b = jorder(*wh), twf.morton_pixel_order(*wh)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(np.sort(b), np.arange(wh[0] * wh[1]))


def test_render_wavefront_matches_vimg_tpu():
    from vimg_tpu.geometry.bvh import BVHTracer
    from vimg_tpu.render.wavefront import render_wavefront as jrender
    from vimg_tpu.scene.synthetic import terrain_scene as jterrain
    js = jterrain(600, 24, 16)
    ts = tsyn.terrain_scene(600, 24, 16, device="cpu")
    _same_scene(js, ts)
    st = _settings(24, 16, 4)
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    ref, rs = jrender(js, jst, tracer=BVHTracer(js, builder="numpy"),
                      return_stats=True)
    img, ps = twf.render_wavefront(ts, st, return_stats=True)
    img = img.numpy()
    assert img.shape == (16, 24, 3) and np.isfinite(img).all()
    assert np.abs(img - ref).mean() < 5e-3
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] > 0.99
    for k in ("segments", "shadow_rays"):
        assert abs(ps[k] - rs[k]) <= 0.02 * rs[k], (k, ps[k], rs[k])


def test_cluster_and_soa_wavefronts_agree():
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    ts = tsyn.terrain_scene(60, 16, 12, device="cpu")
    assert ts.n_tris() <= 64
    st = _settings(16, 12, 4)
    a, sa = twf.render_wavefront(ts, st, tracer=tct.ClusterTracer(ts),
                                 return_stats=True)
    b, sb = twf.render_wavefront(ts, st, tracer=SoATracer(ts),
                                 return_stats=True)
    assert (a - b).abs().mean() < 1e-5
    for k in ("segments", "shadow_rays", "supersteps"):
        assert sa[k] == sb[k], k


def test_wavefront_has_no_depth_cut():
    """As in vimg_tpu (ROADMAP queue C): the wavefront does not read
    settings.max_depth, so a path may run past it."""
    ts = tsyn.terrain_scene(60, 8, 8, device="cpu")
    tr = tct.ClusterTracer(ts)
    a, sa = twf.render_wavefront(ts, _settings(8, 8, 4, max_depth=1),
                                 tracer=tr, return_stats=True)
    b, sb = twf.render_wavefront(ts, _settings(8, 8, 4, max_depth=64),
                                 tracer=tr, return_stats=True)
    assert torch.equal(a, b) and sa == dict(sb, seconds=sa["seconds"])
    assert sa["segments"] > 1.5 * 8 * 8 * 4     # paths past one segment


def test_hit_info_smooth_normals():
    """Interpolated vertex normals (TRI_HAS_NORMALS) equal vimg_tpu's."""
    import jax.numpy as jnp
    from vimg_tpu.geometry import intersect as ji
    from vimg_tpu.scene.synthetic import bumpy_sphere_scene as jbumpy
    from vimg_tpu_torch.geometry import intersect as ti
    js = jbumpy(800, 16, 8, smooth_normals=True)
    ts = tsyn.bumpy_sphere_scene(800, 16, 8, smooth_normals=True,
                                 device="cpu")
    _same_scene(js, ts)
    assert bool((ts.tri_flags[:800] & tir.TRI_HAS_NORMALS).all())
    r = np.random.default_rng(3)
    n = 3000
    ro = (r.normal(size=(n, 3)) * 0.3 + [0, 0.6, 3.2]).astype(np.float32)
    rd = (-ro + r.normal(size=(n, 3)) * 0.3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    mn = np.full(n, 1e-4, np.float32)
    mx = np.full(n, np.inf, np.float32)
    th = tct.ClusterTracer(ts).closest(ts, *map(torch.as_tensor,
                                                (ro, rd, mn, mx)))
    f = th.hit.numpy()
    assert f.mean() > 0.3
    jh = ji.HitResult(t=jnp.asarray(th.t.numpy()),
                      prim_type=jnp.asarray(th.prim_type.numpy(), jnp.int32),
                      prim_id=jnp.asarray(th.prim_id.numpy(), jnp.int32),
                      u=jnp.asarray(th.u.numpy()), v=jnp.asarray(th.v.numpy()))
    jhi = ji.hit_info(js, jnp.asarray(ro), jnp.asarray(rd), jh)
    thi = ti.hit_info(ts, torch.as_tensor(ro), torch.as_tensor(rd), th)
    assert np.array_equal(np.asarray(jhi.mat_id)[f], thi.mat_id.numpy()[f])
    for k in ("p", "n_s", "n_g", "tangent", "bitangent"):
        np.testing.assert_allclose(getattr(thi, k).numpy()[f],
                                   np.asarray(getattr(jhi, k))[f],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # smooth shading really differs from the facet normal
    assert np.abs(thi.n_s.numpy() - thi.n_g.numpy())[f].max() > 1e-2


def test_render_frame_mesh_dispatch():
    """A CPU mesh MIS frame at production spp (>= 8; lower spp goes to
    the mesh-mode megakernel's plain version) goes to the wavefront and
    launches nothing."""
    from vimg_tpu_torch.render.mega import kernel
    from vimg_tpu_torch.render.render import render_frame
    ts = tsyn.terrain_scene(300, 8, 6, device="cpu")
    st = _settings(8, 6, 8)
    before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH, tct.LAUNCHES_WIDE,
              tct.LAUNCHES_SKIP)
    img = render_frame(ts, st)
    assert (kernel.LAUNCHES, kernel.LAUNCHES_MESH, tct.LAUNCHES_WIDE,
            tct.LAUNCHES_SKIP) == before
    assert img.shape == (6, 8, 3) and img.device.type == "cpu"
    assert torch.equal(img, twf.render_wavefront(ts, st))
