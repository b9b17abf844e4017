"""The slice as a whole: vimg_tpu_torch's render_megakernel on CPU scenes
(its plain PyTorch version) against vimg_tpu.render.render.render, plus
film output, dispatch, the CLI and package hygiene.

Render criteria (tests/test_megakernel.py): at unit scale, per-pixel
|d|.mean() < 1e-4, < 1% of pixels with max|d| > 1e-5 and corr > 0.999;
on the 1300-unit flagship scene mean|d| < 6e-3 and corr > 0.99, because
shadow/self-intersection epsilon races (SHADOW_EPS = MIN_T = 1e-4 against
float32 ulps of ~6e-5 at 600 units) flip single samples between two
differently rounded programs.
"""
import dataclasses
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vimg_tpu.core.math import look_at
from vimg_tpu.render import film as jfilm
from vimg_tpu.render.camera import Camera
from vimg_tpu.render.render import render as jrender
from vimg_tpu.scene import ir as jir
from vimg_tpu.scene.json_loader import SceneBuilder
from vimg_tpu_torch.render import film as tfilm
from vimg_tpu_torch.render.mega import kernel as tkernel
from vimg_tpu_torch.scene import ir as tir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_JSON = os.path.join(ROOT, "scenes", "disney_spheres_flagship.json")


def _unit_scene(spp, integrator):
    """tests/test_megakernel.py::_simple_scene."""
    b = SceneBuilder()
    red = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(jir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={jir.MS_IOR: 1.5})
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    cam = Camera.make(look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]), 32, 24,
                      45.0)
    st = jir.RenderSettings(width=32, height=24, spp=spp, max_depth=64,
                            integrator=integrator, batch_size=32 * 24 * spp)
    return b.build(camera=cam), st


def _flagship_small():
    from __graft_entry__ import _flagship_scene
    js, st = _flagship_scene()
    js = js.replace(camera=dataclasses.replace(js.camera, width=48,
                                               height=24))
    return js, dataclasses.replace(st, width=48, height=24, spp=4)


def _port(js, st):
    return (tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu"),
            tir.RenderSettings(**dataclasses.asdict(st)))


@pytest.fixture(scope="module")
def renders():
    """Each vimg_tpu reference render once (each compiles its own jitted
    chunk step); the port's render of the same scene beside it."""
    out = {}
    for name, (js, st) in {
            "unit_mis": _unit_scene(8, "mis"),
            "unit_material": _unit_scene(8, "material"),
            "flagship_mis": _flagship_small()}.items():
        ts, tst = _port(js, st)
        img, stats = tkernel.render_megakernel(ts, tst, return_stats=True)
        out[name] = (np.asarray(jrender(js, st)), img.numpy(), stats, tst)
    return out


@pytest.mark.parametrize("name", ["unit_mis", "unit_material"])
def test_unit_scale_parity(renders, name):
    ref, img, _, _ = renders[name]
    d = np.abs(ref - img)
    assert np.isfinite(img).all()
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(ref.ravel(), img.ravel())[0, 1] > 0.999


def test_flagship_statistical_parity(renders):
    ref, img, _, _ = renders["flagship_mis"]
    assert img.shape == (24, 48, 3) and np.isfinite(img).all()
    assert np.abs(ref - img).mean() < 6e-3
    assert np.corrcoef(ref.ravel(), img.ravel())[0, 1] > 0.99


@pytest.mark.parametrize("name", ["unit_mis", "unit_material",
                                  "flagship_mis"])
def test_ray_counts(renders, name):
    """Every path traces at least its primary segment; MIS shoots at most
    one shadow ray per segment, the material integrator none."""
    _, _, stats, st = renders[name]
    paths = st.width * st.height * st.spp
    assert stats["segments"] >= paths
    if st.integrator == "mis":
        assert 0 < stats["shadow_rays"] <= stats["segments"]
    else:
        assert stats["shadow_rays"] == 0


@pytest.mark.parametrize("name", ["unit_mis", "unit_material",
                                  "flagship_mis"])
def test_plain_warp_steps(name):
    """The plain version's warp steps, the analytic kernel's third counter:
    for each group of 32 consecutive pixels, the largest per-pixel sum of
    path segments, summed over groups; held to a brute-force loop over the
    per-pixel sums the integrator reports, whose sum is the segment
    count."""
    from vimg_tpu_torch.render.render import render
    js, st = {"unit_mis": lambda: _unit_scene(8, "mis"),
              "unit_material": lambda: _unit_scene(8, "material"),
              "flagship_mis": _flagship_small}[name]()
    ts, tst = _port(js, st)
    _, stats = tkernel.render_megakernel(ts, tst, return_stats=True)
    n_pix = tst.width * tst.height
    lens = {"pixel_segments": torch.zeros(n_pix, dtype=torch.int64)}
    render(ts, tst, stats=lens, tracer=tkernel.plain_tracer(ts))
    per_pixel = lens["pixel_segments"].tolist()
    steps = 0
    for g0 in range(0, n_pix, 32):
        steps += max(per_pixel[g0:g0 + 32])
    assert stats["warp_steps"] == steps
    assert sum(per_pixel) == stats["segments"] == lens["segments"]
    # every path traces at least its camera ray
    assert min(per_pixel) >= tst.spp and steps * 32 >= stats["segments"]


def test_sample_offset_slabs_compose():
    """Two half-spp slabs at offsets 0 and spp/2 average to the full
    render (same RNG streams); only the accumulation grouping differs."""
    ts, tst = _port(*_unit_scene(8, "mis"))
    full = tkernel.render_megakernel(ts, tst)
    half = dataclasses.replace(tst, spp=4)
    a = tkernel.render_megakernel(ts, half, sample_offset=0)
    b = tkernel.render_megakernel(ts, half, sample_offset=4)
    assert (((a + b) / 2 - full).abs().max()) < 1e-5
    assert (a - b).abs().mean() > 1e-4


def test_render_frame_cpu_dispatch():
    """vimg_tpu's CPU rule: no frame takes the megakernel on the CPU; an
    MIS frame the megakernel covers goes to the wavefront."""
    from vimg_tpu_torch.render import wavefront as twf
    from vimg_tpu_torch.render.render import render_frame
    ts, tst = _port(*_unit_scene(2, "mis"))
    before = tkernel.LAUNCHES
    img = render_frame(ts, tst)
    assert tkernel.LAUNCHES == before       # CPU scenes never launch
    assert img.shape == (24, 32, 3) and img.device.type == "cpu"
    assert torch.equal(img, twf.render_wavefront(ts, tst))


def test_pack_tables_match_vimg_tpu():
    """The kernel's host tables are vimg_tpu's _pack_scene tables."""
    from __graft_entry__ import _flagship_scene
    from vimg_tpu.render.mega.kernel import _pack_scene as jpack
    js, _ = _flagship_scene()
    ts = tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")
    jt, jstatic = jpack(js)
    tt = tkernel._pack_scene(ts)
    assert np.array_equal(jt["tri_c"], tt["tri_c"])
    assert np.array_equal(jt["tri_v"], tt["tri_v"][:, :12])
    assert np.array_equal(np.asarray(jstatic["tri_area"], np.float32),
                          tt["tri_v"][:, 12])
    assert np.array_equal(jt["sph_c"], tt["sph"][:, :4])
    assert np.array_equal(jt["light_rows"], tt["light_rows"])
    assert np.array_equal(jt["mat_base"], tt["mat_base"])
    assert np.array_equal(np.asarray(jstatic["prim_mat"]),
                          tt["prim_mat"][:-1])
    cam = tkernel._cam_table(ts)
    assert np.array_equal(jt["cam_row"][4:16], cam[5:17])
    for scene in (ts, _port(*_unit_scene(1, "mis"))[0]):   # with / no tris
        shapes = tkernel._table_shapes(scene)
        for k, t in tkernel._device_tables(scene).items():
            assert tuple(t.shape) == shapes[k], k
    assert tkernel.supports_megakernel(ts, tir.RenderSettings(
        integrator="mis"))


def test_tonemappers_and_finalize():
    r = np.random.default_rng(60)
    img = (r.random((16, 24, 3)) * 4).astype(np.float32)
    img[0, 0, 1] = np.nan
    for name in ("clamp", "agx", "reinhard", "aces"):
        a = np.asarray(jfilm.TONEMAPPERS[name](jnp.asarray(img[1:])))
        b = tfilm.TONEMAPPERS[name](torch.as_tensor(img[1:])).numpy()
        # log2/pow come from XLA's and ATen's libraries: a few ulp apart
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    for name in ("clamp", "agx"):
        a = np.asarray(jfilm.finalize(jnp.asarray(img), tonemap=name))
        b = tfilm.finalize(torch.as_tensor(img), tonemap=name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        assert b[0, 0].tolist() == [1.0, 0.0, 1.0]    # NaN -> magenta
    s = np.linspace(0, 1, 101, dtype=np.float32)
    np.testing.assert_allclose(
        tfilm.srgb_encode(torch.as_tensor(s)).numpy(),
        np.asarray(jfilm.srgb_encode(jnp.asarray(s))), rtol=1e-5, atol=1e-6)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                              "big")
    idat, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(61).random((7, 5, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    tfilm.write_png(str(p), torch.as_tensor(img))
    assert np.array_equal(_read_png(p),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _small_json(tmp_path):
    import json
    cfg = json.loads(open(FLAGSHIP_JSON).read())
    cfg["camera"]["resolution"] = [24, 12]
    p = tmp_path / "small.json"
    p.write_text(json.dumps(cfg))
    return str(p)


def test_cli_cpu_render(tmp_path, capsys):
    from vimg_tpu_torch import cli
    out = tmp_path / "o.png"
    assert cli.main(["-f", _small_json(tmp_path), "--device", "cpu",
                     "--spp", "1", "-o", str(out)]) == 0
    assert _read_png(out).shape == (12, 24, 3)
    assert "Image written" in capsys.readouterr().out


def test_cuda_request_without_cuda_raises(tmp_path):
    """A CUDA request never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the no-CUDA path cannot be shown")
    from vimg_tpu_torch import cli
    from vimg_tpu_torch.render.camera import Camera as TCamera
    from vimg_tpu_torch.scene import synthetic
    from vimg_tpu_torch.scene.json_loader import SceneBuilder as TB
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_json_scene(FLAGSHIP_JSON, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-f", _small_json(tmp_path), "-o",
                  str(tmp_path / "x.png")])        # --device defaults to cuda
    ts, _ = _port(*_unit_scene(1, "mis"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.to("cuda")
    # every scene entry point defaults to the card
    c2w = np.eye(4, dtype=np.float32)
    fields, meta = tir.scene_to_numpy(ts)
    b = TB()
    b.add_material(tir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, 0), 1.0, 0)
    for call in (lambda: load_json_scene(FLAGSHIP_JSON),
                 lambda: b.build(camera=dict(cam2world=c2w, width=4,
                                             height=4, vfov_deg=45.0)),
                 lambda: tir.scene_from_numpy(fields, meta),
                 lambda: TCamera.make(c2w, 4, 4, 45.0),
                 lambda: synthetic.terrain_scene(200, 4, 4),
                 lambda: synthetic.bumpy_sphere_scene(200, 4, 4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_package_never_imports_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import vimg_tpu_torch\n"
            "for m in pkgutil.walk_packages(vimg_tpu_torch.__path__,"
            " 'vimg_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'vimg_tpu.')) or m == 'vimg_tpu']\n"
            "print(len([m for m in sys.modules"
            " if m.startswith('vimg_tpu_torch')]))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
