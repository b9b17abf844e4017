"""The port's CLI against vimg_tpu's on the CPU: ``load_scene_any`` for
each suffix, the parser's flags, the heatmap (``-m``), the debug pixel
(``-d``) and ``-b 1``.

Criteria: loaded scenes equal byte for byte (tests/test_torch_loaders.py);
the flags, their types and defaults equal vimg_tpu's but ``--trace``
(ROADMAP A9) and the port's own ``--device``; heatmaps per pixel within
1e-5 (the Turbo polynomial is a 6-term product, summed in another order
than XLA's); the debug pixel within 1e-5 (the same hits; vimg_tpu's CPU
takes its BVH tracer and XLA fuses products into FMAs).
"""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from vimg_tpu_torch import cli
from vimg_tpu_torch.geometry import bvh as tb
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene.synthetic import terrain_mesh


def _mesh_json(tmp_path, spp=2, integrator="mis", res=(24, 12)):
    v, t = terrain_mesh(300, 1)
    (tmp_path / "t.obj").write_text(
        "".join(f"v {a!r} {b!r} {c!r}\n" for a, b, c in v.tolist())
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in t.tolist()))
    cfg = {
        "camera": {"transform": {"from": [0, 2.2, 4.6], "at": [0, 0, 0]},
                   "resolution": list(res), "vfov": 45},
        "sampler": {"samples": spp, "depth": 6},
        "integrator": {"type": integrator},
        "materials": [{"name": "g", "type": "lambertian",
                       "albedo": [0.55, 0.5, 0.42]},
                      {"name": "l", "type": "diffuse_light",
                       "albedo": [14, 13.5, 12]}],
        "surfaces": [
            {"type": "mesh", "mat_name": "g", "filename": "t.obj"},
            {"type": "quad", "mat_name": "l",
             "transform": [{"scale": 1.2},
                           {"rotate": [0.7071068, 0, 0, 0.7071068]},
                           {"translate": [0, 4, 0]}]}]}
    p = tmp_path / "mesh.json"
    p.write_text(json.dumps(cfg))
    return p


def _same_scene(js, ts):
    jf, jm = tir.scene_to_numpy(js)
    tf, tm = tir.scene_to_numpy(ts)
    assert jm == tm
    for k in jf:
        if k != "env_mips":
            assert np.array_equal(np.asarray(jf[k]), tf[k]), k


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """One file of each suffix (the loader tests' writers)."""
    import test_torch_loaders as tl
    d = tmp_path_factory.mktemp("cli_scenes")
    files = {".json": _mesh_json(d), ".xml": tl._mitsuba_files(d)}
    pngs = [tl._png("RGB", 16, 1), tl._png("RGBA", 8, 2), tl._png("L", 8, 3)]
    doc, blob = tl._gltf_doc(pngs)
    files[".glb"] = d / "s.glb"
    tl._write_glb(files[".glb"], doc, blob)
    files[".gltf"] = d / "s.gltf"
    files[".gltf"].write_text(json.dumps(tl._to_data_uris(doc, blob)))
    comp = d / "c.json"
    comp.write_text(json.dumps({"spp": 2, "integrator": "mis", "yres": 12}))
    return files, comp


@pytest.mark.parametrize("suffix", [".json", ".xml", ".glb", ".gltf"])
def test_load_scene_any(scene_files, suffix):
    from vimg_tpu.cli import load_scene_any as jload
    files, comp = scene_files
    js, jst = jload(files[suffix], comp)
    ts, tst = cli.load_scene_any(files[suffix], comp, device="cpu")
    _same_scene(js, ts)
    assert dataclasses.asdict(jst) == dataclasses.asdict(tst)
    with pytest.raises(ValueError, match="unknown scene format"):
        cli.load_scene_any(files[suffix].with_suffix(".obj"), device="cpu")


def test_parser_flags_match():
    from vimg_tpu.cli import build_argparser as jparser
    jp, tp = jparser(), cli.build_argparser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.type, a.default,
                         a.required, tuple(a.choices or ()))
                for a in p._actions if a.dest != "help"}
    jf, tf = flags(jp), flags(tp)
    assert set(tf) - set(jf) == {"device"}
    assert set(jf) - set(tf) == set()
    for k in set(jf) & set(tf):
        assert jf[k] == tf[k], k
    argv = ["-f", "a.glb", "-j", "c.json", "-m", "4", "-t", "8", "-c", "2",
            "-d", "3 4", "-b", "1", "-o", "x.png", "--spp", "9",
            "--depth", "-1", "--integrator", "mis", "--cpu", "--trace", "tr"]
    ja, ta = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
    assert ta.pop("device") == "cuda"
    assert ja == ta


HEAT_CASES = (("mesh", "sweep", 6.0), ("lights", "bvh", 0.0),
              ("mesh", "soa", 400.0))


def _heat_scenes(pkg, mesh_json):
    """(scene, settings) of the heatmap cases: the mesh JSON and
    many_lights_scene, at 32x16."""
    if pkg == "jax":
        from vimg_tpu.scene import ir
        from vimg_tpu.scene.json_loader import load_json_scene as load
        from vimg_tpu.scene.synthetic import many_lights_scene as ml
        kw = {}
    else:
        from vimg_tpu_torch.scene import ir
        from vimg_tpu_torch.scene.json_loader import load_json_scene as load
        from vimg_tpu_torch.scene.synthetic import many_lights_scene as ml
        kw = dict(device="cpu")
    return {"mesh": load(mesh_json, **kw),
            "lights": (ml(256, 32, 16, **kw), ir.RenderSettings(32, 16))}


def _heat_references(path, mesh_json):
    """vimg_tpu's heatmaps, in a child process whose XLA fuses no
    multiply-add (tests/test_torch_bvh.py's reason)."""
    from vimg_tpu.geometry.trace import make_tracer
    from vimg_tpu.render.heatmap import render_heatmap
    scenes = _heat_scenes("jax", mesh_json)
    out = {}
    for name, force, factor in HEAT_CASES:
        scene, st = scenes[name]
        out[f"{name}_{force}"] = np.asarray(render_heatmap(
            scene, st, make_tracer(scene, force=force), factor))
    np.savez(path, **out)


def test_heatmap_matches(tmp_path):
    """32x16 heatmaps over each package's BVH (a mesh scene: the sweep
    tree; many_lights_scene: the binned tree) and over the dense tracer
    (the brute-force cost), factor <= 0 taking the reference's 20."""
    import os
    import subprocess
    import sys
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render.heatmap import render_heatmap
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    p = _mesh_json(tmp_path, res=(32, 16))
    path = str(tmp_path / "heat.npz")
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_max_isa=AVX", JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path[:0] = [{root!r}, {here!r}]; "
            f"import test_torch_cli as t; "
            f"t._heat_references({path!r}, {str(p)!r})")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    refs = dict(np.load(path))
    scenes = _heat_scenes("torch", p)
    for name, force, factor in HEAT_CASES:
        scene, st = scenes[name]
        img = render_heatmap(scene, st, make_tracer(scene, force=force),
                             factor).numpy()
        ref = refs[f"{name}_{force}"]
        assert img.shape == ref.shape == (16, 32, 3)
        assert np.abs(img - ref).max() <= 1e-5, force
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > (
            1 if force != "soa" else 0)


def _pixel(out):
    lin = re.search(r"linear: \[(.*)\]", out).group(1)
    srgb = re.search(r"sRGB: +\[(.*)\]", out).group(1)
    return (np.array([float(x) for x in lin.split(",")]),
            np.array([float(x) for x in srgb.split(",")]))


def test_debug_pixel_matches(tmp_path, capsys):
    from vimg_tpu import cli as jcli
    p = _mesh_json(tmp_path, spp=8)
    assert jcli.main(["-f", str(p), "--cpu", "-d", "12 5"]) == 0
    ref = _pixel(capsys.readouterr().out)
    assert cli.main(["-f", str(p), "--cpu", "-d", "12 5"]) == 0
    got = _pixel(capsys.readouterr().out)
    assert ref[0].max() > 0.0
    for a, b in zip(ref, got):
        assert np.abs(a - b).max() <= 1e-5


def test_bvh_flag_and_heatmap_cli(tmp_path, monkeypatch, capsys):
    """-b 1 renders over BVHTracer(builder="sweep"); -m writes the
    heatmap render_heatmap gives over the binned BVH."""
    from vimg_tpu_torch.render import film
    from vimg_tpu_torch.render.heatmap import render_heatmap
    p = _mesh_json(tmp_path)
    builders = []
    init = tb.BVHTracer.__init__

    def spy(self, scene, builder="auto", plain=False):
        builders.append(builder)
        init(self, scene, builder=builder, plain=plain)
    monkeypatch.setattr(tb.BVHTracer, "__init__", spy)
    out = tmp_path / "b1.png"
    assert cli.main(["-f", str(p), "--cpu", "-b", "1", "-o", str(out)]) == 0
    assert builders == ["sweep"] and out.exists()
    hm = tmp_path / "hm.png"
    assert cli.main(["-f", str(p), "--device", "cpu", "-m", "4",
                     "-o", str(hm)]) == 0
    assert builders == ["sweep", "auto"]
    assert "Heatmap written" in capsys.readouterr().out
    ts, tst = cli.load_scene_any(p, device="cpu")
    ref = tmp_path / "ref.png"
    img = render_heatmap(ts, tst, tb.BVHTracer(ts), 4.0)
    film.write_png(ref, img)
    assert hm.read_bytes() == ref.read_bytes()
    assert torch.isfinite(img).all()


def test_sweep_note_only_when_the_megakernel_takes_the_frame(tmp_path):
    """ROADMAP C24, pinned: vimg_tpu prints its ``-b 1`` note for every
    MIS or material frame its megakernel supports (vimg_tpu/cli.py:
    134-142), also a mesh MIS frame at 8 spp or more that its wavefront
    takes; the port prints it only when render_frame sends the frame to
    the megakernel."""
    from vimg_tpu.render.mega import supports_megakernel as jsupports
    from vimg_tpu.scene.json_loader import load_json_scene as jload
    from vimg_tpu_torch.render.mega import supports_megakernel
    from vimg_tpu_torch.render.render import megakernel_takes
    p = _mesh_json(tmp_path, spp=64)
    js, jst = jload(p)
    ts, tst = cli.load_scene_any(p, device="cpu")
    assert jsupports(js, jst) and supports_megakernel(ts, tst)
    assert not megakernel_takes(ts, tst)
    assert megakernel_takes(ts, dataclasses.replace(tst, spp=4))
