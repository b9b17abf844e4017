"""vimg_tpu_torch.render.render's dispatch against vimg_tpu's.

- Call forms: vimg_tpu's positional ``render_frame(scene, st, tracer)``
  and keyword ``render(scene, st, integrator="mis")`` run in the port
  unchanged, use the tracer they are given, print nothing, and equal
  vimg_tpu's renders of the same unit-scale scene at the unit-scale
  criteria of tests/test_torch_render.py (per-pixel |d|.mean() < 1e-4,
  < 1% of pixels with max|d| > 1e-5, corr > 0.999).
- The CPU rule: on the CPU no frame takes the megakernel. The port's
  ``render_frame`` of a small analytic MIS scene equals vimg_tpu's
  ``render_frame`` on the CPU (both the refill wavefront over the SoA
  tracer) at tests/test_torch_wavefront.py's parity: mean|d| < 5e-3 and
  corr > 0.99.
- The dispatch table, by spies on the functions ``render_frame`` calls:
  on the CPU, and on CUDA with a scene that reports a CUDA device (the
  spies replace every renderer, so nothing runs on a card), every
  ``s_normal``, ``g_normal`` and refused ``material`` frame goes to the
  loop ``render`` over ``make_tracer(scene, force=tracer_force)``; the
  megakernel runs only on CUDA.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vimg_tpu.core.math import look_at
from vimg_tpu.geometry.soa_intersect import SoATracer as JSoA
from vimg_tpu.render import render as jr
from vimg_tpu.render.camera import Camera
from vimg_tpu.scene import ir as jir
from vimg_tpu.scene.json_loader import SceneBuilder
from vimg_tpu_torch.geometry.soa_intersect import SoATracer as TSoA
from vimg_tpu_torch.render import render as tr
from vimg_tpu_torch.render.mega import kernel as tkernel
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn

W, H = 24, 16


def _unit_scene(spp, integrator, n_extra=0):
    """tests/test_megakernel.py::_simple_scene at W x H, plus ``n_extra``
    small spheres (257 of them make the megakernel refuse the scene)."""
    b = SceneBuilder()
    red = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(jir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={jir.MS_IOR: 1.5})
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    for k in range(n_extra):
        b.add_sphere((-3.0 + 0.02 * k, -2.0, 0), 0.01, red)
    cam = Camera.make(look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]), W, H, 45.0)
    st = jir.RenderSettings(width=W, height=H, spp=spp, max_depth=64,
                            integrator=integrator, batch_size=W * H * spp)
    return b.build(camera=cam), st


def _port(js, st):
    return (tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu"),
            tir.RenderSettings(**dataclasses.asdict(st)))


def _unit_parity(ref, img):
    d = np.abs(np.asarray(ref) - img.numpy())
    assert img.shape == (H, W, 3) and np.isfinite(img.numpy()).all()
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(np.asarray(ref).ravel(), img.numpy().ravel())[0, 1] \
        > 0.999


class _CountingTracer(TSoA):
    """The port's SoA tracer, counting its calls."""
    calls = 0

    def closest(self, *a):
        type(self).calls += 1
        return super().closest(*a)


def test_positional_tracer_form_matches_vimg_tpu(capsys):
    """render_frame(scene, st, tracer): the third positional argument is
    the tracer (not ``progress``), as in vimg_tpu."""
    js, st = _unit_scene(2, "s_normal")
    ts, tst = _port(js, st)
    ref = jr.render_frame(js, st, JSoA(js))
    _CountingTracer.calls = 0
    img = tr.render_frame(ts, tst, _CountingTracer(ts))
    assert _CountingTracer.calls > 0
    assert capsys.readouterr().out == ""          # progress stays off
    _unit_parity(ref, img)


def test_render_integrator_keyword_matches_vimg_tpu(capsys):
    """render(scene, st, integrator="mis") overrides settings.integrator
    for that call, as in vimg_tpu."""
    js, st = _unit_scene(4, "s_normal")
    ts, tst = _port(js, st)
    ref = jr.render(js, st, integrator="mis")
    stats = {"segments": 0, "shadow_rays": 0}
    img = tr.render(ts, tst, integrator="mis", stats=stats)
    assert capsys.readouterr().out == ""
    assert tst.integrator == "s_normal"           # the settings stay
    assert stats["shadow_rays"] > 0               # MIS ran, not s_normal
    _unit_parity(ref, img)


def test_cpu_render_frame_matches_vimg_tpu():
    """On the CPU both packages send an analytic MIS frame that the
    megakernel covers to the wavefront."""
    js, st = _unit_scene(4, "mis")
    ts, tst = _port(js, st)
    assert tkernel.supports_megakernel(ts, tst)
    before = (tkernel.LAUNCHES, tkernel.LAUNCHES_MESH)
    img = tr.render_frame(ts, tst)
    assert (tkernel.LAUNCHES, tkernel.LAUNCHES_MESH) == before
    ref = np.asarray(jr.render_frame(js, st))
    assert img.shape == (H, W, 3) and np.isfinite(img.numpy()).all()
    assert np.abs(ref - img.numpy()).mean() < 5e-3
    assert np.corrcoef(ref.ravel(), img.numpy().ravel())[0, 1] > 0.99


class _OnCuda:
    """A CPU scene that reports a CUDA device: the dispatch takes its CUDA
    branch while the spies keep every renderer off the card."""

    def __init__(self, scene):
        self._scene = scene

    def __getattr__(self, name):
        return getattr(self._scene, name)

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def spies(monkeypatch):
    """Replace every renderer and the tracer factory that render_frame
    reaches; returns the list of (renderer, integrator, tracer) calls."""
    from vimg_tpu_torch.render import mega, wavefront
    calls = []

    def spy(name):
        def fn(scene, settings, tracer=None, progress=False,
               integrator=None):
            calls.append((name, integrator or settings.integrator, tracer))
            return name
        return fn

    monkeypatch.setattr(mega, "render_megakernel", spy("megakernel"))
    monkeypatch.setattr(wavefront, "render_wavefront", spy("wavefront"))
    monkeypatch.setattr(tr, "render", spy("render"))
    monkeypatch.setattr(tr, "make_tracer",
                        lambda scene, force=None: ("tracer", force))
    return calls


ANALYTIC = _port(*_unit_scene(1, "mis"))[0]
REFUSED = _port(*_unit_scene(1, "mis", n_extra=257))[0]
MESH = tsyn.terrain_scene(300, 8, 6, device="cpu")

# (scene, integrator, spp) -> where each device sends the frame
CASES = [
    ("analytic", "mis", 1, "megakernel", "wavefront"),
    ("analytic", "material", 1, "megakernel", "render"),
    ("analytic", "s_normal", 1, "render", "render"),
    ("analytic", "g_normal", 1, "render", "render"),
    ("refused", "material", 1, "render", "render"),
    ("refused", "mis", 1, "wavefront", "wavefront"),
    ("mesh", "mis", 4, "megakernel", "wavefront"),
    ("mesh", "mis", 8, "wavefront", "wavefront"),
    ("mesh", "material", 64, "megakernel", "render"),
    ("mesh", "s_normal", 4, "render", "render"),
    ("mesh", "g_normal", 4, "render", "render"),
]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("kind,integrator,spp,on_cuda,on_cpu", CASES)
def test_dispatch_table(spies, device, kind, integrator, spp, on_cuda,
                        on_cpu):
    scene = {"analytic": ANALYTIC, "refused": REFUSED, "mesh": MESH}[kind]
    if kind == "refused":
        assert not tkernel.supports_megakernel(
            scene, tir.RenderSettings(W, H, integrator="material"))
    if device == "cuda":
        scene = _OnCuda(scene)
    st = tir.RenderSettings(W, H, spp=spp, integrator="s_normal")
    # integrator= overrides the settings', as in vimg_tpu
    assert tr.render_frame(scene, st, integrator=integrator,
                           tracer_force="soa") == (
        on_cuda if device == "cuda" else on_cpu)
    (name, used, tracer), = spies
    assert used == integrator
    if name != "megakernel":
        assert tracer == ("tracer", "soa")      # make_tracer's, forced


def test_given_tracer_and_use_wavefront(spies):
    """A given tracer is used as it is; use_wavefront=False sends an MIS
    frame to the loop render on both devices."""
    st = tir.RenderSettings(W, H, spp=8, integrator="mis")
    for scene in (MESH, _OnCuda(MESH)):
        assert tr.render_frame(scene, st, "mine") == "wavefront"
        assert tr.render_frame(scene, st, use_wavefront=False) == "render"
    assert [c[2] for c in spies] == ["mine", ("tracer", None)] * 2


def test_other_devices_raise(spies):
    class _OnMeta(_OnCuda):
        device = property(lambda self: torch.device("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        tr.render_frame(_OnMeta(ANALYTIC),
                        tir.RenderSettings(W, H, integrator="s_normal"))
    assert spies == []
