"""trace_radiance under bounded_depth and make_train_step's Adam steps
(vimg_tpu_torch) against vimg_tpu's on the CPU.

Criteria. Radiance under bounded_depth: tests/test_megakernel.py's unit
scale criteria per ray (mean |d| < 1e-4, < 1% of rays with max |d| >
1e-5, corr > 0.999). Train steps: losses within 1e-4 relative,
parameters within PARAM_ATOL. Inputs come from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diff_shard import _simple_scene
from test_torch_diff import _flat, _port, _rays
from vimg_tpu.diff import grad as jg
from vimg_tpu.geometry.trace import make_tracer as jmake
from vimg_tpu.scene import ir as jir
from vimg_tpu_torch.diff import grad as tg
from vimg_tpu_torch.geometry.trace import make_tracer as tmake
from vimg_tpu_torch.render.integrators import trace_radiance

PARAM_ATOL = 1e-5


def _ground_scene(integrator):
    """tests/test_torch_render.py's unit scene (a diffuse, a glass and a
    light sphere) on a grey ground sphere, so that some paths live past
    max_depth = 6."""
    from vimg_tpu.core.math import look_at
    from vimg_tpu.render.camera import Camera
    from vimg_tpu.scene.json_loader import SceneBuilder
    b = SceneBuilder()
    red = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(jir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={jir.MS_IOR: 1.5})
    light = b.add_material(jir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    grey = b.add_material(jir.MAT_LAMBERTIAN, base=(0.8, 0.8, 0.8))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    b.add_sphere((0, -101.0, 0), 100.0, grey)
    cam = Camera.make(look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]), 32, 24,
                      45.0)
    st = jir.RenderSettings(width=32, height=24, spp=2, max_depth=6,
                            integrator=integrator)
    return b.build(camera=cam), st


@pytest.fixture(scope="module")
def depth_renders():
    """(integrator, k) -> (vimg_tpu's radiance, the port's, the port's
    segment count) on the closed scene at max_depth 6; k = None is the
    port's loop without a bound."""
    from vimg_tpu.render.integrators import trace_radiance as jtrace
    out = {}
    for integ in ("mis", "material"):
        js, st = _ground_scene(integ)
        ts, tst = _port(js, st)
        jt, tt = jmake(js, force="soa"), tmake(ts, differentiable=True)
        n = st.width * st.height * 2
        pix = np.arange(n) // 2
        samp = np.arange(n) % 2
        jpix, jsamp = jnp.asarray(pix, jnp.int32), jnp.asarray(samp,
                                                                jnp.int32)
        tpix, tsamp = torch.as_tensor(pix), torch.as_tensor(samp)
        for k in (1, 3, 8, None):
            ref = None if k is None else np.asarray(jax.jit(
                lambda a, b, k=k: jtrace(js, st, jt, a, b, integrator=integ,
                                         bounded_depth=k))(jpix, jsamp))
            stats = {}
            got = trace_radiance(ts, tst, tt, tpix, tsamp, integrator=integ,
                                 bounded_depth=k, stats=stats).numpy()
            out[integ, k] = (ref, got, stats["segments"])
    return out


@pytest.mark.parametrize("integrator", ["mis", "material"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_bounded_depth_radiance(depth_renders, integrator, k):
    ref, got, segments = depth_renders[integrator, k]
    d = np.abs(ref - got)
    assert np.isfinite(got).all()
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.999
    # the bound, not max_depth = 6, stops the loop: fewer segments below
    # it, more above it
    unbounded = depth_renders[integrator, None][2]
    assert segments > unbounded if k == 8 else segments < unbounded


def test_train_steps_match_optax():
    """Three make_train_step steps (Adam, lr 1e-2) against vimg_tpu's
    optax steps from the same scene and rays."""
    js, st = _simple_scene(spp=1)
    ts, tst = _port(js, st)
    pix, samp, target = _rays(60)
    jstep, jstate, jp = jg.make_train_step(js, st, jmake(js), bounded_depth=3)
    tstep, tstate, tp = tg.make_train_step(ts, tst, tmake(ts), bounded_depth=3)
    assert sorted(jp) == sorted(tp)
    for i in range(3):
        jp, jstate, jl = jstep(jp, jstate, jnp.asarray(pix),
                               jnp.asarray(samp), jnp.asarray(target))
        tp, tstate, tl = tstep(tp, tstate, torch.as_tensor(pix).long(),
                               torch.as_tensor(samp).long(),
                               torch.as_tensor(target))
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), i
    jf = _flat(jp)
    tf = _flat({k: v.detach() for k, v in tp.items()})
    moved = 0
    for k in jf:
        assert np.abs(jf[k] - tf[k]).max() <= PARAM_ATOL, k
        moved += not np.array_equal(tf[k], _flat(tg.get_params(ts))[k])
    assert moved >= 3
    # the scene's own tensors are not written
    assert np.array_equal(ts.mat_base.numpy(), np.asarray(js.mat_base))
