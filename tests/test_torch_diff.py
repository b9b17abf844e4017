"""The differentiable path (vimg_tpu_torch.diff.grad) against
vimg_tpu.diff.grad on the CPU: get_params, the gradient of
radiance_loss_fn for every parameter key, the cluster tracer's zero
tangent, the finite-difference checks of tests/test_diff_shard.py, the
env pyramid cache under training (ROADMAP C20), and the texture colours'
gradients at the shading inputs. trace_radiance under bounded_depth and
the train steps are held in tests/test_torch_diff_steps.py, the
gradients where vimg_tpu's reverse mode is NaN (ROADMAP C21) in
tests/test_torch_diff_checks.py.

Scenes: tests/test_diff_shard.py's simple and closeup scenes and the
env-lit textured terrain (``textured_terrain_scene``) at 8 triangles and
16x16: vimg_tpu's SoA tracer tests every triangle in an unrolled loop, so
its gradient graph grows with the triangle count (at 200 triangles its
jit of value_and_grad took over 40 GiB of host memory), and 8 keep the
file inside its time. The port's tracers are held on a terrain of 300 triangles too.
Inputs come from a seed with numpy; no vimg_tpu Pallas kernel runs.

Criterion. Gradients, per key: max |g_port - g_jax| <= GRAD_RTOL *
max |g_jax| + GRAD_ATOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diff_shard import _closeup_scene, _simple_scene
from vimg_tpu.diff import grad as jg
from vimg_tpu.geometry.trace import make_tracer as jmake
from vimg_tpu.scene import ir as jir
from vimg_tpu_torch.diff import grad as tg
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.geometry.trace import make_tracer as tmake
from vimg_tpu_torch.lights import envmap as tenv
from vimg_tpu_torch.render.integrators import trace_radiance
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ENV_SMALL = dict(n_tris=8, width=16, height=16, tex_size=32,
                 env_size=(16, 32))
DEPTH = 3
CAMERA_KEYS = ("cam_vfov", "cam2world", "cam_aperture", "cam_focal")


def _envtex_scene():
    from vimg_tpu.scene.synthetic import textured_terrain_scene as jtt
    js = jtt(**ENV_SMALL)
    return js, jir.RenderSettings(width=16, height=16, spp=4, max_depth=6,
                                  integrator="mis")


SCENES = {"simple": lambda: _simple_scene(), "closeup": _closeup_scene,
          "envtex": _envtex_scene}
# the closeup scene's gradients are held by the finite-difference check
# (its JAX compile would add about 11 s)
GRAD_SCENES = ("simple", "envtex")


def _port(js, st):
    return (tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu"),
            tir.RenderSettings(**dataclasses.asdict(st)))


def _rays(seed, n=256, n_pix=256):
    r = np.random.default_rng(seed)
    pix = (np.arange(n) % n_pix).astype(np.int32)
    samp = r.integers(0, 64, n).astype(np.int32)
    target = (r.random((n, 3)) * 0.3).astype(np.float32)
    return pix, samp, target


def _leaf_params(ts):
    return {k: tuple(m.clone().requires_grad_(True) for m in v)
            if isinstance(v, tuple) else v.clone().requires_grad_(True)
            for k, v in tg.get_params(ts).items()}


def _flat(params):
    """key -> numpy array; env_mips as env_mips/<level>."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (tuple, list)):
            out.update({f"{k}/{i}": np.asarray(m) for i, m in enumerate(v)})
        else:
            out[k] = np.asarray(v)
    return out


def _port_grads(ts, st, tracer, rays, depth=DEPTH):
    pix, samp, target = (torch.as_tensor(x) for x in rays)
    loss, g = tg.value_and_grad(ts, st, tracer, _leaf_params(ts), pix.long(),
                                samp.long(), target, bounded_depth=depth,
                                integrator="mis")
    return float(loss), _flat(g)


class _JaxZeroTangent:
    """vimg_tpu's SoA tracer behind the facade of vimg_tpu's ClusterTracer
    (geometry/cluster_trace.py: traversal inputs stop_gradient'ed) where
    ``on``, a traced flag, holds: one compile serves both semantics."""

    def __init__(self, tracer, on):
        self.tracer, self.on = tracer, on

    def _cut(self, *xs):
        return [jnp.where(self.on, jax.lax.stop_gradient(x), x) for x in xs]

    def closest(self, scene, ro, rd, minT, maxT):
        return self.tracer.closest(scene, *self._cut(ro, rd, minT, maxT))

    def occluded(self, scene, ro, rd, minT, maxT):
        return self.tracer.occluded(scene, *self._cut(ro, rd, minT, maxT))


class _PortZeroTangent(_JaxZeroTangent):
    """The port's SoA tracer behind the facade of the port's cluster
    tracer (rays detached)."""

    def __init__(self, tracer):
        self.tracer = tracer

    def _cut(self, *xs):
        return tct.detached_rays(*xs)


def _camera_basis(params):
    """The camera keys' unit tangents, stacked on a leading axis, with zero
    tangents for every other key; and their (key, index) labels."""
    labels, tans = [], []
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    for k in CAMERA_KEYS:
        shape = np.shape(params[k])
        for idx in np.ndindex(*shape):
            e = np.zeros(shape, np.float32)
            e[idx] = 1.0
            labels.append((k, idx))
            tans.append(dict(zeros, **{k: e}))
    return labels, jax.tree_util.tree_map(lambda *x: jnp.stack(x), *tans)


@pytest.fixture(scope="module")
def jax_grads():
    """name -> dict(js, st, rays, loss, grads): jax.value_and_grad of
    radiance_loss_fn over vimg_tpu's SoA tracer, each compiled once. On the
    envtex scene, whose reverse-mode camera gradients are NaN (ROADMAP
    C21), the camera keys come from forward mode (the discarded branches'
    tangents are selected away, not multiplied by a zero cotangent), in
    the same compile, and the same again at zero tangent (``zt_grads``:
    vimg_tpu's ClusterTracer semantics)."""
    out = {}
    for i, name in enumerate(GRAD_SCENES):
        js, st = SCENES[name]()
        rays = _rays(40 + i)
        pix, samp, target = (jnp.asarray(x) for x in rays)
        soa = jmake(js, force="soa")
        p0 = jg.get_params(js)

        def loss(p, zt, js=js, st=st, soa=soa):
            return jg.radiance_loss_fn(
                jg.apply_params(js, p), st, _JaxZeroTangent(soa, zt), pix,
                samp, target, bounded_depth=DEPTH, integrator="mis")
        entry = dict(js=js, st=st, rays=rays)
        if name != "envtex":
            val, g = jax.jit(jax.value_and_grad(loss))(p0, False)
            out[name] = dict(entry, loss=float(val), grads=_flat(g))
            continue
        labels, tans = _camera_basis(p0)

        def both(p, tans, zt, loss=loss):
            val, lin = jax.linearize(lambda q: loss(q, zt), p)
            g, = jax.linear_transpose(lin, p)(jnp.ones_like(val))
            return val, g, jax.vmap(lin)(tans)
        both = jax.jit(both)
        for key, zt in (("grads", False), ("zt_grads", True)):
            val, g, cam = both(p0, tans, zt)
            flat = _flat(g)
            fwd = {k: np.zeros(np.shape(p0[k]), np.float32)
                   for k in CAMERA_KEYS}
            for (k, idx), d in zip(labels, np.asarray(cam)):
                fwd[k][idx] = d
            entry[key] = dict(flat, **fwd)
            entry.setdefault("loss", float(val))
            entry.setdefault("reverse_camera", {k: flat[k]
                                                for k in CAMERA_KEYS})
        out[name] = entry
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_get_params_keys_and_values(name):
    js, st = SCENES[name]()
    ts, _ = _port(js, st)
    jp, tp = jg.get_params(js), tg.get_params(ts)
    assert sorted(jp) == sorted(tp)
    assert ("env_mips" in tp) == (name == "envtex")
    jf, tf = _flat(jp), _flat(tp)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert np.array_equal(jf[k], tf[k]), k
    # the parameters are the scene's own tensors, and apply_params puts
    # the given tensors themselves back
    assert tp["mat_base"] is ts.mat_base and tp["cam2world"] is \
        ts.camera.cam2world
    back = tg.params_from_numpy(
        {k: [np.asarray(m) for m in v] if isinstance(v, tuple)
         else np.asarray(v) for k, v in jp.items()}, device="cpu")
    assert isinstance(back.get("env_mips", ()), tuple)
    bf = _flat(back)
    assert sorted(bf) == sorted(tf)
    for k in bf:
        assert np.array_equal(bf[k], tf[k]) and bf[k].dtype == np.float32, k
    s2 = tg.apply_params(ts, back)
    assert s2.mat_base is back["mat_base"]
    assert s2.camera.vfov_deg is back["cam_vfov"]
    if "env_mips" in back:
        assert all(a is b for a, b in zip(s2.env_mips, back["env_mips"]))


def _check_grads(jflat, tflat, keys=None):
    bad = []
    for k in (keys or jflat):
        a, b = jflat[k], tflat[k]
        assert a.shape == b.shape, k
        assert np.isfinite(a).all() and np.isfinite(b).all(), k
        err = np.abs(a - b).max()
        if err > GRAD_RTOL * np.abs(a).max() + GRAD_ATOL:
            bad.append((k, err, np.abs(a).max()))
    assert not bad, bad


@pytest.mark.parametrize("name", GRAD_SCENES)
def test_gradients_match_jax(jax_grads, name):
    """Every key's gradient through the SoA tracer on both sides. On the
    envtex scene vimg_tpu's reverse-mode camera gradients are NaN (ROADMAP
    C21): there the camera keys are held to vimg_tpu's forward mode."""
    e = jax_grads[name]
    ts, tst = _port(e["js"], e["st"])
    loss, tflat = _port_grads(ts, tst, tmake(ts, force="soa"), e["rays"])
    assert abs(loss - e["loss"]) <= 1e-5 * abs(e["loss"])
    assert sorted(tflat) == sorted(e["grads"])
    if name == "envtex":
        assert not np.isfinite(e["reverse_camera"]["cam2world"]).all()
    _check_grads(e["grads"], tflat)
    # the keys the scene reads carry a gradient
    live = {"simple": ("mat_base", "cam2world", "cam_vfov", "bg_color"),
            "envtex": ("mat_scalars", "env_scale", "env_mips/0",
                       "cam2world", "cam_vfov")}[name]
    for k in live:
        assert np.abs(tflat[k]).max() > 0.0, k


def test_cluster_tracer_zero_tangent(jax_grads, monkeypatch):
    """Through the cluster tracer (its plain walk on the CPU, B3 on the
    card) every key's gradient equals vimg_tpu's at zero tangent (its SoA
    tracer behind its ClusterTracer's stop_gradient; the camera keys by
    forward mode), the material, texture and env ones equal its SoA ones
    too, and the walk gets detached rays."""
    e = jax_grads["envtex"]
    ts, tst = _port(e["js"], e["st"])
    seen = []
    trace = tct.ClusterTracer.trace

    def spy(self, ro, rd, minT, maxT, any_hit):
        seen.append(any(x.requires_grad for x in (ro, rd, minT, maxT)))
        return trace(self, ro, rd, minT, maxT, any_hit)
    monkeypatch.setattr(tct.ClusterTracer, "trace", spy)
    tracer = tmake(ts, force="cluster", differentiable=True)
    assert isinstance(tracer, tct.ClusterTracer) and tracer.walk == "wide"
    _, tflat = _port_grads(ts, tst, tracer, e["rays"])
    assert len(seen) > DEPTH and not any(seen)
    _check_grads(e["zt_grads"], tflat)
    _check_grads(e["grads"], tflat,
                 [k for k in e["grads"] if k not in CAMERA_KEYS])
    # the hit-point motion term is gone, not every camera term
    assert np.abs(tflat["cam2world"]).max() > 0.0
    assert not np.allclose(e["zt_grads"]["cam2world"],
                           e["grads"]["cam2world"])


def test_cluster_tracer_at_300_triangles():
    """The textured terrain at 300 triangles: every key's gradient through
    the cluster tracer equals the port's SoA tracer's behind a detaching
    facade (held to vimg_tpu's zero tangent above), and the material and
    env ones equal the SoA tracer's without it."""
    ts = tsyn.textured_terrain_scene(**dict(ENV_SMALL, n_tris=300),
                                     device="cpu")
    st = tir.RenderSettings(width=16, height=16, spp=4, max_depth=6,
                            integrator="mis")
    rays = _rays(50)
    soa = tmake(ts, force="soa")
    _, full = _port_grads(ts, st, soa, rays, depth=2)
    _, cut = _port_grads(ts, st, _PortZeroTangent(soa), rays, depth=2)
    _, clu = _port_grads(ts, st, tmake(ts, force="cluster"), rays, depth=2)
    _check_grads(cut, clu)
    _check_grads(full, clu, [k for k in full if k not in CAMERA_KEYS])
    assert np.abs(clu["env_scale"]).max() > 0.0
    assert np.abs(clu["cam2world"]).max() > 0.0


def test_texture_gradients_match_jax():
    """The checker colours (tex_cols) and base colours (mat_base) reach
    the shading inputs with vimg_tpu's gradients: texture_inputs on
    tests/test_torch_envtex.py's scene holding every texture kind, on the
    port's hits, weighted by seeded random cotangents."""
    from test_torch_envtex import _shading_hits
    from vimg_tpu.materials import bsdf as jb
    from vimg_tpu_torch.materials import bsdf as tb
    js, ts, jhi, thi, f, rd = _shading_hits(n=2000, seed=31)
    r = np.random.default_rng(32)
    cw = (r.random(f.shape[0]) * 0.02).astype(np.float32)
    w = (r.normal(size=(f.shape[0], 3)) * f[:, None]).astype(np.float32)

    def jloss(tc, mb):
        tex = jb.texture_inputs(js.replace(tex_cols=tc, mat_base=mb),
                                jhi.mat_id, jhi, jnp.asarray(cw),
                                jnp.asarray(rd))
        return jnp.sum(tex["base_col"] * w)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(js.tex_cols,
                                                      js.mat_base)
    tc = ts.tex_cols.clone().requires_grad_(True)
    mb = ts.mat_base.clone().requires_grad_(True)
    tex = tb.texture_inputs(ts.replace(tex_cols=tc, mat_base=mb), thi.mat_id,
                            thi, torch.as_tensor(cw), torch.as_tensor(rd))
    (tex["base_col"] * torch.as_tensor(w)).sum().backward()
    _check_grads({"tex_cols": np.asarray(jgrads[0]),
                  "mat_base": np.asarray(jgrads[1])},
                 {"tex_cols": tc.grad.numpy(), "mat_base": mb.grad.numpy()})
    assert np.abs(tc.grad.numpy()).max() > 0.0


def _fd_loss(ts, st, params, rays, depth=3):
    pix, samp, target = (torch.as_tensor(x) for x in rays)
    tracer = tmake(ts)
    return tg.radiance_loss_fn(tg.apply_params(ts, params), st, tracer,
                               pix.long(), samp.long(), target,
                               bounded_depth=depth, integrator="mis")


def test_albedo_gradient_matches_fd():
    """tests/test_diff_shard.py::TestGradients::
    test_albedo_gradient_matches_fd on the port, same tolerance."""
    ts, st = _port(*_simple_scene())
    B = 16 * 16 * 4
    rays = (np.arange(B) % 256, np.arange(B) // 256, np.zeros((B, 3),
                                                               np.float32))
    p = _leaf_params(ts)
    _fd_loss(ts, st, p, rays).backward()
    ad = float(p["mat_base"].grad[0, 0])
    assert np.isfinite(p["mat_base"].grad[0].numpy()).all()
    eps = 1e-2
    with torch.no_grad():
        fd = []
        for s in (1.0, -1.0):
            q = dict(tg.get_params(ts))
            mb = q["mat_base"].clone()
            mb[0, 0] += s * eps
            q["mat_base"] = mb
            fd.append(float(_fd_loss(ts, st, q, rays)))
    fd = (fd[0] - fd[1]) / (2 * eps)
    assert abs(fd - ad) < 0.05 * max(abs(fd), abs(ad), 1e-3), (fd, ad)


def test_vfov_gradient_matches_fd():
    """tests/test_diff_shard.py::TestCameraGradients::
    test_vfov_gradient_matches_fd on the port, same tolerance."""
    ts, st = _port(*_closeup_scene())
    B = 16 * 16
    rays = (np.arange(B), np.zeros(B, np.int64), np.zeros((B, 3),
                                                          np.float32))
    p = _leaf_params(ts)
    _fd_loss(ts, st, p, rays).backward()
    ad = float(p["cam_vfov"].grad)
    assert np.isfinite(ad) and ad != 0.0
    eps = 1e-2
    with torch.no_grad():
        v = tg.get_params(ts)["cam_vfov"]
        fd = [float(_fd_loss(ts, st, dict(tg.get_params(ts),
                                          cam_vfov=v + s * eps), rays))
              for s in (1.0, -1.0)]
    fd = (fd[0] - fd[1]) / (2 * eps)
    assert abs(fd - ad) < 0.12 * max(abs(fd), abs(ad), 1e-4), (fd, ad)


def test_c20_trained_sky_two_steps():
    """Two train steps on the envtex scene with the sky trained: the
    second step's loss equals a fresh scene's at the updated parameters,
    both backwards run, and a forward render with the same levels tuple
    after the in-place update reads the new sky, not a cached pyramid."""
    ts = tsyn.textured_terrain_scene(**dict(ENV_SMALL, n_tris=32),
                                     device="cpu")
    st = tir.RenderSettings(width=16, height=16, spp=4, max_depth=6,
                            integrator="mis")
    pix, samp, target = (torch.as_tensor(x) for x in _rays(70))
    pix, samp = pix.long(), samp.long()
    tracer = tmake(ts, force="cluster")
    step, state, params = tg.make_train_step(ts, st, tracer, bounded_depth=2)
    mips = params["env_mips"]

    def fresh_loss(p):
        copy = {k: tuple(m.detach().clone() for m in v)
                if isinstance(v, tuple) else v.detach().clone()
                for k, v in p.items()}
        with torch.no_grad():
            return float(tg.radiance_loss_fn(
                tg.apply_params(ts, copy), st, tracer, pix, samp, target,
                bounded_depth=2, integrator="mis"))

    def render_same_tuple():
        with torch.no_grad():
            return trace_radiance(tg.apply_params(ts, params), st, tracer,
                                  pix, samp, bounded_depth=2)

    before = render_same_tuple()          # caches the pyramid of `mips`
    params, state, l0 = step(params, state, pix, samp, target)
    assert params["env_mips"] is mips
    expect = fresh_loss(params)
    params, state, l1 = step(params, state, pix, samp, target)
    assert float(l1) == expect and float(l1) != float(l0)
    assert all(m.grad is not None and torch.isfinite(m.grad).all()
               for m in mips)
    after = render_same_tuple()
    copy = {k: tuple(m.detach().clone() for m in v) if isinstance(v, tuple)
            else v.detach().clone() for k, v in params.items()}
    with torch.no_grad():
        ref = trace_radiance(tg.apply_params(ts, copy), st, tracer, pix,
                             samp, bounded_depth=2)
    assert torch.equal(after, ref) and not torch.equal(after, before)
    assert len(tenv._PYRAMIDS) <= 9


def test_mesh_raises(monkeypatch):
    """The sharded step (``mesh=``) in one process is the unsharded step
    bit for bit; it raises where the step's rays do not split evenly over
    the group's ranks, and for a mesh of more than one device (a process
    runs its share on one)."""
    from vimg_tpu_torch.parallel import distributed
    from vimg_tpu_torch.parallel.sharding import make_mesh
    ts, st = _port(*_simple_scene())
    pix, samp, target = (torch.as_tensor(x) for x in _rays(5, n=64))
    pix, samp = pix.long(), samp.long()
    out = []
    for mesh in (None, make_mesh(["cpu"])):
        step, state, params = tg.make_train_step(ts, st, tmake(ts),
                                                 bounded_depth=2, mesh=mesh)
        params, state, loss = step(params, state, pix, samp, target)
        out.append((float(loss), _flat({k: tuple(m.detach() for m in v)
                                        if isinstance(v, tuple)
                                        else v.detach()
                                        for k, v in params.items()})))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert np.array_equal(out[0][1][k], out[1][1][k]), k
    monkeypatch.setattr(distributed, "world", lambda: (3, 0))
    with pytest.raises(ValueError, match="3 ranks"):
        step(params, state, pix, samp, target)
    with pytest.raises(ValueError, match="one device a process"):
        tg.make_train_step(ts, st, tmake(ts), bounded_depth=2,
                           mesh=make_mesh(["cpu", "cpu"]))
