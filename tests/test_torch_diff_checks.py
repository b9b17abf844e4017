"""The port's gradients where vimg_tpu's reverse mode gives NaN (ROADMAP
C21), held by other means on the CPU: the flagship's gradients against
central finite differences, the Principled BSDF at scalars outside
[0, 1] (where unconstrained Adam steps take them) against vimg_tpu's
forward mode, and the three C21 sources pinned against vimg_tpu.

Criteria: finite differences within 5% (tests/test_diff_shard.py's
albedo check); gradients per key as tests/test_torch_diff.py's
(max |g_port - g_jax| <= GRAD_RTOL * max |g_jax| + GRAD_ATOL); values as
tests/test_torch_materials.py's. Inputs come from a seed with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import _check_grads, _fd_loss, _leaf_params
from vimg_tpu_torch.diff import grad as tg
from vimg_tpu_torch.geometry.trace import make_tracer as tmake
from vimg_tpu_torch.scene import ir as tir


@pytest.fixture(scope="module")
def flagship_hits():
    """The flagship at 1 spp: pixels of every 97th, with the material of
    their primary hit (the port's SoA tracer, sample 0)."""
    from vimg_tpu_torch.geometry import intersect as ti
    from vimg_tpu_torch.render.integrators import _primary_rays
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    ts, st = load_json_scene("scenes/disney_spheres_flagship.json",
                             device="cpu")
    st = dataclasses.replace(st, spp=1)
    pix = torch.arange(0, st.width * st.height, 97)
    ro, rd, _, _ = _primary_rays(ts, st, pix, torch.zeros_like(pix))
    hr = tmake(ts).closest(ts, ro, rd, torch.full_like(ro[:, 0], 1e-4),
                           torch.full_like(ro[:, 0], float("inf")))
    mid = torch.where(hr.hit, ti.hit_info(ts, ro, rd, hr).mat_id, -1)
    return ts, st, pix.numpy(), mid.numpy()


@pytest.mark.parametrize("key,idx", [
    ("mat_base", (0, 1)), ("mat_base", (4, 0)),
    ("mat_scalars", (4, tir.MS_SPECULAR)),
    ("mat_scalars", (2, tir.MS_SUBSURFACE)),
    ("mat_scalars", (7, tir.MS_SHEEN))],
    ids=["white-albedo", "red_glossy-base", "red_glossy-specular",
         "blue_plastic-subsurface", "orange_sheen-sheen"])
def test_flagship_gradient_matches_fd(flagship_hits, key, idx):
    """The flagship's gradients (vimg_tpu's are NaN there, ROADMAP C21)
    against central finite differences, on 512 rays whose primary hit is
    the material of the entry, MIS at bounded_depth 3, with
    test_albedo_gradient_matches_fd's tolerance (5%). The entries enter
    only the BSDF's value, not its pdf, lobe weights or sampling, and no
    path reaches roulette at depth 3, so the detached-sampling gradient is
    the derivative of the fixed-sample estimate."""
    ts, st, pix, mid = flagship_hits
    r = np.random.default_rng(100 + idx[0])
    sel = pix[mid == idx[0]][:512]
    n = len(sel)
    assert n >= 256
    rays = (sel, r.integers(0, 64, n),
            (r.random((n, 3)) * 0.3).astype(np.float32))
    p = _leaf_params(ts)
    _fd_loss(ts, st, p, rays).backward()
    ad = float(p[key].grad[idx])
    assert all(torch.isfinite(v.grad).all() for v in p.values()
               if v.grad is not None)
    eps = 1e-2
    with torch.no_grad():
        fd = []
        for s in (1.0, -1.0):
            q = dict(tg.get_params(ts))
            v = q[key].clone()
            v[idx] += s * eps
            q[key] = v
            fd.append(float(_fd_loss(ts, st, q, rays)))
    fd = (fd[0] - fd[1]) / (2 * eps)
    assert ad != 0.0
    assert abs(fd - ad) < 0.05 * max(abs(fd), abs(ad)), (fd, ad)


def test_principled_out_of_range_matches_jax():
    """Principled scalars outside [0, 1], where unconstrained Adam steps
    take them (at 1e-2 on the flagship a path's throughput then blows up:
    negative lobe weights, reference principled.cpp:28-38), on lanes of
    the six Principled flagship materials: the port's sampling, eval, pdf
    and eval/pdf equal vimg_tpu's (tests/test_torch_materials.py's
    criteria), and on the lanes where those values agree the gradient of
    eval, pdf and eval/pdf with respect to the Principled rows of mat_base
    and mat_scalars equals vimg_tpu's forward-mode one (the per-key
    criterion above). Forward mode, as vimg_tpu's reverse-mode IOR
    gradient is NaN wherever a lane's Fresnel meets total internal
    reflection (ROADMAP C21); op by op, as under jit XLA's fused code
    moves the glass IOR derivative of the grazing lanes by 4% while their
    values agree."""
    from __graft_entry__ import _flagship_scene
    from test_torch_materials import ATOL, B, RTOL, _close, _hits, _inputs
    from vimg_tpu.materials import bsdf as jb
    from vimg_tpu_torch.materials import bsdf as tb
    js, _ = _flagship_scene()
    ms = np.array(js.mat_scalars)
    r = np.random.default_rng(110)
    ms[2:, 1:] += r.uniform(-0.06, 0.06, ms[2:, 1:].shape).astype(np.float32)
    ms[2, tir.MS_CLEARCOAT] = -0.04               # blue_plastic
    ms[6, tir.MS_METALLIC] = 1.04                 # green_metal
    ms[5, tir.MS_SPEC_TRANS] = 1.03               # glass
    js = js.replace(mat_scalars=jnp.asarray(ms))
    ts = tir.scene_from_numpy(*tir.scene_to_numpy(js), device="cpu")
    x = _inputs(130, 2)
    x["mid"] = r.integers(2, 8, B).astype(np.int32)
    jh, th = _hits(x)
    jargs = (jnp.asarray(x["mid"]), jnp.asarray(x["wi"]),
             jnp.asarray(x["wo"]), jh, jnp.asarray(x["reg"]))
    targs = (torch.as_tensor(x["mid"]).long(), torch.as_tensor(x["wi"]),
             torch.as_tensor(x["wo"]), th, torch.as_tensor(x["reg"]))
    rands = {k: r.random(B).astype(np.float32)
             for k in ("lobe", "u", "v", "fresnel")}
    jsm = jb.sample_mat(js, *jargs[:2], jh, {k: jnp.asarray(v) for k, v
                                            in rands.items()}, jargs[4])
    tsm = tb.sample_mat(ts, *targs[:2], th, {k: torch.as_tensor(v) for k, v
                                            in rands.items()}, targs[4])
    agree = (np.asarray(jsm.valid) == tsm.valid.numpy()) & (
        np.asarray(jsm.is_specular) == tsm.is_specular.numpy())
    assert (~agree).mean() <= 1e-3
    ok = agree & tsm.valid.numpy()
    assert ok.mean() > 0.5
    _close(np.asarray(jsm.wo)[ok], tsm.wo.numpy()[ok], frac=1e-3)
    _close(np.asarray(jsm.eta)[agree], tsm.eta.numpy()[agree], frac=1e-3)

    def values(eval_pdf, eval_div_pdf, s, args):
        f, pdf = eval_pdf(s, *args)
        return f, pdf, eval_div_pdf(s, *args)
    jv = values(jb.eval_pdf, jb.eval_div_pdf, js, jargs)
    tv = values(tb.eval_pdf, tb.eval_div_pdf, ts, targs)
    # the lanes where every value agrees (the others are the grazing
    # rough-glass lanes that test_torch_materials.py allows)
    mask = np.ones(B, bool)
    for a, b in zip(jv, tv):
        _close(a, b, frac=5e-3)
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        mask &= (np.abs(a - b) <= ATOL + RTOL * np.abs(a)).reshape(
            B, -1).all(-1)
    assert (~mask).mean() <= 1e-2
    mask = mask.astype(np.float32)
    w = r.normal(size=(2, B, 3)).astype(np.float32) * mask[:, None]
    w1 = r.normal(size=B).astype(np.float32) * mask

    def jloss(mb, sc):
        f, pdf, q = values(jb.eval_pdf, jb.eval_div_pdf,
                           js.replace(mat_base=mb, mat_scalars=sc), jargs)
        return (jnp.sum(f * w[0]) + jnp.sum(pdf * w1)
                + jnp.sum(q * w[1]))
    # a unit tangent for every entry of the Principled rows
    rows = np.arange(2, 8)
    entries = [(k, row, c) for row in rows
               for k, n in (("mat_base", 3), ("mat_scalars", ms.shape[1]))
               for c in range(n)]
    tans = {k: np.zeros((len(entries),) + np.shape(v), np.float32)
            for k, v in (("mat_base", js.mat_base), ("mat_scalars", ms))}
    for i, (k, row, c) in enumerate(entries):
        tans[k][i, row, c] = 1.0
    d = jax.vmap(lambda t, u: jax.jvp(jloss, (js.mat_base, js.mat_scalars),
                                      (t, u))[1])(tans["mat_base"],
                                                  tans["mat_scalars"])
    jgrads = {k: np.zeros(v.shape[1:], np.float32) for k, v in tans.items()}
    for (k, row, c), v in zip(entries, np.asarray(d)):
        jgrads[k][row, c] = v

    mb = ts.mat_base.clone().requires_grad_(True)
    sc = ts.mat_scalars.clone().requires_grad_(True)
    f, pdf, q = values(tb.eval_pdf, tb.eval_div_pdf,
                       ts.replace(mat_base=mb, mat_scalars=sc), targs)
    ((f * torch.as_tensor(w[0])).sum() + (pdf * torch.as_tensor(w1)).sum()
     + (q * torch.as_tensor(w[1])).sum()).backward()
    _check_grads({k: v[2:] for k, v in jgrads.items()},
                 {"mat_base": mb.grad.numpy()[2:],
                  "mat_scalars": sc.grad.numpy()[2:]})
    assert np.abs(sc.grad.numpy()[2:]).min(0)[1:].max() > 0.0


def test_c21_reference_arccos_gradient():
    """ROADMAP C21: vimg_tpu's refraction cone update runs on every lane;
    on a lane where the 2D directions coincide its arccos sits at 1, and
    the zero cotangent of the discarded lane becomes NaN. The port's
    _acos gives the same values and a finite gradient."""
    from vimg_tpu.core import raycone as jcone
    from vimg_tpu_torch.core import raycone as tcone
    r = np.random.default_rng(80)
    n = 64
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    width = (r.random(n) * 0.01).astype(np.float32)
    spread = (r.random(n) * 1e-3).astype(np.float32)
    ssa = np.zeros(n, np.float32)
    eta = np.zeros(n, np.float32)          # no lane refracts
    wo = -rd                                # degenerate frames

    def jf(w, s):
        a, b = jcone.propagate_refract(w, s, jnp.asarray(rd), jnp.asarray(
            ssa), jnp.asarray(eta), jnp.asarray(wo))
        return jnp.sum(jnp.where(jnp.asarray(eta) != 0.0, a + b, 0.0))
    jg_s = np.asarray(jax.jit(jax.grad(jf, argnums=1))(
        jnp.asarray(width), jnp.asarray(spread)))
    tw = torch.tensor(width, requires_grad=True)
    ts_ = torch.tensor(spread, requires_grad=True)
    a, b = tcone.propagate_refract(tw, ts_, *(torch.as_tensor(x) for x in
                                              (rd, ssa, eta, wo)))
    ja, jb = jcone.propagate_refract(*(jnp.asarray(x) for x in
                                       (width, spread, rd, ssa, eta, wo)))
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))
    torch.where(torch.as_tensor(eta) != 0.0, a + b,
                torch.zeros_like(a)).sum().backward()
    assert np.isnan(jg_s).all()
    assert torch.isfinite(tw.grad).all() and torch.isfinite(ts_.grad).all()


def test_c21_rough_glass_gradient_on_other_lanes():
    """ROADMAP C21, second source: the Principled eval runs on every lane
    and keeps lanes of Principled materials only. On a lane of another
    material its IOR column holds 0, and the rough-glass term's
    1/eta^2 x eta^2 is inf x 0: vimg_tpu's gradient through it is NaN
    (its flagship gradients are NaN). The port gives those lanes IOR 1
    (the kept lanes' values are unchanged: tests/test_torch_materials.py),
    and its gradients are finite on the flagship's first hits (Lambertian
    walls, a light and Principled glass)."""
    from vimg_tpu.materials import disney as jd
    from vimg_tpu_torch.geometry import intersect as ti
    from vimg_tpu_torch.materials import bsdf as tb
    from vimg_tpu_torch.render.integrators import _primary_rays
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    r = np.random.default_rng(90)
    n = 32
    v = r.normal(size=(4, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    din, dout, ng, h = (jnp.asarray(x) for x in v)
    fw = ng
    fu = jnp.cross(fw, jnp.asarray([0.0, 0.0, 1.0]))
    fu = fu / jnp.linalg.norm(fu, axis=-1, keepdims=True)
    fv = jnp.cross(fw, fu)
    one = jnp.ones(n)

    def jf(base):
        ev, _ = jd.eval_pdf_rough_glass(din, dout, ng, base, jnp.zeros(n), h,
                                        fu, fv, fw, one, one, 0.3 * one,
                                        0.3 * one)
        return jnp.sum(jnp.where(False, ev, 0.0))
    assert np.isnan(np.asarray(jax.grad(jf)(jnp.full((n, 3), 0.5)))).all()

    ts, st = load_json_scene(
        "scenes/disney_spheres_flagship.json", device="cpu")
    assert ts.has_spec_trans
    pix = torch.arange(0, st.width * st.height, 997)
    ro, rd, _, _ = _primary_rays(ts, st, pix, torch.zeros_like(pix))
    rd = rd.detach().requires_grad_(True)
    hr = tmake(ts).closest(ts, ro, rd, torch.full_like(ro[:, 0], 1e-4),
                           torch.full_like(ro[:, 0], float("inf")))
    hit = hr.hit
    hi = ti.hit_info(ts, ro, rd, hr)
    mt = ts.mat_type[hi.mat_id]
    assert (hit & (mt != tir.MAT_PRINCIPLED)).any()
    assert (hit & (mt == tir.MAT_PRINCIPLED)).any()
    wo = torch.as_tensor(r.normal(size=(pix.shape[0], 3)).astype(np.float32))
    wo = wo / wo.norm(dim=-1, keepdim=True)
    reg = torch.zeros_like(hit)
    f, _ = tb.eval_pdf(ts, hi.mat_id, rd, wo, hi, reg)
    torch.where(hit[:, None], f, torch.zeros_like(f)).sum().backward()
    assert torch.isfinite(rd.grad).all()


def test_c21_fresnel_root_at_zero():
    """ROADMAP C21, third source: the dielectric Fresnel's
    sqrt(max(n_dot_t^2, 0)) at exactly 0 (the edge of total internal
    reflection, which a step of 131,072 flagship rays meets) and below it:
    vimg_tpu's gradient is NaN there. The port's core.math.sqrt_pos has the same
    bits (-0.0 included) and a zero derivative where its argument is not
    positive, so the port's Fresnel gradient is finite."""
    from vimg_tpu.materials import disney as jd
    from vimg_tpu_torch.core.math import sqrt_cr, sqrt_pos
    from vimg_tpu_torch.materials import disney as td
    ndi = np.float32([0.0, 0.3, 0.9, 0.0])
    eta = np.float32([1.0, 1.5, 1.0 / 1.5, 1.0 / 1.5])
    jgrad = np.asarray(jax.grad(lambda e: jnp.sum(jd.fresnel_dielectric(
        jnp.asarray(ndi), e)))(jnp.asarray(eta)))
    # the edge and the total-internal-reflection lane (F = 1) are NaN
    assert np.isnan(jgrad[[0, 3]]).all() and np.isfinite(jgrad[1:3]).all()
    te = torch.tensor(eta, requires_grad=True)
    f = td.fresnel_dielectric(torch.as_tensor(ndi), te)
    f.sum().backward()
    assert torch.isfinite(te.grad).all() and float(te.grad[3]) == 0.0
    np.testing.assert_allclose(te.grad.numpy()[1:3], jgrad[1:3], rtol=1e-5)
    x = torch.tensor([-1.0, -0.0, 0.0, 1e-30, 0.25, 2.0], requires_grad=True)
    y = sqrt_pos(x)
    want = sqrt_cr(torch.clamp_min(x.detach(), 0.0))
    assert torch.equal(y.detach().view(torch.int32), want.view(torch.int32))
    y.sum().backward()
    assert torch.equal(x.grad[:3], torch.zeros(3))
    assert torch.isfinite(x.grad).all() and (x.grad[3:] > 0).all()
