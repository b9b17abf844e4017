"""Scale-out in vimg_tpu_torch against vimg_tpu on the CPU: ``split_spp``,
``render_sharded`` over a mesh, ``render_distributed`` and the sharded
train step, in one process and across two gloo ranks.

Criteria. split_spp: equal to vimg_tpu's. render_sharded against
vimg_tpu's on its 8-device CPU mesh: tests/test_torch_render.py's unit
scale criteria (mean |d| < 1e-4, < 1% of pixels with max |d| > 1e-5,
corr > 0.999); sample slabs combine within 1e-5. Two gloo ranks: the film
within 1e-5 of the one-process render_sharded and bit-equal across ranks;
the step's loss and gradients within chip_smoke.py's GRAD_RTOL x max|g|
+ GRAD_ATOL of the one-process step on all the rays. The one-process
sharded step against vimg_tpu's sharded step: tests/test_torch_diff_steps
.py's bounds (loss 1e-4 relative, parameters PARAM_ATOL).

The two-rank runs are child processes under a 120 s timeout, with a free
localhost port and a 60 s timeout on the process group, so that a hang
fails the test and not the suite.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_diff_shard import _simple_scene
from test_torch_diff import _flat, _port
from test_torch_diff_steps import PARAM_ATOL
from vimg_tpu_torch.diff import grad as tg
from vimg_tpu_torch.geometry.trace import make_tracer as tmake
from vimg_tpu_torch.parallel import distributed as tdist
from vimg_tpu_torch.parallel import sharding as tsh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6       # chip_smoke.py's
N_RANKS = 2
TRAIN_RAYS = 64


@pytest.mark.parametrize("spp,nproc", [(512, 4), (7, 3), (5, 8), (1, 1),
                                       (16, 16)])
def test_split_spp_matches_vimg_tpu(spp, nproc):
    from vimg_tpu.parallel.distributed import split_spp
    slabs = tdist.split_spp(spp, nproc)
    assert slabs == split_spp(spp, nproc)
    ids = [i for count, off in slabs for i in range(off, off + count)]
    assert sorted(ids) == list(range(spp))


def _unit_film_checks(ref, img):
    d = np.abs(ref - img)
    assert np.isfinite(img).all()
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(ref.ravel(), img.ravel())[0, 1] > 0.999


def test_render_sharded_matches_vimg_tpu():
    from vimg_tpu.geometry.trace import make_tracer as jmake
    from vimg_tpu.parallel.sharding import make_mesh, render_sharded
    js, st = _simple_scene(spp=4)
    ref = np.asarray(render_sharded(js, st, jmake(js), mesh=make_mesh()))
    ts, tst = _port(js, st)
    mesh = tsh.make_mesh(["cpu"] * len(jax.devices()))
    assert mesh.size == 8 and mesh.axis_names == ("rays",)
    img = tsh.render_sharded(ts, tst, tmake(ts), mesh=mesh)
    assert img.shape == (16, 16, 3) and img.device.type == "cpu"
    _unit_film_checks(ref, img.numpy())
    # the mesh's size does not change the film, which sums each pixel's
    # samples in sample order as render() does
    from vimg_tpu_torch.render.render import render
    one = tsh.render_sharded(ts, tst, tmake(ts), mesh=tsh.make_mesh(["cpu"]))
    assert torch.equal(one, img)
    assert torch.equal(render(ts, tst, tracer=tmake(ts)), img)


def test_sharded_sample_offsets_combine():
    ts, st = _port(*_simple_scene(spp=4))
    tr, mesh = tmake(ts), tsh.make_mesh(["cpu"] * 3)
    full = tsh.render_sharded(ts, st, tr, mesh=mesh)
    half = dataclasses.replace(st, spp=2)
    a = tsh.render_sharded(ts, half, tr, mesh=mesh, sample_offset=0)
    b = tsh.render_sharded(ts, half, tr, mesh=mesh, sample_offset=2)
    assert ((a * 2 + b * 2) / 4 - full).abs().max() < 1e-5
    one = dataclasses.replace(st, spp=1)
    c = tsh.render_sharded(ts, one, tr, mesh=mesh, sample_offset=0)
    d = tsh.render_sharded(ts, one, tr, mesh=mesh, sample_offset=1)
    assert not torch.allclose(c, d)


def test_sharded_trace_fn_splits_rays():
    ts, st = _port(*_simple_scene(spp=1))
    tr = tmake(ts)
    pix = torch.arange(250) % 256
    samp = torch.arange(250) // 256
    fn = tsh.sharded_trace_fn(ts, st, tr, tsh.make_mesh(["cpu"] * 4),
                              integrator="mis")
    from vimg_tpu_torch.render.integrators import trace_radiance
    assert torch.equal(fn(ts, pix, samp),
                       trace_radiance(ts, st, tr, pix, samp,
                                      integrator="mis"))


def test_train_step_sharded_matches_vimg_tpu():
    """tests/test_diff_shard.py::test_train_step_sharded's step: vimg_tpu
    over its 8-device mesh, the port in one process."""
    from jax.sharding import Mesh
    from vimg_tpu.diff.grad import make_train_step
    from vimg_tpu.geometry.trace import make_tracer as jmake
    js, st = _simple_scene(spp=1)
    n = min(8, len(jax.devices()))
    jstep, jstate, jp = make_train_step(
        js, st, jmake(js), bounded_depth=2,
        mesh=Mesh(np.asarray(jax.devices()[:n]), ("rays",)))
    B = 32 * n
    pix = np.arange(B, dtype=np.int32) % 256
    samp = np.zeros((B,), np.int32)
    target = np.full((B, 3), 0.1, np.float32)
    jp2, _, jl = jstep(jp, jstate, jnp.asarray(pix), jnp.asarray(samp),
                       jnp.asarray(target))
    ts, tst = _port(js, st)
    tstep, tstate, tp = tg.make_train_step(ts, tst, tmake(ts),
                                           bounded_depth=2,
                                           mesh=tsh.make_mesh(["cpu"]))
    tp2, _, tl = tstep(tp, tstate, torch.from_numpy(pix).long(),
                       torch.from_numpy(samp).long(),
                       torch.from_numpy(target))
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    jf = _flat({k: np.asarray(v) if not isinstance(v, tuple) else v
                for k, v in jp2.items()})
    tf = _flat({k: tuple(m.detach() for m in v) if isinstance(v, tuple)
                else v.detach() for k, v in tp2.items()})
    for k in jf:
        assert np.abs(jf[k] - tf[k]).max() <= PARAM_ATOL, k
    assert not np.allclose(tf["mat_base"], _flat(tg.get_params(ts))
                           ["mat_base"])


# --- two gloo ranks --------------------------------------------------------

_RANK = r'''
import datetime, sys
import numpy as np, torch
sys.path[:0] = [{root!r}, {tests!r}]
from test_diff_shard import _simple_scene
from test_torch_diff import _port
from vimg_tpu_torch.diff import grad as tg
from vimg_tpu_torch.geometry.trace import make_tracer
from vimg_tpu_torch.parallel import distributed as dist_
rank = int(sys.argv[1])
dist_.initialize("tcp://127.0.0.1:{port}", {world}, rank, device="cpu",
                 timeout=datetime.timedelta(seconds=60))
out = {{}}
ts, st = _port(*_simple_scene(spp=5))
out["film"] = dist_.render_distributed(ts, st).numpy()
ts, st = _port(*_simple_scene(spp=1))
step, state, params = tg.make_train_step(ts, st, make_tracer(ts),
                                         bounded_depth=2,
                                         mesh=dist_.global_mesh())
r = np.random.default_rng(7)
pix = torch.arange({rays}) % 256
samp = torch.zeros({rays}, dtype=torch.int64)
target = torch.from_numpy((r.random(({rays}, 3)) * 0.3).astype(np.float32))
params, state, loss = step(params, state, pix, samp, target)
out["loss"] = float(loss)
for k, v in params.items():
    for i, m in enumerate(v if isinstance(v, tuple) else (v,)):
        out[f"grad/{{k}}/{{i}}"] = m.grad.numpy()
        out[f"param/{{k}}/{{i}}"] = m.detach().numpy()
np.savez(sys.argv[2], **out)
torch.distributed.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    code = _RANK.format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                        port=_free_port(), world=N_RANKS, rays=TRAIN_RAYS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(d / f"rank{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(N_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(N_RANKS)]


def test_render_distributed_two_ranks(two_ranks):
    ts, st = _port(*_simple_scene(spp=5))
    ref = tsh.render_sharded(ts, st, tmake(ts), mesh=tsh.make_mesh(["cpu"]))
    films = [r["film"] for r in two_ranks]
    assert np.array_equal(films[0], films[1])
    assert np.abs(films[0] - ref.numpy()).max() < 1e-5
    # one process without a group: render_sharded's film itself
    assert torch.equal(tdist.render_distributed(ts, st), ref)


def test_train_step_two_ranks(two_ranks):
    ts, st = _port(*_simple_scene(spp=1))
    step, state, params = tg.make_train_step(ts, st, tmake(ts),
                                             bounded_depth=2)
    r = np.random.default_rng(7)
    pix = torch.arange(TRAIN_RAYS) % 256
    samp = torch.zeros(TRAIN_RAYS, dtype=torch.int64)
    target = torch.from_numpy((r.random((TRAIN_RAYS, 3)) * 0.3)
                              .astype(np.float32))
    start = {k: tuple(m.detach().clone() for m in v) if isinstance(v, tuple)
             else v.detach().clone() for k, v in params.items()}
    params, state, loss = step(params, state, pix, samp, target)
    for rank in two_ranks:
        assert abs(rank["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
    moved = False
    for k, v in params.items():
        for i, m in enumerate(v if isinstance(v, tuple) else (v,)):
            ref = m.grad.numpy()
            bound = GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL
            for rank in two_ranks:
                assert np.abs(rank[f"grad/{k}/{i}"] - ref).max() <= bound, k
            a, b = (rank[f"param/{k}/{i}"] for rank in two_ranks)
            assert np.array_equal(a, b), k       # one step on every rank
            s = start[k][i] if isinstance(v, tuple) else start[k]
            moved |= not np.array_equal(a, s.numpy())
    assert moved


def test_replicas_keep_the_tracer_and_follow_the_scene():
    """A cluster tracer's copy keeps its walk, sort and plain settings and
    shares its host tables; a scene's copy on another device (the meta
    device stands in for a second card) is kept while the scene is
    unchanged, made anew after an in-place write, and freed with the
    scene."""
    import gc
    import weakref
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    ts = terrain_scene(600, 8, 4, device="cpu")
    tr = ClusterTracer(ts, walk="skip", sort_rays=False, plain=True)
    twin = tsh._tracer_like(tr, ts)
    assert (twin.walk, twin.sort_rays, twin.plain) == ("skip", False, True)
    assert twin.data is tr.data
    assert tsh.replicate(ts, "cpu") is ts
    a = tsh.replicate(ts, "meta")
    assert a.device.type == "meta" and tsh.replicate(ts, "meta") is a
    for t in (ts.verts, ts.env_mips[0], ts.camera.cam2world):
        with torch.no_grad():
            t.add_(0.0)                          # bumps the version only
        b = tsh.replicate(ts, "meta")
        assert b is not a and tsh.replicate(ts, "meta") is b
        a = b
    assert ts.replace(bg_color=ts.bg_color.clone()).replicas == {}
    copy = weakref.ref(a)
    del ts, a, b
    gc.collect()
    assert copy() is None


def test_sharded_trace_fn_follows_the_scene():
    """Every share traces the scene given at call time: after an in-place
    write to the scene's materials (an optimizer's step, say), the share
    on a second device (``cpu:1``: ``.to`` makes a real copy) reads the
    new values, as on the scene's own device."""
    from vimg_tpu_torch.render.integrators import trace_radiance
    ts, st = _port(*_simple_scene(spp=1))
    tr = tmake(ts)
    pix = torch.arange(256).flip(0)      # the lit top half on cpu:1
    samp = torch.zeros(256, dtype=torch.int64)
    fn = tsh.sharded_trace_fn(ts, st, tr, tsh.make_mesh(["cpu", "cpu:1"]),
                              integrator="mis")
    before = fn(ts, pix, samp)
    assert torch.equal(before, trace_radiance(ts, st, tr, pix, samp,
                                              integrator="mis"))
    assert before[128:].amax() > 0
    with torch.no_grad():
        ts.mat_base.mul_(0.5)
    after = fn(ts, pix, samp)
    assert torch.equal(after, trace_radiance(ts, st, tr, pix, samp,
                                             integrator="mis"))
    assert not torch.equal(after[128:], before[128:])
