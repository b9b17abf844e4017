"""The wavefront's diagnosis hook ``make_superstep(..., ablate=)`` and its
probe ``vimg_tpu_torch/probes/ablate_superstep.py``, with ClusterTracer's
``trace_stats`` and the probe leftovers of probes/probe_r3b.py,
probe_r3c.py and probe_regen.py, on the CPU.

Criteria. An empty ``ablate`` runs the superstep's usual code: state and
film bit for bit the superstep without the keyword, and render_wavefront's
frame bit for bit a loop of those supersteps. Each of the twelve variants
runs two supersteps with the full superstep's state keys, shapes and
dtypes. For {"trace", "shadow"} and {"hitinfo"} the port's film and lane
state after two supersteps are held to vimg_tpu's make_superstep with the
same keys on the same scene (terrain_scene(60), 24x16 @ 4 spp, both
packages' SoA tracers; vimg_tpu's superstep runs eagerly, op by op: its
jit took 31 s a variant here, eager 16 s for both), at
tests/test_torch_wavefront.py's
bound for a frame (mean|d| < 5e-3, corr > 0.99; XLA may fuse a * b + c
where the port rounds twice, which moves a sampled direction by ulps) and
with the same lanes alive and the same segment count. trace_stats' rows
on the CPU equal the warp replays' per-warp counts and sum to their
totals. bounce_batches gives tools/probe_r3b.py's rays bit for bit.
"""
import numpy as np
import pytest
import torch

from vimg_tpu_torch.probes import ablate_superstep as ab
from vimg_tpu_torch.render import wavefront as twf
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn

CPU = torch.device("cpu")
W, H, SPP, LANES = 24, 16, 4, 256


@pytest.fixture(scope="module")
def terrain():
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    sc = tsyn.terrain_scene(2000, W, H, device="cpu")
    return sc, tir.RenderSettings(W, H, spp=SPP, integrator="mis"), \
        ClusterTracer(sc)


def _run(scene, st, tracer, n, **kw):
    step = twf.make_superstep(scene, st, tracer, 2 ** 31 - 1, **kw)
    s = twf.init_state(LANES, CPU, cones=scene.needs_cones)
    acc = torch.zeros(3, W * H)
    for _ in range(n):
        s, acc = step(s, acc)
    return s, acc


def _bits_equal(a, b):
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def test_empty_ablate_is_the_usual_superstep(terrain):
    sc, st, tr = terrain
    s0, a0 = _run(sc, st, tr, 4)
    s1, a1 = _run(sc, st, tr, 4, ablate=frozenset())
    assert _bits_equal(a0, a1)
    assert s0.keys() == s1.keys()
    assert all(_bits_equal(s0[k], s1[k]) for k in s0)
    # render_wavefront's frame: its own loop of the same supersteps
    w, h = 8, 4
    small = tir.RenderSettings(w, h, spp=1, integrator="mis")
    img = twf.render_wavefront(sc, small, tracer=tr)
    morton = torch.from_numpy(twf.morton_pixel_order(w, h).astype(np.int64))
    step = twf.make_superstep(sc, small, tr, w * h, morton,
                              ablate=frozenset())
    s = twf.init_state(1024, CPU)          # render_wavefront's lane count
    acc = torch.zeros(3, w * h)
    while int(s["n_done"]) < w * h:
        s, acc = step(s, acc)
    assert _bits_equal(img, acc.T.reshape(h, w, 3) / 1)


def test_unknown_key_raises(terrain):
    sc, st, tr = terrain
    with pytest.raises(ValueError, match="unknown ablate keys"):
        twf.make_superstep(sc, st, tr, 10, ablate={"trace", "tracing"})


@pytest.mark.parametrize("name,keys", ab.VARIANTS, ids=[v[0] for v in
                                                        ab.VARIANTS])
def test_variant_runs_two_supersteps(terrain, name, keys):
    sc, st, tr = terrain
    full, _ = _run(sc, st, tr, 2)
    s, acc = _run(sc, st, tr, 2, ablate=keys)
    assert s.keys() == full.keys()
    for k in s:
        assert (s[k].shape, s[k].dtype) == (full[k].shape, full[k].dtype), k
    assert bool(torch.isfinite(acc).all())
    assert int(s["n_segments"]) == int(full["n_segments"]) == LANES
    if "film" in keys:
        assert float(acc.abs().max()) < 1e-20


@pytest.fixture(scope="module")
def small_scenes():
    from vimg_tpu.scene.synthetic import terrain_scene as jterrain
    js = jterrain(60, W, H)
    ts = tsyn.terrain_scene(60, W, H, device="cpu")
    assert ts.n_tris() <= 64
    return js, ts


@pytest.mark.parametrize("keys", [frozenset({"trace", "shadow"}),
                                  frozenset({"hitinfo"})],
                         ids=["trace", "hitinfo"])
def test_variant_matches_vimg_tpu(small_scenes, keys):
    import jax.numpy as jnp
    from vimg_tpu.geometry.soa_intersect import SoATracer as JSoA
    from vimg_tpu.render import wavefront as jwf
    from vimg_tpu.scene import ir as jir
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    js, ts = small_scenes
    st = tir.RenderSettings(W, H, spp=SPP, integrator="mis")
    jst = jir.RenderSettings(W, H, spp=SPP, integrator="mis")
    jstep = jwf.make_superstep(js, jst, JSoA(js), 2 ** 31 - 1,
                               ablate=keys)
    js_, ja = jwf.init_state(LANES), jnp.zeros((3, W * H), jnp.float32)
    for _ in range(2):
        js_, ja = jstep(js_, ja)
    ts_, ta = _run(ts, st, SoATracer(ts), 2, ablate=keys)
    assert float(np.asarray(ja).sum()) > 0
    assert np.array_equal(np.asarray(js_["alive"]), ts_["alive"].numpy())
    assert int(js_["n_segments"]) == int(ts_["n_segments"])
    for k, a, b in (("film", ja, ta), *((k, js_[k], ts_[k]) for k in (
            "result", "throughput", "ro", "rd"))):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), k
        assert np.abs(a - b).mean() < 5e-3, k
        if a.std() > 0 or b.std() > 0:
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.99, k


def test_ablate_probe_records(terrain):
    sc, st, tr = terrain
    res = ab.ablate(sc, st, tr, 512, 2, repeats=1,
                    names={"full", "-film", "skeleton"})
    assert list(res) == ["full", "-film", "skeleton"]
    for rec in res.values():
        assert rec["ms"] > 0 and rec["mseg_s"] > 0 and rec["film_finite"]
        assert rec["busy_ms"] is None and rec["event_ms"] is None
    assert res["full"]["delta_ms"] is None
    assert res["skeleton"]["ablate"] == sorted(ab.VARIANTS[-1][1])


@pytest.mark.parametrize("walk", ["wide", "skip"])
def test_trace_stats_rows_equal_warp_replay(walk):
    from vimg_tpu_torch.geometry import skip_schedule as ss
    from vimg_tpu_torch.geometry.cluster_trace import ClusterTracer
    from vimg_tpu_torch.probes.probe_r3b import bounce_batches
    sc = tsyn.terrain_scene(2000, W, H, device="cpu")
    tr = ClusterTracer(sc, walk=walk)
    ro, rd = bounce_batches(sc, 1000)
    mn, mx = torch.full((1000,), 1e-4), torch.full((1000,), float("inf"))
    mx[::13] = 0.5
    for any_hit in (False, True):
        st = tr.trace_stats(ro, rd, mn, mx, any_hit)
        assert st.dtype == np.float32 and st.shape == (32, 2)
        rays = (ro, rd, mn, mx, any_hit)
        if walk == "wide":
            _, c = ss.wide_warp_schedule(*tr.node_tables, tr.tri_rows,
                                         tr.max_stack, *rays)
        else:
            _, c = ss.warp_schedule(*tr.node_tables, tr.tri_rows,
                                    tr.data.n_nodes, *rays)
        assert np.array_equal(st, c["warp_steps"].numpy())
        assert st.sum(0).tolist() == [c["node_steps"], c["tri_steps"]]
        assert (st[:, 0] > 0).all()


def test_bounce_batches_equal_tool():
    import tools.probe_r3b as tool
    from vimg_tpu.scene.synthetic import terrain_scene as jterrain
    from vimg_tpu_torch.probes.probe_r3b import bounce_batches
    js = jterrain(2000, W, H)
    ts = tsyn.terrain_scene(2000, W, H, device="cpu")
    ro, rd = tool.bounce_batches(js, 4096, seed=3)
    pro, prd = bounce_batches(ts, 4096, seed=3)
    assert np.array_equal(np.asarray(ro), pro.numpy())
    assert np.array_equal(np.asarray(rd), prd.numpy())


def test_probe_leftovers_on_cpu():
    from vimg_tpu_torch.probes import common, probe_r3b, probe_r3c, \
        probe_regen
    log = common.Log(CPU)
    r = probe_r3b.cluster_bounce("cpu", 2000, 1024, log)
    assert set(r) == {"none", "origin", "dir"}
    assert {"us_per_ray", "visits_per_warp", "tri_steps_per_warp",
            "n_warps", "hit_frac"} <= set(r["none"])
    assert r["none"]["n_warps"] == 32 and 0 < r["none"]["hit_frac"] < 1
    tax = probe_r3b.sort_tax("cpu", (1000,), log)
    key, state, out = tax[1000]
    assert torch.equal(out, state[torch.argsort(key)])
    imgs = probe_r3b.wavefront_e2e("cpu", 600, (8, 4), 1, log)
    assert set(imgs) == {"terrain", "bumpy"}
    g = probe_r3c.xla_gather("cpu", (500,), log=log)
    for (b, name), (tab, idx, out) in g.items():
        assert torch.equal(out, tab[idx.long()].sum(-1))
    assert np.isfinite(float(probe_r3c.hit_info_cost("cpu", 600, 256, log)))
    d = probe_regen.depth_decomposition("cpu", 600, (8, 4), 1, (1, 3), log)
    assert set(d) == {1, 3}
    assert d[1][1]["segments"] <= d[3][1]["segments"]
    keys = {rec["probe"] for rec in log.records}
    assert keys == {"bounce_trace", "sort_tax", "wavefront_e2e",
                    "xla_gather", "hit_info", "depth"}


def test_endless_run_drops_paths_past_the_frame(terrain):
    """The probe's work count (2^31 - 1) outruns a 4x2 frame at 1 spp at
    once: lanes take pixels below the frame, whose paths the film drops
    (as vimg_tpu's out-of-range scatter does) instead of failing; the
    lanes' work is the film-ablated run's."""
    sc, _, tr = terrain
    st = tir.RenderSettings(4, 2, spp=1, integrator="mis")
    step = twf.make_superstep(sc, st, tr, 2 ** 31 - 1)
    s = twf.init_state(64, CPU)
    acc = torch.zeros(3, 8)
    for _ in range(6):
        s, acc = step(s, acc)
    assert int(s["next_work"]) > 64 and bool(torch.isfinite(acc).all())
    ref_step = twf.make_superstep(sc, st, tr, 2 ** 31 - 1,
                                  ablate={"film"})
    s2 = twf.init_state(64, CPU)
    acc2 = torch.zeros(3, 8)
    for _ in range(6):
        s2, acc2 = ref_step(s2, acc2)
    assert torch.equal(s["pix"], s2["pix"]) and int(s2["pix"].max()) >= 8
