"""Sample slabs in vimg_tpu_torch against vimg_tpu on the CPU: the
wavefront's ``sample_offset`` and ``VIMG_NO_MORTON``, checkpointed renders,
the megakernel's pixel-group ranges (``render_megakernel_sharded`` over
the plain versions), the primary pre-pass and the profiling helpers.

Criteria. The wavefront against vimg_tpu's (its BVH tracer, watertight
triangle test, against the port's cluster walk): the bounds of
tests/test_torch_wavefront.py (mean |d| < 5e-3, corr > 0.99, segment and
shadow-ray counts within 2%). Slabs against the one-shot frame: 1e-5
(the per-pixel sums group differently), counts exactly. Checkpoints:
tests/test_checkpoint.py's bounds (1e-5, resume 1e-6). Pre-pass table:
the tracer parity of tests/test_torch_geometry.py; pre-pass frame:
tests/test_cluster_trace.py::test_prepass_render_parity's bounds. Group
ranges: bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_geometry import _check_hits, _close
from test_torch_render import _unit_scene
from test_torch_wavefront import _same_scene, _settings
from vimg_tpu.scene import ir as jir
from vimg_tpu_torch.geometry import cluster_trace as tct
from vimg_tpu_torch.parallel.sharding import make_mesh
from vimg_tpu_torch.render import checkpoint as tck
from vimg_tpu_torch.render import wavefront as twf
from vimg_tpu_torch.render.mega import kernel as tkernel
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene import synthetic as tsyn


@pytest.fixture(scope="module")
def terrain():
    """vimg_tpu's and the port's terrain_scene(600) at 24x16, equal."""
    from vimg_tpu.scene.synthetic import terrain_scene as jterrain
    js = jterrain(600, 24, 16)
    ts = tsyn.terrain_scene(600, 24, 16, device="cpu")
    _same_scene(js, ts)
    return js, ts


@pytest.fixture(scope="module")
def tracer(terrain):
    return tct.ClusterTracer(terrain[1])


@pytest.mark.parametrize("offset,raster", [(3, False), (0, True)])
def test_wavefront_offset_and_order_match_vimg_tpu(terrain, tracer, offset,
                                                   raster, monkeypatch):
    from vimg_tpu.geometry.bvh import BVHTracer
    from vimg_tpu.render.wavefront import render_wavefront as jrender
    if raster:
        monkeypatch.setenv("VIMG_NO_MORTON", "1")
    js, ts = terrain
    st = _settings(24, 16, 4)
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    ref, rs = jrender(js, jst, tracer=BVHTracer(js, builder="numpy"),
                      sample_offset=offset, return_stats=True)
    img, ps = twf.render_wavefront(ts, st, tracer=tracer,
                                   sample_offset=offset, return_stats=True)
    img = img.numpy()
    assert np.isfinite(img).all()
    assert np.abs(img - ref).mean() < 5e-3
    assert np.corrcoef(img.ravel(), ref.ravel())[0, 1] > 0.99
    for k in ("segments", "shadow_rays"):
        assert abs(ps[k] - rs[k]) <= 0.02 * rs[k], (k, ps[k], rs[k])
    assert ps["prepass_seconds"] == 0.0


def test_wavefront_slabs_compose(terrain, tracer, monkeypatch):
    ts = terrain[1]
    full, sf = twf.render_wavefront(ts, _settings(24, 16, 6), tracer=tracer,
                                    return_stats=True)
    half = _settings(24, 16, 3)
    a, sa = twf.render_wavefront(ts, half, tracer=tracer, return_stats=True)
    b, sb = twf.render_wavefront(ts, half, tracer=tracer, sample_offset=3,
                                 return_stats=True)
    assert ((a + b) / 2 - full).abs().max() < 1e-5
    for k in ("segments", "shadow_rays"):
        assert sa[k] + sb[k] == sf[k], k
    assert (a - b).abs().mean() > 1e-4          # other streams
    # raster order: the same paths, handed out in another order
    monkeypatch.setenv("VIMG_NO_MORTON", "1")
    r, sr = twf.render_wavefront(ts, _settings(24, 16, 6), tracer=tracer,
                                 return_stats=True)
    assert (r - full).abs().max() < 1e-5
    assert (sr["segments"], sr["shadow_rays"]) == (sf["segments"],
                                                   sf["shadow_rays"])


# --- checkpoints (tests/test_checkpoint.py's cases) ------------------------

def _ck_settings(spp=6):
    return tir.RenderSettings(width=24, height=16, spp=spp, max_depth=5,
                              integrator="mis", batch_size=1 << 13)


def test_slabs_equal_oneshot(terrain, tracer, tmp_path):
    ts = terrain[1]
    st = _ck_settings()
    ref, rs = twf.render_wavefront(ts, st, tracer=tracer, return_stats=True)
    stats = {}
    out = tck.render_with_checkpoints(ts, st, str(tmp_path / "a.ckpt"),
                                      slab_spp=2, tracer=tracer, stats=stats)
    assert (out - ref).abs().max() < 1e-5
    assert stats["slabs"] == 3
    assert (stats["segments"], stats["shadow_rays"]) == (rs["segments"],
                                                         rs["shadow_rays"])


def test_resume_continues(terrain, tracer, tmp_path):
    ts = terrain[1]
    st = _ck_settings()
    path = str(tmp_path / "b.ckpt")
    partial = tck.render_with_checkpoints(ts, _ck_settings(4), path,
                                          slab_spp=2, tracer=tracer)
    assert tck.load_checkpoint(path)["spp_done"] == 4
    out = tck.render_with_checkpoints(ts, st, path, slab_spp=2,
                                      tracer=tracer)
    full = tck.render_with_checkpoints(ts, st, str(tmp_path / "c.ckpt"),
                                       slab_spp=2, tracer=tracer)
    assert (out - full).abs().max() < 1e-6
    assert (partial - full).abs().mean() > 1e-5


def test_checkpoint_atomic_no_leak(tmp_path):
    d = tmp_path / "sub"
    d.mkdir()
    p = str(d / "x.ckpt")
    tck.save_checkpoint(p, np.zeros((4, 4, 3), np.float32), 3)
    tck.save_checkpoint(p, torch.ones((4, 4, 3)), 6)
    ck = tck.load_checkpoint(p)
    assert ck["spp_done"] == 6 and ck["accum"].mean() == 1.0
    assert os.listdir(d) == [os.path.basename(p)]


def test_mismatched_digest_raises(terrain, tracer, tmp_path):
    ts = terrain[1]
    path = str(tmp_path / "d.ckpt")
    tck.save_checkpoint(path, np.zeros((16, 24, 3), np.float32), 2,
                        meta=dict(digest="0" * 32))
    with pytest.raises(ValueError, match="digest"):
        tck.render_with_checkpoints(ts, _ck_settings(), path, slab_spp=2,
                                    tracer=tracer)


def _digest_cases(terrain):
    from test_torch_render import _port
    js, ts = terrain
    ju, su = _unit_scene(4, "material")
    tu, tsu = _port(ju, su)
    st = _ck_settings()
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    return [(js, ts, jst, st, 2), (js, ts, jst, st, 4),
            (ju, tu, su, tsu, 2),
            (ju, tu, dataclasses.replace(su, integrator="mis"),
             dataclasses.replace(tsu, integrator="mis"), 1)]


def test_render_digest_matches_vimg_tpu(terrain):
    from vimg_tpu.render.checkpoint import _render_digest as jdigest
    digests = set()
    for js, ts, jst, st, slab in _digest_cases(terrain):
        for wf in (True, False):
            d = tck._render_digest(ts, st, wf, slab)
            assert d == jdigest(js, jst, wf, slab)
            digests.add(d)
    # spp is not hashed; the scene and the integrator are
    assert len(digests) == 3


def test_checkpoints_cross_packages(terrain, tracer, tmp_path):
    """A checkpoint vimg_tpu's save_checkpoint writes resumes in the port
    (to the port's own uninterrupted film), and one the port writes is
    accepted by vimg_tpu's render_with_checkpoints."""
    from vimg_tpu.render import checkpoint as jck
    js, ts = terrain
    st = _ck_settings()
    path = str(tmp_path / "e.ckpt")
    tck.render_with_checkpoints(ts, _ck_settings(4), path, slab_spp=2,
                                tracer=tracer)
    ck = tck.load_checkpoint(path)
    moved = str(tmp_path / "f.ckpt")
    jck.save_checkpoint(moved, ck["accum"], ck["spp_done"],
                        meta=dict(digest=ck["digest"]))
    out = tck.render_with_checkpoints(ts, st, moved, slab_spp=2,
                                      tracer=tracer)
    full = tck.render_with_checkpoints(ts, st, str(tmp_path / "g.ckpt"),
                                       slab_spp=2, tracer=tracer)
    assert torch.equal(out, full)
    # vimg_tpu resumes the port's finished file without rendering a slab
    jst = jir.RenderSettings(**dataclasses.asdict(st))
    img = jck.render_with_checkpoints(js, jst, moved, slab_spp=2,
                                      tracer=object())
    assert np.array_equal(np.asarray(img), out.numpy())
    assert jck.load_checkpoint(moved)["digest"] == ck["digest"]
    bad = str(tmp_path / "h.ckpt")
    jck.save_checkpoint(bad, ck["accum"], 4, meta=dict(digest="1" * 32))
    with pytest.raises(ValueError, match="digest"):
        tck.render_with_checkpoints(ts, st, bad, slab_spp=2, tracer=tracer)


# --- pixel-group ranges of the megakernel (plain versions) -----------------

@pytest.fixture(scope="module")
def mega_frames(terrain):
    """(scene, settings, the whole-frame render) in analytic and mesh
    mode."""
    from test_torch_render import _port
    ju, su = _unit_scene(2, "mis")
    tu, tsu = _port(ju, su)
    tm = terrain[1]
    tsm = tir.RenderSettings(width=24, height=16, spp=1, max_depth=6,
                             integrator="mis")
    assert not tkernel.is_mesh_mode(tu) and tkernel.is_mesh_mode(tm)
    return {m: (s, st, tkernel.render_megakernel(s, st))
            for m, (s, st) in (("analytic", (tu, tsu)), ("mesh", (tm, tsm)))}


@pytest.mark.parametrize("mode", ["analytic", "mesh"])
@pytest.mark.parametrize("ranges", [2, 3])
def test_megakernel_sharded_equals_whole(mega_frames, mode, ranges):
    scene, st, whole = mega_frames[mode]
    img, stats = tkernel.render_megakernel_sharded(
        scene, st, mesh=make_mesh(["cpu"] * ranges), return_stats=True)
    assert torch.equal(img, whole)
    _, ws = tkernel.render_megakernel(scene, st, return_stats=True)
    assert (stats["segments"], stats["shadow_rays"]) == (ws["segments"],
                                                         ws["shadow_rays"])


@pytest.mark.parametrize("mode", ["analytic", "mesh"])
def test_group_ranges_partition_the_frame(mega_frames, mode):
    scene = mega_frames[mode][0]
    for W, H in ((24, 16), (37, 5), (9, 3)):
        st = tir.RenderSettings(width=W, height=H)
        n = tkernel.n_groups(scene, st)
        pix = torch.cat([tkernel.group_pixels(scene, st, g, g + 1)
                         for g in range(n)])
        assert torch.equal(torch.sort(pix).values, torch.arange(W * H))
        assert torch.equal(tkernel.group_pixels(scene, st, 0, n), pix)
    st = mega_frames[mode][1]
    n = tkernel.n_groups(scene, st)
    for bad in ((0, n + 1), (3, 2), (-1, 4)):
        with pytest.raises(ValueError, match="outside"):
            tkernel.render_megakernel(scene, st, groups=bad)


def test_group_range_leaves_other_pixels_zero(mega_frames):
    scene, st, whole = mega_frames["mesh"]
    n = tkernel.n_groups(scene, st)
    part = tkernel.render_megakernel(scene, st, groups=(2, n - 1))
    pix = tkernel.group_pixels(scene, st, 2, n - 1)
    mask = torch.zeros(st.width * st.height, dtype=torch.bool)
    mask[pix] = True
    flat, ref = part.view(-1, 3), whole.view(-1, 3)
    assert torch.equal(flat[mask], ref[mask])
    assert (flat[~mask] == 0).all() and (~mask).any()


# --- the primary pre-pass --------------------------------------------------

class _Sortless:
    """A tracer whose closest() takes (and ignores) the pre-pass's
    ``sort`` argument."""

    presortable = True

    def __init__(self, tracer):
        self.tracer = tracer

    def closest(self, scene, ro, rd, minT, maxT, sort=None):
        return self.tracer.closest(scene, ro, rd, minT, maxT)


def test_trace_primaries_matches_vimg_tpu():
    import jax.numpy as jnp
    from vimg_tpu.geometry.soa_intersect import SoATracer as JSoA
    from vimg_tpu.render.wavefront import (morton_pixel_order,
                                           trace_primaries as jprim)
    from vimg_tpu.scene.synthetic import terrain_scene as jterrain
    from vimg_tpu_torch.geometry.intersect import HitResult
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer as TSoA
    js = jterrain(60, 16, 12)
    ts = tsyn.terrain_scene(60, 16, 12, device="cpu")
    _same_scene(js, ts)
    st = _settings(16, 12, 3)
    total = 16 * 12 * 3
    mp = morton_pixel_order(16, 12)
    jtab = np.asarray(jprim(js, jir.RenderSettings(**dataclasses.asdict(st)),
                            _Sortless(JSoA(js)), jnp.asarray(mp), total,
                            sample_offset=2, chunk_B=256)["pre_tab"])[:total]
    ttab = twf.trace_primaries(ts, st, _Sortless(TSoA(ts)),
                               torch.from_numpy(mp.astype(np.int64)), total,
                               sample_offset=2, chunk_B=256)["pre_tab"]
    assert ttab.shape == (total, 16) and ttab.dtype == torch.float32

    def hits(tab):
        tab = torch.as_tensor(np.array(tab))
        return HitResult(t=tab[:, 0], prim_type=tab[:, 1].long(),
                         prim_id=tab[:, 2].long(), u=tab[:, 3], v=tab[:, 4])
    assert _check_hits(hits(jtab), hits(ttab), ts) > total // 2
    _close(jtab[:, 5:13], ttab[:, 5:13].numpy())
    assert (ttab[:, 13:] == 0).all()


def test_prepass_frame_parity(terrain, tracer, monkeypatch):
    ts = terrain[1]
    st = _settings(24, 16, 6, batch=1 << 10)
    img_off, s_off = twf.render_wavefront(ts, st, tracer=tracer,
                                          return_stats=True)
    monkeypatch.setenv("VIMG_PREPASS", "1")
    img_on, s_on = twf.render_wavefront(ts, st, tracer=tracer,
                                        return_stats=True)
    assert s_on["prepass_seconds"] > 0.0 and s_off["prepass_seconds"] == 0.0
    assert s_on["supersteps"] == s_off["supersteps"]
    assert abs(s_on["segments"] - s_off["segments"]) \
        <= 0.001 * s_off["segments"]
    on, off = img_on.numpy(), img_off.numpy()
    assert np.isfinite(on).all()
    d = np.abs(on - off)
    assert d.mean() < 1e-4
    assert (d.max(-1) > 1e-5).mean() < 0.01
    assert np.corrcoef(on.ravel(), off.ravel())[0, 1] > 0.999
    # the switches: VIMG_NO_PREPASS wins; the SoA tracer cannot presort
    total = 24 * 16 * 6
    assert twf._want_prepass(ts, tracer, total)
    assert not twf._want_prepass(ts, tracer, twf.PREPASS_MAX_TOTAL + 1)
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    assert not twf._want_prepass(ts, SoATracer(ts), total)
    monkeypatch.setenv("VIMG_NO_PREPASS", "1")
    assert not twf._want_prepass(ts, tracer, total)


# --- profiling -------------------------------------------------------------

def test_profiling_utils(capsys):
    from vimg_tpu_torch.utils.profiling import PhaseTimer, block_and_time
    ph = PhaseTimer()
    with ph.phase("build"):
        pass
    with ph.phase("render"):
        pass
    out = capsys.readouterr().out
    assert "build" in out and "render" in out
    assert [n for n, _ in ph.records] == ["build", "render"]
    r, dt = block_and_time(lambda x: torch.sum(x * 2.0), torch.ones((8, 8)),
                           warmup=1, iters=2)
    assert dt >= 0.0 and float(r) == 128.0


def test_fmt_and_walk_roofline_match_vimg_tpu():
    from vimg_tpu.utils import profiling as jprof
    from vimg_tpu_torch.utils import profiling as tprof
    for s in (0.0, 3e-7, 4.2e-5, 1e-3, 0.12345, 0.9999, 1.0, 7.5, 59.99,
              60.0, 61.25, 3725.4):
        assert tprof._fmt(s) == jprof._fmt(s), s
    rows, max_k = 8, 64
    lanes = rows * 128
    jstats = dict(leaf_visits=1234.0, leaf_visits_shadow=77.0,
                  node_visits=5678.0, node_visits_shadow=910.0,
                  segments=3.5e6, shadow_rays=1.25e6)
    tstats = dict(tri_tests=(1234 + 77) * max_k * lanes,
                  box_tests=(5678 + 910) * lanes,
                  segments=3_500_000, shadow_rays=1_250_000)
    j = jprof.walk_roofline(jstats, 0.5, rows, max_k)
    t = tprof.walk_roofline(tstats, 0.5)
    for k in ("rays_per_s", "vector_flops", "work_amplification",
              "tri_tests_per_ray"):
        assert t[k] == j[k], k
    assert t["fp32_utilization"] == t["vector_flops"] / 0.5 / 67e12


def test_cli_trace_on_cpu(tmp_path, capsys):
    from vimg_tpu_torch import cli
    scene = {"camera": {"transform": {"from": [0, 0, 6], "at": [0, 0, 0]},
                        "resolution": [16, 12], "vfov": 45},
             "sampler": {"samples": 2, "depth": 4},
             "integrator": {"type": "mis"},
             "materials": [{"name": "r", "type": "lambertian",
                            "albedo": [0.8, 0.2, 0.2]},
                           {"name": "l", "type": "diffuse_light",
                            "albedo": [5, 5, 5]}],
             "surfaces": [{"type": "sphere", "mat_name": "r",
                           "center": [0, 0, 0], "radius": 1},
                          {"type": "sphere", "mat_name": "l",
                           "center": [0, 3, 0], "radius": 1}]}
    f = tmp_path / "s.json"
    f.write_text(json.dumps(scene))
    assert cli.main(["-f", str(f), "--cpu", "--trace", str(tmp_path / "tr"),
                     "-o", str(tmp_path / "o.png")]) == 0
    path = tmp_path / "tr" / "trace.json"
    assert f"Device trace captured to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert (tmp_path / "o.png").stat().st_size > 0
