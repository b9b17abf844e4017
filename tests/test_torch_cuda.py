"""The CUDA kernels against their plain PyTorch versions, on the card:
the megakernel (B1 analytic mode, B2 mesh mode), the cluster walks (B3
wide, B4 skip; their per-warp counted launch), the packet cull (X1) and
walk (B5), the table-row gather (B6), the SAH sweep (X3) and the device
BVH build over it, and the probe kernels P1-P31 (vimg_tpu_torch/probes);
an s_normal frame and the product-formulation (``mxu``) tracer on the
card.

This file imports no JAX, so it also runs on the GPU machine, which has
none: ``python3 -m pytest --noconftest tests/test_torch_cuda.py -q`` from
the repository root (``--noconftest`` because tests/conftest.py imports
JAX). Without CUDA the card tests skip and only the dispatch checks run.
Criteria: for B1 and B2, tests/test_megakernel.py's per-pixel bound at
unit scale (mean|d| < 1e-4, < 1% of pixels with max|d| > 1e-5; the mesh
scenes are unit scale too) and equal segment and shadow-ray counts; for
B3, B4 and B5, bit-equality with their plain walks (B3 and B4 also with
exact ties, and their warp steps equal to their schedules' replays); for
X1, B6 and P1-P31, bit-equality with their plain versions, except where
the P12-P31 tests say otherwise. C19: the frame's last divide and AgX's
divide give the CPU's bits on the card. The envtex frame (main path 9) at
64x32 against the CPU statistically (the flagship's bound: the card's
transcendentals round otherwise, and an ulp can move a texel, a mip level
or a sampled direction), launching B3. Main path 10's gradients through
B3 against the plain walk's, per key within 1e-3 of the largest.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vimg_tpu_torch.core.math import look_at
from vimg_tpu_torch.geometry import cluster_trace as ct
from vimg_tpu_torch.render.mega import kernel
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.json_loader import SceneBuilder
from vimg_tpu_torch.scene.synthetic import terrain_mesh, terrain_scene


def _unit_scene(device, integrator, spp=8, n_extra=0, floor_tris=0,
                width=32, height=24):
    """Red Lambertian, glass and an emissive sphere, plus ``n_extra``
    small spheres (257 make the megakernel refuse the scene) and a terrain
    floor of ``floor_tris`` triangles below them."""
    b = SceneBuilder()
    red = b.add_material(ir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(ir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={ir.MS_IOR: 1.5})
    light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    for k in range(n_extra):
        b.add_sphere((-3.0 + 0.02 * k, -2.0, 0), 0.01, red)
    if floor_tris:
        verts, tris = terrain_mesh(floor_tris)
        b.add_mesh(verts - np.float32([0, 2.5, 0]), tris, red)
    cam = dict(cam2world=look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]),
               width=width, height=height, vfov_deg=45.0)
    return (b.build(camera=cam, device=device),
            ir.RenderSettings(width=width, height=height, spp=spp,
                              max_depth=64, integrator=integrator))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (see chip_smoke.py)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["mis", "material"])
def test_kernel_matches_plain_on_card(cuda, integrator):
    scene, st = _unit_scene(cuda, integrator)
    before = kernel.LAUNCHES
    img, ks = kernel.render_megakernel(scene, st, return_stats=True)
    assert kernel.LAUNCHES == before + 1
    ref, ps = kernel.render_megakernel_plain(scene, st, return_stats=True)
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(img).all()
    d = np.abs(ref - img)
    assert d.mean() < 1e-4 and (d.max(-1) > 1e-5).mean() < 0.01
    assert ks["segments"] == ps["segments"]
    assert ks["shadow_rays"] == ps["shadow_rays"]


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["mis", "material"])
def test_kernel_warp_steps_match_plain_on_card(cuda, integrator):
    """B1's flat loop runs, per group of 32 pixels, as many iterations as
    the group's busiest pixel has segments: its warp-step counter equals
    the plain version's count from the per-path segments, as do the ray
    counts."""
    scene, st = _unit_scene(cuda, integrator, spp=16, width=64, height=48)
    _, ks = kernel.render_megakernel(scene, st, return_stats=True)
    _, ps = kernel.render_megakernel_plain(scene, st, return_stats=True)
    for key in ("segments", "shadow_rays", "warp_steps"):
        assert ks[key] == ps[key], key
    assert 0.5 < ks["segments"] / (32 * ks["warp_steps"]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["mis", "material"])
def test_kernel_film_independent_of_grid(cuda, integrator):
    """The persistent grid's size decides only which warp shades which
    pixel group: one block per SM and the full resident grid give the same
    film bit for bit, and the same counts. At 256 x 192 the frame's 1,536
    groups need more warps than one block per SM holds."""
    scene, st = _unit_scene(cuda, integrator, spp=4, width=256, height=192)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    a, sa = kernel._launch(scene, st, return_stats=True, blocks=sms)
    b, sb = kernel._launch(scene, st, return_stats=True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for key in ("segments", "shadow_rays", "warp_steps"):
        assert sa[key] == sb[key], key


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["terrain_mis", "bumpy_smooth_material"])
def test_mesh_kernel_matches_plain_on_card(cuda, frame):
    """B2 against its plain version (the loop integrator over the cluster
    tracer's plain skip walk), which must launch no kernel."""
    from vimg_tpu_torch.scene.synthetic import bumpy_sphere_scene, terrain_scene
    if frame == "terrain_mis":
        scene, integ = terrain_scene(2000, 64, 32, device=cuda), "mis"
    else:
        scene = bumpy_sphere_scene(2000, 64, 32, smooth_normals=True,
                                   device=cuda)
        integ = "material"
    st = ir.RenderSettings(width=64, height=32, spp=2, max_depth=64,
                           integrator=integ)
    assert kernel.is_mesh_mode(scene) and kernel.supports_megakernel(scene, st)
    before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH)
    img, ks = kernel.render_megakernel(scene, st, return_stats=True)
    assert (kernel.LAUNCHES, kernel.LAUNCHES_MESH) == (before[0],
                                                      before[1] + 1)
    walks = (ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP, kernel.LAUNCHES_MESH)
    ref, ps = kernel.render_megakernel_plain(scene, st, return_stats=True)
    assert (ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP, kernel.LAUNCHES_MESH) == walks
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    d = np.abs(ref - img)
    assert d.mean() < 1e-4 and (d.max(-1) > 1e-5).mean() < 0.01
    assert ks["segments"] == ps["segments"]
    assert ks["shadow_rays"] == ps["shadow_rays"]
    assert ks["box_tests"] > 0 and ks["tri_tests"] > 0


def test_wrapper_dispatch_on_cpu():
    """CPU scenes take the plain version and never count a launch; a
    device without a kernel raises; unsupported settings are rejected."""
    scene, st = _unit_scene("cpu", "mis", spp=1)
    before = kernel.LAUNCHES
    img = kernel.render_megakernel(scene, st)
    assert kernel.LAUNCHES == before and img.shape == (24, 32, 3)
    meta = scene.replace(verts=scene.verts.to("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        kernel.render_megakernel(meta, st)
    assert not kernel.supports_megakernel(scene, ir.RenderSettings(
        integrator="s_normal"))


def _terrain_rays(device, n=16384, seed=0):
    """Rays from above a 20k terrain toward it, half with a finite maxT."""
    r = np.random.default_rng(seed)
    ro = np.stack([r.uniform(-4, 4, n), r.uniform(0.5, 3, n),
                   r.uniform(-4, 4, n)], -1).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd[:, 1] = -np.abs(rd[:, 1])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    mx = np.where(r.random(n) < 0.5, np.inf, r.uniform(0.5, 4, n))
    mx[::97] = -np.inf                              # idle lanes
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                 device=device)
                 for x in (ro, rd, np.full(n, 1e-4), mx))


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["wide", "skip"])
def test_cluster_kernels_match_plain_walks(cuda, walk):
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(20_000, 16, 8, device=cuda)
    tr = ct.ClusterTracer(scene, walk=walk)
    rays = _terrain_rays(cuda)
    if walk == "wide":
        kern = lambda *r: ct.trace_wide(*tr.node_tables, tr.tri_rows,
                                        tr.n_wide, tr.max_stack, *r)
        plain = lambda *r: ct.wide_walk_plain(*tr.node_tables, tr.tri_rows,
                                              tr.max_stack, *r)
    else:
        kern = lambda *r: ct.trace_skip(*tr.node_tables, tr.tri_rows,
                                        tr.data.n_nodes, *r)
        plain = lambda *r: ct.skip_walk_plain(*tr.node_tables, tr.tri_rows,
                                              tr.data.n_nodes, *r)
    for any_hit in (False, True):
        before = (ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP)
        got = kern(*rays, any_hit)
        torch.cuda.synchronize()
        moved = (ct.LAUNCHES_WIDE - before[0], ct.LAUNCHES_SKIP - before[1])
        assert moved == ((1, 0) if walk == "wide" else (0, 1))
        ref = plain(*rays, any_hit)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert bool((got[1] >= 0).any()) or any_hit


def _bits(x):
    return x.view(torch.int32)


def _tied(tri):
    """tests/test_torch_cluster_warp.py's exact ties: in every cluster
    row 1 repeats row 0 and rows 16..23 repeat rows 0..7 (sub-box 1's box
    widened to hold sub-box 0's)."""
    t = tri.clone().view(-1, ct.CLUSTER_K, ct.ROW16)
    t[:, 1, :13] = t[:, 0, :13]
    t[:, 16:24, :13] = t[:, 0:8, :13]
    t[:, 2, 13:16] = torch.minimum(t[:, 2, 13:16], t[:, 0, 13:16])
    t[:, 3, 13:16] = torch.maximum(t[:, 3, 13:16], t[:, 1, 13:16])
    return t.reshape(-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_skip_kernel_bit_equal_with_warp_steps(cuda, ties):
    """B4 (the warp-cooperative walk) bit for bit against skip_walk_plain,
    closest and any hit, on a ragged ray count with idle lanes, with exact
    ties or not; its warp node and triangle steps equal the replay of its
    schedule (skip_schedule.warp_schedule)."""
    from vimg_tpu_torch.geometry import skip_schedule as ss
    scene = terrain_scene(20_000, 16, 8, device=cuda)
    tr = ct.ClusterTracer(scene, walk="skip")
    tri = _tied(tr.tri_rows) if ties else tr.tri_rows
    rays = tuple(x[:16384 - 11] for x in _terrain_rays(cuda))
    order = tr.sort_order(rays[0], rays[1], rays[3])
    rays = tuple(x[order].contiguous() for x in rays)
    tabs = (*tr.node_tables, tri, tr.data.n_nodes)
    for any_hit in (False, True):
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        got = ct.trace_skip(*tabs, *rays, any_hit, steps=steps)
        st = {}
        ref = ct.skip_walk_plain(*tabs, *rays, any_hit, stats=st)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b) if b.is_floating_point() else b)
        _, counts = ss.warp_schedule(*tabs, *rays, any_hit)
        assert [int(x) for x in steps.cpu()] == [counts["node_steps"],
                                                 counts["tri_steps"]]
        assert st["tri_tests"] / (32 * counts["tri_steps"]) > 0.5


def _ray_kinds(scene, tracer, device):
    """Camera rays (128x64 @ 1 spp), bounce rays from their hit points
    (random upward directions) and shadow rays from the same points to a
    point above the terrain (finite maxT)."""
    from vimg_tpu_torch.render.integrators import _primary_rays
    n = 128 * 64
    ro, rd, _, _ = _primary_rays(scene, ir.RenderSettings(width=128, height=64),
                           torch.arange(n, device=device),
                           torch.zeros(n, dtype=torch.int64, device=device))
    mn = torch.full((n,), 1e-4, device=device)
    inf = torch.full((n,), float("inf"), device=device)
    hr = tracer.closest(scene, ro, rd, mn, inf)
    idx = torch.nonzero(hr.hit)[:, 0]
    p = (ro[idx] + rd[idx] * hr.t[idx, None]).contiguous()
    r = np.random.default_rng(1)
    d = r.normal(size=(idx.numel(), 3))
    d[:, 1] = np.abs(d[:, 1])
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32, device=device)
    wl = torch.tensor([0.3, 4.0, -0.2], device=device) - p
    dist = wl.norm(dim=1)
    m = idx.numel()
    return {"camera": (ro, rd, mn, inf),
            "bounce": (p, d, mn[:m], inf[:m]),
            "shadow": (p, (wl / dist[:, None]).contiguous(), mn[:m],
                       dist * 0.999)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "bounce", "shadow", "ties"])
def test_wide_kernel_bit_equal_with_warp_steps(cuda, kind):
    """B3 (the 8-ary stack walk on the warp's leaf round) bit for bit
    against wide_walk_plain on camera, bounce and shadow (any hit) rays,
    and with exact ties on random rays (closest and any hit, idle lanes, a
    ragged last warp); its warp node and triangle steps equal the replay
    of its schedule (skip_schedule.wide_warp_schedule)."""
    from vimg_tpu_torch.geometry import skip_schedule as ss
    scene = terrain_scene(20_000, 128, 64, device=cuda)
    tr = ct.ClusterTracer(scene, walk="wide")
    if kind == "ties":
        tri = _tied(tr.tri_rows)
        cases = [(tuple(x[:16384 - 11] for x in _terrain_rays(cuda)), ah)
                 for ah in (False, True)]
    else:
        tri = tr.tri_rows
        cases = [(_ray_kinds(scene, tr, cuda)[kind], kind == "shadow")]
    for rays, any_hit in cases:
        order = tr.sort_order(rays[0], rays[1], rays[3])
        rays = tuple(x[order].contiguous() for x in rays)
        tabs = (*tr.node_tables, tri)
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        before = ct.LAUNCHES_WIDE
        got = ct.trace_wide(*tabs, tr.n_wide, tr.max_stack, *rays, any_hit,
                            steps=steps)
        assert ct.LAUNCHES_WIDE == before + 1
        st = {}
        ref = ct.wide_walk_plain(*tabs, tr.max_stack, *rays, any_hit,
                                 stats=st)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b) if b.is_floating_point() else b)
        assert bool((ref[0] == -float("inf")).any() if any_hit
                    else (ref[1] >= 0).any())
        _, counts = ss.wide_warp_schedule(*tabs, tr.max_stack, *rays,
                                          any_hit)
        assert [int(x) for x in steps.cpu()] == [counts["node_steps"],
                                                 counts["tri_steps"]]
        assert st["tri_tests"] / (32 * counts["tri_steps"]) > 0.5


@pytest.mark.cuda
def test_wide_kernel_refuses_misaligned_tables(cuda):
    """B3 reads wide boxes, refs, cluster boxes and triangle rows 16 bytes
    at a time: a view of any of them that does not start 16-byte aligned
    raises (no fallback)."""
    scene = terrain_scene(2_000, 16, 8, device=cuda)
    tr = ct.ClusterTracer(scene, walk="wide")
    rays = _terrain_rays(cuda, n=256)
    tabs = [*tr.node_tables, tr.tri_rows]
    for k in range(4):
        moved = list(tabs)
        x = tabs[k]
        moved[k] = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
        moved[k].copy_(x)
        with pytest.raises(ValueError, match="16-byte"):
            ct.trace_wide(*moved, tr.n_wide, tr.max_stack, *rays, False)


def _cull_edge_rays(C, device, seed=0):
    """tests/test_torch_packet.py's cull edge case (three workgroups, one
    looking away; idle lanes; zero direction components) with more: a
    denormal direction component (1 / d = +-inf) on every 13th ray, -0
    components, origins on a box's planes (so (lo - o) * inf is NaN), NaN
    and inf origins, a NaN minT and a second minT on every 17th ray (X1's
    buckets with more than one minT); with 5 clusters or more, boxes with
    lo == hi (flat and a point), an empty cluster's (+inf, -inf) and one
    with a NaN corner (tests/test_torch_cull_octant.py's edge case)."""
    r = np.random.default_rng(seed)
    ctr, half = r.random((C, 3)), 0.02 + 0.1 * r.random((C, 3))
    ctr[0], half[0] = 0.5, 0.45
    lo, hi = (ctr - half).astype(np.float32), (ctr + half).astype(np.float32)
    if C >= 5:
        lo[1, 1] = hi[1, 1]
        lo[2] = hi[2]
        lo[3], hi[3] = np.inf, -np.inf
        lo[4, 2] = np.nan
    n = 3 * 128
    ro = r.random((n, 3)).astype(np.float32)
    ro[:, 1] += 1.5
    rd = r.normal(size=(n, 3))
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.5
    rd[128:256, 1] *= -1.0
    rd[::5, 0] = 0.0
    rd[::11, 2] = 0.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[1::10, 0] = -0.0
    rd[3::13, 0] = 1e-40
    rd[4::13, 2] = -1e-40
    ro[3::26, 0] = lo[0, 0]
    ro[5::10, 0] = hi[0, 0]
    ro[6::17, 2] = lo[min(1, C - 1), 2]
    ro[7::31, 1] = np.nan
    ro[8::37, 0] = np.inf
    ro[9::41, 2] = -np.inf
    mn = np.full(n, 1e-4, np.float32)
    mn[10::43] = np.nan
    mn[2::17] = 0.05              # buckets with more than one minT
    mx = np.full(n, np.inf, np.float32)
    mx[::3] = 2.0
    mx[::7] = -np.inf
    pi = np.stack([r.permutation(C) for _ in range(8)])
    t = lambda x: torch.as_tensor(x, device=device)
    return (t(ro), t(rd), t(mn), t(mx)), t(lo), t(hi), t(pi)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_cull_kernel_bit_equal_to_plain(cuda, variant):
    """X1 (packet_cull.cu, through cull_meta and PacketTracer.cull) against
    the plain cull _cull_meta, meta bit for bit: on a 20k terrain's random,
    camera, bounce and shadow rays, and on edge cases with 1, 5, 127, 128,
    129 and 300 clusters (every slot of the meta is the kernel's: it is
    allocated empty). With 5 clusters or more one box is an empty
    cluster's, which the plain form meets from every ray with minT <=
    maxT: the workgroup looking away then has that one candidate."""
    from vimg_tpu_torch.geometry import packet_trace as pt
    scene = terrain_scene(20_000, 128, 64, device=cuda)
    tr = pt.PacketTracer(scene, variant=variant)
    f2b = variant == "f2b"
    kinds = _ray_kinds(scene, ct.ClusterTracer(scene, walk="wide"), cuda)
    for rays in (_terrain_rays(cuda), *kinds.values()):
        _, packed = tr.pack(*rays)
        before = pt.LAUNCHES_CULL
        got = tr.cull(packed)
        assert pt.LAUNCHES_CULL == before + 1
        ref = pt._cull_meta(*packed, tr.cl_lo, tr.cl_hi, tr.cp,
                            tr.pi if f2b else None, tr.entry_scale)
        assert pt.LAUNCHES_CULL == before + 1
        assert torch.equal(got, ref)
        assert int(got.view(-1, 8, tr.cp)[:, 2, 0].sum()) > 0
    for C in (1, 5, 127, 128, 129, 300):
        rays, lo, hi, pi = _cull_edge_rays(C, cuda, seed=C)
        cp = -(-(C + 1) // 128) * 128
        args = (*rays, lo, hi, cp, pi if f2b else None, 3.0e5)
        got, ref = pt.cull_meta(*args), pt._cull_meta(*args)
        assert torch.equal(got, ref), C
        assert int(got.view(-1, 8, cp)[1, 2, 0]) == (C >= 5), C


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_cull_kernel_steps_equal_replay(cuda, variant):
    """X1's counted launch: the meta of the uncounted launch, and its
    select-form, plain-form, bounds and skipped test counts those of
    cull_schedule.cull_steps on the CPU, on a 20k terrain's camera, bounce
    and shadow rays and on the edge cases with 5 and 300 clusters (both
    forms, unsafe buckets)."""
    from vimg_tpu_torch.geometry import cull_schedule as cs
    from vimg_tpu_torch.geometry import packet_trace as pt
    scene = terrain_scene(20_000, 128, 64, device=cuda)
    tr = pt.PacketTracer(scene, variant=variant)
    f2b = variant == "f2b"
    cases = []
    for rays in _ray_kinds(scene, ct.ClusterTracer(scene, walk="wide"),
                           cuda).values():
        _, packed = tr.pack(*rays)
        cases.append((*packed, tr.cl_lo, tr.cl_hi, tr.cp,
                      tr.pi if f2b else None, tr.entry_scale))
    for C in (5, 300):
        rays, lo, hi, pi = _cull_edge_rays(C, cuda, seed=C)
        cases.append((*rays, lo, hi, -(-(C + 1) // 128) * 128,
                      pi if f2b else None, 3.0e5))
    for args in cases:
        steps = torch.zeros(4, dtype=torch.int64, device=cuda)
        got = pt.cull_meta(*args, steps=steps)
        assert torch.equal(got, pt.cull_meta(*args))
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
               for a in args[:8]]
        want = cs.cull_steps(*cpu)
        assert dict(zip(cs.KEYS, (int(x) for x in steps.cpu()))) == want
        live = int((args[2] <= args[3]).sum())
        assert (want["select_tests"] + want["plain_tests"]
                + want["skipped_tests"]) == live * args[4].shape[0]
    with pytest.raises(ValueError, match="steps"):
        pt.cull_meta(*cpu, steps=torch.zeros(4, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_packet_tracer_launches_cull_and_walk(cuda, variant):
    """A CUDA PacketTracer runs X1 and B5 once a trace, with the hits of a
    plain=True tracer (plain cull and walk, no launch); a packet frame
    through render_frame (the wavefront) moves both counters alike."""
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.render.render import render_frame
    scene = terrain_scene(20_000, 64, 32, device=cuda)
    tr = pt.PacketTracer(scene, variant=variant)
    plain = pt.PacketTracer(scene, variant=variant, plain=True, data=tr.data)
    kinds = _ray_kinds(scene, ct.ClusterTracer(scene, walk="wide"), cuda)
    for kind, rays in kinds.items():
        before = (pt.LAUNCHES_CULL, pt.LAUNCHES)
        if kind == "shadow":
            got = tr.occluded(scene, *rays)
            assert (pt.LAUNCHES_CULL, pt.LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
            want = plain.occluded(scene, *rays)
            assert torch.equal(got, want) and bool(got.any())
        else:
            h = tr.closest(scene, *rays)
            assert (pt.LAUNCHES_CULL, pt.LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
            hp = plain.closest(scene, *rays)
            for f in ("t", "prim_type", "prim_id", "u", "v"):
                assert torch.equal(getattr(h, f), getattr(hp, f)), f
        assert (pt.LAUNCHES_CULL, pt.LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    before = (pt.LAUNCHES_CULL, pt.LAUNCHES)
    # 8 spp: a mesh MIS frame below it goes to the megakernel B2
    img = render_frame(scene, ir.RenderSettings(width=64, height=32, spp=8,
                                                integrator="mis"),
                       tracer_force="packet")
    n_cull, n_walk = (pt.LAUNCHES_CULL - before[0], pt.LAUNCHES - before[1])
    assert n_cull == n_walk > 0 and bool(torch.isfinite(img).all())


@pytest.mark.cuda
def test_skip_kernel_refuses_misaligned_tables(cuda):
    """B4 reads node boxes and triangle rows 16 bytes at a time: a view
    that does not start 16-byte aligned raises (no fallback)."""
    scene = terrain_scene(2_000, 16, 8, device=cuda)
    tr = ct.ClusterTracer(scene, walk="skip")
    rays = _terrain_rays(cuda, n=256)
    aabbs, cid, skip = tr.node_tables
    shifted = torch.empty(aabbs.numel() + 1, device=cuda)[1:]
    shifted.copy_(aabbs)
    with pytest.raises(ValueError, match="16-byte"):
        ct.trace_skip(shifted, cid, skip, tr.tri_rows, tr.data.n_nodes,
                      *rays, False)
    rows = torch.empty(tr.tri_rows.numel() + 2, device=cuda)[2:]
    rows.copy_(tr.tri_rows)
    with pytest.raises(ValueError, match="16-byte"):
        ct.trace_skip(aabbs, cid, skip, rows, tr.data.n_nodes, *rays, True)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["terrain_mis", "bumpy_smooth_material"])
def test_mesh_kernel_bit_identical_to_plain(cuda, frame):
    """B2 (every lane of a warp at each walk) against its plain version at
    a small size whose width is not a power of two: the film bit for bit,
    equal segment and shadow-ray counts, and the walk's lane fill from its
    counters."""
    from vimg_tpu_torch.scene.synthetic import bumpy_sphere_scene
    if frame == "terrain_mis":
        scene, integ = terrain_scene(5000, 48, 32, device=cuda), "mis"
    else:
        scene = bumpy_sphere_scene(5000, 48, 32, smooth_normals=True,
                                   device=cuda)
        integ = "material"
    st = ir.RenderSettings(width=48, height=32, spp=1, max_depth=64,
                           integrator=integ)
    img, ks = kernel.render_megakernel(scene, st, return_stats=True)
    ref, ps = kernel.render_megakernel_plain(scene, st, return_stats=True)
    assert torch.equal(_bits(img.contiguous()), _bits(ref.contiguous()))
    assert (ks["segments"], ks["shadow_rays"]) == (ps["segments"],
                                                   ps["shadow_rays"])
    assert 0.5 < ks["tri_tests"] / (32 * ks["warp_tri_steps"]) <= 1.0
    assert ks["warp_node_steps"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["analytic", "mesh"])
def test_megakernel_group_ranges_on_card(cuda, mode):
    """B1's and B2's pixel-group range: the whole-frame range given
    explicitly is the default launch bit for bit, three ranges launched in
    turn assemble the same film with the same counts, and (B2) a range is
    its plain version's range bit for bit."""
    from vimg_tpu_torch.parallel.sharding import make_mesh
    if mode == "analytic":
        scene, st = _unit_scene(cuda, "mis", spp=2, width=256, height=192)
    else:
        scene = terrain_scene(5000, 48, 32, device=cuda)
        st = ir.RenderSettings(width=48, height=32, spp=1, max_depth=64,
                               integrator="mis")
    n = kernel.n_groups(scene, st)
    whole, ws = kernel.render_megakernel(scene, st, return_stats=True)
    full = kernel.render_megakernel(scene, st, groups=(0, n))
    assert torch.equal(_bits(full), _bits(whole))
    img, ss = kernel.render_megakernel_sharded(
        scene, st, mesh=make_mesh([cuda] * 3), return_stats=True)
    assert torch.equal(_bits(img.contiguous()), _bits(whole.contiguous()))
    assert (ss["segments"], ss["shadow_rays"]) == (ws["segments"],
                                                   ws["shadow_rays"])
    if mode == "mesh":
        part = kernel.render_megakernel(scene, st, groups=(5, n - 7))
        ref = kernel.render_megakernel_plain(scene, st, groups=(5, n - 7))
        assert torch.equal(_bits(part), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_packet_kernel_matches_plain_walk(cuda, variant):
    """B5 against packet_walk_plain on the same meta, closest and any hit,
    on rays from above (idle lanes included) and on camera rays (coherent
    workgroups, where f2b's early exit fires), its step counter covering
    the needed tests; then the tracer facade."""
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.render.integrators import _primary_rays
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(20_000, 128, 64, device=cuda)
    tr = pt.PacketTracer(scene, variant=variant)
    n = 128 * 64
    ro, rd, _, _ = _primary_rays(scene, ir.RenderSettings(width=128, height=64),
                           torch.arange(n, device=cuda),
                           torch.zeros(n, dtype=torch.int64, device=cuda))
    camera = (ro, rd, torch.full((n,), 1e-4, device=cuda),
              torch.full((n,), float("inf"), device=cuda))
    for rays in (_terrain_rays(cuda), camera):
        _, packed = tr.pack(*rays)
        meta = tr.cull(packed)
        for any_hit in (False, True):
            before = pt.LAUNCHES
            steps = torch.zeros(1, dtype=torch.int64, device=cuda)
            got = pt.trace_packet(tr.tri_t, meta, *packed,
                                  *tr.walk_args(any_hit), steps=steps)
            torch.cuda.synchronize()
            assert pt.LAUNCHES == before + 1
            st = {}
            ref = pt.packet_walk_plain(tr.tri_t, meta, *packed,
                                       *tr.walk_args(any_hit), stats=st,
                                       cl_len=tr.data.cl_len)
            assert pt.LAUNCHES == before + 1
            for a, b in zip(got, ref):
                assert torch.equal(_bits(a), _bits(b))
            assert bool((got[1] >= 0).any()) or any_hit
            assert 0 < st["tri_tests"] <= 32 * int(steps)
    plain = pt.PacketTracer(scene, variant=variant, plain=True, data=tr.data)
    before = pt.LAUNCHES
    h = tr.closest(scene, *camera)
    assert pt.LAUNCHES == before + 1
    hp = plain.closest(scene, *camera)
    for f in ("t", "prim_type", "prim_id", "u", "v"):
        assert torch.equal(getattr(h, f), getattr(hp, f)), f


@pytest.mark.cuda
def test_gather_kernel_matches_plain(cuda):
    from vimg_tpu_torch.ops import mxu_gather as g
    rs = np.random.RandomState(1)
    table = (rs.randn(24, 256) * np.exp(rs.randn(24, 256) * 4)
             ).astype(np.float32)
    hi, mid, lo = (x.to(cuda) for x in g.split3(table))
    ids = torch.from_numpy(rs.randint(-2, 258, (1, 4096)).astype(np.int32))
    before = g.LAUNCHES
    got = g.gather_row(hi, mid, lo, ids.to(cuda), 256)
    torch.cuda.synchronize()
    assert g.LAUNCHES == before + 1
    ref = g.gather_row_plain(hi, mid, lo, ids.to(cuda), 256)
    assert torch.equal(_bits(got), _bits(ref))
    ok = ((ids >= 0) & (ids < 256))[0]
    assert np.array_equal(got.cpu().numpy()[:, ok.numpy()],
                          table[:, ids[0][ok].numpy()])


# ---------------------------------------------------------------------------
# the probe kernels P1-P11 (vimg_tpu_torch/probes) against their plain
# versions, bit for bit, at small sizes
# ---------------------------------------------------------------------------

def _probe_launches(name, fn):
    from vimg_tpu_torch.probes import common
    before = common.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert common.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 1])
def test_probe_walk_kernel_matches_plain(cuda, group):
    from vimg_tpu_torch.probes import probe_walkablate as pw
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(20_000, 64, 32, device=cuda)
    data = ct.ClusterData(scene)
    tables = pw.probe_tables(data, cuda)
    rays = pw.sorted_bounce_rays(scene, data, 8192)
    for variant in pw.VARIANTS:
        bt, nv = _probe_launches("probe_walkablate", lambda: pw.walkablate(
            *tables, *rays, variant, group))
        rbt, rnv = pw.walkablate_plain(*tables, *rays, variant, group)
        assert torch.equal(_bits(bt), _bits(rbt)), variant
        assert torch.equal(nv, rnv), variant
        assert nv.shape == (8192 // group,)
        if variant == "full":
            assert bool(torch.isfinite(bt).any())


@pytest.mark.cuda
@pytest.mark.parametrize("group", [32, 1])
def test_probe_walk_kernel_steps_equal_replay(cuda, group):
    """P1's full walk counted: bt and visits the plain walk's and its warp
    node and triangle steps the replay's (walk_schedule), also on a ragged
    ray count at group 1 (lanes past the rays take part in the leaf
    rounds without a ray) and with ties (two copies of every triangle)."""
    from vimg_tpu_torch.probes import probe_walkablate as pw
    scene = terrain_scene(20_000, 64, 32, device=cuda)
    data = ct.ClusterData(scene)
    tables = pw.probe_tables(data, cuda)
    tied = tables[:3] + (_tied(tables[3]),) + tables[4:]
    rays = pw.sorted_bounce_rays(scene, data, 8192)
    cases = [(tables, rays), (tied, rays)]
    if group == 1:
        cases.append((tables, tuple(x[:8192 - 75] for x in rays)))
    for tabs, r in cases:
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        bt, nv = _probe_launches("probe_walkablate", lambda: pw.walkablate(
            *tabs, *r, "full", group, steps=steps))
        rbt, rnv = pw.walkablate_plain(*tabs, *r, "full", group)
        sbt, snv, c = pw.walk_schedule(*tabs, *r, group)
        assert torch.equal(_bits(bt), _bits(rbt))
        assert torch.equal(nv, rnv)
        assert torch.equal(_bits(sbt), _bits(rbt)) and torch.equal(snv, rnv)
        assert [int(x) for x in steps.cpu()] == [c["node_steps"],
                                                 c["tri_steps"]]
        assert c["tri_tests"] == 32 * c["tri_steps"] > 0
    with pytest.raises(ValueError, match="full walk"):
        pw.walkablate(*tables, *rays, "no_tri", group, steps=steps)


@pytest.mark.cuda
def test_probe_scalar_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_r3b, probe_r3c, probe_regen
    x = torch.full((32, 128), 0.1, device=cuda)
    x[3, 7] = 0.499999                       # crosses the thresholds
    for mode in probe_r3b.MODES:
        got = _probe_launches("probe_sync",
                              lambda: probe_r3b.sync(x, mode, 3000))
        ref = probe_r3b.sync_plain(x, mode, 3000)
        assert torch.equal(_bits(got), _bits(ref)), mode
    x8 = torch.rand((8, 128), device=cuda)
    tab = probe_r3c.probe_table(cuda)
    for packed, n_reads in probe_r3c.CONFIGS:
        got = _probe_launches("probe_smem_read", lambda: probe_r3c.smem_read(
            x8, tab, n_reads, packed, 500))
        ref = probe_r3c.smem_read_plain(x8, tab, n_reads, packed, 500)
        assert torch.equal(_bits(got), _bits(ref)), (packed, n_reads)
    with pytest.raises(ValueError, match="tab"):
        probe_r3c.smem_read(x8, tab - 1, 4, False, 10)
    got = _probe_launches("probe_smem_write",
                          lambda: probe_regen.stack_sum(x8))
    assert torch.equal(_bits(got), _bits(probe_regen.stack_sum_plain(x8)))
    assert torch.equal(got, x8 + 423.0)


@pytest.mark.cuda
def test_probe_packet_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_r4a as r
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.rand(8, 128).astype(np.float32)).to(cuda)
    tbl = torch.from_numpy(rs.rand(40 * 12, 128).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rs.randint(-3, 45, 64).astype(np.int32)).to(cuda)
    m = torch.from_numpy((rs.rand(1, 128) < 0.1).astype(np.float32)).to(cuda)
    t128 = torch.from_numpy(rs.rand(128, 128).astype(np.float32)).to(cuda)
    cases = (
        ("probe_setup", lambda: r.setup(x, True, 37),
         lambda: r.setup_plain(x, 37)),
        ("probe_setup", lambda: r.setup(x, False, 37),
         lambda: r.setup_plain(x, 37)),
        ("probe_dynrow", lambda: r.dynrow(tbl, idx, 70),
         lambda: r.rows_plain(tbl, idx, 70, False)),
        ("probe_dynblock", lambda: r.dynblock(tbl, idx, 70, True),
         lambda: r.rows_plain(tbl, idx, 70, True)),
        ("probe_dynblock", lambda: r.dynblock(tbl, idx, 70, False),
         lambda: r.rows_plain(tbl, idx, 70, False)),
        ("probe_dynrow_par", lambda: r.dynrow_par(tbl, idx, 70),
         lambda: r.rows_plain(tbl, idx, 70, True)),
        ("probe_ffs", lambda: r.ffs(m, t128, 5),
         lambda: r.ffs_plain(m, t128, 5)),
        ("probe_epilogue", lambda: r.epilogue(x, 300),
         lambda: r.epilogue_plain(x, 300)))
    for name, kern, plain in cases:
        got = _probe_launches(name, kern)
        assert torch.equal(_bits(got), _bits(plain())), name


@pytest.mark.cuda
@pytest.mark.parametrize("stage,n_packets",
                         [(0, 16), (1, 16), (2, 16), (3, 16), (4, 1), (4, 4),
                          (4, 16)])
def test_probe_packet_stage_kernel_matches_plain(cuda, stage, n_packets):
    from vimg_tpu_torch.probes import probe_r4c
    args = probe_r4c.stage_inputs(cuda)
    got = _probe_launches("probe_packet_stages",
                          lambda: probe_r4c.packet_stage(*args, stage,
                                                         n_packets))
    ref = probe_r4c.packet_stage_plain(*args, stage, n_packets)
    assert torch.equal(_bits(got), _bits(ref))
    # exact ties: a lane repeated and clusters repeated along the chain
    xt, meta, tri = (a.clone() for a in args)
    c = tri.view(-1, 12, 128)
    c[:, :, 77] = c[:, :, 5]
    meta.view(-1, 8, 128)[:, 0, :40] = torch.arange(40, device=cuda) % 9
    got = probe_r4c.packet_stage(xt, meta, tri, stage, n_packets)
    ref = probe_r4c.packet_stage_plain(xt, meta, tri, stage, n_packets)
    assert torch.equal(_bits(got), _bits(ref))


# the probe kernels P12-P31 against their plain versions at small sizes:
# bit for bit, except P19 (within 2 K u (|A| |B|) of the float64 product)
# and P27 (rtol 1e-4 of float64, the probe's own gate)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_probe_prims_kernel_matches_plain(cuda):
    from vimg_tpu_torch.probes import probe_prims
    tab = probe_prims.table(cuda)
    init = torch.rand(probe_prims.SHAPE, device=cuda) * 99.9
    for prim in probe_prims.PRIMS:
        for n_rep in (1, 4):
            ref = probe_prims.prims_plain(tab, init, prim, n_rep, 300)
            for n_blocks in (1, 0):
                got, blocks = _probe_launches(
                    "probe_prims", lambda: probe_prims.prims(
                        tab, init, prim, n_rep, 300, n_blocks))
                assert torch.equal(_bits(got), _bits(ref)), (prim, n_rep)
                assert blocks == 1 if n_blocks else blocks >= 132


def _rate_kernels_match(cases):
    """Each (launch name, kernel, plain, x) in both forms, one block and
    the full card, float32 and bf16, bit for bit."""
    for dtype in ("f32", "bf16"):
        for fused in (False, True):
            for name, kern, plain, x in cases:
                ref = plain(x, dtype, fused, 150)
                for n_blocks in (1, 0):
                    got, _ = _probe_launches(name, lambda: kern(
                        x, dtype, fused, 150, n_blocks))
                    assert torch.equal(_bits(got), _bits(ref)), (
                        name, dtype, fused)


@pytest.mark.cuda
def test_probe_vpu2_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_vpu2 as v
    _rate_kernels_match((
        ("probe_fma", v.fma, v.fma_plain, v.tile(3, cuda)),
        ("probe_mix", v.mix, v.mix_plain, v.tile(4, cuda))))


@pytest.mark.cuda
def test_probe_vpu3_kernel_matches_plain(cuda):
    from vimg_tpu_torch.probes import probe_vpu2, probe_vpu3
    x4 = probe_vpu2.tile(4, cuda)
    for form in probe_vpu3.FORMS:
        for fused in (False, True):
            ref = probe_vpu3.vpu3_plain(x4, form, fused)
            for n_blocks in (1, 0):
                got, _ = _probe_launches("probe_vpu3", lambda: probe_vpu3.vpu3(
                    x4, form, fused, n_blocks=n_blocks))
                assert torch.equal(_bits(got), _bits(ref)), (form, fused)


@pytest.mark.cuda
def test_probe_r2c_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_r2c as r
    for n in (8, 2048):
        tab, idx = r.take_table(n, cuda), r.indices(n, cuda)
        got = _probe_launches("probe_take", lambda: r.take(tab, idx))
        assert torch.equal(_bits(got), _bits(r.take_plain(tab, idx))), n
    for n in (256, 2048):
        tab, idx = r.onehot_table(n, cuda), r.indices(n, cuda)
        got = _probe_launches("probe_onehot", lambda: r.onehot(tab, idx))
        assert torch.equal(_bits(got), _bits(r.onehot_plain(tab, idx))), n
    for n in r.SELCHAIN_N:
        tab, idx = r.selchain_table(n, cuda), r.indices(n, cuda)
        got = _probe_launches("probe_selchain", lambda: r.selchain(tab, idx))
        assert torch.equal(_bits(got), _bits(r.selchain_plain(tab, idx))), n
    a, b = r.matmul_inputs(cuda)
    for form in r.MM_U:
        got = _probe_launches("probe_mxu_precision",
                              lambda: r.matmul(a, b, form))
        assert r.matmul_held(a, b, got, form) <= 1.0, form
    _rate_kernels_match((("probe_vpu_rate", r.rate, r.rate_plain,
                                r.tile(3, cuda)),))


@pytest.mark.cuda
def test_probe_r4j_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_r4j as j
    for n_mats in (48, 512):
        table, ids = j.inputs(n_mats, device=cuda)
        hi, mid, lo = j.split3(table)
        got = _probe_launches("probe_lookup_check",
                              lambda: j.lookup_check(ids, hi, mid, lo))
        assert torch.equal(got, table[:, ids[0].long()])
        got = _probe_launches("probe_lookup",
                              lambda: j.lookup_mxu(ids, hi, mid, lo, 2))
        ref = j.mxu_plain(ids, hi, mid, lo, 2)
        assert torch.equal(_bits(got), _bits(ref)), n_mats
    table, ids = j.inputs(48, device=cuda)
    hi = j.split3(table)[0]
    got = _probe_launches("probe_lookup",
                          lambda: j.lookup_chain(ids, hi, 48, reps=2))
    assert torch.equal(_bits(got), _bits(j.chain_plain(ids, hi, 48, reps=2)))


@pytest.mark.cuda
def test_probe_pallas_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_pallas as pp
    x = torch.full(pp.TILE, 0.5, device=cuda)
    tbl = pp.scalars_table(cuda)
    xt = pp.transc_input(cuda)
    for name, kern, plain in (
            ("probe_grid", lambda: pp.grid(cuda), lambda: pp.grid_plain(cuda)),
            ("probe_while", lambda: pp.while_loop(x),
             lambda: pp.while_plain(x)),
            ("probe_pcg", lambda: pp.pcg(cuda), lambda: pp.pcg_plain(cuda)),
            ("probe_scalars", lambda: pp.scalars(tbl),
             lambda: pp.scalars_plain(tbl))):
        got = _probe_launches(name, kern)
        assert torch.equal(_bits(got), _bits(plain())), name
    got = _probe_launches("probe_transcendental",
                          lambda: pp.transcendental(xt))
    exact = pp.transc_exact(xt)
    assert bool(((got.double() - exact).abs() <= 1e-4 * exact.abs()).all())
    ref = pp.throughput_plain(cuda, 200)
    for n_blocks in (pp.TP_BLOCKS, 0):
        got, blocks = _probe_launches(
            "probe_throughput", lambda: pp.throughput(cuda, 200, n_blocks))
        assert torch.equal(_bits(got), _bits(ref)) and blocks >= 128


@pytest.mark.cuda
def test_probe_constructs_kernels_match_plain(cuda):
    from vimg_tpu_torch.probes import probe_constructs as pc
    args = pc.inputs(cuda)
    for which in (1, 2, 3):
        got = _probe_launches(pc.LAUNCH_NAMES[which],
                              lambda: pc.constructs(*args, which))
        assert torch.equal(_bits(got), _bits(pc.constructs_plain(*args,
                                                                 which)))


@pytest.mark.cuda
def test_s_normal_frame_renders_on_card(cuda):
    """A JSON scene without an integrator block renders s_normal on the
    card through render() (no megakernel), as on the CPU."""
    import dataclasses
    import os
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene.json_loader import load_json_scene
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "disney_spheres_flagship.json")
    imgs = {}
    for dev in (cuda, torch.device("cpu")):
        scene, st = load_json_scene(path, device=dev)
        scene = scene.replace(camera=dataclasses.replace(
            scene.camera, width=180, height=80))
        st = dataclasses.replace(st, width=180, height=80, spp=1,
                                 integrator="s_normal")
        before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH)
        imgs[dev.type] = render_frame(scene, st)
        assert (kernel.LAUNCHES, kernel.LAUNCHES_MESH) == before
    img = imgs["cuda"]
    assert img.is_cuda and img.shape == imgs["cpu"].shape
    assert bool(torch.isfinite(img).all())
    d = (img.cpu() - imgs["cpu"]).abs()
    assert float(d.mean()) < 1e-4 and float((d.max(-1).values > 1e-5)
                                            .float().mean()) < 0.01


def _other_frame(case, device):
    """(scene, settings, render_frame keywords, the walk kernel the card
    must launch or None) of a frame that render_frame sends to render()
    on CUDA: a g_normal terrain frame, and material frames the megakernel
    refuses (260 spheres) over a triangle floor through the cluster tracer
    and alone through the SoA tracer (make_tracer has no tracer for 260
    spheres by itself: the BVH is ROADMAP A21)."""
    if case == "terrain_g_normal":
        scene = terrain_scene(20_000, 64, 32, device=device)
        return (scene, ir.RenderSettings(64, 32, spp=4, integrator="g_normal"),
                {}, ct.ClusterTracer(scene).walk)
    floor = 0 if case == "unit_material" else 2_000
    scene, st = _unit_scene(device, "material", spp=4, n_extra=257,
                            floor_tris=floor)
    st = dataclasses.replace(st, max_depth=8)
    if not floor:
        return scene, st, {"tracer_force": "soa"}, None
    if case == "floor_material_skip":
        return scene, st, {"tracer": ct.ClusterTracer(scene, walk="skip")}, \
            "skip"
    return scene, st, {"tracer_force": "cluster"}, \
        ct.ClusterTracer(scene).walk


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["terrain_g_normal", "floor_material",
                                  "floor_material_skip", "unit_material"])
def test_other_frames_render_on_card(cuda, case):
    """g_normal and refused material frames render through render() on
    the card, equal per pixel to the CPU's at the unit-scale bound, and
    launch only their walk kernel (B3 or B4; these integrators trace no
    shadow rays) or none."""
    from vimg_tpu_torch.render.mega import supports_megakernel
    from vimg_tpu_torch.render.render import render_frame
    imgs = {}
    for dev in (torch.device("cpu"), cuda):
        scene, st, kw, walk = _other_frame(case, dev)
        assert not supports_megakernel(scene, st)
        before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH, ct.LAUNCHES_WIDE,
                  ct.LAUNCHES_SKIP)
        imgs[dev.type] = render_frame(scene, st, **kw)
    moved = [n for n, b, a in zip(("mega", "mega_mesh", "wide", "skip"),
                                  before, (kernel.LAUNCHES,
                                           kernel.LAUNCHES_MESH,
                                           ct.LAUNCHES_WIDE, ct.LAUNCHES_SKIP))
             if a != b]
    assert moved == ([walk] if walk else [])
    img = imgs["cuda"]
    assert img.is_cuda and img.shape == imgs["cpu"].shape
    assert bool(torch.isfinite(img).all())
    d = (img.cpu() - imgs["cpu"]).abs()
    assert float(d.mean()) < 1e-4 and float((d.max(-1).values > 1e-5)
                                            .float().mean()) < 0.01


@pytest.mark.cuda
def test_c19_agx_frame_bit_equal_to_cpu(cuda):
    """C19: an accumulated film of spp = 3 samples (not a power of two),
    divided by spp with the renderers' core.math.div and AgX-tonemapped,
    has the same bits on the card as on the CPU (PyTorch's CUDA division by
    a Python number would multiply by its float32 reciprocal instead)."""
    from vimg_tpu_torch.core.math import div
    from vimg_tpu_torch.render import film
    r = np.random.default_rng(30)
    acc = torch.as_tensor((r.random((96, 128, 3)) ** 3 * 12.0)
                          .astype(np.float32))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        img = div(acc.to(dev), 3)
        out[dev.type] = (img, film.agx(img), film.finalize(img, "agx"))
    for name, a, b in zip(("frame", "agx", "finalize"), out["cpu"],
                          out["cuda"]):
        bad = int((_bits(a) != _bits(b.cpu())).sum())
        assert bad == 0, (name, bad)
    # the reciprocal form really differs here: the test can see C19
    assert not torch.equal(_bits(acc.to(cuda) / 3).cpu(),
                           _bits(out["cpu"][0]))


@pytest.mark.cuda
def test_envtex_frame_card_vs_cpu(cuda):
    """Main path 9 at 64x32 @ 4 spp: the env-lit textured terrain through
    render_frame -> the wavefront on the card (B3 launches, nothing else)
    and on the CPU: mean|d| < 6e-3 and corr > 0.99."""
    from vimg_tpu_torch.render.render import render_frame
    from vimg_tpu_torch.scene.synthetic import textured_terrain_scene
    st = ir.RenderSettings(64, 32, spp=4, max_depth=64, integrator="mis",
                           tonemap="agx")
    imgs = {}
    for dev in (torch.device("cpu"), cuda):
        scene = textured_terrain_scene(100_000, 64, 32, device=dev)
        before = (kernel.LAUNCHES, kernel.LAUNCHES_MESH, ct.LAUNCHES_WIDE,
                  ct.LAUNCHES_SKIP)
        imgs[dev.type] = render_frame(scene, st)
        after = (kernel.LAUNCHES, kernel.LAUNCHES_MESH, ct.LAUNCHES_WIDE,
                 ct.LAUNCHES_SKIP)
    moved = [n for n, b, a in zip(("mega", "mega_mesh", "wide", "skip"),
                                  before, after) if a != b]
    assert moved == ["wide"]
    img = imgs["cuda"]
    assert img.is_cuda and img.shape == (32, 64, 3)
    assert bool(torch.isfinite(img).all())
    a, b = img.cpu().double().numpy(), imgs["cpu"].double().numpy()
    assert np.abs(a - b).mean() < 6e-3
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.99


@pytest.mark.cuda
def test_train_gradients_kernel_vs_plain_walk_on_card(cuda):
    """Main path 10's gradients (diff/grad.py, MIS, bounded_depth 6) on
    the envtex scene at 64x32 through kernel B3 at zero tangent and
    through the plain walk, both on the card: every key finite and within
    1e-3 of the largest (the backward's scatter-adds use atomics, so not
    bit for bit), and B3 launched."""
    from vimg_tpu_torch.diff import grad
    from vimg_tpu_torch.geometry.trace import make_tracer
    from vimg_tpu_torch.render.integrators import trace_radiance
    from vimg_tpu_torch.scene.synthetic import textured_terrain_scene
    scene = textured_terrain_scene(100_000, 64, 32, device=cuda)
    st = ir.RenderSettings(64, 32, spp=1, max_depth=64, integrator="mis")
    start = scene.replace(env_scale=scene.env_scale * 0.5)
    kern = make_tracer(start, differentiable=True)
    plain = ct.ClusterTracer(start, data=kern.data, plain=True)
    pix = torch.arange(64 * 32, device=cuda)
    samp = torch.zeros_like(pix)
    with torch.no_grad():
        target = trace_radiance(scene, st, kern, pix, samp,
                                bounded_depth=6)
    out = {}
    for name, tr in (("kernel", kern), ("plain", plain)):
        params = {k: tuple(m.clone().requires_grad_(True) for m in v)
                  if isinstance(v, tuple) else v.clone().requires_grad_(True)
                  for k, v in grad.get_params(start).items()}
        before = ct.LAUNCHES_WIDE
        loss, g = grad.value_and_grad(start, st, tr, params, pix, samp,
                                      target, bounded_depth=6)
        out[name] = (float(loss), g, ct.LAUNCHES_WIDE - before)
    assert out["kernel"][2] > 0 and out["plain"][2] == 0
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-5 * out["plain"][0]
    for k, ref in out["plain"][1].items():
        got = out["kernel"][1][k]
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert bool(torch.isfinite(a).all()), k
            err = float((a - b).abs().max())
            assert err <= 1e-3 * float(b.abs().max()) + 1e-6, (k, err)


def _bvh_scene(device):
    """A 20k terrain with 100 spheres over it and among the rays."""
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(20_000, 16, 8, device=device)
    r = np.random.default_rng(3)
    c = np.stack([r.uniform(-4, 4, 100), r.uniform(0.0, 1.5, 100),
                  r.uniform(-4, 4, 100)], -1).astype(np.float32)
    return scene.replace(
        sph_center=torch.as_tensor(c, device=device),
        sph_radius=torch.as_tensor(r.uniform(0.05, 0.4, 100), device=device,
                                   dtype=torch.float32),
        sph_mat=torch.zeros(100, dtype=torch.int64, device=device))


def _bvh_case(kind, device):
    """(scene, rays) of an X2 test: the 20k terrain with spheres, or
    tests/test_torch_bvh_warp.py's stacks of coincident triangles (equal t
    within a leaf and across leaves)."""
    if kind == "terrain":
        return _bvh_scene(device), _terrain_rays(device)
    from test_torch_bvh_warp import _stack_rays, _stack_scene
    return _stack_scene(device), _stack_rays(device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("builder", ["auto", "sweep"])
@pytest.mark.parametrize("kind", ["terrain", "stacks"])
def test_bvh_kernel_bit_equal_to_plain(cuda, kind, builder):
    """X2 against bvh_traverse in its three modes: closest (t, prim type,
    prim id, u, v), any hit and the cost counter, bit for bit, one launch
    each; BVHTracer launches X2 and its plain twin never does."""
    from vimg_tpu_torch.geometry import bvh as tb
    scene, rays = _bvh_case(kind, cuda)
    tr = tb.BVHTracer(scene, builder=builder)
    before = tb.LAUNCHES
    hr = tb.bvh_trace(scene, tr.bvh, *rays)
    occ = tb.bvh_trace(scene, tr.bvh, *rays, any_hit=True)
    hc, cost = tb.bvh_trace(scene, tr.bvh, *rays, count_cost=True)
    torch.cuda.synchronize()
    assert tb.LAUNCHES == before + 3
    ref = tb.bvh_traverse(scene, tr.bvh, *rays)
    rocc = tb.bvh_traverse(scene, tr.bvh, *rays, any_hit=True)
    _, rcost = tb.bvh_traverse(scene, tr.bvh, *rays, count_cost=True)
    assert tb.LAUNCHES == before + 3
    for got in (hr, hc):
        for k in ("t", "u", "v"):
            assert torch.equal(_bits(getattr(got, k)), _bits(getattr(ref, k)))
        for k in ("prim_type", "prim_id"):
            assert torch.equal(getattr(got, k), getattr(ref, k))
    assert torch.equal(occ, rocc) and torch.equal(_bits(cost), _bits(rcost))
    assert bool((ref.prim_type == ir.PRIM_SPHERE).any())
    assert bool((ref.prim_type == ir.PRIM_TRI).any())
    assert bool(ref.hit.any()) and not bool(ref.hit.all())
    plain = tb.BVHTracer(scene, builder=builder, plain=True)
    got = tr.closest(scene, *rays)
    assert tb.LAUNCHES == before + 4
    assert torch.equal(got.prim_id, plain.closest(scene, *rays).prim_id)
    assert torch.equal(tr.occluded(scene, *rays), rocc)
    assert tb.LAUNCHES == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["terrain", "stacks"])
def test_bvh_kernel_steps_equal_replay(cuda, kind):
    """X2's counted launch: its warp node and leaf steps equal the replay
    of its schedule (geometry/bvh_schedule.py::warp_schedule) on the same
    rays, and its outputs are the uncounted launch's, in each mode."""
    from vimg_tpu_torch.geometry import bvh as tb
    from vimg_tpu_torch.geometry import bvh_schedule as bs
    scene, rays = _bvh_case(kind, cuda)
    tr = tb.BVHTracer(scene)
    nodes, rows = tb.packed_tables(scene, tr.bvh)
    for any_hit, count_cost in ((False, False), (True, False), (False, True)):
        kw = dict(any_hit=any_hit, count_cost=count_cost)
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        got = tb.bvh_trace(scene, tr.bvh, *rays, steps=steps, **kw)
        ref = tb.bvh_trace(scene, tr.bvh, *rays, **kw)
        replay, counts = bs.warp_schedule(nodes, rows, *rays, **kw)
        assert [int(x) for x in steps.cpu()] == [counts["node_steps"],
                                                 counts["leaf_steps"]]
        if any_hit:
            assert torch.equal(got, ref) and torch.equal(got, replay)
            continue
        if count_cost:
            (got, gc), (ref, rc), (replay, pc) = got, ref, replay
            assert torch.equal(_bits(gc), _bits(rc))
            assert torch.equal(_bits(gc), _bits(pc))
        for k in ("t", "u", "v"):
            assert torch.equal(_bits(getattr(got, k)), _bits(getattr(ref, k)))
            assert torch.equal(_bits(getattr(got, k)),
                               _bits(getattr(replay, k)))
        for k in ("prim_type", "prim_id"):
            assert torch.equal(getattr(got, k), getattr(replay, k))


@pytest.mark.cuda
def test_bvh_kernel_follows_scene(cuda):
    """X2's packed tables on the card follow the scene: after the vertices
    and sphere centres are replaced and the tree refit, and after the
    vertices are written in place (the rows at once, the boxes at the next
    refit), X2 stays bvh_traverse's on the scene as it is then."""
    from vimg_tpu_torch.geometry import bvh as tb
    scene = _bvh_scene(cuda)
    rays = _terrain_rays(cuda)
    tr = tb.BVHTracer(scene)

    def held(sc):
        got = tr.closest(sc, *rays)
        ref = tb.bvh_traverse(sc, tr.bvh, *rays)
        for k in ("t", "u", "v"):
            assert torch.equal(_bits(getattr(got, k)), _bits(getattr(ref, k)))
        for k in ("prim_type", "prim_id"):
            assert torch.equal(getattr(got, k), getattr(ref, k))
        return got

    first = held(scene)
    r = np.random.default_rng(9)
    dv = torch.as_tensor(r.normal(0, 0.05, tuple(scene.verts.shape)),
                         dtype=torch.float32, device=cuda)
    dc = torch.as_tensor(r.normal(0, 0.1, tuple(scene.sph_center.shape)),
                         dtype=torch.float32, device=cuda)
    moved = scene.replace(verts=scene.verts + dv,
                          sph_center=scene.sph_center + dc)
    tr.refit(moved)
    second = held(moved)
    assert not torch.equal(first.t, second.t)
    with torch.no_grad():
        moved.verts.add_(dv)
    third = held(moved)
    assert not torch.equal(second.t, third.t)
    tr.refit(moved)
    held(moved)


def _sweep_inputs(device, P, seed, seg_len):
    """One axis of one level as the device build hands it to X3: segment
    starts (runs of random lengths up to ``seg_len``, or with ``seg_len``
    "chunk_edges" of 1 to 3 whole 1,024-position chunks, so that every
    segment edge is a chunk edge) and boxes with some exact duplicates and
    zero-size ones."""
    r = np.random.default_rng(seed)
    starts, s = [], 0
    while s < P:
        n = (1024 * int(r.integers(1, 4)) if seg_len == "chunk_edges"
             else int(r.integers(1, seg_len + 1)))
        n = min(n, P - s)
        starts += [s] * n
        s += n
    c = r.random((P, 3)).astype(np.float32)
    h = (0.03 * r.random((P, 3))).astype(np.float32)
    h[::7] = 0.0
    c[1::5] = c[0]
    return (torch.as_tensor(np.asarray(starts, np.int32), device=device),
            torch.as_tensor(c - h, device=device),
            torch.as_tensor(c + h, device=device))


def _same_sweep(got, ref):
    """seg_cost's bits (any NaN as NaN) and seg_j equal."""
    a, b = got[0], ref[0]
    both = torch.isnan(a) & torch.isnan(b)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(_bits(torch.where(both, 0.0, a)),
                       _bits(torch.where(both, 0.0, b)))
    assert torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("P,seg_len", [(1, 1), (2, 2), (1000, 1000),
                                       (1025, 1025), (5000, 40), (70000, 1),
                                       (70000, 3000), (300000, 300000),
                                       (4_194_304, 4_194_304),
                                       (4_194_304, 50),
                                       (600_000, 600_000),
                                       (500_000, "chunk_edges")])
def test_sah_sweep_kernel_bit_equal_to_plain(cuda, P, seg_len):
    """X3 (csrc/sah_sweep.cu) bit for bit against sah_sweep_plain, both on
    the card, on segments from single positions to one segment spanning
    hundreds of 1,024-position chunks, with duplicate and zero-size boxes;
    and with a NaN box (its segment's least cost NaN in both). At 4,194,304
    positions the tiles outnumber what shared memory holds (inputs read
    from HBM in both phases, several chunks a tile); at 600,000 they are
    staged with several chunks a tile; "chunk_edges" puts every segment
    edge on a chunk edge."""
    from vimg_tpu_torch.geometry import device_build as db
    seed = P + (seg_len if isinstance(seg_len, int) else 7)
    seg, lo, hi = _sweep_inputs(cuda, P, seed, seg_len)
    before = db.LAUNCHES
    got = db.sah_sweep(seg, lo, hi)
    assert db.LAUNCHES == before + 1
    _same_sweep(got, db.sah_sweep_plain(seg, lo, hi))
    if P > 2:
        lo[P // 2, 1] = float("nan")
        _same_sweep(db.sah_sweep(seg, lo, hi), db.sah_sweep_plain(seg, lo,
                                                                  hi))


@pytest.mark.cuda
def test_sah_sweep_one_kernel_a_call(cuda):
    """X3 queues exactly one kernel a call (torch.profiler), at a level's
    size of the 100k build and at one too large to stage. A session that
    comes back with no device activity at all (CUPTI drops one now and
    then) is profiled again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vimg_tpu_torch.geometry import device_build as db
    for P in (99_460, 4_194_304):
        seg, lo, hi = _sweep_inputs(cuda, P, 3, 500)
        db.sah_sweep(seg, lo, hi)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                db.sah_sweep(seg, lo, hi)
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if getattr(e, "device_type", None) == DeviceType.CUDA]
            if kernels:
                break
        assert len(kernels) == 1 and "sah_sweep_coop" in kernels[0], kernels


@pytest.mark.cuda
def test_sah_sweep_plan(cuda):
    """The launch's shape: at the 100k build's size a chunk a tile, staged
    in shared memory, every block resident; at 4,194,304 positions several
    chunks a tile, read from HBM."""
    from vimg_tpu_torch.geometry import device_build as db
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    small = db.sweep_plan(99_460, cuda)
    assert small["tile_chunks"] == 1 and small["grid"] == 98
    assert small["smem_bytes"] == 1024 * 28
    large = db.sweep_plan(4_194_304, cuda)
    assert large["smem_bytes"] == 0 and large["tile_chunks"] > 1
    for plan in (small, large):
        assert plan["grid"] <= plan["per_sm"] * sms
        assert 0 < plan["regs"] <= 128


@pytest.mark.cuda
def test_device_build_card_equals_cpu(cuda):
    """The device build on the card (X3 and tensor code) equals the plain
    build on the CPU in every key, on terrain 20k's primitive boxes; X3
    launches 3 x the levels run, and equals its plain version on every
    level's inputs."""
    from vimg_tpu_torch.geometry import bvh as tb
    from vimg_tpu_torch.geometry import device_build as db
    scene = terrain_scene(20_000, 16, 8, device="cpu")
    bmin, bmax, cen, _, _ = tb.scene_prim_bounds(scene)
    before = db.LAUNCHES
    got = db.build_sweep_sah_device(bmin, bmax, cen, device=cuda)
    levels = db.LAST_STATS["levels"]
    assert db.LAUNCHES == before + 3 * levels
    ref = db.build_sweep_sah_device(bmin, bmax, cen, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    checked = []

    def both(seg, lo, hi):
        out = db.sah_sweep(seg, lo, hi)
        _same_sweep(out, db.sah_sweep_plain(seg, lo, hi))
        checked.append(seg.shape[0])
        return out
    t = [torch.as_tensor(x, device=cuda) for x in (bmin, bmax, cen)]
    db.build_levels(*t, db.max_levels_for(bmin.shape[0]), sweep=both)
    assert len(checked) == 3 * levels


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["wide", "skip"])
def test_cluster_per_warp_steps(cuda, walk):
    """The per-warp counted launch of B3 / B4 (trace_stats' source): its
    rows equal the warp replay's, sum to the launch's total steps, and its
    hits equal the uncounted launch's."""
    from vimg_tpu_torch.geometry import skip_schedule as ss
    scene = terrain_scene(20_000, 16, 8, device=cuda)
    tr = ct.ClusterTracer(scene, walk=walk)
    rays = tuple(x[:16384 - 11].contiguous() for x in _terrain_rays(cuda))
    per = tr.trace_stats(*rays)
    walk_rays, _ = tr._walk_rays(*rays, None)
    if walk == "wide":
        tabs = (*tr.node_tables, tr.tri_rows)
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        got = ct.trace_wide(*tabs, tr.n_wide, tr.max_stack, *walk_rays,
                            False, steps=steps)
        plain = ct.trace_wide(*tabs, tr.n_wide, tr.max_stack, *walk_rays,
                              False)
        _, counts = ss.wide_warp_schedule(*tabs, tr.max_stack, *walk_rays,
                                          False)
    else:
        tabs = (*tr.node_tables, tr.tri_rows, tr.data.n_nodes)
        steps = torch.zeros(2, dtype=torch.int64, device=cuda)
        got = ct.trace_skip(*tabs, *walk_rays, False, steps=steps)
        plain = ct.trace_skip(*tabs, *walk_rays, False)
        _, counts = ss.warp_schedule(*tabs, *walk_rays, False)
    assert per.shape == (-(-walk_rays[0].shape[0] // 32), 2)
    assert np.array_equal(per, counts["warp_steps"].cpu().numpy())
    assert per.sum(0).tolist() == [float(x) for x in steps.cpu()]
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mxu_tracer_against_soa_on_card(cuda):
    """make_tracer(force="mxu") on the card against the SoA tracer at
    tests/test_fast_tracers.py's tolerances; chunked equals unchunked."""
    import warnings
    from vimg_tpu_torch.geometry.soa_intersect import SoATracer
    from vimg_tpu_torch.geometry.trace import make_tracer
    b = SceneBuilder()
    m = b.add_material(ir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    r = np.random.default_rng(0)
    c = r.uniform(-10, 10, (300, 3)).astype(np.float32)
    v = (c[:, None] + r.uniform(-0.8, 0.8, (300, 3, 3))).astype(np.float32)
    b.add_mesh(v.reshape(-1, 3), np.arange(900).reshape(300, 3), m)
    for _ in range(20):
        b.add_sphere(r.uniform(-10, 10, 3), r.uniform(0.2, 1.5), m)
    scene = b.build(camera=dict(cam2world=np.eye(4, dtype=np.float32),
                                width=8, height=8, vfov_deg=45.0),
                    device=cuda)
    n = 8192
    ro = torch.as_tensor(r.uniform(-15, 15, (n, 3)), dtype=torch.float32,
                         device=cuda)
    rd = torch.as_tensor(r.normal(size=(n, 3)), dtype=torch.float32,
                         device=cuda)
    rd = rd / rd.norm(dim=1, keepdim=True)
    mn = torch.full((n,), 1e-4, device=cuda)
    mx = torch.full((n,), float("inf"), device=cuda)
    with warnings.catch_warnings(record=True):
        tr = make_tracer(scene, force="mxu")
    got = tr.closest(scene, ro, rd, mn, mx)
    ref = SoATracer(scene).closest(scene, ro, rd, mn, mx)
    t1, t2 = ref.t.cpu().numpy(), got.t.cpu().numpy()
    assert (np.isfinite(t1) == np.isfinite(t2)).mean() > 0.999
    both = np.isfinite(t1) & np.isfinite(t2)
    assert both.mean() > 0.05
    assert np.allclose(t1[both], t2[both], rtol=1e-3, atol=1e-3)
    assert (ref.prim_id.cpu().numpy()[both]
            == got.prim_id.cpu().numpy()[both]).mean() > 0.999
    tri = both & (ref.prim_type.cpu().numpy() == 0)
    assert np.allclose(ref.u.cpu().numpy()[tri], got.u.cpu().numpy()[tri],
                       atol=2e-3)
    ten = torch.full((n,), 10.0, device=cuda)
    occ = (SoATracer(scene).occluded(scene, ro, rd, mn, ten).cpu().numpy()
           == tr.occluded(scene, ro, rd, mn, ten).cpu().numpy())
    assert occ.mean() > 0.999
    from vimg_tpu_torch.geometry.mxu_intersect import mxu_intersect
    small = mxu_intersect(tr.W, tr.aux, ro, rd, mn, mx, tr.nt, tr.ns,
                          max_bytes=1 << 16)
    for k in ("t", "prim_type", "prim_id", "u", "v"):
        assert torch.equal(getattr(small, k), getattr(got, k)), k
