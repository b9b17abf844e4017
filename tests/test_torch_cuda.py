"""The CUDA kernels against their plain PyTorch versions, on the card:
the megakernel (B1 analytic mode, B2 mesh mode), the cluster walks (B3
wide, B4 skip), the packet walk (B5), the table-row gather (B6) and the
probe kernels P1-P11 (vimg_tpu_torch/probes).

This file imports no JAX, so it also runs on the GPU machine, which has
none: ``python3 -m pytest --noconftest tests/test_torch_cuda.py -q`` from
the repository root (``--noconftest`` because tests/conftest.py imports
JAX). Without CUDA the card tests skip and only the dispatch checks run.
Criteria: for B1 and B2, tests/test_megakernel.py's per-pixel bound at
unit scale (mean|d| < 1e-4, < 1% of pixels with max|d| > 1e-5; the mesh
scenes are unit scale too) and equal segment and shadow-ray counts; for
B3, B4 and B5, bit-equality with their plain walks; for B6 and P1-P11,
bit-equality with their plain versions.
"""
import numpy as np
import pytest
import torch

from vimg_tpu_torch.core.math import look_at
from vimg_tpu_torch.geometry import cluster_trace as ct
from vimg_tpu_torch.render.mega import kernel
from vimg_tpu_torch.scene import ir
from vimg_tpu_torch.scene.json_loader import SceneBuilder


def _unit_scene(device, integrator, spp=8):
    b = SceneBuilder()
    red = b.add_material(ir.MAT_LAMBERTIAN, base=(0.8, 0.2, 0.2))
    glass = b.add_material(ir.MAT_DIELECTRIC, base=(1, 1, 1),
                           scalars={ir.MS_IOR: 1.5})
    light = b.add_material(ir.MAT_DIFFUSE_LIGHT, base=(5.0, 5.0, 5.0))
    b.add_sphere((0, 0, 0), 1.0, red)
    b.add_sphere((2.2, 0, 0), 1.0, glass)
    b.add_sphere((0, 3.0, 0), 1.0, light)
    cam = dict(cam2world=look_at([0, 0, 6], [0.7, 0, 0], [0, 1, 0]),
               width=32, height=24, vfov_deg=45.0)
    return (b.build(camera=cam, device=device),
            ir.RenderSettings(width=32, height=24, spp=spp, max_depth=64,
                              integrator=integrator))


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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["slist", "f2b"])
def test_packet_kernel_matches_plain_walk(cuda, variant):
    """B5 against packet_walk_plain on the same meta, closest and any hit,
    on rays from above (idle lanes included) and on camera rays (coherent
    workgroups, where f2b's early exit fires); then the tracer facade."""
    from vimg_tpu_torch.geometry import packet_trace as pt
    from vimg_tpu_torch.render.integrators import _primary_rays
    from vimg_tpu_torch.scene.synthetic import terrain_scene
    scene = terrain_scene(20_000, 128, 64, device=cuda)
    tr = pt.PacketTracer(scene, variant=variant)
    n = 128 * 64
    ro, rd = _primary_rays(scene, ir.RenderSettings(width=128, height=64),
                           torch.arange(n, device=cuda),
                           torch.zeros(n, dtype=torch.int64, device=cuda))
    camera = (ro, rd, torch.full((n,), 1e-4, device=cuda),
              torch.full((n,), float("inf"), device=cuda))
    for rays in (_terrain_rays(cuda), camera):
        _, packed = tr.pack(*rays)
        meta = tr.cull(packed)
        for any_hit in (False, True):
            before = pt.LAUNCHES
            got = pt.trace_packet(tr.tri_t, meta, *packed,
                                  *tr.walk_args(any_hit))
            torch.cuda.synchronize()
            assert pt.LAUNCHES == before + 1
            ref = pt.packet_walk_plain(tr.tri_t, meta, *packed,
                                       *tr.walk_args(any_hit))
            assert pt.LAUNCHES == before + 1
            for a, b in zip(got, ref):
                assert torch.equal(_bits(a), _bits(b))
            assert bool((got[1] >= 0).any()) or any_hit
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
