"""Kernel X2's packed tables and the replays of its warp schedules
(geometry/bvh_schedule.py) against the plain walk bvh_traverse, on the
CPU.

Criteria. The packed tables decode back to the tree's tables and the
scene's geometry bit for bit, follow the scene (after a refit, after the
vertices are replaced and after they are written in place) and live as
long as the tree they were packed for. Both
replays (the warp-cooperative walk of csrc/bvh_walk.cu and the per-lane
walk of its first design) return bvh_traverse's results bit for bit in
the three modes (closest t, prim type, prim id, u, v; any hit; the cost
counter), on a ragged last warp, rays with maxT = -inf, rays with zero
direction components, any-hit rays whose only hit lies at maxT, and
stacks of coincident triangles (equal t within a leaf and across leaves);
their box and primitive tests are the plain walk's. bvh_traverse itself is
held to vimg_tpu in test_torch_bvh.py.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from test_torch_bvh import _mixed_scene, _rays
from vimg_tpu_torch.geometry import bvh as tb
from vimg_tpu_torch.geometry import bvh_schedule as bs
from vimg_tpu_torch.scene import ir as tir
from vimg_tpu_torch.scene.json_loader import SceneBuilder

MODES = ("closest", "any_hit", "cost")
N_RAGGED = 2048 - 13
FIELDS = ("t", "prim_type", "prim_id", "u", "v")


@pytest.fixture(scope="module")
def scene():
    return _mixed_scene("torch")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(got, ref, mode):
    """Bit-equality of two walks' returns in ``mode``."""
    if mode == "any_hit":
        assert torch.equal(got, ref)
        return
    if mode == "cost":
        (got, gc), (ref, rc) = got, ref
        assert torch.equal(_bits(gc), _bits(rc)), "cost"
    for f in FIELDS:
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(ref, f))), f


def _walk_rays(scene, tree):
    """The mixed scene's rays, a ragged count, with maxT = -inf on some and
    maxT = the closest hit's t on others (their only hit lies at maxT)."""
    ro, rd, mn, mx = (torch.from_numpy(x)[:N_RAGGED].clone()
                      for x in _rays())
    mx[100:110] = -float("inf")
    hr = tb.bvh_traverse(scene, tree, ro, rd, mn, mx)
    at = torch.nonzero(hr.hit)[200:260, 0]
    mx[at] = hr.t[at]
    return (ro, rd, mn, mx), at


def _check_counts(counts, st):
    assert counts["box_tests"] == st["box_tests"]
    assert counts["prim_tests"] == st["tri_tests"] + st["sphere_tests"]
    assert 0 < counts["node_steps"] <= counts["box_tests"]
    assert 0 < counts["leaf_steps"] <= counts["prim_tests"]


@pytest.mark.parametrize("builder", ("auto", "sweep"))
def test_packed_tables_decode(scene, builder):
    tree = tb.build_scene_bvh(scene, builder)
    nodes, rows = tb.packed_tables(scene, tree)
    assert nodes.dtype == rows.dtype == torch.float32
    assert nodes.shape == (tree.n_nodes, tb.NODE_WORDS)
    assert rows.shape == (tree.prim_type.shape[0], tb.ROW_WORDS)
    lo, hi, skip, start, count = tb.node_fields(nodes)
    for got, want in ((lo, tree.node_min), (hi, tree.node_max)):
        assert torch.equal(_bits(got.contiguous()), _bits(want))
    for got, want in ((skip, tree.node_skip), (start, tree.node_start),
                      (count, tree.node_count)):
        assert torch.equal(got, want)
    kind, ptype, pidx = tb.row_fields(rows)
    assert torch.equal(ptype, tree.prim_type)
    assert torch.equal(pidx, tree.prim_idx)
    assert torch.equal(kind, tree.prim_type)  # every slot testable here
    w = rows.view(torch.int32)
    tri = torch.nonzero(ptype == tir.PRIM_TRI)[:, 0]
    sph = torch.nonzero(ptype == tir.PRIM_SPHERE)[:, 0]
    assert tri.numel() == scene.n_tris() and sph.numel() == scene.n_spheres()
    verts = scene.verts[scene.tri_vidx[pidx[tri].long()]].reshape(-1, 9)
    assert torch.equal(w[tri, 0:9], _bits(verts.contiguous()))
    assert torch.equal(w[sph, 0:3],
                       _bits(scene.sph_center[pidx[sph].long()]))
    assert torch.equal(w[sph, 3], _bits(scene.sph_radius[pidx[sph].long()]))
    # packed once: the same tensors come back while nothing changed
    again = tb.packed_tables(scene, tree)
    assert again[0] is nodes and again[1] is rows


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("builder", ("auto", "sweep"))
def test_replays_bit_equal(scene, builder, mode):
    tree = tb.build_scene_bvh(scene, builder)
    nodes, rows = tb.packed_tables(scene, tree)
    rays, at = _walk_rays(scene, tree)
    kw = dict(any_hit=mode == "any_hit", count_cost=mode == "cost")
    st = {}
    ref = tb.bvh_traverse(scene, tree, *rays, stats=st, **kw)
    for schedule in (bs.warp_schedule, bs.lane_schedule):
        got, counts = schedule(nodes, rows, *rays, **kw)
        _equal(got, ref, mode)
        _check_counts(counts, st)
    occ = ref if mode == "any_hit" else None
    if occ is not None:
        # a hit at maxT exactly does not occlude; the rest of the rays do
        assert not bool(occ[at].any()) and bool(occ.any())
        assert not bool(occ[100:110].any())
    else:
        hr = ref[0] if mode == "cost" else ref
        assert not bool(hr.hit[at].any()) and not bool(hr.hit[100:110].any())
        assert bool((hr.prim_type == tir.PRIM_SPHERE).any())
        assert bool(torch.isfinite(hr.t).any())


def _stack_scene(device="cpu"):
    """Terrain-free stacks of coincident triangles: 40 quads' worth of
    triangles, each repeated 12 times (more than a leaf holds, so a stack
    fills a leaf and spills into another), and 30 spheres among them."""
    rs = np.random.RandomState(11)
    b = SceneBuilder()
    m = b.add_material(tir.MAT_LAMBERTIAN, base=(0.5, 0.5, 0.5))
    verts, tris = [], []
    for q in range(40):
        c = rs.uniform(-3, 3, 3).astype(np.float32)
        tri = c + rs.uniform(-0.6, 0.6, (3, 3)).astype(np.float32)
        verts.append(tri)
        tris += [[3 * q, 3 * q + 1, 3 * q + 2]] * 12
    b.add_mesh(np.concatenate(verts), np.asarray(tris, np.int32), m)
    for _ in range(30):
        b.add_sphere(rs.uniform(-3, 3, 3), rs.uniform(0.05, 0.3), m)
    eye = np.eye(4, dtype=np.float32)
    return b.build(camera=dict(cam2world=eye, width=8, height=8,
                               vfov_deg=40.0), device=device)


def _stack_rays(n=1000, device="cpu"):
    """Rays from around the stacks toward points among them."""
    rs = np.random.RandomState(2)
    ro = torch.from_numpy(rs.uniform(-4, 4, (n, 3)).astype(np.float32))
    tgt = torch.from_numpy(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
    rd = tgt - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    return tuple(x.to(device) for x in (ro, rd, torch.full((n,), 1e-4),
                                        torch.full((n,), float("inf"))))


@pytest.mark.parametrize("builder", ("numpy", "auto", "sweep"))
def test_packed_tables_live_with_the_tree(scene, builder):
    """X2's tables are cached on the tree they were packed for: a refit's
    new tree packs its own (unmoved geometry: the same bits), the old tree
    keeps its own, and the tables are freed with their tree."""
    tr = tb.BVHTracer(scene, builder=builder)
    old = tr.bvh
    nodes0, rows0 = tb.packed_tables(scene, old)
    tr.refit(scene)
    assert tr.bvh is not old and not tr.bvh.packed
    nodes1, rows1 = tb.packed_tables(scene, tr.bvh)
    assert nodes1 is not nodes0 and rows1 is not rows0
    assert torch.equal(_bits(nodes1), _bits(nodes0))
    assert torch.equal(_bits(rows1), _bits(rows0))
    assert tb.packed_tables(scene, old)[0] is nodes0
    gone = weakref.ref(nodes0), weakref.ref(rows0)
    del old, nodes0, rows0
    gc.collect()
    assert gone[0]() is None and gone[1]() is None


@pytest.mark.parametrize("builder", ("auto", "sweep"))
def test_replays_coincident_triangles(builder):
    """Equal t within a leaf keeps its first slot, equal t in a later leaf
    does not replace the best: both replays as bvh_traverse."""
    scene = _stack_scene()
    tree = tb.build_scene_bvh(scene, builder)
    nodes, rows = tb.packed_tables(scene, tree)
    ro, rd, mn, mx = _stack_rays()
    for mode in MODES:
        kw = dict(any_hit=mode == "any_hit", count_cost=mode == "cost")
        st = {}
        ref = tb.bvh_traverse(scene, tree, ro, rd, mn, mx, stats=st, **kw)
        for schedule in (bs.warp_schedule, bs.lane_schedule):
            got, counts = schedule(nodes, rows, ro, rd, mn, mx, **kw)
            _equal(got, ref, mode)
            _check_counts(counts, st)
    # the stacks span leaves, and rays hit them: a hit's copy is the first
    # copy of its stack in walk order (the lowest slot of the first leaf)
    start, count = tree.node_start, tree.node_count
    leaf_of = torch.full((tree.prim_type.shape[0],), -1, dtype=torch.int64)
    for i in torch.nonzero(count > 0)[:, 0].tolist():
        leaf_of[int(start[i]):int(start[i]) + int(count[i])] = i
    tri_slots = torch.nonzero(tree.prim_type == tir.PRIM_TRI)[:, 0]
    stack = tree.prim_idx[tri_slots].long() // 12
    spans = [torch.unique(leaf_of[tri_slots[stack == s]]).numel()
             for s in range(40)]
    assert max(spans) >= 2
    hr = tb.bvh_traverse(scene, tree, ro, rd, mn, mx)
    hits = hr.hit & (hr.prim_type == tir.PRIM_TRI)
    assert int(hits.sum()) > 50
    slot_of = torch.empty_like(tri_slots)
    slot_of[tree.prim_idx[tri_slots].long()] = tri_slots
    win = slot_of[hr.prim_id[hits]]
    first = torch.stack([tri_slots[stack == s].min()
                         for s in (hr.prim_id[hits] // 12).tolist()])
    # the walk meets a stack's leaves in slot order and keeps the first
    assert bool((win == first).all())


def test_packed_tables_follow_scene(scene):
    """The packed tables are packed anew after a refit, after the scene's
    vertices and sphere centres are replaced, and after they are written
    in place; the warp replay over them stays bvh_traverse's."""
    tr = tb.BVHTracer(scene, builder="numpy")
    nodes0, rows0 = tb.packed_tables(scene, tr.bvh)
    rs = np.random.RandomState(9)
    dv = torch.from_numpy(rs.normal(0, 0.05, tuple(scene.verts.shape))
                          .astype(np.float32))
    dc = torch.from_numpy(rs.normal(0, 0.1, tuple(scene.sph_center.shape))
                          .astype(np.float32))
    moved = scene.replace(verts=scene.verts + dv,
                          sph_center=scene.sph_center + dc)
    tr.refit(moved)
    nodes1, rows1 = tb.packed_tables(moved, tr.bvh)
    assert nodes1 is not nodes0 and rows1 is not rows0
    lo, hi = tb.node_fields(nodes1)[:2]
    assert torch.equal(lo, tr.bvh.node_min) and torch.equal(hi,
                                                            tr.bvh.node_max)
    assert not torch.equal(lo, tb.node_fields(nodes0)[0])

    rays = [torch.from_numpy(x)[:1024] for x in _rays()]

    def held(sc):
        nodes, rows = tb.packed_tables(sc, tr.bvh)
        _, pidx = tb.row_fields(rows)[1:]
        tri = torch.nonzero(tb.row_fields(rows)[1] == tir.PRIM_TRI)[:, 0]
        want = sc.verts[sc.tri_vidx[pidx[tri].long()]].reshape(-1, 9)
        assert torch.equal(rows.view(torch.int32)[tri, 0:9],
                           want.contiguous().view(torch.int32))
        got, _ = bs.warp_schedule(nodes, rows, *rays)
        _equal(got, tb.bvh_traverse(sc, tr.bvh, *rays), "closest")
        return nodes, rows

    held(moved)
    # written in place: the rows follow at once, the nodes after a refit
    with torch.no_grad():
        moved.verts.add_(dv)
    nodes2, rows2 = held(moved)
    assert rows2 is not rows1 and nodes2 is nodes1
    tr.refit(moved)
    nodes3, rows3 = held(moved)
    assert nodes3 is not nodes2 and torch.equal(_bits(rows3), _bits(rows2))
