"""The warp schedules of the binary skip walk (kernel B4 and the mesh mode
of the megakernel B2) and of the 8-ary stack walk (kernel B3), replayed
on the CPU by vimg_tpu_torch.geometry.skip_schedule, against the plain
walks.

``lane_schedule`` / ``wide_lane_schedule`` (a lane walks its ray and
scans its own leaves, the design before the warp-cooperative leaf) and
``warp_schedule`` / ``wide_warp_schedule`` (the kernels' design: nodes
per lane, the posted leaves of a warp run 32 triangles a step, hits
merged by least (t, k)) must return ``skip_walk_plain``'s or
``wide_walk_plain``'s (t, slot, u, v) bit for bit and its box and
triangle test counts. The cases: closest and any-hit rays on a 20k
terrain; the same with exact ties (a triangle duplicated inside its
sub-box and into another sub-box of its cluster); rays with maxT = -inf
and with a zero direction component; a ragged last warp; and a
participating mask of fewer than 32 lanes a warp (B2 calls the walk from
lanes that may have no ray). The plain walk itself is held to vimg_tpu in
tests/test_torch_cluster.py; vimg_tpu's Pallas kernel is not run here.
"""
import numpy as np
import pytest
import torch

from vimg_tpu_torch.geometry import cluster_trace as ct
from vimg_tpu_torch.geometry import skip_schedule as ss
from vimg_tpu_torch.scene.synthetic import terrain_scene

SCHEDULES = {"lane": ss.lane_schedule, "warp": ss.warp_schedule}
WIDE_SCHEDULES = {"wide_lane": ss.wide_lane_schedule,
                  "wide_warp": ss.wide_warp_schedule}


@pytest.fixture(scope="module")
def scene():
    return terrain_scene(20_000, 16, 8, device="cpu")


@pytest.fixture(scope="module")
def terrain(scene):
    """A 20k terrain's skip tables, and a copy whose every cluster holds
    exact ties: row 1 repeats row 0 (the same sub-box) and rows 16..23
    repeat rows 0..7 (sub-box 1, whose box is widened to hold sub-box
    0's)."""
    tr = ct.ClusterTracer(scene, walk="skip")
    tri = tr.tri_rows.clone().view(-1, ct.CLUSTER_K, ct.ROW16)
    tri[:, 1, :13] = tri[:, 0, :13]
    tri[:, 16:24, :13] = tri[:, 0:8, :13]
    tri[:, 2, 13:16] = torch.minimum(tri[:, 2, 13:16], tri[:, 0, 13:16])
    tri[:, 3, 13:16] = torch.maximum(tri[:, 3, 13:16], tri[:, 1, 13:16])
    return tr, tri.reshape(-1).contiguous()


def _rays(tr, n, seed, aim=False):
    """n rays from above the terrain, half with a finite maxT, every 97th
    with maxT = -inf, every 13th with a zero x direction; ``aim`` points
    them at triangle centroids (so that most hit, ties included). In the
    tracer's Morton order, as the kernels get them."""
    r = np.random.default_rng(seed)
    ro = np.stack([r.uniform(-4, 4, n), r.uniform(0.5, 3, n),
                   r.uniform(-4, 4, n)], -1).astype(np.float32)
    if aim:
        rows = tr.tri_rows.view(-1, ct.CLUSTER_K, ct.ROW16)
        c = r.integers(0, rows.shape[0], n)
        box = rows[c, 0:8:2, 13:16].numpy(), rows[c, 1:8:2, 13:16].numpy()
        tgt = 0.5 * (box[0][:, 0] + box[1][:, 0])
        rd = tgt - ro
    else:
        rd = r.normal(size=(n, 3))
        rd[:, 1] = -np.abs(rd[:, 1])
    rd[::13, 0] = 0.0
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    mx = np.where(r.random(n) < 0.5, np.inf, r.uniform(0.5, 6, n))
    mx[::97] = -np.inf
    rays = tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32))
                 for x in (ro, rd, np.full(n, 1e-4), mx))
    order = tr.sort_order(rays[0], rays[1], rays[3])
    return tuple(x[order].contiguous() for x in rays)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def wide(scene, terrain):
    """The same terrain's 8-ary tables (the same clusters and rows)."""
    return ct.ClusterTracer(scene, walk="wide", data=terrain[0].data)


def _tables(tr, wide, tri, schedule):
    """The walk's tables for ``schedule`` and its plain walk."""
    if schedule.startswith("wide"):
        return ((*wide.node_tables, tri, wide.max_stack),
                ct.wide_walk_plain)
    return (*tr.node_tables, tri, tr.data.n_nodes), ct.skip_walk_plain


def _run(tr, wide, tri, rays, any_hit, schedule, mask=None):
    tabs, plain = _tables(tr, wide, tri, schedule)
    st = {}
    ref = plain(*tabs, *rays, any_hit, stats=st)
    got, counts = _schedule(schedule)(*tabs, *rays, any_hit, mask=mask)
    return ref, st, got, counts


def _schedule(name):
    return {**SCHEDULES, **WIDE_SCHEDULES}[name]


@pytest.mark.parametrize("schedule", [*SCHEDULES, *WIDE_SCHEDULES])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_schedule_matches_plain_walk(terrain, wide, schedule, any_hit, ties):
    """(t, slot, u, v) bit for bit and the same box and triangle tests,
    on a ragged number of rays (the last warp holds 5), ties or not."""
    tr, tied = terrain
    tri = tied if ties else tr.tri_rows
    rays = _rays(tr, 2048 + 5, seed=3 + ties, aim=ties)
    ref, st, got, counts = _run(tr, wide, tri, rays, any_hit, schedule)
    assert _same(got, ref)
    assert (counts["box_tests"], counts["tri_tests"]) == (st["box_tests"],
                                                          st["tri_tests"])
    assert counts["tri_steps"] > 0 and counts["node_steps"] > 0
    if any_hit:
        assert 0 < int((ref[0] == -float("inf")).sum()) < ref[0].numel()
    else:
        assert int((ref[1] >= 0).sum()) > 200
    if ties and not any_hit:
        # hits on a duplicated row keep the first copy
        k = ref[1][ref[1] >= 0] % ct.CLUSTER_K
        assert int((k == 0).sum()) > 0
        assert not bool(((k == 1) | ((k >= 16) & (k < 24))).any())


def test_ties_are_exercised(terrain):
    """The tied tables do put equal t on rows of one sub-box and of two
    (so the merge's (t, k) order is tested): with the originals removed,
    the same rays hit the copies at the same t."""
    tr, tied = terrain
    rays = _rays(tr, 2048 + 5, seed=4, aim=True)
    base = ct.skip_walk_plain(*tr.node_tables, tied, tr.data.n_nodes, *rays,
                              False)
    was0 = (base[1] >= 0) & (base[1] % ct.CLUSTER_K == 0)
    assert int(was0.sum()) > 10
    gone = tied.clone().view(-1, ct.CLUSTER_K, ct.ROW16)
    for row, copy in ((0, 1), (1, 16)):
        gone[:, row, :12] = 0.0                 # n = 0: never hits
        got = ct.skip_walk_plain(*tr.node_tables, gone.reshape(-1),
                                 tr.data.n_nodes, *rays, False)
        assert bool((got[1][was0] % ct.CLUSTER_K == copy).all())
        assert torch.equal(_bits(got[0][was0]), _bits(base[0][was0]))


@pytest.mark.parametrize("schedule", [*SCHEDULES, *WIDE_SCHEDULES])
@pytest.mark.parametrize("any_hit", [False, True])
def test_schedule_with_partial_warps(terrain, wide, schedule, any_hit):
    """A mask of the lanes that walk, fewer than 32 a warp: they get the
    plain walk's answers, the others keep (maxT, -1, 0, 0)."""
    tr, tied = terrain
    rays = _rays(tr, 1024 + 17, seed=9, aim=True)
    mask = torch.as_tensor(np.random.default_rng(2).random(1041) < 0.6)
    ref, _, got, counts = _run(tr, wide, tied, rays, any_hit, schedule,
                               mask=mask)
    for x, y in zip(got, ref):
        assert torch.equal(_bits(x[mask]), _bits(y[mask]))
    off = ~mask
    assert torch.equal(_bits(got[0][off]), _bits(rays[3][off]))
    assert bool((got[1][off] == -1).all())
    assert bool((got[2][off] == 0).all() and (got[3][off] == 0).all())
    tabs, _ = _tables(tr, wide, tied, schedule)
    full = _schedule(schedule)(*tabs, *rays, any_hit)[1]
    assert counts["tri_tests"] < full["tri_tests"]


def test_warp_schedule_fills_the_warp(terrain):
    """The warp-cooperative leaf runs the needed tests in far fewer warp
    steps: its lane fill (tri_tests / (32 x tri_steps)) is near 1, the
    per-lane leaf's far below."""
    tr, _ = terrain
    rays = _rays(tr, 4096, seed=5)
    fills = {}
    for name, fn in SCHEDULES.items():
        _, counts = fn(*tr.node_tables, tr.tri_rows, tr.data.n_nodes, *rays,
                       False)
        fills[name] = counts["tri_tests"] / (32 * counts["tri_steps"])
    assert fills["warp"] > 0.9
    assert fills["lane"] < 0.5 * fills["warp"]


@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_warp_schedule_fills_the_warp(terrain, wide, any_hit):
    """B3 on the warp's leaf round: the same needed tests in far fewer
    warp triangle steps than its per-lane leaf (a higher lane fill)."""
    tr, _ = terrain
    rays = _rays(tr, 4096, seed=5)
    tabs, _ = _tables(tr, wide, tr.tri_rows, "wide")
    counts = {name: fn(*tabs, *rays, any_hit)[1]
              for name, fn in WIDE_SCHEDULES.items()}
    fills = {k: c["tri_tests"] / (32 * c["tri_steps"])
             for k, c in counts.items()}
    assert counts["wide_lane"]["tri_tests"] == counts["wide_warp"]["tri_tests"]
    assert fills["wide_warp"] > (0.8 if any_hit else 0.9)
    assert fills["wide_lane"] < 0.5 * fills["wide_warp"]
